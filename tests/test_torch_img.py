"""The port's image branch against the JAX package, on the CPU.

The ResNet18 trunk and the eval forward of ``ImgResNetEncAdaPoinTrVariableLoss``
(ImgAdaPoinTr) on ``cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml`` with 64x64
images, from numpy-seeded weights carried across by ``state_dict_from_flax``
(``strict=True``), in float64 on both sides: 1e-9 absolute, as in
``tests/test_torch_seg.py``, whose helpers this file shares. Then the
converter at the superset's full width, and the synthetic images and
class one-hots against the JAX generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_seg import ATOL, as_f64, build_pair, jax_forward, model_inputs, random_tree, x64

from imgadapointr_tpu.datasets.synthetic import SyntheticPCN as JaxSyntheticPCN
from imgadapointr_tpu.models.build import build_model_spec
from imgadapointr_tpu.nn.image_encoders import ResNet18Encoder as JaxResNet18Encoder
from imgadapointr_tpu.utils.config import AttrDict
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch.datasets import SyntheticPCN
from imgadapointr_tpu_torch.main import swap_synthetic
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.models.fusion import image_tokens_width
from imgadapointr_tpu_torch.tools.convert import state_dict_from_flax
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

IMG_MODEL = "ImgResNetEncAdaPoinTrVariableLoss"
SUPERSET_CFG = "cfgs/SegImgPCN_models/ImgEncSegDecAdaPoinTrVariableLoss.yaml"


def test_img_adapointr_and_its_resnet_match_jax():
    cfg, spec, variables, model = build_pair(IMG_MODEL, seed=11)
    inputs = model_inputs(1)
    assert model.inputs == tuple(spec.inputs) == ("partial", "img")
    # the trunk alone: (B, 64, 64, 3) NHWC -> (B, 256, 16) tokens
    with x64():
        v = as_f64({k: variables[k]["im_encoder"] for k in ("params", "batch_stats")})
        want = np.asarray(JaxResNet18Encoder().apply(v, jnp.asarray(inputs["img"])))
    with torch.inference_mode():
        tokens = model.base_model.im_encoder(torch.from_numpy(inputs["img"])).numpy()
    assert tokens.shape == (2, 256, image_tokens_width(64)) == (2, 256, 16)
    np.testing.assert_allclose(tokens, want, rtol=0, atol=ATOL)

    jc, jf = jax_forward(spec, variables, inputs)
    with torch.inference_mode():
        coarse, fine = model(*(torch.from_numpy(inputs[k]) for k in model.inputs))
    np.testing.assert_allclose(coarse.numpy(), jc, rtol=0, atol=ATOL)
    np.testing.assert_allclose(fine.numpy(), jf, rtol=0, atol=ATOL)


def test_converter_loads_the_full_width_superset():
    """The superset at full width (224² images, 2048 points), its tree's
    shapes from ``jax.eval_shape``: strict load, one parameter per flax
    value, and the reference's ``Linear(196, 384)`` image projection."""
    cfg = jax_cfg(SUPERSET_CFG)
    spec = build_model_spec(cfg.model)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: spec.module.init(
        {"params": key, "noise": key, "dropout": key}, jnp.zeros((1, 2048, 3)),
        jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 16)), train=False))
    variables = random_tree(dict(shapes), 2)
    pcfg = cfg_from_yaml_file(SUPERSET_CFG).model
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert tuple(model.base_model.get_better_img_size[0].weight.shape) == (384, 196)
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables["params"]))
    n_port = sum(p.numel() for p in model.parameters()) - 2 * 384  # the unused encoder norm
    assert n_port == n_flax


def test_synthetic_images_and_classes_match_jax_generator():
    conf = {"N_POINTS": 2048, "LENGTH": 20, "WITH_IMG": True, "WITH_CLS": True,
            "others": {"subset": "test"}}
    for i in (0, 17):
        want = JaxSyntheticPCN(AttrDict(conf)).get(i, None)
        got = SyntheticPCN(conf).get(i, None)
        assert got[:2] == want[:2] and sorted(got[2]) == sorted(want[2])
        for k, v in want[2].items():
            np.testing.assert_array_equal(got[2][k], v, err_msg=k)
    assert got[2]["img"].shape == (224, 224, 3) and got[2]["cls_vec"].argmax() == 1


def test_swap_synthetic_gives_each_model_its_inputs():
    """Images for the image models, class one-hots for the segmentation
    models, by name (the JAX package's ``main.py:114-115``)."""
    want = {"ImgEncSegDecAdaPoinTrVariableLoss": (True, True), "SegEncAdaPoinTr": (False, True),
            IMG_MODEL: (True, False), "AdaPoinTr": (False, False)}
    for name, (img, cls) in want.items():
        config = cfg_from_yaml_file("cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml")
        config.model.NAME = name
        swap_synthetic(config, train_len=4)
        for split in ("train", "val", "test"):
            sub = config.dataset[split]
            assert (sub.NAME, sub.WITH_IMG, sub.WITH_CLS) == ("SyntheticPCN", img, cls), (name, split)
        sample = SyntheticPCN(config.dataset.test).get(0, None)[2]
        assert ("img" in sample, "cls_vec" in sample) == (img, cls)
