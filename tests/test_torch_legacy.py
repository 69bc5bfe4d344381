"""The standalone modules of the options slice in the port against the
JAX package, on the CPU, in float64.

- The seven legacy blocks (``nn/legacy_blocks.py``) at dim 48, 6 heads, 40
  tokens (the decoder blocks over 24 memory tokens): the output and the
  gradient of ``sum(sin(out))`` in the tokens (and the memory), 1e-9
  absolute; two of them with LayerScale.
- ``ImprovedDeformableLocalCrossAttention`` at ``n_group`` 2 as self- and
  cross-attention: the output and its VJP in the queries and the values
  (which reaches the values through the 3-NN interpolation's backward),
  1e-9 absolute.
- ``ResNet50Encoder`` (the whole trunk, 2 x 64 x 64 images: at 32 x 32 the
  last stage's train-mode BatchNorms see two values a channel, whose
  normalisation amplifies float64 rounding, either form of the variance,
  to 1e-4) and a narrowed
  ``ConvNextEncoder`` (depths (1, 1, 2, 1), widths (8, 16, 24, 32), 2 x 38 x
  38 images, so that flax's 'SAME' padding of the strided convolutions is
  uneven at three of the four), in eval mode and ResNet50 in train mode
  (batch statistics), 1e-9 relative to the output's scale.
- Each module's weights are a numpy-seeded flax tree (shapes from the
  init's ``jax.eval_shape``) carried across by
  ``tools.convert.module_state_from_flax`` and loaded strictly.
- The GDANet remat lever (``IMGADAPOINTR_ENABLE_SEG_REMAT``) on the tiny
  superset in float32: the same loss bit for bit, every gradient within
  1e-6 of its largest entry, GDANet run twice (the replay) instead of once.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgadapointr_tpu.nn import image_encoders as jie
from imgadapointr_tpu.nn import legacy_blocks as jlb
from imgadapointr_tpu.nn import local_attention as jla
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.models import gdanet as port_gdanet
from imgadapointr_tpu_torch.nn import image_encoders, legacy_blocks, local_attention
from imgadapointr_tpu_torch.tools.convert import module_state_from_flax
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from test_torch_seg import one_torch_thread, random_tree  # noqa: F401  (a fixture)

DIM, HEADS, N, M = 48, 6, 40, 24
ATOL = 1e-9


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(tree))


def _flax_variables(jmod, args, seed: int) -> dict:
    """numpy-seeded variables of ``jmod`` (float64), shapes from its init."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    return _np_tree({k: dict(v) for k, v in random_tree(dict(shapes), seed).items()})


def _port(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    sd = module_state_from_flax(module, variables["params"], variables.get("batch_stats"), torch.float64)
    assert set(sd) == set(module.state_dict())
    module.double().load_state_dict(sd, strict=True)
    return module


def _inputs(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"q": rng.randn(2, N, DIM), "q_pos": rng.randn(2, N, 3) * 0.3,
            "v": rng.randn(2, M, DIM), "v_pos": rng.randn(2, M, 3) * 0.3}


ENCODER_BLOCKS = ["Block", "RegionWiseBlock", "DeformableAttnBlock", "GraphConvBlock"]
DECODER_BLOCKS = ["DecoderBlock", "DeformableAttnDecoderBlock", "GraphConvDecoderBlock"]


@pytest.mark.parametrize("name", ENCODER_BLOCKS + DECODER_BLOCKS)
def test_legacy_block_matches_flax_fp64(name):
    x = _inputs(len(name))
    decoder = name in DECODER_BLOCKS
    ls = 1e-5 if name in ("Block", "DeformableAttnDecoderBlock") else None
    kw = {} if name == "GraphConvBlock" else {"num_heads": HEADS, "qkv_bias": True}
    jmod = getattr(jlb, name)(DIM, init_values=ls, **kw)
    names = ("q", "v") if decoder else ("q",)
    pos = (x["q_pos"], x["v_pos"]) if decoder else (x["q_pos"],)
    with x64():
        args = tuple(jnp.asarray(x[n]) for n in names)
        jpos = tuple(jnp.asarray(p) for p in pos)
        variables = _flax_variables(jmod, args[:1] + args[1:] + jpos, 3)

        def loss(*feats):
            out = jmod.apply(variables, *feats, *jpos)
            return jnp.sum(jnp.sin(out)), out

        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    mod = _port(getattr(legacy_blocks, name)(DIM, init_values=ls, **kw), variables)
    assert (getattr(mod, "ls_attn", None) or getattr(mod, "ls_self", None)) is not None or ls is None
    feats = [torch.from_numpy(x[n]).requires_grad_() for n in names]
    out = mod(*feats, *(torch.from_numpy(p) for p in pos))
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for f, jg in zip(feats, jgrads):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(jg), rtol=0, atol=ATOL)


@pytest.mark.parametrize("form", ["self", "cross"])
def test_improved_deformable_cross_attention_matches_flax_fp64(form):
    x = _inputs(7)
    jmod = jla.ImprovedDeformableLocalCrossAttention(DIM, num_heads=HEADS, qkv_bias=True, k=8, n_group=2)
    with x64():
        q, q_pos = jnp.asarray(x["q"]), jnp.asarray(x["q_pos"])
        if form == "cross":
            v_pos = jnp.asarray(x["v_pos"])
            variables = _flax_variables(jmod, (q, q_pos, jnp.asarray(x["v"]), v_pos), 5)

            def loss(q, v):
                out = jmod.apply(variables, q, q_pos, v=v, v_pos=v_pos)
                return jnp.sum(jnp.sin(out)), out

            args = (q, jnp.asarray(x["v"]))
        else:
            variables = _flax_variables(jmod, (q, q_pos), 5)

            def loss(q):
                out = jmod.apply(variables, q, q_pos)
                return jnp.sum(jnp.sin(out)), out

            args = (q,)
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    mod = _port(local_attention.ImprovedDeformableLocalCrossAttention(DIM, HEADS, True, k=8, n_group=2),
                variables)
    qt = torch.from_numpy(x["q"]).requires_grad_()
    if form == "cross":
        vt = torch.from_numpy(x["v"]).requires_grad_()
        out, feats = mod(qt, torch.from_numpy(x["q_pos"]), v=vt, v_pos=torch.from_numpy(x["v_pos"])), [qt, vt]
    else:
        out, feats = mod(qt, torch.from_numpy(x["q_pos"])), [qt]
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for f, jg in zip(feats, jgrads):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(jg), rtol=0, atol=ATOL)
    # the shifted positions are detached: the offset net gets no gradient, as in JAX
    assert mod.linear_offset[0].weight.grad is None and mod.proj_v_off.weight.grad is None


def _image_check(jmod, mod, img, train: bool):
    with x64():
        jimg = jnp.asarray(img)
        variables = _flax_variables(jmod, (jimg,), 9)
        if train:
            want, _ = jax.jit(lambda v, i: jmod.apply(v, i, train=True, mutable=["batch_stats"]))(variables, jimg)
        else:
            want = jax.jit(lambda v, i: jmod.apply(v, i))(variables, jimg)
    mod = _port(mod, variables).train(train)
    with torch.no_grad():
        got = mod(torch.from_numpy(img))
    assert got.shape == want.shape
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9 * float(np.abs(want).max()))


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_matches_flax_fp64(train, one_torch_thread):
    img = np.random.RandomState(4).rand(2, 64, 64, 3)
    _image_check(jie.ResNet50Encoder(), image_encoders.ResNet50Encoder(), img, train)


def test_convnext_matches_flax_fp64():
    img = np.random.RandomState(6).rand(2, 38, 38, 3)
    depths, dims = (1, 1, 2, 1), (8, 16, 24, 32)
    _image_check(jie.ConvNextEncoder(depths=depths, dims=dims),
                 image_encoders.ConvNextEncoder(depths, dims), img, False)
    # 'SAME' pads unevenly where the size does not divide by the stride
    x = torch.zeros(1, 1, 5, 38)
    assert image_encoders.same_pad(x, 2, 2).shape == (1, 1, 6, 38)
    assert image_encoders.same_pad(x, 4, 4).shape == (1, 1, 8, 40)


# ------------------------------------------------------------ the remat lever


def test_seg_remat_gives_the_same_step(monkeypatch, one_torch_thread):
    cfg = cfg_from_yaml_file("cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml").model
    cfg.img_size = 64
    model = build_model(cfg, device="cpu", seed=3)
    rng = np.random.RandomState(8)
    cls = np.zeros((2, 16), np.float32)
    cls[0, 3] = cls[1, 11] = 1.0
    inputs = [torch.from_numpy((rng.randn(2, 256, 3) * 0.3).astype(np.float32)),
              torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32)), torch.from_numpy(cls)]
    gt = torch.from_numpy((rng.randn(2, int(cfg.num_points), 3) * 0.3).astype(np.float32))
    noise = torch.from_numpy(rng.randn(2, 64, 3).astype(np.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    calls = []
    forward = port_gdanet.GDANet.forward
    monkeypatch.setattr(port_gdanet.GDANet, "forward", lambda self, *a, **k: calls.append(1) or forward(self, *a, **k))
    runs = []
    for remat in ("0", "1"):
        monkeypatch.setenv("IMGADAPOINTR_ENABLE_SEG_REMAT", remat)
        model.load_state_dict(state)
        model.train().zero_grad(set_to_none=True)
        calls.clear()
        loss = sum(model.loss(model(*inputs, noise=noise), gt, 0.0))
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
                     len(calls)))
    (l0, g0, c0), (l1, g1, c1) = runs
    assert (c0, c1) == (1, 2)  # the replay runs GDANet's forward again
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and not any("segmentator" in n for n in g0)
    for n in g0:
        assert float((g0[n] - g1[n]).abs().max()) <= 1e-6 * float(g0[n].abs().max()), n
