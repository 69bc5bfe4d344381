"""The port's segmentation path against the JAX package, on the CPU.

Covers the weighted gather-sum (plain version against the Pallas kernel in
interpret mode and the XLA chain), the normals, GDANet's pieces (kNN
ranking, GDM, SGCAM, the whole net), the fusion stack, and the eval
forward of ``ImgEncSegDecAdaPoinTrVariableLoss`` (the superset) and
``SegEncAdaPoinTr`` on ``cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml`` with
64x64 images, from weights carried across by ``state_dict_from_flax`` and
loaded with ``strict=True``; then the runner's ``validate`` / ``test`` on
the superset and ``--gdanet_w``.

Weights: every flax leaf is drawn from a numpy seed (shapes from
``jax.eval_shape`` of the model's init): kernels ~ N(0, 1/fan_in), norm
scales ~ 1 + N(0, 0.01), running variances ~ U(0.5, 1.5), the SGCAM
BatchNorm scale ~ N(0, 0.25) (zero at a real init, which would make SGCAM
the identity), other leaves ~ N(0, 0.01). Both sides run in float64
(``jax_enable_x64`` / torch float64); clouds and features must agree to
1e-9 absolute, and the discrete selections (kNN, GDM's sharp and gentle
points, the query ranking) exactly, which the 1e-9 agreement of the
gathered values shows.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgadapointr_tpu.models import fusion as jax_fusion
from imgadapointr_tpu.models import gdanet as jax_gdanet
from imgadapointr_tpu.models.build import build_model_spec
from imgadapointr_tpu.ops import index_points as jax_index_points
from imgadapointr_tpu.ops.normals import estimate_pointcloud_normals as jax_normals
from imgadapointr_tpu.ops.pallas.gather_sum import weighted_gather_sum_pallas
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import main as port_main
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.models import gdanet as port_gdanet
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.tools.convert import state_dict_from_flax
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

TINY = "cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml"
SUPERSET = "ImgEncSegDecAdaPoinTrVariableLoss"
B, N_IN, IMG = 2, 256, 64
ATOL = 1e-9


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def random_tree(shapes, seed: int):
    """A flax variables tree of ``shapes`` with numpy-seeded values (the
    scales of the module docstring), in float32 as the port's state dict
    keeps them."""
    rng = np.random.RandomState(seed)

    def draw(name, shape):
        if name == "kernel":
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("var", "W_bn_var"):
            return rng.uniform(0.5, 1.5, shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name == "W_bn_scale":
            return 0.5 * rng.randn(*shape)
        return 0.1 * rng.randn(*shape)

    def leaf(path, s):
        return draw(path[-1].key, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def model_inputs(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    cls = np.zeros((B, 16))
    cls[0, 3], cls[1, 11] = 1.0, 1.0
    return {"partial": rng.randn(B, N_IN, 3) * 0.3, "img": rng.rand(B, IMG, IMG, 3), "cls_vec": cls}


def build_pair(name: str, seed: int):
    """(jax config, spec, float64 variables, port model in float64) for
    ``name`` on the tiny config, weights carried across by the converter."""
    cfg = jax_cfg(TINY)
    cfg.model.NAME = name
    spec = build_model_spec(cfg.model)
    inputs = model_inputs()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda *i: spec.module.init(
        {"params": key, "noise": key, "dropout": key}, *i, train=False),
        *[jnp.asarray(inputs[k], jnp.float32) for k in spec.inputs])
    variables = random_tree(dict(shapes), seed)
    pcfg = cfg_from_yaml_file(TINY).model
    pcfg.NAME, pcfg.img_size = name, IMG
    model = build_model(pcfg, device="cpu", dtype=torch.float64)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg)
    model.load_state_dict(sd, strict=True)
    return cfg, spec, variables, model


def as_f64(tree):
    """The tree as float64 JAX arrays (call under :func:`x64`): the JAX
    package's BatchNorm takes ``rsqrt`` in the statistics' own type."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def jax_forward(spec, variables, inputs):
    with x64():
        fwd = jax.jit(lambda v, *i: spec.module.apply(v, *i, train=False))
        out = fwd(as_f64(variables), *[jnp.asarray(inputs[k], jnp.float64) for k in spec.inputs])
        return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def superset():
    return build_pair(SUPERSET, seed=5)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test: the test workers share the
    machine's cores, and loops of small tensor ops (a train step at the
    tiny size, the EMD auction) slow down many times over when every
    worker's PyTorch spreads each op over all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------- weighted gather-sum


def _gather_sum_case(seed, B_, S, K, M, C, dyadic=False):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, M, (B_, S, K))
    if dyadic:  # every product and partial sum exact in float32
        w = rng.randint(-8, 9, (B_, S, K)) / 4.0
        f = rng.randint(-16, 17, (B_, M, C)).astype(np.float64)
    else:
        w, f = rng.randn(B_, S, K), rng.randn(B_, M, C)
    return w, idx, f


def _abs_sum(w, idx, f):
    """Σ_m |w · f| per output element: the scale of a sum's rounding."""
    B_, S, K = w.shape
    nbr = np.take_along_axis(f[:, None], idx[..., None].clip(0, f.shape[1] - 1), axis=2)
    return np.abs(w[..., None] * nbr).sum(axis=2)


@pytest.mark.parametrize("shape", [(2, 40, 7, 50, 12), (1, 64, 63, 64, 64), (2, 17, 5, 9, 3)])
def test_weighted_gather_sum_plain_matches_pallas_and_xla(shape):
    """Against the Pallas kernel in interpret mode (float32 by construction,
    so on dyadic inputs whose every partial sum is exact in float32) and
    against the XLA chain of ``gdanet.py:115-116`` in float64, to 1e-12 of
    each element's absolute sum."""
    w, idx, f = _gather_sum_case(1, *shape, dyadic=True)
    got = ops.weighted_gather_sum(torch.from_numpy(w), torch.from_numpy(idx), torch.from_numpy(f)).numpy()
    pallas = np.asarray(weighted_gather_sum_pallas(
        jnp.asarray(w, jnp.float32), jnp.asarray(idx, jnp.int32), jnp.asarray(f, jnp.float32), True))
    assert np.all(np.abs(got - pallas) <= 1e-12 * _abs_sum(w, idx, f))

    w, idx, f = _gather_sum_case(2, *shape)
    got = ops.weighted_gather_sum(torch.from_numpy(w), torch.from_numpy(idx), torch.from_numpy(f)).numpy()
    with x64():
        xla = np.asarray(jnp.sum(jnp.asarray(w)[..., None]
                                 * jax_index_points(jnp.asarray(f), jnp.asarray(idx)), axis=2))
    assert np.all(np.abs(got - xla) <= 1e-12 * _abs_sum(w, idx, f))


def test_weighted_gather_sum_out_of_range_index_contributes_nothing():
    """The Pallas kernel's rule (no column, no weight), which the port
    follows; the XLA route would clamp (ROADMAP Queue 3)."""
    w, idx, f = _gather_sum_case(3, 2, 30, 9, 40, 8, dyadic=True)
    idx[:, :, 0] = -1
    idx[:, :4, 1], idx[:, 4:8, 2] = 40, 10**6
    got = ops.weighted_gather_sum(torch.from_numpy(w), torch.from_numpy(idx), torch.from_numpy(f)).numpy()
    pallas = np.asarray(weighted_gather_sum_pallas(
        jnp.asarray(w, jnp.float32), jnp.asarray(idx, jnp.int32), jnp.asarray(f, jnp.float32), True))
    np.testing.assert_array_equal(got, pallas)
    valid = (idx >= 0) & (idx < 40)
    want = (np.where(valid, w, 0.0)[..., None]
            * np.take_along_axis(f[:, None], idx.clip(0, 39)[..., None], axis=2)).sum(axis=2)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        ops.weighted_gather_sum(torch.from_numpy(w), torch.from_numpy(idx).int(), torch.from_numpy(f))
    with pytest.raises(ValueError):
        ops.weighted_gather_sum(torch.from_numpy(w), torch.from_numpy(idx[:, :5]), torch.from_numpy(f))


# ----------------------------------------------------------------- normals


@pytest.mark.parametrize("kind", ["random", "plane", "duplicates"])
def test_normals_match_jax(kind):
    """Random clouds, a plane (the cross products decide) and a cloud whose
    first 40 points coincide (a zero covariance: the +z fallback)."""
    rng = np.random.RandomState(4)
    pts = rng.randn(2, 96, 3) * 0.3
    if kind == "plane":
        pts[..., 2] = 0.0
    elif kind == "duplicates":
        pts[:, :40] = pts[:, :1]
    got = ops.estimate_pointcloud_normals(torch.from_numpy(pts), 30).numpy()
    with x64():
        want = np.asarray(jax_normals(jnp.asarray(pts), 30))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-12)
    if kind == "duplicates":
        np.testing.assert_array_equal(got[:, :40], np.broadcast_to([0.0, 0.0, 1.0], (2, 40, 3)))
    if kind == "plane":
        np.testing.assert_allclose(np.abs(got[..., 2]), 1.0, atol=1e-12)


# ------------------------------------------------------------------ GDANet


def test_gdm_matches_jax():
    """Feature-space kNN ranking equal, both point sets equal (their
    features to 1e-10), with features scaled so that some but not all
    neighbour distances fall under tau: the gather-sum's weights are
    neither all zero nor all set."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 128, 64) * rng.uniform(0.01, 0.03, (2, 128, 1))
    xt = torch.from_numpy(x)
    idx, p, _ = port_gdanet._knn_desc(xt, 64)
    with x64():
        jidx, _, _ = jax_gdanet._knn_desc(jnp.asarray(x), 64)
        jsharp, jgentle = (np.asarray(a) for a in jax_gdanet.gdm(jnp.asarray(x), M=512))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    near = (torch.sqrt(p.abs()) < 0.2).double().mean()
    assert 0.05 < float(near) < 0.95
    sharp, gentle = port_gdanet.gdm(xt, M=512)
    assert sharp.shape == (2, 128, 64)
    np.testing.assert_allclose(sharp.numpy(), jsharp, rtol=0, atol=1e-10)
    np.testing.assert_allclose(gentle.numpy(), jgentle, rtol=0, atol=1e-10)
    # with M = N both are full orders of the same points, opposite ways
    np.testing.assert_array_equal(np.sort(sharp.numpy(), axis=1), np.sort(gentle.numpy(), axis=1))


def test_sgcam_matches_jax():
    rng = np.random.RandomState(7)
    x, x2 = rng.randn(2, 50, 64), rng.randn(2, 30, 64)
    module = jax_gdanet.SGCAM(64)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((2, 50, 64)),
                                                jnp.zeros((2, 30, 64))))
    v = random_tree(dict(shapes), 8)
    with x64():
        want = np.asarray(module.apply(as_f64(v), jnp.asarray(x), jnp.asarray(x2)))
    port = port_gdanet.SGCAM(64).double()
    p, s = v["params"], v["batch_stats"]
    with torch.no_grad():
        for n in ("g", "theta", "phi"):
            getattr(port, n).weight.copy_(torch.from_numpy(p[n]["kernel"].T))
            getattr(port, n).bias.copy_(torch.from_numpy(p[n]["bias"]))
        port.W[0].weight.copy_(torch.from_numpy(p["W_conv"]["kernel"].T))
        port.W[0].bias.copy_(torch.from_numpy(p["W_conv"]["bias"]))
        bn = port.W[1]
        bn.weight.copy_(torch.from_numpy(p["W_bn_scale"]))
        bn.bias.copy_(torch.from_numpy(p["W_bn_bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["W_bn_mean"]))
        bn.running_var.copy_(torch.from_numpy(s["W_bn_var"]))
    got = port.eval()(torch.from_numpy(x), torch.from_numpy(x2)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(want - x).max() > 0.1  # the attention branch is not the identity


def test_gdanet_matches_jax(superset):
    """The superset's GDANet (converted weights) on a 128-point cloud:
    features and log-probabilities to 1e-9."""
    _, _, variables, model = superset
    rng = np.random.RandomState(9)
    coor = rng.randn(2, 128, 3) * 0.3
    normals = rng.randn(2, 128, 3)
    cls = model_inputs()["cls_vec"]
    with x64():
        v = as_f64({k: variables[k]["segmentator"] for k in ("params", "batch_stats")})
        jfeat, jlogp = (np.asarray(a) for a in jax.jit(
            lambda v, *i: jax_gdanet.GDANet(50).apply(v, *i))(v, coor, normals, cls))
    gdanet = model.base_model.segmentator
    model.train()  # GDANet is frozen: it stays in eval mode
    assert not gdanet.training and not gdanet.bn1.training
    model.eval()
    with torch.inference_mode():
        feat, logp = gdanet(*(torch.from_numpy(a) for a in (coor, normals, cls)))
    assert feat.shape == (2, 128, 128) and logp.shape == (2, 128, 50)
    np.testing.assert_allclose(feat.numpy(), jfeat, rtol=0, atol=ATOL)
    np.testing.assert_allclose(logp.numpy(), jlogp, rtol=0, atol=ATOL)


def test_seg_fusion_matches_jax(superset):
    """The shared segmentation fusion stack (converted weights)."""
    _, _, variables, model = superset
    rng = np.random.RandomState(10)
    x, feat = rng.randn(2, 40, 192), rng.randn(2, 40, 128)
    p = variables["params"]["core"]["base_model"]["seg_fusion"]
    with x64():
        want = np.asarray(jax_fusion.SegFusion(192).apply(
            {"params": as_f64(p)}, jnp.asarray(x), jnp.asarray(feat)))
    with torch.inference_mode():
        got = model.base_model.seg_fusion(torch.from_numpy(x), torch.from_numpy(feat)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -------------------------------------------------------------- the models


@pytest.mark.parametrize("name", [SUPERSET, "SegEncAdaPoinTr"])
def test_eval_forward_matches_jax(name, superset):
    cfg, spec, variables, model = superset if name == SUPERSET else build_pair(name, seed=6)
    inputs = model_inputs()
    assert model.inputs == tuple(spec.inputs)
    jc, jf = jax_forward(spec, variables, inputs)
    with torch.inference_mode():
        coarse, fine = model(*(torch.from_numpy(inputs[k]) for k in model.inputs))
    nq, n_fine = int(cfg.model.num_query), int(cfg.model.num_points)
    assert coarse.shape == (B, nq, 3) and fine.shape == (B, n_fine, 3)
    np.testing.assert_allclose(coarse.numpy(), jc, rtol=0, atol=ATOL)
    np.testing.assert_allclose(fine.numpy(), jf, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", [SUPERSET, "SegEncAdaPoinTr", "ImgResNetEncAdaPoinTrVariableLoss"])
def test_state_dict_from_flax_carries_every_leaf(name):
    """Every flax leaf reaches the port's state dict, which loads with
    ``strict=True`` (shapes from ``jax.eval_shape``; no values computed)."""
    cfg = jax_cfg(TINY)
    cfg.model.NAME = name
    spec = build_model_spec(cfg.model)
    inputs = model_inputs()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda *i: spec.module.init(
        {"params": key, "noise": key, "dropout": key}, *i, train=False),
        *[jnp.asarray(inputs[k], jnp.float32) for k in spec.inputs])
    variables = random_tree(dict(shapes), 1)
    pcfg = cfg_from_yaml_file(TINY).model
    pcfg.NAME, pcfg.img_size = name, IMG
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables))
    dim = int(pcfg.encoder_config.embed_dim)
    counters = sum(1 for k in sd if k.endswith("num_batches_tracked"))
    assert sum(v.numel() for v in sd.values()) - 2 * dim - counters == n_flax


# ------------------------------------------------------------- the runner


def test_runner_validates_and_tests_the_superset_on_the_cpu(tmp_path, monkeypatch, capfd, one_torch_thread):
    """validate through the Runner; one ``train_step`` of the superset
    (finite losses, GDANet untouched and without a gradient, every other
    trainable parameter moved); ``test_net`` (the PCN protocol at batch
    size 1 on synthetic images and class one-hots) from a checkpoint, with
    ``--gdanet_w``."""
    import pathlib
    import types

    (tmp_path / "cfgs").symlink_to(pathlib.Path(__file__).resolve().parent.parent / "cfgs")
    monkeypatch.chdir(tmp_path)
    config = cfg_from_yaml_file(TINY)
    port_main.swap_synthetic(config, train_len=2)
    for split in ("train", "val", "test"):
        config.dataset[split].LENGTH = 2
        config.dataset[split].others.bs = 1
    assert config.dataset.val.WITH_IMG and config.dataset.val.WITH_CLS
    args = types.SimpleNamespace(device="cpu", seed=0, num_workers=0, experiment_path=str(tmp_path))
    runner = port_runner.Runner(args, config, logger="silent")
    _, val_loader = port_runner.dataset_builder(args, config.dataset.val)
    metrics = port_runner.validate(runner, val_loader, 0, "silent")
    assert all(np.isfinite(v) for v in metrics.state_dict().values())

    runner.make_train_state(1)
    batch = next(iter(port_runner.dataset_builder(args, config.dataset.train)[1]))[2]
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    out = runner.train_step(batch, 0.0)
    assert all(np.isfinite(float(v)) for v in out.values()) and float(out["total_loss"]) > 0
    for name, p in runner.model.named_parameters():
        if "segmentator" in name:
            assert p.grad is None and not p.requires_grad and torch.equal(p, before[name]), name
        elif p.grad is not None:
            assert not torch.equal(p, before[name]), name

    torch.save({"base_model": runner.model.state_dict()}, tmp_path / "superset.pth")
    torch.save(runner.model.base_model.segmentator.state_dict(), tmp_path / "gdanet.pth")
    args = types.SimpleNamespace(device="cpu", seed=1, num_workers=0, experiment_path=str(tmp_path),
                                 ckpts=str(tmp_path / "superset.pth"),
                                 gdanet_w=str(tmp_path / "gdanet.pth"), emd=False)
    scores = port_runner.test_net(args, config)
    log = capfd.readouterr().out
    assert "GDANet weights loaded" in log and "TEST RESULTS" in log
    assert 0.0 <= scores["F-Score"] <= 1.0 and scores["CDL1"] > 0 and scores["EMDistance"] == 0.0


def test_gdanet_w_loads_a_reference_checkpoint(tmp_path):
    """A reference-layout GDANet checkpoint (Conv weights with trailing
    1-dims, the BatchNorms also under ``convN.1``) fills the segmentator;
    a file with nothing of GDANet raises."""
    pcfg = cfg_from_yaml_file(TINY).model
    pcfg.NAME = "SegEncAdaPoinTr"
    donor = build_model(pcfg, device="cpu", seed=3).base_model.segmentator
    ref = {}
    for k, v in donor.state_dict().items():
        if k.endswith(".weight") and v.dim() == 2:
            v = v[..., None, None] if k.startswith("conv1.") else v[..., None]
        ref[k] = v.clone()
    ref["conv1.1.weight"] = ref["bn1.weight"].clone()
    torch.save(ref, tmp_path / "gdanet.pth")
    model = build_model(pcfg, device="cpu", seed=4)
    port_runner.load_gdanet(model, str(tmp_path / "gdanet.pth"))
    for k, v in donor.state_dict().items():
        assert torch.equal(model.base_model.segmentator.state_dict()[k], v), k
    torch.save({"something.else": torch.zeros(3)}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="no GDANet weights"):
        port_runner.load_gdanet(model, str(tmp_path / "other.pth"))


def test_runner_loads_a_reference_layout_superset_checkpoint(tmp_path):
    """A reference checkpoint of the superset: GDANet's pointwise weights
    with the reference's trailing 1-dims and its BatchNorms also under
    ``convN.1``; ``Runner.load_weights`` fits those and loads strictly."""
    import types

    pcfg = cfg_from_yaml_file(TINY)
    donor = build_model(pcfg.model, device="cpu", seed=3)
    ref = {}
    for k, v in donor.state_dict().items():
        if k.startswith("base_model.segmentator.conv") and k.endswith(".0.weight"):
            v = v[..., None, None] if ".conv1." in k else v[..., None]
        ref[k] = v.clone()
    ref["base_model.segmentator.conv1.1.weight"] = ref["base_model.segmentator.bn1.weight"].clone()
    torch.save({"base_model": ref}, tmp_path / "ref.pth")
    runner = port_runner.Runner(types.SimpleNamespace(device="cpu", seed=4), pcfg, logger="silent")
    runner.load_weights(str(tmp_path / "ref.pth"))
    for k, v in donor.state_dict().items():
        assert torch.equal(runner.model.state_dict()[k], v), k
