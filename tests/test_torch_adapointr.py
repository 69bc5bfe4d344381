"""The port's AdaPoinTr serving path against the JAX package, on the CPU.

Weights come from the JAX package's canonical flax init
(``parity/param_source.init_variables``, query-ranking boost included) and
are carried across with the port's own converter
(``imgadapointr_tpu_torch.tools.convert.state_dict_from_flax``). Both sides
run in float64 (``jax_enable_x64`` / torch float64): on the CPU the JAX path
ranks kNN in matmul form and FPS in float32 matmul form, while the port (and
the TPU and Hopper kernels) rank in diff form; in float64 near-ties do not
separate the two. Coarse and fine must agree to 1e-9 absolute; the FPS
picks (grouper centres), the query ranking (coarse) and the kNN indices
must be equal.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgadapointr_tpu.ops import pointops as jpo
from imgadapointr_tpu.tools.convert_torch import export_adapointr_torch
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.datasets import SyntheticPCN
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.tools import inference
from imgadapointr_tpu_torch.tools.convert import state_dict_from_flax
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from imgadapointr_tpu_torch.utils.metrics import eval_metric_suite
from parity.param_source import init_variables

ATOL = 1e-9
CONFIGS = {  # name: (batch, input points)
    "AdaPoinTr-tiny": (2, 256),
    "AdaPoinTr": (1, 2048),
}


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flax_flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(name, config, flax variables as numpy, port model in float64, x)."""
    name = request.param
    B, N = CONFIGS[name]
    cfg = jax_cfg(f"cfgs/PCN_models/{name}.yaml")
    # jitted: the eager init compiles op by op and costs twice as long
    variables = jax.jit(lambda: init_variables(cfg.model, "adapointr", batch=B, n_points=N)[1])()
    variables = {k: _np_tree(dict(v)) for k, v in variables.items()}
    pcfg = cfg_from_yaml_file(f"cfgs/PCN_models/{name}.yaml")
    model = build_model(pcfg.model, device="cpu", dtype=torch.float64)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg.model)
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(N).randn(B, N, 3) * 0.3
    return name, cfg, variables, model, x


def _jax_apply(cfg, variables, x):
    """Eval forward in float64 under jit, with the module intermediates."""
    from imgadapointr_tpu.models.build import build_model_spec

    spec = build_model_spec(cfg.model)
    v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
    fwd = jax.jit(lambda v, x: spec.module.apply(
        v, x, train=False, capture_intermediates=True, mutable=["intermediates"]
    ))
    return fwd(v64, jnp.asarray(x, jnp.float64))


def test_slice_matches_jax_fp64(pair):
    name, cfg, variables, model, x = pair
    with x64():
        (jc, jf), mods = _jax_apply(cfg, variables, x)
        bm = mods["intermediates"]["base_model"]
        j_coor, j_feat = (np.asarray(a) for a in bm["grouper"]["__call__"][0])
        jc, jf = np.asarray(jc), np.asarray(jf)
        enc_k = int(cfg.model.encoder_config.k)
        j_enc_idx = np.asarray(jpo.knn_point(enc_k, jnp.asarray(j_coor), jnp.asarray(j_coor)))
        j_cross_idx = np.asarray(jpo.knn_point(enc_k, jnp.asarray(j_coor), jnp.asarray(jc)))

    xt = torch.from_numpy(x)
    with torch.inference_mode():
        coor, feat = model.base_model.grouper(xt, model.base_model.center_num)
        coarse, fine = model(xt)
        enc_idx = ops.knn_point(enc_k, coor, coor)
        cross_idx = ops.knn_point(enc_k, coor, coarse)

    B, N = CONFIGS[name]
    nq, n_fine = int(cfg.model.num_query), int(cfg.model.num_points)
    assert coarse.dtype == torch.float64
    assert coarse.shape == (B, nq, 3) and fine.shape == (B, n_fine, 3)
    # FPS picks: the grouper's centres are copies of input points
    np.testing.assert_array_equal(coor.numpy(), j_coor)
    np.testing.assert_allclose(feat.numpy(), j_feat, rtol=0, atol=ATOL)
    # query ranking: the kept queries, in top_k order
    np.testing.assert_allclose(coarse.numpy(), jc, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(enc_idx.numpy(), j_enc_idx)
    np.testing.assert_array_equal(cross_idx.numpy(), j_cross_idx)
    np.testing.assert_allclose(fine.numpy(), jf, rtol=0, atol=ATOL)


def test_converter_matches_export_adapointr_torch(pair):
    name, cfg, variables, model, _ = pair
    got = state_dict_from_flax(variables["params"], variables["batch_stats"], cfg.model)
    want = export_adapointr_torch(variables["params"], variables["batch_stats"], cfg.model)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert sorted(got) == sorted(model.state_dict())
    # every flax leaf is carried across (the count of weights agrees)
    n_flax = sum(np.asarray(v).size for _, v in _flax_flat(variables["params"]))
    n_flax += sum(np.asarray(v).size for _, v in _flax_flat(variables["batch_stats"]))
    enc_dim = int(cfg.model.encoder_config.embed_dim)
    n_port = sum(v.numel() for v in got.values()) - 2 * enc_dim - 1  # dead norm, BN counter
    assert n_port == n_flax


def test_converter_full_config_from_eval_shape():
    """The flagship's tree, shapes from ``jax.eval_shape`` of its init and
    values from a numpy seed: the port's converter equals the JAX export."""
    from imgadapointr_tpu.models.build import build_model_spec

    cfg = jax_cfg("cfgs/PCN_models/AdaPoinTr.yaml")
    spec = build_model_spec(cfg.model)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: spec.module.init(
            {"params": key, "noise": key, "dropout": key},
            jnp.zeros((1, 2048, 3), jnp.float32), train=False,
        )
    )
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), dict(shapes)
    )
    params, stats = tree["params"], tree["batch_stats"]
    got = state_dict_from_flax(params, stats, cfg.model)
    want = export_adapointr_torch(params, stats, cfg.model)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    pcfg = cfg_from_yaml_file("cfgs/PCN_models/AdaPoinTr.yaml")
    model = build_model(pcfg.model, device="cpu")
    model.load_state_dict(got, strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    assert 32e6 < n_params < 33e6, n_params  # the flagship's 32.5 M


def test_synthetic_requests_match_jax_generator():
    from imgadapointr_tpu.datasets.synthetic import SyntheticPCN as JaxSyntheticPCN
    from imgadapointr_tpu.utils.config import AttrDict

    conf = {"N_POINTS": 4096, "LENGTH": 8, "others": {"subset": "test"}}
    for i in (0, 5):
        want = JaxSyntheticPCN(AttrDict(conf)).get(i, None)
        got = SyntheticPCN(conf).get(i, None)
        assert got[:2] == want[:2]
        for k in ("partial", "gt"):
            np.testing.assert_array_equal(got[2][k], want[2][k])


def test_inference_cli_writes_fine_cloud(tmp_path):
    """The serving entry point on the CPU (asked for): reference-layout
    checkpoint in, ``<out>/<name>/fine.npy`` out, equal to the model's
    own answer on the upsampled cloud."""
    cfg = cfg_from_yaml_file("cfgs/PCN_models/AdaPoinTr-tiny.yaml")
    model = build_model(cfg.model, device="cpu", seed=3)
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"base_model": model.state_dict()}, ckpt)
    pc = np.random.RandomState(0).randn(700, 3).astype(np.float32) * 0.3
    np.save(tmp_path / "partial.npy", pc)
    out = tmp_path / "out"
    inference.main([
        "--model_config", "cfgs/PCN_models/AdaPoinTr-tiny.yaml",
        "--model_checkpoint", str(ckpt), "--pc", str(tmp_path / "partial.npy"),
        "--out_pc_root", str(out), "--device", "cpu",
    ])
    fine = np.load(out / "partial" / "fine.npy")
    assert fine.shape == (int(cfg.model.num_points), 3) and np.isfinite(fine).all()
    up = inference.UpSamplePoints({"n_points": 2048})(pc, np.random.default_rng(0))
    with torch.inference_mode():
        _, want = model(torch.from_numpy(up[None]))
    np.testing.assert_array_equal(fine, want[0].numpy())
    f, l1, l2 = eval_metric_suite(torch.from_numpy(fine[None]), torch.from_numpy(fine[None]))
    assert float(f) == 1.0 and float(l1) < 1e-6 and float(l2) == 0.0
