"""Deformable local attention in the port against the JAX package, on the CPU.

- The 3-NN interpolation: ``three_nn`` and the plain fused version against
  the JAX XLA chain in float64 (1e-9; on the CPU the chain ranks in matmul
  form, the port in diff form, and in float64 near-ties do not separate
  them); against the Pallas kernel in the interpreter in float32 (indices
  equal, weights and outputs within 1e-4, the JAX test's own bound:
  ``tests/test_pallas_kernels.py:110-115``); the Function's gradient in
  ``feats`` against ``jax.grad`` through the fused custom VJP.
- ``OffsetNet`` and each deformable class in each call form (self, cross,
  two-phase denoise) against the flax modules in float64, 1e-9 absolute.
- The tiny deformable AdaPoinTr (``tiny_deform_config``, numpy-seeded
  weights): eval forward and one whole train step against the JAX runner
  in float64 (losses 1e-9
  relative, every gradient 1e-8 of the gradient norm, parameters after the
  step 1e-9 where ``|grad| > 1e-9``, as ``tests/test_torch_train.py``);
  ``linear_offset`` and ``proj_v_off`` get ``grad is None`` in the port and
  an exactly zero gradient in JAX, and neither side moves them.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import imgadapointr_tpu.ops as jops
from imgadapointr_tpu.nn import local_attention as jla
from imgadapointr_tpu.ops import pointops as jpo
from imgadapointr_tpu.ops.pallas.nn_distance import three_nn_interpolate_pallas
from imgadapointr_tpu.tools.builder import build_opt_sched as jax_build_opt_sched
from imgadapointr_tpu.tools.runner import Runner as JaxRunner
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.nn import blocks, local_attention
from imgadapointr_tpu_torch.tools.builder import ZERO_GRAD_PARAM_MARKERS
from imgadapointr_tpu_torch.tools.convert import (
    _mapping,
    _params_from_flax,
    adamw_state_from_optax,
    state_dict_from_flax,
)
from imgadapointr_tpu_torch.tools.runner import Runner
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from parity.param_source import init_variables
from test_torch_seg import one_torch_thread, random_tree  # noqa: F401  (a fixture)

TINY = "cfgs/PCN_models/AdaPoinTr-tiny.yaml"
B, N_IN = 2, 256
STEPS_PER_EPOCH = 4
GRAD_FLOOR = 1e-9
ATOL = 1e-9


def tiny_deform_config(cfg):
    """``cfg`` (the tiny AdaPoinTr, either package's loader) with the
    deformable block lists of ``chip_smoke.deform_config``, cut to the depth
    (3) that holds every deformable token in every call form."""
    enc, dec = cfg.model.encoder_config, cfg.model.decoder_config
    enc.depth, dec.depth = 3, 3
    enc.block_style_list = ["attn-rw_deform", "attn-deform", "attn-deform_graph"]
    dec.self_attn_block_style_list = ["attn-deform", "attn-deform_graph", "attn-rw_deform"]
    dec.cross_attn_block_style_list = ["attn-deform", "attn-deform_graph", "attn"]
    return cfg


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


def _is_zero_grad(name: str) -> bool:
    return any(m in name for m in ZERO_GRAD_PARAM_MARKERS)


# ------------------------------------------------------ 3-NN interpolation


@pytest.mark.parametrize("Bq,S,M,C", [(2, 257, 65, 50), (3, 96, 3, 8), (1, 640, 576, 12)])
def test_three_nn_interpolate_matches_jax_xla_chain_fp64(Bq, S, M, C):
    rng = np.random.RandomState(S + M)
    u, k, f = rng.randn(Bq, S, 3), rng.randn(Bq, M, 3), rng.randn(Bq, M, C)
    with x64():
        jd, ji = jpo.three_nn(jnp.asarray(u), jnp.asarray(k))
        jout = jpo.three_nn_interpolate(jnp.asarray(u), jnp.asarray(k), jnp.asarray(f))
    d, i = ops.three_nn(torch.from_numpy(u), torch.from_numpy(k))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    out = ops.three_nn_interpolate(torch.from_numpy(u), torch.from_numpy(k), torch.from_numpy(f))
    assert out.dtype == torch.float64 and out.shape == (Bq, S, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=ATOL)


@pytest.mark.parametrize("Bq,S,M,C", [(2, 257, 65, 50), (2, 200, 576, 64), (1, 64, 3, 5)])
def test_three_nn_interpolate_matches_pallas_interpreter(Bq, S, M, C):
    rng = np.random.RandomState(1 + S)
    u = rng.randn(Bq, S, 3).astype(np.float32)
    k = rng.randn(Bq, M, 3).astype(np.float32)
    f = rng.randn(Bq, M, C).astype(np.float32)
    got, idx, w = three_nn_interpolate_pallas(jnp.asarray(u), jnp.asarray(k), jnp.asarray(f),
                                              interpret=True)
    out, pi, pw = ops.three_nn_interpolate_plain(torch.from_numpy(u), torch.from_numpy(k),
                                                 torch.from_numpy(f))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(idx))
    np.testing.assert_allclose(pw.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    want = np.asarray(got)
    assert float(np.abs(out.numpy() - want).max() / np.abs(want).max()) < 1e-4
    # the autograd entry is the plain version on the CPU
    assert torch.equal(ops.three_nn_interpolate(torch.from_numpy(u), torch.from_numpy(k),
                                                torch.from_numpy(f)), out)


def test_three_nn_interpolate_feats_gradient_matches_jax_custom_vjp():
    rng = np.random.RandomState(3)
    u = rng.randn(2, 300, 3).astype(np.float32)
    k = rng.randn(2, 70, 3).astype(np.float32)
    f = rng.randn(2, 70, 24).astype(np.float32)

    def loss(feats):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jnp.sin(jpo._three_nn_interpolate_fused(jnp.asarray(u), jnp.asarray(k),
                                                                   feats, 1e-8)))

    want = np.asarray(jax.grad(loss)(jnp.asarray(f)))
    ut, kt = torch.from_numpy(u).requires_grad_(), torch.from_numpy(k).requires_grad_()
    ft = torch.from_numpy(f).requires_grad_()
    torch.sin(ops.three_nn_interpolate(ut, kt, ft)).sum().backward()
    assert ut.grad is None and kt.grad is None  # positions: no gradient
    assert float(np.abs(ft.grad.numpy() - want).max() / np.abs(want).max()) < 1e-5


def test_three_nn_interpolate_edges():
    g = torch.Generator().manual_seed(0)
    known = torch.randn(1, 9, 3, generator=g, dtype=torch.float64)
    feats = torch.randn(1, 9, 4, generator=g, dtype=torch.float64)
    # a query on a known point: distance 0, weight about 1, the row itself
    out, idx, w = ops.three_nn_interpolate_plain(known[:, 4:5], known, feats)
    assert int(idx[0, 0, 0]) == 4 and float(w[0, 0, 0]) > 1 - 1e-6
    torch.testing.assert_close(out[0, 0], feats[0, 4], rtol=0, atol=1e-6)
    # duplicated known points: ties go to the lower index
    dup = torch.cat([known, known], dim=1)
    _, idx, w = ops.three_nn_interpolate_plain(known[:, :3] + 1e-3, dup, torch.cat([feats, feats], 1))
    assert torch.equal(idx, ops.knn_plain(3, dup, known[:, :3] + 1e-3)[1])
    assert torch.equal(idx[0, :, :2], torch.tensor([[0, 9], [1, 10], [2, 11]]))  # copy, then its twin
    torch.testing.assert_close(w.sum(-1), torch.ones(1, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="at least 3"):
        ops.three_nn_interpolate(known[:, :5], known[:, :2], feats[:, :2])
    with pytest.raises(ValueError, match="expected"):
        ops.three_nn_interpolate(known, known, feats[:, :5])


# ------------------------------------------------------ modules, each call form


def _torch_from_flax(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax local-attention tree into the port's module (float64)."""
    sub = {"linear_offset.0": ("linear_offset", "Dense_0"),
           "linear_offset.1": ("linear_offset", "LayerNorm_0"),
           "linear_offset.3": ("linear_offset", "Dense_1"), "knn_map.0": ("knn_map",)}
    sd = {}
    for name in module.state_dict():
        path, leaf = name.rsplit(".", 1)
        node = params
        for key in sub.get(path, tuple(path.split("."))):
            node = node[key]
        if leaf == "weight":
            v = np.asarray(node["kernel"]).T if "kernel" in node else node["scale"]
        else:
            v = node["bias"]
        sd[name] = torch.from_numpy(np.array(v, dtype=np.float64))
    module.double().load_state_dict(sd, strict=True)
    return module


C_MOD, H_MOD, K_MOD, G_MOD, L_MOD = 48, 6, 8, 2, 8


def _module_inputs(seed):
    rng = np.random.RandomState(seed)
    return {"q": rng.randn(2, 40, C_MOD), "q_pos": rng.randn(2, 40, 3) * 0.3,
            "v": rng.randn(2, 24, C_MOD), "v_pos": rng.randn(2, 24, 3) * 0.3}


MODULE_CASES = [  # (token, call form)
    ("rw_deform", "self"), ("rw_deform", "self_idx"),
    ("deform", "self"), ("deform", "cross"), ("deform", "denoise"),
    ("deform_graph", "self"), ("deform_graph", "cross"), ("deform_graph", "denoise"),
]


@pytest.mark.parametrize("token,form", MODULE_CASES)
def test_deformable_module_matches_flax(token, form):
    x = _module_inputs(len(token) + len(form))
    with x64():
        jx = {k: jnp.asarray(v) for k, v in x.items()}
        if token == "rw_deform":
            jmod = jla.DeformableLocalAttention(C_MOD, num_heads=H_MOD, qkv_bias=True, k=K_MOD,
                                                n_group=G_MOD)
        elif token == "deform":
            jmod = jla.DeformableLocalCrossAttention(C_MOD, num_heads=H_MOD, qkv_bias=True, k=K_MOD,
                                                     n_group=G_MOD)
        else:
            jmod = jla.ImprovedDeformableLocalGraphAttention(C_MOD, k=K_MOD)
        idx = np.asarray(jpo.knn_point(K_MOD, jx["q_pos"], jx["q_pos"]))
        if form in ("self", "self_idx"):
            args, kw = (jx["q"], jx["q_pos"]), {"idx": jnp.asarray(idx)} if form == "self_idx" else {}
        elif form == "cross":
            args, kw = (jx["q"], jx["q_pos"]), {"v": jx["v"], "v_pos": jx["v_pos"]}
        else:
            args, kw = (jx["q"], jx["q_pos"]), {"denoise_length": L_MOD}
        params = jmod.init(jax.random.PRNGKey(5), *args, **kw)["params"]
        want = np.asarray(jmod.apply({"params": params}, *args, **kw))
    mod = _torch_from_flax(local_attention.make_local_attn(token, C_MOD, H_MOD, True, K_MOD, G_MOD),
                           _np_tree(params))
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    if form == "self_idx":
        kw = {"idx": torch.from_numpy(np.array(idx, dtype=np.int64))}
    elif form == "cross":
        kw = {"v": tx["v"], "v_pos": tx["v_pos"]}
    elif form == "denoise":
        kw = {"denoise_length": L_MOD}
    else:
        kw = {}
    with torch.no_grad():
        got = mod(tx["q"], tx["q_pos"], **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_offset_net_matches_flax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 3, 2 * C_MOD)
    with x64():
        jmod = jla.OffsetNet(C_MOD)
        params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    net = local_attention.offset_net(2 * C_MOD, C_MOD)
    sub = {"0": "Dense_0", "1": "LayerNorm_0", "3": "Dense_1"}
    sd = {}
    for name in net.state_dict():
        i, leaf = name.split(".")
        node = _np_tree(params)[sub[i]]
        v = (node["kernel"].T if "kernel" in node else node["scale"]) if leaf == "weight" else node["bias"]
        sd[name] = torch.from_numpy(np.array(v, dtype=np.float64))
    net.double().load_state_dict(sd, strict=True)
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 5, 3, 3) and float(np.abs(got).max()) < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_block_styles_parse_like_the_jax_package():
    assert blocks._parse_style("attn-deform_graph") == (True, "deform_graph")
    assert blocks._parse_style("rw_deform") == (False, "rw_deform")
    with pytest.raises(ValueError, match="rw_deform"):
        blocks.CrossAttnBlockApi(48, 6, cross_attn_block_style="attn-rw_deform")
    with pytest.raises(ValueError, match="unexpected"):
        blocks._parse_style("attn-bogus")
    with pytest.raises(NotImplementedError, match="concat"):
        blocks.SelfAttnBlockApi(48, 6, block_style="attn-deform", combine_style="onebyone")
    blk = blocks.CrossAttnBlockApi(48, 6, self_attn_block_style="rw_deform",
                                   cross_attn_block_style="deform_graph", n_group=3)
    assert blk.self_attn is None and blk.self_attn_merge_map is None
    assert blk.local_self_attn.n_group == 3
    assert blk.local_self_attn.linear_offset[0].in_features == 2 * 48 // 3


# ------------------------------------------------ the tiny deformable model


@pytest.fixture(scope="module")
def tiny():
    """(jax config, port config, flax variables as numpy): numpy-seeded
    leaves (``test_torch_seg.random_tree``) of the shapes of the model's
    init (``jax.eval_shape``, which computes no values)."""
    cfg = tiny_deform_config(jax_cfg(TINY))
    shapes = jax.eval_shape(lambda: init_variables(cfg.model, "adapointr", batch=B, n_points=N_IN)[1])
    variables = {k: _np_tree(dict(v)) for k, v in random_tree(dict(shapes), 11).items()}
    return cfg, tiny_deform_config(cfg_from_yaml_file(TINY)), variables


def _port_model(pcfg, variables):
    model = build_model(pcfg.model, device="cpu", dtype=torch.float64)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg.model)
    p64 = _params_from_flax(variables["params"], pcfg.model)  # undo the float32 cast
    sd.update({k: torch.from_numpy(np.array(v, dtype=np.float64)) for k, v in p64.items()})
    model.load_state_dict(sd, strict=True)
    return model


def test_converter_loads_the_deformable_tree_strictly(tiny):
    _, pcfg, variables = tiny
    model = build_model(pcfg.model, device="cpu")
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"], pcfg.model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    keys = [k for k, *_ in _mapping(pcfg.model)]
    enc0 = "base_model.encoder.blocks.blocks.0.local_attn"
    for suffix in ("proj_q.weight", "proj_q.bias", "proj_k.weight", "proj_v.weight", "proj_v_off.bias",
                   "linear_offset.0.weight", "linear_offset.1.weight", "linear_offset.3.weight",
                   "proj.weight"):
        assert f"{enc0}.{suffix}" in keys, suffix
    assert f"{enc0}.linear_offset.3.bias" not in keys
    graph = "base_model.encoder.blocks.blocks.2.local_attn"
    assert f"{graph}.knn_map.0.weight" in keys and f"{graph}.proj_v_off.bias" in keys
    assert f"{graph}.proj_q.weight" not in keys and f"{graph}.proj.weight" not in keys
    cross = "base_model.decoder.blocks.blocks.1.local_cross_attn"
    assert f"{cross}.linear_offset.0.weight" in keys and f"{cross}.knn_map.0.bias" in keys


def test_tiny_deform_eval_forward_matches_jax_fp64(tiny):
    from imgadapointr_tpu.models.build import build_model_spec

    cfg, pcfg, variables = tiny
    x = np.random.RandomState(N_IN).randn(B, N_IN, 3) * 0.3
    with x64():
        spec = build_model_spec(cfg.model)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jc, jf = jax.jit(lambda v, x: spec.module.apply(v, x, train=False))(v64, jnp.asarray(x))
    model = _port_model(pcfg, variables)
    with torch.inference_mode():
        coarse, fine = model(torch.from_numpy(x))
    assert fine.shape == (B, int(pcfg.model.num_points), 3)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(fine.numpy(), np.asarray(jf), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def jax_step(tiny):
    """One JAX train step of the tiny deformable model on fixed inputs, its
    gradients, and the states before and after."""
    cfg, _, variables = tiny
    rng = np.random.RandomState(31)
    batch = {"partial": rng.randn(B, N_IN, 3) * 0.3,
             "gt": rng.randn(B, int(cfg.model.num_points), 3) * 0.3}
    noise = rng.randn(B, 64, 3)
    patch = pytest.MonkeyPatch()
    with x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        runner = JaxRunner(types.SimpleNamespace(tp=1), cfg)
        tx, runner.lr_sched, runner.bnm_sched = jax_build_opt_sched(cfg, STEPS_PER_EPOCH, v64["params"])
        # the optimizer as the runner builds it, its state carrying the
        # gradients the step hands it out of the one jitted step
        runner.tx = optax.GradientTransformation(
            lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
            lambda g, s, p=None: (lambda u, ns: (u, (ns, g)))(*tx.update(g, s[0], p)))
        runner.steps_per_epoch = STEPS_PER_EPOCH
        state = {"params": v64["params"], "batch_stats": v64["batch_stats"],
                 "opt_state": runner.tx.init(v64["params"]), "step": jnp.zeros((), jnp.int32)}
        key = jax.random.PRNGKey(0)
        # the model reads `ops.jitter_points` at trace time: hand it the fixed noise
        patch.setattr(jops, "jitter_points",
                      lambda key, pc, std=0.01, clip=0.05: pc + jnp.clip(std * jnp.asarray(noise), -clip, clip))
        try:
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            new_state, metrics = jax.jit(runner._train_step, static_argnums=3)(state, jb, key, 0.0)
        finally:
            patch.undo()
        grads = new_state["opt_state"][1]
    return {"batch": batch, "noise": noise, "before": _np_tree(state), "after": _np_tree(new_state),
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": _np_tree(grads)}


def test_tiny_deform_train_step_matches_jax_fp64(tiny, jax_step, tmp_path, one_torch_thread):
    _, pcfg, _ = tiny
    runner = Runner(types.SimpleNamespace(device="cpu", seed=0, experiment_path=str(tmp_path)),
                    pcfg, logger="silent")
    runner.model = _port_model(pcfg, {"params": jax_step["before"]["params"],
                                      "batch_stats": jax_step["before"]["batch_stats"]})
    runner.make_train_state(STEPS_PER_EPOCH)
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in jax_step["batch"].items()}
    got = runner.train_step(batch, 0.0, noise=torch.from_numpy(jax_step["noise"]))
    want = jax_step["metrics"]
    for k in ("sparse_loss", "dense_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)

    norm = want["grad_norm"]
    coef = min(10.0 / (norm + 1e-6), 1.0)
    jgrads = _params_from_flax(jax_step["grads"], pcfg.model)
    jparams = _params_from_flax(jax_step["after"]["params"], pcfg.model)
    n_zero_grad = 0
    for name, p in runner.model.named_parameters():
        if _is_zero_grad(name) or "encoder.norm" in name:
            # no gradient: untouched (JAX: an exactly zero gradient, decay masked off)
            assert p.grad is None, name
            assert torch.equal(p, before[name]), name
            if name in jgrads:
                assert float(np.abs(jgrads[name]).max()) == 0.0, name
                np.testing.assert_array_equal(p.detach().numpy(), jparams[name])
            n_zero_grad += "linear_offset" in name or "proj_v_off" in name
            continue
        g, jg = p.grad.numpy(), jgrads[name] * coef
        assert float(np.abs(g - jg).max()) <= 1e-8 * norm, name
        live = np.abs(jg) > GRAD_FLOOR
        diff = np.abs(p.detach().numpy() - jparams[name])
        assert float(diff[live].max(initial=0.0)) <= 1e-9, name
        assert float(diff.max()) <= 2.0 * want["lr"] + 1e-9, name
    # 3 + 3 + 2 deformable modules: 5 offset-net tensors each, and proj_v_off
    # (with its bias: qkv_bias is on, and always for deform_graph)
    assert n_zero_grad == 8 * 7
    # the AdamW moments carried across skip the zero-gradient subtrees
    sd = adamw_state_from_optax(jax_step["grads"], jax_step["grads"], 1, pcfg.model,
                                runner.model, runner.optimizer)
    names = {id(p): n for n, p in runner.model.named_parameters()}
    order = [names[id(p)] for group in runner.optimizer.param_groups for p in group["params"]]
    assert sd["state"] and not any(_is_zero_grad(order[i]) for i in sd["state"])
    assert any("linear_offset" in n for n in order)  # in the groups, but without moments
