"""The training path's ops and layers of the port against the JAX package,
on the CPU.

Each port op runs its plain PyTorch version (the tensors lie on the CPU);
the JAX side runs its XLA path or, for the Pallas scatter, the kernel body
in interpret mode (as ``tests/test_pallas_kernels.py`` does). Inputs come
from numpy seeds and go to both sides as numpy arrays. Unless a test says
otherwise both sides run in float64 and agree to 1e-12 (relative to the
largest magnitude compared): the two frameworks sum in different orders.
Selections (indices) must be equal.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imgadapointr_tpu.nn import blocks as jblocks
from imgadapointr_tpu.nn import layers as jlayers
from imgadapointr_tpu.nn import local_attention as jlocal
from imgadapointr_tpu.nn.grouper import DGCNNGrouper as JaxGrouper
from imgadapointr_tpu.ops import chamfer as jchamfer
from imgadapointr_tpu.ops import pointops as jpo
from imgadapointr_tpu.ops.pallas.scatter_rows import scatter_add_rows_pallas
from imgadapointr_tpu.utils import schedulers as jsched
from imgadapointr_tpu.utils.config import cfg_from_yaml_file as jax_cfg
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.nn import blocks, local_attention
from imgadapointr_tpu_torch.nn.grouper import DGCNNGrouper
from imgadapointr_tpu_torch.nn.layers import Attention, BatchNorm
from imgadapointr_tpu_torch.utils import schedulers
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

TOL = 1e-12


@contextlib.contextmanager
def x64(enabled: bool = True):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t.requires_grad_() if grad else t


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max()) / scale


# ------------------------------------------------------------- scatter-add


@pytest.mark.parametrize("B,M,C,S,idx_hi", [
    (1, 1024, 3, 512, 1024),  # mostly unique indices
    (1, 600, 5, 513, 16),  # heavy collisions: about 32 adds per row
    (2, 256, 8, 128, 256),
])
def test_scatter_add_rows_matches_pallas_interpret(B, M, C, S, idx_hi):
    """float32; the one-hot matmul kernel and a sequential scatter sum in
    different orders, so they agree to 1e-6 of the largest row."""
    rng = np.random.RandomState(3)
    vals = rng.randn(B, S, C).astype(np.float32)
    idx = rng.randint(0, idx_hi, (B, S))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_add_rows_pallas(M, jnp.asarray(idx, jnp.int32), jnp.asarray(vals)))
    got = ops.scatter_add_rows(M, _t(idx), _t(vals))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, M, C)
    _close(got, want, 1e-6)


def test_scatter_add_rows_permutation_is_exact():
    """Every row receives one contribution: equal to the TPU kernel, bit
    for bit (``scatter_rows.py:19-22``)."""
    rng = np.random.RandomState(4)
    vals = rng.randn(2, 512, 3).astype(np.float32)
    idx = np.stack([rng.permutation(512) for _ in range(2)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_add_rows_pallas(512, jnp.asarray(idx, jnp.int32), jnp.asarray(vals)))
    got = ops.scatter_add_rows(512, _t(idx), _t(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, idx[0]], vals[0])


@pytest.mark.parametrize("C", [3, 16])
def test_scatter_add_rows_matches_xla_scatter_fp64(C):
    rng = np.random.RandomState(5)
    vals = rng.randn(2, 700, C)
    idx = rng.randint(0, 40, (2, 700))
    with x64():
        want = np.asarray(jchamfer._scatter_add_rows(40, jnp.asarray(idx), jnp.asarray(vals)))
    _close(ops.scatter_add_rows(40, _t(idx), _t(vals)), want)


def test_scatter_add_rows_clamps_and_rejects():
    vals = torch.ones(1, 4, 2)
    out = ops.scatter_add_rows(3, torch.tensor([[-5, 0, 2, 99]]), vals)
    assert out[0, :, 0].tolist() == [2.0, 0.0, 2.0]  # out-of-range lands on the clamped row
    with pytest.raises(TypeError):
        ops.scatter_add_rows(3, torch.zeros(1, 4, dtype=torch.int32), vals)
    with pytest.raises(ValueError):
        ops.scatter_add_rows(3, torch.zeros(1, 5, dtype=torch.int64), vals)
    with pytest.raises(ValueError):
        ops.scatter_add_rows(0, torch.zeros(1, 4, dtype=torch.int64), vals)


def test_gather_rows_gradient_matches_jax():
    """The gather's backward against ``jax.vjp`` of ``index_points``, and,
    with indices past the table's end, against the TPU kernel's own VJP
    (interpret mode, float32 rounding): the cotangent of an out-of-range
    index lands on the clamped (last) row
    (``ops/pallas/gather_rows.py:214-216``), which XLA's plain gather
    gradient would drop."""
    from imgadapointr_tpu.ops.pallas.gather_rows import gather_rows_pallas

    rng = np.random.RandomState(6)
    table = rng.randn(2, 50, 7)
    idx = rng.randint(0, 50, (2, 30, 4))
    weight = rng.randn(2, 30, 4, 7)
    with x64():
        want_out, vjp = jax.vjp(lambda t: jpo.index_points(t, jnp.asarray(idx)), jnp.asarray(table))
        (want_grad,) = vjp(jnp.asarray(weight))
    t = _t(table, grad=True)
    out = ops.index_points(t, _t(idx))
    out.backward(_t(weight))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    _close(t.grad, want_grad)

    flat = idx.reshape(2, -1).copy()
    flat[0, 0], flat[1, 5] = 50 + 3, 10**6
    t32, w32 = table.astype(np.float32), weight.reshape(2, -1, 7).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_out, vjp = jax.vjp(
            lambda tb: gather_rows_pallas(tb, jnp.asarray(flat, jnp.int32)), jnp.asarray(t32))
        (want_grad,) = vjp(jnp.asarray(w32))
    t = _t(t32, grad=True)
    out = ops.gather_rows(t, _t(flat))
    out.backward(_t(w32))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    _close(t.grad, want_grad, 1e-6)
    assert t.grad.dtype == torch.float32 and float(t.grad[1, 49].abs().sum()) > 0


# ----------------------------------------------------------------- chamfer


def _masks(rng, B, N, M):
    w1 = (rng.rand(B, N) > 0.3).astype(np.float64)
    w2 = (rng.rand(B, M) > 0.3).astype(np.float64)
    return w1, w2


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_nn_distance_values_and_gradients_match_jax_vjp(masked):
    rng = np.random.RandomState(8)
    B, N, M = 2, 150, 260
    x, y = rng.randn(B, N, 3), rng.randn(B, M, 3)
    w1, w2 = _masks(rng, B, N, M) if masked else (None, None)
    g1, g2 = rng.randn(B, N), rng.randn(B, M)
    with x64():
        jw = (None, None) if not masked else (jnp.asarray(w1), jnp.asarray(w2))
        (jd1, jd2, ji1, ji2), vjp = jax.vjp(
            lambda a, b: jchamfer.nn_distance(a, b, *jw), jnp.asarray(x), jnp.asarray(y)
        )
        zeros = lambda i: np.zeros(i.shape, jax.dtypes.float0)  # noqa: E731
        jgx, jgy = vjp((jnp.asarray(g1), jnp.asarray(g2), zeros(ji1), zeros(ji2)))
    tx, ty = _t(x, grad=True), _t(y, grad=True)
    tw = (None, None) if not masked else (_t(w1), _t(w2))
    d1, d2, i1, i2 = ops.nn_distance(tx, ty, *tw)
    assert i1.dtype == torch.int64 and not i1.requires_grad and not i2.requires_grad
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    _close(d1, jd1)
    _close(d2, jd2)
    torch.autograd.backward([d1, d2], [_t(g1), _t(g2)])
    _close(tx.grad, jgx)
    _close(ty.grad, jgy)
    if masked:  # an invalid row has distance 0, no gradient of its own, and is no candidate
        assert float(d1.detach()[_t(w1) == 0].abs().max()) == 0.0
        assert not np.isin(i1.numpy()[0], np.nonzero(w2[0] == 0)[0]).any()


def test_nn_distance_skips_the_scatter_of_a_cloud_without_gradient():
    rng = np.random.RandomState(9)
    x, y = _t(rng.randn(1, 20, 3), grad=True), _t(rng.randn(1, 30, 3))
    d1, d2, _, _ = ops.nn_distance(x, y)
    (d1.sum() + d2.sum()).backward()
    assert x.grad is not None and y.grad is None


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("form", ["chamfer_l1", "chamfer_l2", "chamfer_l2_split", "chamfer_l1_pm"])
def test_chamfer_forms_match_jax(form, masked):
    rng = np.random.RandomState(10)
    B, N, M = 2, 120, 200
    x, y = rng.randn(B, N, 3) * 0.3, rng.randn(B, M, 3) * 0.3
    w = _masks(rng, B, N, M) if masked else ()

    def total(out):
        return out[0] + 2.0 * out[1] if isinstance(out, tuple) else out

    with x64():
        jw = tuple(jnp.asarray(a) for a in w)
        want, (jgx, jgy) = jax.value_and_grad(
            lambda a, b: total(getattr(jchamfer, form)(a, b, *jw)), argnums=(0, 1)
        )(jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, grad=True), _t(y, grad=True)
    got = total(getattr(ops, form)(tx, ty, *(_t(a) for a in w)))
    got.backward()
    _close(got, want)
    _close(tx.grad, jgx)
    _close(ty.grad, jgy)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nn_one_direction_matches_jax_diff_form(dtype, masked):
    rng = np.random.RandomState(12)
    B, N, M = 2, 300, 700
    v = rng.randn(B, N + M, 3)
    v = (0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(dtype)  # dense sphere
    x, y = v[:, :N], v[:, N:]
    wy = (rng.rand(B, M) > 0.5).astype(dtype) if masked else None
    with x64(dtype == np.float64):
        _, want = jchamfer._nn_one_direction(
            jnp.asarray(x), jnp.asarray(y), None if wy is None else jnp.asarray(wy),
            tile=256, diff_form=True,
        )
    got = ops.nn_one_direction(_t(x), _t(y), None if wy is None else _t(wy))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not masked:  # the same selection as the bidirectional op's first direction
        np.testing.assert_array_equal(got.numpy(), ops.nn_bidir_argmin(_t(x), _t(y))[0].numpy())


def test_nn_one_direction_single_valid_candidate():
    rng = np.random.RandomState(13)
    x, y = _t(rng.randn(2, 40, 3)), _t(rng.randn(2, 60, 3))
    wy = torch.zeros(2, 60, dtype=torch.float64)
    wy[0, 17] = wy[1, 59] = 1.0
    got = ops.nn_one_direction(x, y, wy)
    assert got[0].eq(17).all() and got[1].eq(59).all()
    assert ops.nn_one_direction(x, y, torch.zeros_like(wy)).eq(0).all()  # no valid y: index 0
    with pytest.raises(ValueError):
        ops.nn_one_direction(x, y, wy[:, :10])


# ------------------------------------------------------------------ layers


def test_batchnorm_train_matches_jax_with_call_time_momentum():
    """Output and running statistics after two train calls with different
    momentum, then an eval call on the updated statistics."""
    rng = np.random.RandomState(14)
    xs = [rng.randn(3, 20, 6) * 2.0 + 1.0, rng.randn(3, 20, 6) * 0.5 - 2.0]
    scale, bias = rng.rand(6) + 0.5, rng.randn(6)
    bn = BatchNorm(6).double().train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    with x64():
        jbn = jlayers.BatchNorm(6)
        variables = {
            "params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)},
        }
        for x, momentum in zip(xs, (0.9, 0.3)):
            want, upd = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                                  momentum=momentum, mutable=["batch_stats"])
            variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
            bn.momentum = momentum
            _close(bn(_t(x)), want)
            _close(bn.running_mean, variables["batch_stats"]["mean"], 1e-10)
            _close(bn.running_var, variables["batch_stats"]["var"], 1e-10)
        want = jbn.apply(variables, jnp.asarray(xs[0]), use_running_average=True)
    assert int(bn.num_batches_tracked) == 2
    _close(bn.eval()(_t(xs[0])), want)
    assert int(bn.num_batches_tracked) == 2  # eval leaves the statistics alone


def test_denoise_mask_and_masked_attention_match_jax():
    want = np.asarray(jblocks.denoise_mask(10, 3))
    got = blocks.denoise_mask(10, 3)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert blocks.denoise_mask(10, 0) is None and jblocks.denoise_mask(10, 0) is None

    rng = np.random.RandomState(15)
    x = rng.randn(2, 10, 12)
    with x64():
        jattn = jlayers.Attention(12, num_heads=3, qkv_bias=True)
        params = jattn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape) * 0.3), params)
        want_out = jattn.apply(params, jnp.asarray(x), mask=jnp.asarray(want))
    attn = Attention(12, num_heads=3, qkv_bias=True).double()
    p = params["params"]
    with torch.no_grad():
        attn.qkv.weight.copy_(_t(np.asarray(p["qkv"]["kernel"]).T))
        attn.qkv.bias.copy_(_t(np.asarray(p["qkv"]["bias"])))
        attn.proj.weight.copy_(_t(np.asarray(p["proj"]["kernel"]).T))
        attn.proj.bias.copy_(_t(np.asarray(p["proj"]["bias"])))
    _close(attn(_t(x), got), want_out)
    # a real query's output does not depend on the denoise tokens
    x2 = x.copy()
    x2[:, -3:] += 1.0
    np.testing.assert_allclose(attn(_t(x2), got)[:, :7].detach().numpy(),
                               attn(_t(x), got)[:, :7].detach().numpy(), rtol=0, atol=1e-13)


def test_two_phase_gather_and_graph_attention_denoise_match_jax():
    rng = np.random.RandomState(16)
    B, N, L, C, k = 2, 40, 6, 8, 5
    pos, feat = rng.randn(B, N, 3), rng.randn(B, N, C)
    with x64():
        (want,) = jlocal._two_phase_knn_gather(k, jnp.asarray(pos), jnp.asarray(pos),
                                               (jnp.asarray(feat),), L)
        jdga = jlocal.DynamicGraphAttention(C, k=k)
        params = jdga.init(jax.random.PRNGKey(0), jnp.asarray(feat), jnp.asarray(pos))
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape) * 0.3), params)
        want_out, (want_gq,) = jax.value_and_grad(
            lambda q: jnp.sum(jnp.sin(jdga.apply(params, q, jnp.asarray(pos), denoise_length=L))),
            argnums=(0,),
        )(jnp.asarray(feat))
    (got,) = local_attention.two_phase_knn_gather(k, _t(pos), _t(pos), (_t(feat),), L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the real queries' neighbours are real tokens only
    real = got[:, : N - L].reshape(B, -1, C)
    assert not any((real[b][:, None] == _t(feat)[b, N - L:][None]).all(-1).any() for b in range(B))

    dga = local_attention.DynamicGraphAttention(C, k=k).double()
    with torch.no_grad():
        dga.knn_map[0].weight.copy_(_t(np.asarray(params["params"]["knn_map"]["kernel"]).T))
        dga.knn_map[0].bias.copy_(_t(np.asarray(params["params"]["knn_map"]["bias"])))
    q = _t(feat, grad=True)
    out = torch.sin(dga(q, _t(pos), denoise_length=L)).sum()
    out.backward()
    _close(out, want_out)
    _close(q.grad, want_gq)
    with pytest.raises(ValueError):
        dga(q, _t(pos), v=q, denoise_length=L)


def test_grouper_train_form_equals_eval_form_and_jax():
    rng = np.random.RandomState(17)
    x = rng.randn(2, 96, 3) * 0.4
    num = (32, 16)
    with x64():
        jg = JaxGrouper(k=16)
        params = jg.init(jax.random.PRNGKey(0), jnp.asarray(x), num)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape) * 0.3), params)
        j_coor, j_feat = jg.apply(params, jnp.asarray(x), num, train=True)
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    g = DGCNNGrouper(k=16).double()
    with torch.no_grad():
        g.input_trans.weight.copy_(_t(p["input_trans"]["kernel"].T[..., None]))
        g.input_trans.bias.copy_(_t(p["input_trans"]["bias"]))
        for i in range(1, 5):
            layer = getattr(g, f"layer{i}")
            layer[0].weight.copy_(_t(p[f"layer{i}_conv"]["kernel"].T[..., None, None]))
            layer[1].weight.copy_(_t(p[f"layer{i}_gn"]["scale"]))
            layer[1].bias.copy_(_t(p[f"layer{i}_gn"]["bias"]))
    coor_t, feat_t = g.train()(_t(x), num)
    coor_e, feat_e = g.eval()(_t(x), num)
    np.testing.assert_array_equal(coor_t.numpy(), coor_e.numpy())
    _close(feat_t, feat_e.detach().numpy(), 1e-13)
    np.testing.assert_array_equal(coor_t.numpy(), np.asarray(j_coor))
    _close(feat_t, j_feat, 1e-10)
    # the train form's layer-1 gather reads the raw cloud: no gradient reaches a gathered table
    feat_t.sum().backward()
    assert g.input_trans.weight.grad is not None


# --------------------------------------------------------------- schedules


@pytest.mark.parametrize("name", ["AdaPoinTr", "AdaPoinTr-tiny"])
def test_schedules_match_jax_over_six_epochs(name):
    path = f"cfgs/PCN_models/{name}.yaml"
    jc, pc = jax_cfg(path), cfg_from_yaml_file(path)
    base_lr = float(pc.optimizer.kwargs.lr)
    with x64():
        j_lr = jsched.build_lr_schedule(base_lr, jc.scheduler, int(jc.max_epoch))
        j_bnm = jsched.build_bnm_schedule(jc.bnmscheduler)
        lr = schedulers.build_lr_schedule(base_lr, pc.scheduler, int(pc.max_epoch))
        bnm = schedulers.build_bnm_schedule(pc.bnmscheduler)
        for e in np.linspace(0.0, 6.0, 25):
            assert isinstance(lr(e), float) and isinstance(bnm(e), float)
            np.testing.assert_allclose(lr(e), float(j_lr(jnp.asarray(e))), rtol=1e-14)
            np.testing.assert_allclose(bnm(e), float(j_bnm(jnp.asarray(e))), rtol=1e-14)
    # far out both reach their floors; with a warm-up the ramp comes first
    assert lr(10_000.0) == base_lr * float(pc.scheduler.kwargs.lowest_decay)
    assert bnm(10_000.0) == 0.01
    np.testing.assert_allclose(
        schedulers.lambda_lr_factor(1.0, 0.9, 21, 0.02, warmingup_e=4),
        float(jsched.lambda_lr_factor(1.0, 0.9, 21, 0.02, warmingup_e=4)), rtol=1e-7)
    assert schedulers.build_bnm_schedule(None)(3.0) == 0.1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        schedulers.build_lr_schedule(1e-3, cfg_from_yaml_file("cfgs/PCN_models/GRNet.yaml").scheduler, 10)
