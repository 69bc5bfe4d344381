"""The opt-in matmul-form eval chamfer and the exact F-score, on the CPU.

- ``nn_argmin_bidir_mxu_plain`` against the JAX package's Pallas kernel
  ``nn_argmin_bidir_mxu`` in the interpreter. XLA:CPU may contract the
  interpreter's sums into multiply-adds, so the two are not held to the
  same bits: at least 99.9 % of the indices equal, every selected distance
  within the JAX test's band of the exact minimum (sqrt-abs < 2e-3,
  ``tests/test_pallas_kernels.py:145``), and CD-L1 and CD-L2 x1000
  recomputed from the indices within 1e-3 of the exact path's (the gate of
  ``benchmarks/kernels.py:180-197``).
- The gate: false on the CPU, flag or not, as the JAX gate is off the TPU.
- ``f_score`` with and without masks against the JAX one; the runner's
  test step takes the F-score from the exact pass, with the gate on
  (``mxu_eval_chamfer_active`` patched) or off.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imgadapointr_tpu.ops.pallas.nn_distance import nn_argmin_bidir_mxu as jax_mxu
from imgadapointr_tpu.utils import metrics as jmetrics
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.ops import chamfer
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.utils import metrics
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

FLAG = "IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER"


@contextlib.contextmanager
def x64(on: bool = True):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _sphere(rng, b, n):
    v = rng.randn(b, n, 3)
    return 0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)


def _selected(q, r, idx):
    """float64 squared distances of q to r at idx."""
    return ((q - np.take_along_axis(r, idx[..., None], axis=1)) ** 2).sum(-1)


@pytest.mark.parametrize("kind,N,M", [("sphere", 300, 420), ("sphere", 1024, 1100), ("random", 257, 1500)])
def test_mxu_plain_agrees_with_the_pallas_interpreter(kind, N, M):
    rng = np.random.RandomState(N + M)
    if kind == "sphere":
        x, y = _sphere(rng, 2, N), _sphere(rng, 2, M)
    else:
        x, y = rng.randn(2, N, 3), rng.randn(2, M, 3)
    x, y = x.astype(np.float32), y.astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j1, j2 = (np.asarray(a) for a in jax_mxu(jnp.asarray(x), jnp.asarray(y)))
    i1, i2 = (a.numpy() for a in ops.nn_argmin_bidir_mxu(torch.from_numpy(x), torch.from_numpy(y)))
    assert i1.dtype == np.int64 and i1.shape == (2, N) and i2.shape == (2, M)
    assert (i1 == j1).mean() >= 0.999 and (i2 == j2).mean() >= 0.999
    x64_, y64 = x.astype(np.float64), y.astype(np.float64)
    e1, e2 = (a.numpy() for a in ops.nn_bidir_argmin(torch.from_numpy(x64_), torch.from_numpy(y64)))
    d1, d2 = _selected(x64_, y64, i1), _selected(y64, x64_, i2)
    t1, t2 = _selected(x64_, y64, e1), _selected(y64, x64_, e2)
    assert max(np.abs(np.sqrt(d1) - np.sqrt(t1)).max(), np.abs(np.sqrt(d2) - np.sqrt(t2)).max()) < 2e-3
    cd_l1 = lambda a, b: (np.sqrt(a).mean() + np.sqrt(b).mean()) / 2 * 1000  # noqa: E731
    cd_l2 = lambda a, b: (a.mean() + b.mean()) * 1000  # noqa: E731
    assert abs(cd_l1(d1, d2) - cd_l1(t1, t2)) < 1e-3
    assert abs(cd_l2(d1, d2) - cd_l2(t1, t2)) < 1e-3


def test_mxu_plain_identical_clouds_and_first_index_ties():
    x = torch.from_numpy(_sphere(np.random.RandomState(0), 2, 500).astype(np.float32))
    i1, i2 = ops.nn_argmin_bidir_mxu(x, x.clone())
    ident = torch.arange(500).expand(2, -1)
    assert float((i1 == ident).float().mean()) >= 0.999 and float((i2 == ident).float().mean()) >= 0.999
    dup = torch.cat([x, x], dim=1)  # every point twice: the first copy wins
    j1, _ = ops.nn_argmin_bidir_mxu(x, dup)
    assert bool((j1 < 500).all())


def test_the_gate_is_off_on_the_cpu(monkeypatch):
    monkeypatch.setenv(FLAG, "1")
    assert not ops.mxu_eval_chamfer_active(16384, 16384, "cpu")
    assert ops.mxu_eval_chamfer_active(16384, 16384, "cuda")
    assert ops.mxu_eval_chamfer_active(2048, 2048, torch.device("cuda", 0))
    assert not ops.mxu_eval_chamfer_active(2048, 2047, "cuda")  # under 2**22 pairs
    assert not ops.mxu_eval_chamfer_active(1 << 19, 16, "cuda")  # over 2**18 points
    for off in ("0", "false", "", "Off"):
        monkeypatch.setenv(FLAG, off)
        assert not ops.mxu_eval_chamfer_active(16384, 16384, "cuda")
    monkeypatch.delenv(FLAG)
    assert not ops.mxu_eval_chamfer_active(16384, 16384, "cuda")
    # on the CPU the eval entry is the exact path, flag or not
    monkeypatch.setenv(FLAG, "1")
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(1, 2048, 3, generator=g), torch.randn(1, 2048, 3, generator=g)
    for a, b in zip(ops.nn_distance_eval(x, y), ops.nn_distance(x, y)):
        assert torch.equal(a, b)


def test_eval_entry_recomputes_distances_exactly_under_the_gate(monkeypatch):
    monkeypatch.setattr(chamfer, "mxu_eval_chamfer_active", lambda n, m, device: True)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(_sphere(rng, 2, 700).astype(np.float32))
    y = torch.from_numpy(_sphere(rng, 2, 900).astype(np.float32))
    d1, d2, i1, i2 = ops.nn_distance_eval(x, y)
    m1, m2 = ops.nn_argmin_bidir_mxu(x, y)
    assert torch.equal(i1, m1) and torch.equal(i2, m2)
    assert torch.equal(d1, ops.pointops.sqdist(x - ops.index_points(y, i1)))
    e1, e2, _, _ = ops.nn_distance(x, y)
    assert float((d1 - e1).abs().max()) < 1e-5 and bool((d1 >= e1).all())
    assert float((d2 - e2).abs().max()) < 1e-5 and bool((d2 >= e2).all())


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_f_score_matches_jax(masked, dtype):
    rng = np.random.RandomState(9)
    gt = _sphere(rng, 2, 600).astype(dtype)
    pred = (gt[:, :500] + 0.006 * rng.randn(2, 500, 3)).astype(dtype)
    pred[:, -40:] = 0.0  # zero-padded rows
    gt[0, -25:] = 0.0
    with x64(dtype == np.float64):
        jp, jg = jnp.asarray(pred), jnp.asarray(gt)
        jw = (jmetrics._nonzero_mask(jp), jmetrics._nonzero_mask(jg)) if masked else (None, None)
        want = np.asarray(jmetrics.f_score(jp, jg, w_pred=jw[0], w_gt=jw[1], reduce=False))
        want_mean = float(jmetrics.f_score(jp, jg, w_pred=jw[0], w_gt=jw[1]))
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    w = (metrics._nonzero_mask(tp), metrics._nonzero_mask(tg)) if masked else (None, None)
    got = metrics.f_score(tp, tg, w_pred=w[0], w_gt=w[1], reduce=False)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(metrics.f_score(tp, tg, w_pred=w[0], w_gt=w[1])), want_mean, rtol=1e-6)


def test_f_score_never_takes_the_opt_in_selection(monkeypatch):
    calls = []

    def spy(*a):
        calls.append(a)
        return ops.nn_argmin_bidir_mxu_plain(*a)

    monkeypatch.setattr(chamfer, "mxu_eval_chamfer_active", lambda n, m, device: True)
    monkeypatch.setattr(chamfer, "nn_argmin_bidir_mxu", spy)
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(2, 300, 3, generator=g), torch.randn(2, 310, 3, generator=g)
    metrics.f_score(x, y)
    assert not calls
    metrics.eval_metric_suite(x, y)
    assert len(calls) == 1


@pytest.mark.parametrize("gate", [False, True], ids=["exact", "mxu"])
def test_test_step_recomputes_f_exactly_under_the_gate(monkeypatch, gate, one_torch_thread):
    monkeypatch.setattr(chamfer, "mxu_eval_chamfer_active", lambda n, m, device: gate)
    exact_calls = []
    f_score = metrics.f_score

    def spy(*a, **kw):
        exact_calls.append(kw)
        return f_score(*a, **kw)

    monkeypatch.setattr(metrics, "f_score", spy)
    cfg = cfg_from_yaml_file("cfgs/PCN_models/AdaPoinTr-tiny.yaml")
    runner = port_runner.Runner(types.SimpleNamespace(device="cpu", seed=0), cfg, logger="silent")
    rng = np.random.RandomState(2)
    batch = {"partial": (rng.randn(2, 256, 3) * 0.3).astype(np.float32),
             "gt": (rng.randn(2, int(cfg.model.num_points), 3) * 0.3).astype(np.float32)}
    rows = runner.test_step(batch, require_emd=False)
    assert rows.shape == (2, 9)
    assert len(exact_calls) == 1
    with torch.inference_mode():
        _, dense = runner.model(torch.from_numpy(batch["partial"]))
    exact = f_score(dense, torch.from_numpy(batch["gt"]), reduce=False).double().numpy()
    # each row's F is that sample's exact one, whatever the suite's selection
    np.testing.assert_allclose(rows[:, 5], exact, rtol=1e-6)
    if not gate:  # and the exact suite's F is the same number
        np.testing.assert_allclose(rows[:, 5], rows[:, 4], rtol=1e-6)
