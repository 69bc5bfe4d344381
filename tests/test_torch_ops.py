"""The port's geometry ops and metrics against the JAX package, on the CPU.

Each port op here runs its plain PyTorch version (the tensors lie on the
CPU); the JAX side runs its XLA path or, for the Pallas kernels, the
kernel body in interpret mode (as ``tests/test_pallas_kernels.py`` does).
Inputs come from numpy seeds and go to both sides as numpy arrays.
Selections (indices) must be equal; values agree to 1e-6 relative in
float32 and 1e-12 in float64 (the two sides sum in different orders).
"""

import ast
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imgadapointr_tpu.ops import chamfer as jchamfer
from imgadapointr_tpu.ops import pointops as jpo
from imgadapointr_tpu.ops.pallas.fps import furthest_point_sample_pallas
from imgadapointr_tpu.ops.pallas.gather_rows import gather_rows_pallas
from imgadapointr_tpu.ops.pallas.nn_distance import knn_pallas, nn_argmin_bidir_exact
from imgadapointr_tpu.utils import metrics as jmetrics
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.utils import metrics
from imgadapointr_tpu_torch.utils.device import resolve_device

RTOL = {np.float32: 1e-6, np.float64: 1e-12}
REPO = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def x64(enabled: bool):
    """Run the JAX side in float64 for the duration (restored after)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sphere(rng, b, n):
    v = rng.randn(b, n, 3)
    return 0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)


# --------------------------------------------------------------------- kNN


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k,S,M", [(16, 200, 500), (8, 64, 64), (5, 33, 7)])
def test_knn_matches_jax_diff_form(dtype, k, S, M):
    rng = np.random.RandomState(3 + k)
    q = rng.randn(2, S, 3).astype(dtype)
    r = rng.randn(2, M, 3).astype(dtype)
    with x64(dtype == np.float64):
        jd, ji = jpo.knn_with_distance(k, jnp.asarray(r), jnp.asarray(q), diff_form=True)
        jd, ji = np.asarray(jd), np.asarray(ji)
    d, i = ops.knn_with_distance(k, _t(r), _t(q))
    assert i.dtype == torch.int64 and d.dtype == torch.from_numpy(q).dtype
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=RTOL[dtype], atol=0)
    assert (np.diff(d.numpy(), axis=-1) >= 0).all(), "ascending"


def test_knn_matches_pallas_interpret():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 200, 3).astype(np.float32)
    r = rng.randn(2, 500, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jd, ji = knn_pallas(16, jnp.asarray(r), jnp.asarray(q))
    d, i = ops.knn_with_distance(16, _t(r), _t(q))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=0)


def test_knn_ties_first_index_and_errors():
    # duplicated reference points: equal distances must come out index-ascending
    r = np.repeat(np.random.RandomState(0).randn(1, 4, 3), 3, axis=1).astype(np.float32)
    q = r[:, :2] + 0.0
    d, i = ops.knn_with_distance(6, _t(r), _t(q))
    want = np.argsort(((q[:, :, None] - r[:, None]) ** 2).sum(-1), axis=-1, kind="stable")
    np.testing.assert_array_equal(i.numpy(), want[..., :6])
    with pytest.raises(ValueError):
        ops.knn_with_distance(13, _t(r), _t(q))  # k > M, like jax top_k
    with pytest.raises(ValueError):
        ops.knn_with_distance(2, _t(r).to("meta"), _t(q).to("meta"))


# --------------------------------------------------------------------- FPS


@pytest.mark.parametrize("B,N,npoint", [(2, 300, 64), (1, 2048, 256)])
def test_fps_matches_jax(B, N, npoint):
    xyz = np.random.RandomState(N).randn(B, N, 3).astype(np.float32)
    want = np.asarray(jpo.furthest_point_sample(jnp.asarray(xyz), npoint, True))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint))
    got = ops.furthest_point_sample(_t(xyz), npoint)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    # float64 plain version picks the same points on these clouds
    np.testing.assert_array_equal(ops.furthest_point_sample(_t(xyz.astype(np.float64)), npoint).numpy(), want)


def test_fps_identical_points_and_fps_coords():
    xyz = np.ones((2, 50, 3), np.float32)
    got = ops.furthest_point_sample(_t(xyz), 10)
    want = np.asarray(jpo.furthest_point_sample(jnp.asarray(xyz), 10, True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), 0)
    pts = np.random.RandomState(1).randn(2, 100, 3).astype(np.float32)
    np.testing.assert_array_equal(
        ops.fps(_t(pts), 16).numpy(), np.asarray(jpo.fps(jnp.asarray(pts), 16))
    )


# ------------------------------------------------------------------ gather


@pytest.mark.parametrize("M,C,S", [(300, 8, 700), (5000, 3, 1000), (600, 384, 257)])
def test_index_points_clamp_matches_pallas_gather(M, C, S):
    """Out-of-range indices clamp to [0, M-1] exactly as gather_rows_pallas
    does (both its regimes: chunk probe for M <= 4096, hi/lo above)."""
    rng = np.random.RandomState(M)
    table = rng.randn(2, M, C).astype(np.float32)
    idx = rng.randint(-5, M + 5, size=(2, S)).astype(np.int64)
    idx[:, :3] = [-1, M, M + 100]
    want = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx, jnp.int32), True))
    got = ops.gather_rows(_t(table), _t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    # index_points: (B, S, K) index layout, float64 values, bit-exact rows
    idx3 = _t(idx[:, : (S // 4) * 4].reshape(2, -1, 4))
    got3 = ops.index_points(_t(table.astype(np.float64)), idx3)
    np.testing.assert_array_equal(got3.numpy(), want[:, : (S // 4) * 4].reshape(2, -1, 4, C))


def test_gather_rejects_what_it_cannot_take():
    table = torch.zeros(1, 4, 3)
    with pytest.raises(TypeError):
        ops.gather_rows(table, torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.gather_rows(table, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="empty table"):
        ops.gather_rows(torch.zeros(1, 0, 3), torch.zeros(1, 2, dtype=torch.int64))
    # a table that requires a gradient is taken: the backward is the scatter-add
    out = ops.gather_rows(table.requires_grad_(), torch.tensor([[1, 1]]))
    out.sum().backward()
    assert table.grad[0, :, 0].tolist() == [0.0, 2.0, 0.0, 0.0]


# ----------------------------------------------------------- chamfer / eval


def _clouds(kind, rng, B, N, M):
    if kind == "random":
        return rng.randn(B, N, 3), rng.randn(B, M, 3)
    if kind == "sphere":  # dense surface: tiny NN spacings
        return _sphere(rng, B, N), _sphere(rng, B, M)
    x = rng.randn(B, N, 3)
    return x, x.copy()


@pytest.mark.parametrize("kind", ["random", "sphere", "identical"])
def test_nn_distance_eval_matches_bidir_pallas(kind):
    rng = np.random.RandomState(7)
    N, M = (512, 512) if kind == "identical" else (300, 700)
    x, y = (a.astype(np.float32) for a in _clouds(kind, rng, 2, N, M))
    with pltpu.force_tpu_interpret_mode():
        ji1, ji2 = nn_argmin_bidir_exact(jnp.asarray(x), jnp.asarray(y))
    jd1, jd2, _, _ = (np.asarray(a) for a in jchamfer.nn_distance_eval(jnp.asarray(x), jnp.asarray(y)))
    d1, d2, i1, i2 = ops.nn_distance_eval(_t(x), _t(y))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(d1.numpy(), jd1, rtol=1e-6, atol=0)
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-6, atol=0)
    if kind == "identical":
        np.testing.assert_array_equal(i1.numpy(), np.broadcast_to(np.arange(N), (2, N)))
        np.testing.assert_array_equal(i2.numpy(), np.broadcast_to(np.arange(N), (2, N)))
        assert float(ops.chamfer_l1(_t(x), _t(y))) < 1e-10


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eval_metrics_and_chamfer_match_jax(dtype):
    rng = np.random.RandomState(11)
    gt = _sphere(rng, 2, 600).astype(dtype)
    pred = (gt[:, :500] + 0.004 * rng.randn(2, 500, 3)).astype(dtype)
    with x64(dtype == np.float64):
        jp, jg = jnp.asarray(pred), jnp.asarray(gt)
        want_suite = [np.asarray(a) for a in jmetrics.eval_metric_suite(jp, jg, reduce=False)]
        want_f = float(jmetrics.f_score(jp, jg))
        want_l1 = float(jchamfer.chamfer_l1(jp, jg))
        want_l2 = float(jchamfer.chamfer_l2(jp, jg))
    got_suite = metrics.eval_metric_suite(_t(pred), _t(gt), reduce=False)
    # F is a float32 quantity in both packages whatever the clouds' type
    # (hit rates counted in float32), so it is held to the float32 tolerance
    assert got_suite[0].dtype == torch.float32 and want_suite[0].dtype == np.float32
    for got, want, rtol in zip(got_suite, want_suite, (RTOL[np.float32], RTOL[dtype], RTOL[dtype])):
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    f, l1, l2 = metrics.eval_metric_suite(_t(pred), _t(gt))
    np.testing.assert_allclose(float(l1), want_suite[1].mean(), rtol=RTOL[dtype])
    np.testing.assert_allclose(float(metrics.f_score(_t(pred), _t(gt))), want_f, rtol=RTOL[np.float32])
    np.testing.assert_allclose(float(ops.chamfer_l1(_t(pred), _t(gt))), want_l1, rtol=RTOL[dtype])
    np.testing.assert_allclose(float(ops.chamfer_l2(_t(pred), _t(gt))), want_l2, rtol=RTOL[dtype])
    assert 0.0 < float(f) <= 1.0


def test_chamfer_loss_forms_refuse_gradients():
    """Only the eval form refuses a gradient now: the loss forms, which
    raised while the port was forward-only, are differentiable (the test
    keeps the name it had then)."""
    x = torch.randn(1, 8, 3, requires_grad=True)
    ops.chamfer_l1(x, torch.randn(1, 9, 3)).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().sum()) > 0
    # the eval form is non-differentiable by design and detaches
    d1, _, _, _ = ops.nn_distance_eval(x, torch.randn(1, 9, 3))
    assert not d1.requires_grad


# ------------------------------------------------------------ port contract


def test_cuda_is_never_a_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_nothing_of_jax():
    """The port package and chip_smoke.py import neither jax, flax nor the
    JAX package (they keep their own copies of what they need)."""
    banned = ("jax", "flax", "imgadapointr_tpu")
    files = sorted((REPO / "imgadapointr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    the script fails before it prints any result."""
    import shutil
    import subprocess
    import sys

    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
