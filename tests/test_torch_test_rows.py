"""The test protocol's per-sample rows against the JAX package, on the CPU.

The port's ``compute_metrics_per_sample`` and ``Runner.test_step`` at batch
3 against JAX ``utils/metrics.py:compute_metrics_per_sample``, on
numpy-seeded clouds in float64 (``jax_enable_x64``), one sample with
zero-padded rows. Each row is one batch-1 evaluation with its own masks:
it must also equal the port's batch-1 call on that sample, and no row may
be a batch mean.

Tolerances: CDs 1e-9 relative (float64 on both sides, sums in another
order); F-Score 1e-6 relative (both packages count hit rates in float32);
EMD 1e-6 relative, the band of ``tests/test_torch_emd.py`` (the auction
runs in float32 in both packages; JAX's top-2 in the Pallas interpreter).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

from imgadapointr_tpu.ops import emd as jax_emd
from imgadapointr_tpu.utils import metrics as jmetrics
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.utils import metrics
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CD_RTOL, F_RTOL, EMD_RTOL = 1e-9, 1e-6, 1e-6


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _clouds(seed, n_pred, n_gt):
    """(pred, gt) float64 (3, N, 3): pred near gt; sample 1 has zero-padded
    rows in both clouds, sample 2 in the prediction only."""
    rng = np.random.RandomState(seed)
    v = rng.randn(3, n_gt, 3)
    gt = 0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    pred = gt[:, rng.permutation(n_gt)[:n_pred]] + 0.006 * rng.randn(3, n_pred, 3)
    gt[1, -n_gt // 5:] = 0.0
    pred[1, -n_pred // 7:] = 0.0
    pred[2, -n_pred // 4:] = 0.0
    return pred, gt


def _jax_rows(pred, gt, require_emd):
    with x64():
        return np.asarray(jmetrics.compute_metrics_per_sample(
            jnp.asarray(pred), jnp.asarray(gt), require_emd=require_emd, ignore_zeros=True))


def _assert_rows(got, want):
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=F_RTOL, atol=0)
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=CD_RTOL, atol=0)
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=EMD_RTOL, atol=0)


def _batch_one(pred, gt, require_emd):
    """The port's compute_metrics on each sample alone, as (3, 4) rows."""
    rows = []
    for b in range(pred.shape[0]):
        vals = metrics.compute_metrics(pred[b:b + 1], gt[b:b + 1], require_emd=require_emd,
                                       ignore_zeros=True)
        rows.append([float(v) for v in vals])
    return np.asarray(rows)


@pytest.mark.parametrize("require_emd", [False, True], ids=["no_emd", "emd"])
def test_compute_metrics_per_sample_matches_jax(require_emd, monkeypatch):
    n_pred, n_gt = (96, 128) if require_emd else (700, 900)
    pred, gt = _clouds(3, n_pred, n_gt)
    if require_emd:  # JAX's auction on its Pallas top-2, as tests/test_torch_emd.py runs it
        monkeypatch.setattr(jax_emd, "_use_pallas_top2", lambda a, b: True)
        with pltpu.force_tpu_interpret_mode():
            want = _jax_rows(pred, gt, True)
    else:
        want = _jax_rows(pred, gt, False)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    got = metrics.compute_metrics_per_sample(tp, tg, require_emd=require_emd, ignore_zeros=True)
    assert got.dtype == torch.float64
    got = got.numpy()
    _assert_rows(got, want)
    # each row is the batch-1 evaluation of its sample, not a batch mean
    _assert_rows(_batch_one(tp, tg, require_emd), got)
    assert len(np.unique(got[:, 1])) == 3
    if require_emd:
        assert bool((got[:, 3] > 0).all())
    else:
        assert bool((got[:, 3] == 0).all())


def test_runner_test_step_returns_per_sample_rows():
    """``Runner.test_step`` at batch 3 in float64 on the tiny AdaPoinTr:
    columns 5-8 are JAX's per-sample rows on the port's fine cloud, and
    every row equals the test step of its sample alone."""
    cfg = cfg_from_yaml_file("cfgs/PCN_models/AdaPoinTr-tiny.yaml")
    runner = port_runner.Runner(types.SimpleNamespace(device="cpu", seed=0), cfg, logger="silent")
    runner.model.double()
    rng = np.random.RandomState(4)
    n_fine = int(cfg.model.num_points)
    _, gt = _clouds(5, 8, n_fine)
    batch = {"partial": rng.randn(3, 256, 3) * 0.3, "gt": gt}
    rows = runner.test_step(batch, require_emd=False)
    assert rows.shape == (3, 9)
    with torch.inference_mode():
        _, dense = runner.model(torch.from_numpy(batch["partial"]))
    assert dense.dtype == torch.float64
    _assert_rows(rows[:, 5:], _jax_rows(dense.numpy(), gt, False))
    # the suite's F and the table's F are the same exact per-sample number
    np.testing.assert_allclose(rows[:, 5], rows[:, 4], rtol=F_RTOL)
    for b in range(3):
        one = runner.test_step({k: v[b:b + 1] for k, v in batch.items()}, require_emd=False)
        np.testing.assert_allclose(rows[b, 5], one[0, 5], rtol=F_RTOL)
        np.testing.assert_allclose(rows[b, [0, 1, 2, 3, 6, 7]], one[0, [0, 1, 2, 3, 6, 7]],
                                   rtol=CD_RTOL)
    assert len(np.unique(rows[:, 6])) == 3  # no row is the batch mean
