"""The port's auction EMD against the JAX package's Pallas path, on the CPU.

The JAX package runs its auction top-2 kernel (``auction_top2_pallas``) in
the Pallas interpreter (``pltpu.force_tpu_interpret_mode``), as
``tests/test_emd_pallas.py`` does, and its single-phase loop
(``_auction_batch(..., use_pallas=True, p2_width=N)``); the port runs the
plain version of its top-2 (``ops.auction_top2`` on a CPU tensor) and its
own loop. Everything is float32, as the auction is.

Tolerances: the top-2's indices are equal on every live row, and its
values are bit-equal to a float32 numpy evaluation of
``-((dx*dx + dy*dy) + dz*dz) - price`` in that order. Against the
interpreter the values agree to 4 units in the last place: XLA:CPU fuses
the interpreter's value chain into multiply-adds (it computes
``fma(dz, dz, fma(dx, dx, dy*dy))``, three roundings where the kernel and
the plain version take five, all of terms of one sign, so each rounding
moves the result by at most half a unit). Whole auctions: the assignments are equal and the EMD metric
agrees to 1e-6 relative. The gradient of ``emd_auction`` (to ``xyz1`` only)
is ``jax.grad``'s to 1e-6 relative in float32.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

from imgadapointr_tpu.ops import emd as jax_emd
from imgadapointr_tpu.ops.pallas.auction import auction_top2_pallas
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.ops import emd as port_emd
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _case(seed, B, N, M):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = rng.randn(B, M, 3).astype(np.float32)
    price = (np.abs(rng.randn(B, M)) * 0.1).astype(np.float32)
    return x, y, price


def _exact_values(x, y, price):
    """(B, N, M) values in float32, in the kernel's order, no multiply-add."""
    d = x[:, :, None, :] - y[:, None, :, :]
    return -((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]) - price[:, None, :]


@pytest.mark.parametrize("B,N,M", [(2, 300, 400), (1, 128, 1500), (2, 256, 256)])
@pytest.mark.parametrize("with_cnt", [False, True], ids=["all_rows", "cnt"])
def test_auction_top2_matches_pallas(B, N, M, with_cnt):
    x, y, price = _case(0, B, N, M)
    cnt = np.array([N // 3, N][:B], np.int64) if with_cnt else None
    with pltpu.force_tpu_interpret_mode():
        jb, js, ji = (np.asarray(a) for a in auction_top2_pallas(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(price),
            cnt=None if cnt is None else jnp.asarray(cnt, jnp.int32)))
    got = ops.auction_top2(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(price),
                           None if cnt is None else torch.from_numpy(cnt))
    best, second, best_i = (t.numpy() for t in got)
    assert best_i.dtype == np.int64
    v = _exact_values(x, y, price)
    top = np.sort(v, axis=-1)
    live = np.arange(N)[None, :] < (np.full(B, N) if cnt is None else cnt)[:, None]
    np.testing.assert_array_equal(best_i[live], ji[live])
    np.testing.assert_array_equal(best_i, v.argmax(-1))
    np.testing.assert_array_equal(best, top[..., -1])
    np.testing.assert_array_equal(second, top[..., -2])
    np.testing.assert_array_max_ulp(best[live], jb[live], maxulp=4)
    np.testing.assert_array_max_ulp(second[live], js[live], maxulp=4)


_MERGE_CASES = {"ragged": (3, 40, 50, (0, 1, 40)), "wide": (2, 64, 33, (64, 17))}


@functools.lru_cache(maxsize=None)
def _merge_case(name):
    """A merge case's clouds and the Pallas interpreter's top-2 on them:
    the items repeat half a cloud apart (item j and j + h equal, at equal
    prices; cloud 0 at zero prices), and a quarter of the bidders sit on
    items, so equal values (exact ties) fall in different tiles."""
    B, N, M, counts = _MERGE_CASES[name]
    rng = np.random.RandomState(N + M)
    h = (M + 1) // 2
    half = rng.randn(B, h, 3).astype(np.float32)
    y = np.ascontiguousarray(np.concatenate([half, half], axis=1)[:, :M])
    p = (np.abs(rng.randn(B, h)) * 0.1).astype(np.float32)
    p[0] = 0.0
    price = np.ascontiguousarray(np.concatenate([p, p], axis=1)[:, :M])
    x = rng.randn(B, N, 3).astype(np.float32)
    x[:, :N // 4] = y[:, :N // 4]
    cnt = np.array(counts, np.int64)
    with pltpu.force_tpu_interpret_mode():
        pallas = tuple(np.asarray(a) for a in auction_top2_pallas(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(price), cnt=jnp.asarray(cnt, jnp.int32)))
    return x, y, price, cnt, pallas


@pytest.mark.parametrize("tile", [1, 3, 7])
@pytest.mark.parametrize("case", sorted(_MERGE_CASES))
def test_plain_top2_tile_merge_matches_pallas(monkeypatch, case, tile):
    """The merge rule that the kernel's item chunks rely on (``upd = c1 >
    best; second = upd ? max(best, c2) : max(second, c1)``,
    ``auction.py:98-102``), pinned on the CPU: the plain version, made to
    merge tiles of ``tile`` items, against the Pallas interpreter on clouds
    whose duplicated items cross tile boundaries, with a count per cloud.
    Indices equal and values within 4 ulp on the live rows (XLA:CPU's fused
    value chain in the interpreter); values bit-equal to the untiled plain
    version and to the float32 numpy evaluation, ties giving the first
    index and second == best."""
    x, y, price, cnt, (jb, js, ji) = _merge_case(case)
    B, N, _ = x.shape
    t = [torch.from_numpy(a) for a in (x, y, price)]
    untiled = ops.auction_top2_plain(*t)
    monkeypatch.setattr(port_emd, "_PLAIN_BLOCK", tile * B * N * 3)
    best, second, best_i = (a.numpy() for a in ops.auction_top2(*t, torch.from_numpy(cnt)))
    live = np.arange(N)[None, :] < cnt[:, None]
    np.testing.assert_array_equal(best_i[live], ji[live])
    np.testing.assert_array_max_ulp(best[live], jb[live], maxulp=4)
    np.testing.assert_array_max_ulp(second[live], js[live], maxulp=4)
    for a, u in zip((best, second, best_i), untiled):
        np.testing.assert_array_equal(a, u.numpy())
    v = _exact_values(x, y, price)
    top = np.sort(v, axis=-1)
    np.testing.assert_array_equal(best_i, v.argmax(-1))
    np.testing.assert_array_equal(best, top[..., -1])
    np.testing.assert_array_equal(second, top[..., -2])
    on_items = np.zeros((B, N), bool)
    on_items[:, :N // 4] = True
    zero_price_ties = on_items & (np.arange(B)[:, None] == 0)
    assert bool((second[zero_price_ties] == best[zero_price_ties]).all())


def test_auction_top2_ties_and_limits():
    """Equal maxima: the first index wins and the second value equals the
    best; a one-item cloud's second value is the initial -3e38."""
    y = torch.tensor([[[0.5, 0.0, 0.0], [0.0, 0.5, 0.0], [0.5, 0.0, 0.0]]])
    x = torch.zeros(1, 2, 3)
    best, second, best_i = ops.auction_top2(x, y, torch.zeros(1, 3))
    assert best_i.tolist() == [[0, 0]] and torch.equal(second, best)
    _, second, _ = ops.auction_top2(x, y[:, :1], torch.zeros(1, 1))
    assert float(second.max()) == float(np.float32(-3.0e38))
    with pytest.raises(ValueError):
        ops.auction_top2(x, y, torch.zeros(1, 2))
    with pytest.raises(ValueError):
        ops.auction_top2(x, y, torch.zeros(1, 3), torch.tensor([1], dtype=torch.int32))


@pytest.mark.parametrize("n", [128, 256])
def test_auction_matches_pallas_path(n):
    """The whole auction, 60 iterations, B = 2: equal assignments."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, n, 3).astype(np.float32)
    y = rng.rand(2, n, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_emd._auction_batch(jnp.asarray(x), jnp.asarray(y), 0.005, 60,
                                                 use_pallas=True, interpret=True, p2_width=n))
    got = port_emd._auction_batch(torch.from_numpy(x), torch.from_numpy(y), 0.005, 60)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the metric on the same assignment: mean of the matched distances
    matched = np.take_along_axis(y, want[..., None], axis=1)
    metric = np.sqrt(((x.astype(np.float64) - matched) ** 2).sum(-1)).mean()
    cost = float(ops.emd_distance_metric(torch.from_numpy(x), torch.from_numpy(y), iterations=60))
    np.testing.assert_allclose(cost, metric, rtol=1e-6)


def test_auction_greedy_fallback_when_bidders_outnumber_items():
    """N > M: the bidders left without an item take their nearest one."""
    rng = np.random.RandomState(2)
    x = rng.rand(1, 96, 3).astype(np.float32)
    y = rng.rand(1, 40, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_emd._auction_batch(jnp.asarray(x), jnp.asarray(y), 0.005, 30,
                                                 use_pallas=True, interpret=True, p2_width=96))
    got = port_emd._auction_batch(torch.from_numpy(x), torch.from_numpy(y), 0.005, 30).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 40  # every item sold, the rest nearest


def test_emd_auction_gradient_matches_jax(monkeypatch):
    """``jax.grad`` of the summed weighted distances (the JAX op forced onto
    its Pallas path in interpret mode) against the port's backward."""
    rng = np.random.RandomState(3)
    x = rng.rand(2, 64, 3).astype(np.float32)
    y = rng.rand(2, 64, 3).astype(np.float32)
    w = rng.rand(2, 64).astype(np.float32)
    monkeypatch.setattr(jax_emd, "_use_pallas_top2", lambda a, b: True)

    def loss(a, b):
        dist, _ = jax_emd.emd_auction(a, b, 0.005, 40)
        return jnp.sum(dist * w)

    with pltpu.force_tpu_interpret_mode():
        gx, gy = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    dist, assign = ops.emd_auction(tx, ty, 0.005, 40)
    (dist * torch.from_numpy(w)).sum().backward()
    assert ty.grad is None and float(jnp.abs(gy).max()) == 0.0
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-6, atol=1e-7)
    assert not assign.requires_grad


def test_runner_test_reports_emd_unless_no_emd(tmp_path, monkeypatch, capfd):
    """The runner's PCN protocol on the tiny AdaPoinTr at batch size 1: the
    EMDistance column is the auction metric x1000 of each cloud, and 0
    with ``--no_emd``."""
    import pathlib

    from imgadapointr_tpu_torch import main as port_main

    (tmp_path / "cfgs").symlink_to(pathlib.Path(__file__).resolve().parent.parent / "cfgs")
    monkeypatch.chdir(tmp_path)
    config = cfg_from_yaml_file("cfgs/PCN_models/AdaPoinTr-tiny.yaml")
    port_main.swap_synthetic(config, train_len=2)
    config.dataset.test.LENGTH = 2
    config.dataset.test.others.bs = 1
    args = types.SimpleNamespace(device="cpu", seed=0, num_workers=0, experiment_path=str(tmp_path))
    runner = port_runner.Runner(args, config, logger="silent")
    _, loader = port_runner.dataset_builder(args, config.dataset.test)
    scores = port_runner.test(runner, loader, args, config)
    assert "EMD on" in capfd.readouterr().out
    want = []
    for _, _, batch in loader:
        with torch.inference_mode():
            _, dense = runner.model.eval()(batch["partial"])
        want.append(float(ops.emd_distance_metric(dense, batch["gt"])) * 1000.0)
    assert scores["EMDistance"] > 0
    np.testing.assert_allclose(scores["EMDistance"], np.mean(want), rtol=1e-6)
    off = port_runner.test(runner, loader, types.SimpleNamespace(emd=False), config)
    assert off["EMDistance"] == 0.0 and "EMD off (--no_emd)" in capfd.readouterr().out
    for k in ("F-Score", "CDL1", "CDL2"):
        assert off[k] == scores[k]
