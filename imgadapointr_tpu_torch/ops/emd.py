"""Approximate Earth Mover's Distance by the auction algorithm.

Counterpart of ``imgadapointr_tpu/ops/emd.py`` (reference CUDA extension
``extensions/emd``): an (eps, iterations) auction assignment of the points
of ``xyz1`` (bidders) to those of ``xyz2`` (items); the metric is the mean
of the matched distances. The N x M cost matrix is never formed.

Each iteration, the unassigned bidders are compacted to the front (their
original ids ascending) and bid: per bidder the best and second-best value
``-|x - y|² - price`` and the first item with the best value, from
:func:`auction_top2` (kernel ``csrc/auction_top2.cu``; the Pallas
``auction_top2_pallas``), whose plain PyTorch version
:func:`auction_top2_plain` the wrapper takes for a CPU tensor only. The
item side (:func:`_bid_update_rows`) is plain PyTorch, as the JAX package
leaves it to XLA: each item accepts its highest bid, ties to the lowest
original bidder id (``scatter_reduce`` amax, then amin of the ids), evicts
its previous owner and takes the bid as its price. Bidders still
unassigned when the iterations run out take their nearest item (the top-2
at zero price).

The port is the JAX package's single-phase Pallas path
(``emd.py:251-277``, ``:386-393``), which ranks by the diff form in
float32. The JAX package's two-phase split of that loop (``:310-377``) is
bit-identical to it and exists to spare the TPU's row-rate-bound gathers;
it is not ported. The loop stops early once no bidder is active: such an
iteration makes no bid, so it sells nothing and changes no price.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .pointops import _on_cpu, sqdist

_NEG_BIG = -3.0e38  # the top-2's initial value, as in the TPU kernel
_NO_BID = -1.0e9  # an item's best bid before any bid (emd.py:_bid_update_rows)
# plain version: elements of one (B, N, tile, 3) difference block
_PLAIN_BLOCK = 1 << 26


# ------------------------------------------------------------------- top-2


def auction_top2_plain(x: torch.Tensor, y: torch.Tensor, price: torch.Tensor,
                       cnt: torch.Tensor | None = None):
    """Plain version of :func:`auction_top2`, tiled over the items so that
    a 16384² call does not hold the whole value field; every row is
    computed, ``cnt`` is not read."""
    B, N, _ = x.shape
    M = y.shape[1]
    tile = max(1, min(M, _PLAIN_BLOCK // max(1, B * N * 3)))
    best = torch.full((B, N), _NEG_BIG, dtype=x.dtype, device=x.device)
    second = best.clone()
    best_i = torch.zeros(B, N, dtype=torch.int64, device=x.device)
    for base in range(0, M, tile):
        v = -sqdist(x[:, :, None, :] - y[:, None, base:base + tile, :]) - price[:, None, base:base + tile]
        c1i = v.argmax(dim=-1)  # first maximum within the tile
        c1 = v.gather(-1, c1i[..., None])[..., 0]
        c2 = v.scatter(-1, c1i[..., None], _NEG_BIG).amax(dim=-1)
        upd = c1 > best  # strict: an earlier tile keeps its tie
        second = torch.where(upd, torch.maximum(best, c2), torch.maximum(second, c1))
        best = torch.where(upd, c1, best)
        best_i = torch.where(upd, c1i + base, best_i)
    return best, second, best_i


def auction_top2(x: torch.Tensor, y: torch.Tensor, price: torch.Tensor,
                 cnt: torch.Tensor | None = None):
    """(best, second, best_i), each (B, N): per bidder row of x (B, N, 3)
    the largest and second-largest of ``v_j = -(dx*dx + dy*dy + dz*dz) -
    price[b, j]`` over the items of y (B, M, 3), and the first j with the
    largest value (int64). ``cnt`` (B,) int64: only rows below ``cnt[b]``
    are live; on the card the kernel neither reads nor writes the others,
    whose outputs are then undefined and must be masked by the caller.
    Non-differentiable."""
    if (x.dim() != 3 or y.dim() != 3 or x.shape[-1] != 3 or y.shape[-1] != 3
            or x.shape[0] != y.shape[0] or price.shape != y.shape[:2]):
        raise ValueError(
            f"auction_top2: x (B, N, 3), y (B, M, 3) and price (B, M) expected, got "
            f"{tuple(x.shape)}, {tuple(y.shape)} and {tuple(price.shape)}"
        )
    B, N, _ = x.shape
    M = y.shape[1]
    if M == 0:
        raise ValueError("auction_top2: no items")
    if cnt is not None and (cnt.shape != (B,) or cnt.dtype != torch.int64):
        raise ValueError(f"auction_top2: cnt (B,) int64 expected, got {tuple(cnt.shape)} {cnt.dtype}")
    if _on_cpu("auction_top2", x):
        return auction_top2_plain(x, y, price, cnt)
    _build.require_cuda_f32("auction_top2", x.device, x, y, last_dim=3)
    _build.require_cuda_f32("auction_top2", x.device, price, ndim=2)
    if cnt is not None and (cnt.device != x.device or not cnt.is_contiguous()):
        raise ValueError("auction_top2: cnt must be contiguous on the clouds' device")
    best = torch.empty(B, N, dtype=torch.float32, device=x.device)
    second = torch.empty_like(best)
    best_i = torch.empty(B, N, dtype=torch.int64, device=x.device)
    chunks = _top2_chunks(B, N, M, x.device)
    # each (row, chunk)'s partial (best, second, best_i bits, pad), merged in chunk order
    partial = torch.empty(B, N, chunks, 4, dtype=torch.float32, device=x.device) if chunks > 1 else None
    _build.launch(
        "auction_top2", "auction_top2_f32", x.device,
        x.data_ptr(), y.data_ptr(), price.data_ptr(), None if cnt is None else cnt.data_ptr(),
        best.data_ptr(), second.data_ptr(), best_i.data_ptr(),
        None if partial is None else partial.data_ptr(), B, N, M, chunks,
    )
    return best, second, best_i


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _top2_chunks(B: int, N: int, M: int, device: torch.device) -> int:
    """The kernel's item chunks for a live width of N rows, as its source
    picks them (``csrc/auction_top2.cu:auction_top2_chunks``). The width is
    the one ``_auction_batch`` already read, so this needs no host read of
    the device."""
    return _build.library().auction_top2_chunks(B, N, M, _sm_count(device))


# ----------------------------------------------------------------- auction


def _bid_update_rows(price, assign, best, second, item, orig, valid, eps: float):
    """The item side of one iteration (``emd.py:_bid_update_rows``),
    batched: rows are compacted bidders, ``orig`` (B, R) their original
    ids (ascending over the live rows, so the lowest-id tie-break is the
    uncompacted one) and ``valid`` (B, R) marks the live rows. Returns the
    new (price (B, M), assign (B, N))."""
    B, N = assign.shape
    M = price.shape[1]
    bid = price.gather(1, item) + (best - second) + eps
    item_best_bid = torch.full_like(price, _NO_BID).scatter_reduce(
        1, item, torch.where(valid, bid, _NO_BID), "amax")
    is_winner = valid & (bid >= item_best_bid.gather(1, item))
    winner_rank = torch.where(is_winner, orig, N)
    item_winner = torch.full((B, M), N, dtype=torch.int64, device=price.device).scatter_reduce(
        1, item, winner_rank, "amin")
    won = is_winner & (item_winner.gather(1, item) == orig)
    # the previous owners of the items just sold lose them
    sold = torch.zeros(B, M + 1, dtype=torch.bool, device=price.device).scatter_(
        1, torch.where(won, item, M), True)[:, :M]
    evicted = sold.gather(1, assign.clamp(0, M - 1)) & (assign >= 0)
    assign = assign.masked_fill(evicted, -1)
    # each winning row's item into its bidder's slot; the rest into column N
    assign = torch.cat([assign, assign.new_zeros(B, 1)], dim=1).scatter_(
        1, torch.where(won, orig, N), item)[:, :N]
    return torch.where(sold, item_best_bid, price), assign


def _auction_batch(x: torch.Tensor, y: torch.Tensor, eps: float, iterations: int,
                   top2=auction_top2) -> torch.Tensor:
    """(B, N) int64 assignment of the bidders x (B, N, 3) to the items
    y (B, M, 3), in float32. ``top2`` is the bidding step,
    :func:`auction_top2`; a check of the kernel hands in the plain version
    to run the same loop on the same device without it. One host read of
    the active count per iteration sizes the compacted rows and ends the
    loop once no bidder is left."""
    B, N, _ = x.shape
    M = y.shape[1]
    x32 = x.detach().float().contiguous()
    y32 = y.detach().float().contiguous()
    price = torch.zeros(B, M, dtype=torch.float32, device=x.device)
    assign = torch.full((B, N), -1, dtype=torch.int64, device=x.device)
    ids = torch.arange(N, device=x.device).expand(B, N)
    for _ in range(iterations):
        active = assign < 0
        cnt = active.sum(dim=1)
        width = int(cnt.max())
        if width == 0:
            break
        # original ids of the active bidders, front-packed in ascending order
        pos = torch.where(active, active.cumsum(dim=1) - 1, width)
        orig = torch.zeros(B, width + 1, dtype=torch.int64, device=x.device).scatter_(
            1, pos, ids)[:, :width]
        valid = ids[:, :width] < cnt[:, None]
        xg = torch.gather(x32, 1, orig[..., None].expand(B, width, 3))
        best, second, item = top2(xg, y32, price, cnt)
        item = item.masked_fill(~valid, 0)  # rows past cnt are undefined
        best, second = best.masked_fill(~valid, 0.0), second.masked_fill(~valid, 0.0)
        price, assign = _bid_update_rows(price, assign, best, second, item, orig, valid, eps)
    unassigned = assign < 0
    if bool(unassigned.any()):  # greedy fallback: the nearest item
        nearest = top2(x32, y32, torch.zeros_like(price))[2]
        assign = torch.where(unassigned, nearest, assign)
    return assign.clamp_max(M - 1)


class _EMDAuction(torch.autograd.Function):
    """(dist (B, N) float32, assignment (B, N)); the gradient reaches
    ``xyz1`` only, ``2 (x1 - x2[a]) · g`` (``emd.py:417-424``)."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iterations):
        assign = _auction_batch(xyz1, xyz2, eps, iterations)
        matched = torch.gather(xyz2, 1, assign[..., None].expand(*assign.shape, 3))
        dist = sqdist(xyz1.float() - matched.float())
        ctx.save_for_backward(xyz1, matched)
        ctx.mark_non_differentiable(assign)
        return dist, assign

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_dist, _g_assign):
        xyz1, matched = ctx.saved_tensors
        return 2.0 * (xyz1 - matched) * g_dist[..., None], None, None, None


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iterations: int = 50):
    """``(dist, assignment)``: the squared distance (B, N) of every point
    of ``xyz1`` to its auction match in ``xyz2`` and the match's index."""
    return _EMDAuction.apply(xyz1, xyz2, eps, iterations)


def emd_distance_metric(pred: torch.Tensor, gt: torch.Tensor, eps: float = 0.005,
                        iterations: int = 100) -> torch.Tensor:
    """``mean(sqrt(dist))`` of the auction matching (the caller applies the
    x1000; reference ``utils/metrics.py:112-116``)."""
    dist, _ = emd_auction(pred, gt, eps, iterations)
    return dist.clamp_min(0.0).sqrt().mean()
