"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference's answer for the same inputs and
weights, and is held to its limit in ``limits/<cell>.json``.

- ``coarse_p99`` / ``fine_p99`` (serving): over the checked clouds, the
  largest 99th percentile of the two-way nearest-point distance between
  the program's cloud and the reference's, over the reference cloud's
  extent. A set comparison by a high quantile: a near-tied selection that
  swaps a query or two moves its own points only (0.2 % of a cloud each),
  while a lower precision moves every point.
- ``fine_far_share`` (serving): over the checked clouds, the largest share
  of the two-way distances above ``FAR`` of the extent. Where near-tied
  picks inside the model (GDANet's) move a whole fine cloud a little in
  sound runs, a lower precision still moves much of it farther.
- ``batch_mismatch`` (training from disk): entries of the checked batches
  that differ from the reference reader's (exact: limit 0).
- ``step1_loss_gap``: the larger relative gap of the first step's two loss
  terms (the later steps' gaps are Adam's: see ``PERF.md``).
- ``grad_gap`` / ``change_gap``: by the worst leaf, the gap between the
  program's norm and the reference's, of the first step's clipped gradient
  and of the parameters' change over the checked steps, over the larger of
  that leaf's reference norm and the median leaf's. Leaves whose reference
  gradient is under ``DEAD_LEAF`` of the median leaf's are left out of the
  change: Adam moves them by round-off alone.
"""

from __future__ import annotations

import torch

DEAD_LEAF = 1e-3
QUANTILES = (0.5, 0.99, 1.0)  # the compared 99th percentile, with the median and the largest for the record
FAR = 3e-3


@torch.no_grad()
def nn_quantiles(a: torch.Tensor, b: torch.Tensor) -> list:
    """Largest over the clouds of each of ``QUANTILES`` of the two-way
    nearest-point distance between (B, n, 3) batches, over the reference
    cloud's (``b``'s) extent, then the largest share of those distances
    above ``FAR``."""
    out = torch.zeros(len(QUANTILES) + 1, dtype=torch.float64)
    q = torch.tensor(QUANTILES, dtype=torch.float64, device=a.device)
    for i in range(a.shape[0]):
        d = []
        for x, y in ((a[i], b[i]), (b[i], a[i])):
            for s in range(0, x.shape[0], 2048):
                d.append((x[s:s + 2048, None, :] - y[None, :, :]).square().sum(-1).amin(dim=1).sqrt())
        d = torch.cat(d).double() / b[i].abs().max().double()
        row = torch.cat([torch.quantile(d, q), (d > FAR).double().mean()[None]])
        out = torch.maximum(out, row.cpu())
    return out.tolist()


def loss_gaps(prog: list, ref: list) -> list:
    """Each step's larger relative gap of its (sparse, dense) loss terms."""
    return [max(abs(p - r) / abs(r) for p, r in zip(ps, rs)) for ps, rs in zip(prog, ref)]


def _median(values: list) -> float:
    v = sorted(values)
    return v[len(v) // 2]


def norm_gap(prog: dict, ref: dict, leaves=None) -> tuple:
    """(worst gap, its leaf) of per-leaf norms {name: norm} by the rule above."""
    med = _median(list(ref.values()))
    worst, where = 0.0, None
    for name in (leaves if leaves is not None else ref):
        gap = abs(prog[name] - ref[name]) / max(ref[name], med)
        if gap >= worst:
            worst, where = gap, name
    return worst, where


def live_leaves(grad_norms: dict) -> list:
    med = _median(list(grad_norms.values()))
    return [n for n, v in grad_norms.items() if v >= DEAD_LEAF * med]


def verdict(values: dict, limits: dict, not_compared=()) -> tuple:
    """(correct, checks): every value at or under its limit. A number the
    cell does not compare (its limits file says why) is left out of both; a
    number with no limit fails, as does a cell with no number compared."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items() if k not in not_compared}
    ok = bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
