"""Reduction of a ``torch.profiler`` trace of the measured window.

Frozen copy of ``chip_smoke.py:profile_run``'s arithmetic, over a stretch
of the window instead of one request: the device's busy time as the union
of its operations' intervals (kernels, copies, fills), time by name, the
count of operations; and, added here, the idle gaps between the busy
intervals, each labelled by the benchmark span the host was in when the
gap began. The trace records the device alone (the profiler's CPU side,
an event for every operator, slows a host-paced step about 2.5 times), so
the spans come from the benchmark's own host clock: ``time.time_ns``, the
clock of the trace's timestamps.
"""

from __future__ import annotations

import bisect

import torch

OUTSIDE = "outside the benchmark's spans"


def device_intervals(prof) -> list:
    """(start ns, end ns, name) of every device operation in the trace, sorted."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        a = e.start_ns()
        out.append((a, a + e.duration_ns(), e.name()))
    out.sort()
    return out


def reduce(intervals: list, window_s: float, spans: list) -> dict:
    """Busy seconds, device seconds by name, the operation count and the
    labelled idle gaps of a traced stretch, from its device ``intervals``
    and the host ``spans`` (start ns, end ns, name) recorded meanwhile."""
    busy, end, gaps = 0, None, []
    for a, b, _ in intervals:  # the union of the intervals
        if end is not None and a > end:
            gaps.append((end, a))
        busy += max(0, b - (a if end is None else max(a, end)))
        end = b if end is None else max(end, b)
    by_name: dict = {}
    for a, b, name in intervals:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    spans = sorted(spans)
    starts = [s[0] for s in spans]

    def label(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if spans[i][0] <= t <= spans[i][1]:
                return spans[i][2]
            i -= 1
            if i >= 0 and t - spans[i][0] > 10**10:
                break
        return OUTSIDE

    labelled = sorted(((b - a) / 1e9, label(a)) for a, b in gaps)[::-1]
    return {"busy_s": busy / 1e9, "window_s": window_s, "by_name": by_name, "launches": len(intervals),
            "idle_gaps": labelled}
