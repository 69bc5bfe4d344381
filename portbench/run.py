"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this package and
the port (``imgadapointr_tpu_torch``) on a machine with the cell's CUDA
devices. Set-up (the model, its weights from the seed, the cell's data, the
checked first steps or the warm-up requests) is timed as ``setup_s``; then
the window measures for ``--seconds``. With ``--trace 0`` the result line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics: the window's first part runs untraced and gives the rates
(``mfu``), its last ``TRACED_SECONDS`` run under a ``torch.profiler`` trace
of the device alone and give what the device did. Either way the window's
answers are then checked against the plain reference
(``portbench/reference``), each compared number printed beside its limit.
A share of a peak above 100 % is an error of its count: the run then exits
4 without a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
# The traced stretch at the end of a traced run's window: long enough for
# some tens of training steps or requests, short enough that its trace is
# reduced in seconds.
TRACED_SECONDS = 5.0
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    harness.setup_environment(ROOT)
    cell = harness.Cell(ROOT, args.workload)
    kind = harness.check_devices(cell.chips)
    # the program's own prints go to standard error: the result is standard output's last line
    with contextlib.redirect_stdout(sys.stderr):
        result, checks = measure(cell, args, kind, harness, cuda_device())
    harness.jax_guard()
    over = harness.shares_over_100(result["metrics"])
    if over:
        print(f"portbench: a share of a peak above 100 %, an error of its count: {'; '.join(over)}", file=sys.stderr)
        harness.print_checks(checks)
        return 4
    harness.emit(result, checks)
    return 0


def cuda_device():
    import torch

    return torch.device("cuda", 0)


def measure(cell, args, kind, harness, device):
    """(result, checks) of one run of ``cell`` on ``device``."""
    import torch

    from portbench import compare, workloads
    from portbench.reference import profile as trace_reduce

    seed = args.seed % (1 << 63)
    on_card = device.type == "cuda"
    spans = harness.Spans()
    run = workloads.make(cell, seed, device, spans)
    run.setup()
    workloads.sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()  # the set-up's objects out of the collector's way for the window
    launches, rate = [], None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from imgadapointr_tpu_torch.ops import _build

        traced_s = min(args.seconds, TRACED_SECONDS)
        t_window = time.perf_counter()
        if args.seconds > traced_s:
            rate = run.window(args.seconds - traced_s)
        launch = _build.launch

        def counted(kernel, entry, dev, *a):  # the port's launches, with their sizes
            launches.append((kernel, entry, a))
            return launch(kernel, entry, dev, *a)

        _build.launch = counted
        spans.recording = True
        try:
            with profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]) as prof:
                out = run.window(traced_s)
        finally:
            _build.launch = launch
            spans.recording = False
    else:
        t_window = time.perf_counter()
        out = run.window(args.seconds)
    setup_s = t_window - T_START
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.unfreeze()
    run.release()
    values = run.check()
    correct, checks = compare.verdict(values, cell.limits, cell.not_compared)
    metrics = {}
    attempted, failed = out["attempted"], out["failed"]
    if args.trace:
        prof_red = trace_reduce.reduce(trace_reduce.device_intervals(prof), out["seconds"], spans.intervals)
        per_cloud = run.net.step_flops(run.model_cfg, int(cell.traffic["n_partial"]), cell.traffic["kind"] == "train")
        readings = harness.Readings(prof_red, launches, spans, out, rate, per_cloud, window_peak)
        power = harness.power_limit() if on_card else None
        for m in cell.per_layer:
            v = harness.load_reader(m["name"])(readings)
            if v is None:
                continue
            entry = {"value": v, "unit": m["unit"]} if not isinstance(v, dict) else dict(v, unit=m["unit"])
            if "peak" in entry:
                entry["power_limit"] = power
            metrics[m["name"]] = entry
        if rate:
            attempted, failed = attempted + rate["attempted"], failed + rate["failed"]
    else:
        values_e2e = dict(out["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values_e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu", "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if args.trace:
        result["device"].update(busy_s=prof_red["busy_s"], window_s=prof_red["window_s"])
        top = sorted(prof_red["by_name"].items(), key=lambda kv: -kv[1])[:10]
        gaps: dict = {}
        for seconds, label in prof_red["idle_gaps"]:
            gaps[label] = gaps.get(label, 0.0) + seconds
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in top],
                               "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10]}
    stretches = {"window": {k: v for k, v in out.items() if k != "latency_ms"}}
    if rate:
        stretches["untraced"] = {k: v for k, v in rate.items() if k != "latency_ms"}
    print(json.dumps({"setup_s": setup_s, **stretches, "spans_s": spans.seconds, "check_detail": run.detail}),
          file=sys.stderr)
    return result, checks


if __name__ == "__main__":
    sys.exit(main())
