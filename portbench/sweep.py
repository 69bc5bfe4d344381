"""Find a serving configuration's capacity on the chip, once, when a cell's
rate is chosen: requests of the cell's traffic back to back, then windows
at fixed shares of that capacity, each with its completed rate and its
latency quantiles.

    python3 portbench/sweep.py --workload <serving cell> --seed <n> --seconds <s>

The benchmark's runs never call it: a cell offers the rate its traffic
file fixes.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--shares", default="0.6,0.7,0.8,0.9,1.0,1.2")
    args = p.parse_args()
    import numpy as np
    import torch

    from portbench import harness, workloads

    root = Path.cwd()
    harness.setup_environment(root)
    cell = harness.Cell(root, args.workload)
    harness.check_devices(cell.chips)
    run = workloads.make(cell, args.seed, torch.device("cuda", 0), harness.Spans())
    run.setup()
    out = []

    def window(rate):
        a = dict(cell.traffic["arrival"], rate_per_s=rate)
        run.traffic = dict(cell.traffic, arrival=a)
        run.due = run.arrivals()
        w = run.window(args.seconds)
        ms = w["latency_ms"]
        row = {"offered_per_s": rate, "completed_per_s": w["units"] / w["seconds"], "requests": w["units"],
               "p50_ms": float(np.percentile(ms, 50)), "p95_ms": float(np.percentile(ms, 95)),
               "queue_wait_ms": w["queue_wait_ms"]}
        out.append(row)
        print(json.dumps(row), file=sys.stderr)
        return row

    capacity = window(1e4)["completed_per_s"]
    for share in (float(s) for s in args.shares.split(",")):
        window(share * capacity)
    print(json.dumps({"workload": args.workload, "capacity_per_s": capacity, "device": torch.cuda.get_device_name(0),
                      "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
