"""The control of a cell's correctness check, on the chip: the plain
reference put in the program's place and computed in TF32 (the nearest
precision below the configuration's float32), compared with the reference
in full float32 by the cell's own numbers. Its readings are each limit's
upper reading; the program's runs give the lower one (``PERF.md``).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3

It reads the same inputs and weights a run of that seed makes, at the
cell's own sizes. The benchmark's runs never call it.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args()
    import torch

    from portbench import harness, workloads

    root = Path.cwd()
    harness.setup_environment(root)
    cell = harness.Cell(root, args.workload)
    harness.check_devices(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = workloads.make(cell, seed, torch.device("cuda", 0), harness.Spans())
        values = run.control()
        print(json.dumps({"workload": cell.name, "seed": seed, "control": values, "detail": run.detail,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
