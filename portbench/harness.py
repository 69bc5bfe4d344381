"""The harness's general parts: the cell's files found by name, the run's
environment, the chip check, the benchmark's spans, the per-layer readers,
the guard against JAX, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. Each
lives in a file of its own under ``portbench/``: ``configs/<config>.json``
(the model configuration as it is run), ``traffic/<traffic>.json`` (the
parameters the general generator of :mod:`portbench.workloads` reads),
``limits/<cell>.json`` (each compared number's limit) and
``metrics/<metric>.py`` (a reader with a ``read(readings)`` function; a
metric ``<base>.<suffix>`` without a file of its own uses ``<base>.py``).
The traffic's ``kind`` and the configuration's model name the code that
reads them (:mod:`portbench.workloads`). A later cell, configuration or
metric is new files and entries only.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "imgadapointr_tpu", "chip_smoke")
CACHE = ".portbench_cache"  # inside the checkout, at a fixed path


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and metric declarations."""

    def __init__(self, root: Path, name: str):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = by_name[name]
        self.name, self.chips = name, int(w["chips"])
        self.cache_dir = str(root / CACHE)  # the data a checkout's first run writes for the later ones
        cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
        self.config = json.loads((root / cfg["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        limits = HERE / "limits" / f"{name}.json"
        # {"limits": {number: limit}, "not_compared": {number: why}, and the readings each was set from}
        spec = json.loads(limits.read_text()) if limits.exists() else {}
        self.limits, self.not_compared = spec.get("limits", {}), spec.get("not_compared", {})

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def setup_environment(root: Path) -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    cache = root / CACHE
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def check_devices(chips: int):
    """The device count and name, or exit 2 without a result."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        raise SystemExit(2)
    return torch.cuda.get_device_name(0)


def jax_guard() -> None:
    """Exit 3 without a result when a forbidden package is loaded, compared
    by whole top-level module names."""
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        raise SystemExit(3)


class Spans:
    """The benchmark's own spans around its calls into the port: host
    seconds summed by name, and, while ``recording`` (the traced stretch),
    each span's interval on the trace's clock (``time.time_ns``), which
    labels the trace's idle gaps and gives the host time of a traced unit."""

    def __init__(self):
        self.seconds: dict = {}
        self.intervals: list = []
        self.recording = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t, a = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t
            if self.recording:
                self.intervals.append((a, time.time_ns(), name))

    def recorded_seconds(self, name: str) -> float:
        return sum(b - a for a, b, n in self.intervals if n == name) / 1e9


class Readings:
    """What a per-layer reader may read of a traced run: the trace's
    reduction (:func:`portbench.reference.profile.reduce`) and the port's
    launches with their arguments over the traced stretch, the benchmark's
    spans, what the traced stretch returned (its units of work, steps or
    requests, and its clouds), what the untraced stretch before it returned
    (``rate``, None where the run was too short for one), the model FLOPs a
    cloud and the window's peak memory.

    The profiler slows the host, so a reading of the host's pace (a rate,
    ``mfu``, the idle share) takes its time from the untraced stretch, and
    the trace gives what the device did (busy time, operations by name,
    launches)."""

    F32_PEAK = "67 TFLOP/s float32 (H100 SXM)"
    ROOFLINE_PEAKS = "3.35 TB/s HBM3, 67 TFLOP/s float32, 989 TFLOP/s bf16 tensor cores (H100 SXM)"

    def __init__(self, profile: dict, launches: list, spans: Spans, window: dict, rate: dict | None,
                 flops_per_cloud: float, peak_bytes: int):
        self.profile, self.launches, self.spans, self.window, self.rate = profile, launches, spans, window, rate
        self.units, self.clouds = window["units"], window["clouds"]
        self.flops_per_cloud, self.peak_bytes = flops_per_cloud, peak_bytes

    def idle_pct(self) -> float:
        """Share of the time with no device operation: the device's busy
        seconds a unit (trace) over the untraced stretch's seconds a unit
        (the trace's own recording slows the host-paced steps about a fifth),
        or over the traced stretch's where there was no untraced one."""
        p, r = self.profile, self.rate
        if r and r["units"] and self.units:
            return 100.0 * (1.0 - (p["busy_s"] / self.units) / (r["seconds"] / r["units"]))
        return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

    def device_seconds(self, pred) -> float:
        return sum(s for name, s in self.profile["by_name"].items() if pred(name))

    def kernels_roofline_pct(self):
        """Σ least time of the port's kernel calls over Σ their device time,
        both over the kernels whose bound is known, with the peaks; None
        without such calls."""
        from .reference import bounds

        least, kernels = 0.0, set()
        for kernel, entry, args in self.launches:
            w = bounds.work(entry, args)
            if w is None:
                continue
            least += bounds.least_seconds(*w)
            kernels.add(kernel)
        spent = self.device_seconds(lambda n: bounds.kernel_of(n) in kernels)
        if not kernels or spent <= 0:
            return None
        return {"value": 100.0 * least / spent, "peak": self.ROOFLINE_PEAKS}

    def mfu_pct(self):
        """Model FLOPs of the untraced stretch's clouds over its seconds times
        the float32 peak, with the peak; None without an untraced stretch."""
        from .reference import bounds

        r = self.rate
        if not r or r["seconds"] <= 0 or not r["clouds"]:
            return None
        return {"value": 100.0 * r["clouds"] * self.flops_per_cloud / (r["seconds"] * bounds.PEAK_F32),
                "peak": self.F32_PEAK}


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``, or of
    ``metrics/<base>.py`` for a metric ``<base>.<suffix>`` without a file of
    its own (the suffix names the end-to-end metric the reading moves)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it (a card set below
    its maximum runs slower under load), or None where it cannot."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def shares_over_100(metrics: dict) -> list:
    """The shares of a peak (entries that name their ``peak``) above 100 %:
    an error of the count, never a reading."""
    return [f"{k} {m['value']!r} % of {m['peak']}" for k, m in metrics.items() if "peak" in m and m["value"] > 100]


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()


def emit(result: dict, checks: dict) -> None:
    """The compared numbers and their limits as the last lines of standard
    error, then the result line, ``checks`` its last key."""
    print_checks(checks)
    line = dict(result, checks=checks)
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
