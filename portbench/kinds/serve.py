"""The ``serve`` kind: an open loop of requests of ``batch`` clouds from a
pool made at set-up, due at the times of the traffic's ``arrival`` process
(a fixed set of gaps, put in another order by the seed), each handed to the
device, completed by ``Runner.predict`` and copied back. The check compares
a sample, drawn from the seed, of the clouds the window served with the
plain reference's clouds of the same requests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare
from ..workloads import Run, free, sub_seed, sync, tf32


class Serve(Run):
    """An open loop of batched requests through ``Runner.predict``."""

    def setup_data(self):
        t = self.traffic
        n_pool = int(t["pool"])
        pool = self.samples(n_pool * self.batch, sub_seed(self.seed, 3))
        names = self.inputs
        self.requests = [{k: pool[k][i * self.batch:(i + 1) * self.batch] for k in names} for i in range(n_pool)]
        if self.device.type == "cuda":
            self.requests = [{k: v.pin_memory() for k, v in r.items()} for r in self.requests]
        self.order = np.random.default_rng(sub_seed(self.seed, 4)).integers(0, n_pool, 1 << 16)
        self.due = self.arrivals()

    def setup(self):
        with self.spans("setup_data"):
            self.setup_data()
        with self.spans("setup_program"):
            self.runner = self.build_runner()
        self.outputs = {}  # pool entry -> (request number, coarse, fine) of its latest service
        for i in range(int(self.traffic["warmup"])):
            self.serve(self.requests[i % len(self.requests)])
        sync(self.device)

    def arrivals(self) -> np.ndarray:
        """Due times (s from the window's start): a fixed set of gaps drawn
        from the traffic's own seed, in the run seed's order."""
        a = self.traffic["arrival"]
        n = int(a["requests"])
        rng = np.random.default_rng(int(a["gaps_seed"]))
        if a["process"] != "erlang":
            raise ValueError(f"arrival process {a['process']!r}")
        # a batch is due when the `shape`-th scan of a Poisson stream has arrived
        gaps = rng.gamma(float(a["shape"]), 1.0 / (float(a["shape"]) * float(a["rate_per_s"])), n)
        gaps = gaps[np.random.default_rng(sub_seed(self.seed, 5)).permutation(n)]
        return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])

    def serve(self, request: dict):
        spans = self.spans
        with spans("h2d"):
            batch = {k: v.to(self.device, non_blocking=True) for k, v in request.items()}
        with spans("predict"):
            coarse, fine = self.runner.predict(batch)
        with spans("d2h"):
            return coarse.cpu(), fine.cpu()

    def window(self, seconds: float) -> dict:
        lat, waits, n, t0 = [], [], 0, time.perf_counter()
        done = t0
        while True:
            now = time.perf_counter() - t0
            if now >= seconds or n >= len(self.due):
                break
            if self.due[n] > now:
                with self.spans("wait_for_arrival"):
                    time.sleep(self.due[n] - now)
            entry = int(self.order[n])
            waits.append(time.perf_counter() - t0 - self.due[n])
            coarse, fine = self.serve(self.requests[entry])
            done = time.perf_counter()
            lat.append(done - t0 - self.due[n])
            self.outputs[entry] = (n, coarse, fine)
            n += 1
        elapsed = done - t0
        ms = np.array(lat) * 1e3
        return {"seconds": elapsed, "units": n, "clouds": n * self.batch, "attempted": n, "failed": 0,
                "end_to_end": {"serve_clouds_per_s": n * self.batch / elapsed,
                               "serve_request_ms_p95": float(np.percentile(ms, 95))},
                "queue_wait_ms": float(np.mean(waits) * 1e3), "latency_ms": ms}

    def release(self) -> None:
        self.runner = None
        free()

    def picked(self, entries) -> list:
        k = min(int(self.traffic["checked_requests"]), len(entries))
        return [int(e) for e in np.random.default_rng(sub_seed(self.seed, 6)).choice(sorted(entries), size=k,
                                                                                   replace=False)]

    def reference_clouds(self, entry: int, model, control: bool = False):
        req = {key: v.to(self.device) for key, v in self.requests[entry].items()}
        inputs = [req[key] for key in self.inputs]
        with torch.no_grad(), tf32(control):
            return model(inputs[0], *inputs[1:])

    def check(self) -> dict:
        """The reference's clouds for a sample, drawn from the seed, of the
        pool entries the window served (each at its latest service)."""
        model = self.reference().eval()
        pairs = []
        for entry in self.picked(self.outputs):
            _, coarse, fine = self.outputs[entry]
            pairs.append((coarse.to(self.device), fine.to(self.device), *self.reference_clouds(entry, model)))
        del model
        free()
        return self.cloud_numbers(pairs)

    def cloud_numbers(self, pairs) -> dict:
        """The compared numbers of (coarse, fine, reference coarse, reference
        fine) quadruples; the other quantiles go to ``detail``."""
        q = {"coarse": [0.0] * (len(compare.QUANTILES) + 1), "fine": [0.0] * (len(compare.QUANTILES) + 1)}
        for c, f, rc, rf in pairs:
            for key, a, b in (("coarse", c, rc), ("fine", f, rf)):
                q[key] = [max(x, y) for x, y in zip(q[key], compare.nn_quantiles(a, b))]
        self.detail = {f"{k}_p50_p99_max_far": v for k, v in q.items()}
        p99 = compare.QUANTILES.index(0.99)
        return {"coarse_p99": q["coarse"][p99], "fine_p99": q["fine"][p99], "fine_far_share": q["fine"][-1]}

    def control(self) -> dict:
        """The reference in TF32 in the program's place: its numbers."""
        self.setup_data()
        model = self.reference().eval()
        pairs = [(*self.reference_clouds(e, model, control=True), *self.reference_clouds(e, model))
                 for e in self.picked(range(len(self.requests)))]
        del model
        free()
        return self.cloud_numbers(pairs)


KIND = Serve
