#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero and prints no result line:

1. checks: a CUDA device, the card's name and power limit (nvidia-smi), and
   the build of every kernel in ``imgadapointr_tpu_torch/csrc``;
2. every kernel against its plain PyTorch version on the card, at each
   shape one serving request gives it, plus edge probes (identical clouds,
   dense sphere, all-equal points, out-of-range gather indices). Indices
   must be equal and values bit-equal (tolerance 0): each kernel repeats
   its plain version's arithmetic. Each kernel, its plain version and,
   where one PyTorch call computes the same function, that call are timed
   with CUDA events over one request's calls;
3. the serving path at full width: ``cfgs/PCN_models/AdaPoinTr.yaml`` with
   seeded weights answers ``REQUESTS`` requests of ``B`` synthetic PCN
   partial clouds (2048 points) with coarse (512) and fine (16384)
   clouds, scored by CD-L1, CD-L2 and F-Score against the 16384-point
   ground truth. The launch counts of that run must equal the calls the
   request table predicts, and one request is held against the same
   model run on the CPU through the plain versions.

Output: a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.datasets import SyntheticPCN
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.ops import _build
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from imgadapointr_tpu_torch.utils.metrics import eval_metric_suite

CONFIG = "cfgs/PCN_models/AdaPoinTr.yaml"
N_PARTIAL = 2048
B = 8  # clouds per request
REQUESTS = 3
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 outside the tensor cores (the kernels do no matrix products).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# operations per candidate pair: 3 subtracts, 3 multiplies, 2 adds, and
# one compare per direction the pair is ranked in
OPS_PAIR_ONE_WAY = 9
OPS_PAIR_BIDIR = 10

SOURCES = {
    "nn_bidir_argmin": ("imgadapointr_tpu_torch/csrc/nn_bidir_argmin.cu",
                        "imgadapointr_tpu/ops/pallas/nn_distance.py:194"),
    "knn": ("imgadapointr_tpu_torch/csrc/knn.cu",
            "imgadapointr_tpu/ops/pallas/nn_distance.py:498"),
    "fps": ("imgadapointr_tpu_torch/csrc/fps.cu",
            "imgadapointr_tpu/ops/pallas/fps.py:71"),
    "gather_rows": ("imgadapointr_tpu_torch/csrc/gather_rows.cu",
                    "imgadapointr_tpu/ops/pallas/gather_rows.py:179"),
}


def log(*a):
    print(*a, flush=True)


def request_calls(cfg) -> dict:
    """Each kernel's calls in one eval request plus its metrics, per batch
    element count, from the model config: knn (k, S, M), fps (N, npoint),
    gather_rows (M, C, S), nn_bidir_argmin (N, M)."""
    n1, n2 = (int(n) for n in cfg.center_num)
    nq, n_fine = int(cfg.num_query), int(cfg.num_points)
    enc, dec = cfg.encoder_config, cfg.decoder_config
    C, ke, kd, kg = int(enc.embed_dim), int(enc.k), int(dec.k), 16
    n_cand = nq + nq // 2  # coarse_pred queries + FPS seeds, before ranking
    N = N_PARTIAL
    knn = [(kg, N, N), (kg, n1, N), (kg, n1, n1), (kg, n2, n1),  # grouper
           (ke, n2, n2),  # encoder, shared by the stack
           (kd, nq, nq), (kd, nq, n2)]  # decoder self and cross
    fps = [(N, n1), (n1, n2), (N, nq // 2)]
    gather = [
        (N, 8, N * kg), (N, 3, n1), (N, 32, n1), (N, 32, n1 * kg),  # grouper 1-2
        (n1, 64, n1 * kg), (n1, 3, n2), (n1, 64, n2), (n1, 64, n2 * kg),  # 3-4
        (N, 3, nq // 2), (n_cand, 3, nq),  # query seeds, ranking
    ]
    gather += [(n2, C, n2 * ke)] * sum("graph" in s for s in enc.block_style_list)
    gather += [(nq, C, nq * kd)] * sum("graph" in s for s in dec.self_attn_block_style_list)
    gather += [(n2, C, nq * kd)] * sum("graph" in s for s in dec.cross_attn_block_style_list)
    gather += [(n_fine, 3, n_fine)] * 2  # metric residuals, both directions
    return {"knn": knn, "fps": fps, "gather_rows": gather,
            "nn_bidir_argmin": [(n_fine, n_fine)]}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sphere(g, b, n, dev):
    v = torch.randn(b, n, 3, generator=g, dtype=torch.float64)
    return (0.5 * v / v.norm(dim=-1, keepdim=True)).float().to(dev)


# ------------------------------------------------------------ phase 2 checks


def check_knn(calls, g, dev):
    inputs = [(k, torch.randn(B, M, 3, generator=g).to(dev), torch.randn(B, S, 3, generator=g).to(dev))
              for k, S, M in calls]
    err = 0.0
    for k, ref, q in inputs:
        d, i = ops.knn_with_distance(k, ref, q)
        pd, pi = ops.knn_plain(k, ref, q)
        require(torch.equal(i, pi), f"knn k={k} {tuple(q.shape)}x{tuple(ref.shape)}: indices differ")
        err = max(err, float((d - pd).abs().max()))
    require(err == 0.0, f"knn distances differ by {err}")
    t = {
        "ms": cuda_ms(lambda: [ops.knn_with_distance(k, r, q) for k, r, q in inputs], 20),
        "plain_ms": cuda_ms(lambda: [ops.knn_plain(k, r, q) for k, r, q in inputs], 5),
        "library_ms": cuda_ms(lambda: [torch.cdist(q, r).topk(k, largest=False) for k, r, q in inputs], 20),
    }
    pairs = sum(B * S * M for _, S, M in calls)
    nbytes = sum(B * (S + M) * 12 + B * S * k * 12 for k, S, M in calls)
    return err, t, pairs * OPS_PAIR_ONE_WAY, nbytes


def check_fps(calls, g, dev):
    inputs = [(torch.randn(B, N, 3, generator=g).to(dev), n) for N, n in calls]
    err = 0.0
    for xyz, n in inputs:
        diff = ops.furthest_point_sample(xyz, n) - ops.fps_plain(xyz, n)
        err = max(err, float(diff.abs().max()))
        require(err == 0.0, f"fps {tuple(xyz.shape)}->{n}: picks differ")
    same = torch.ones(B, N_PARTIAL, 3, device=dev) * 0.25
    require(torch.equal(ops.furthest_point_sample(same, 512),
                        torch.zeros(B, 512, dtype=torch.int64, device=dev)),
            "fps on identical points must pick index 0 throughout")
    t = {
        "ms": cuda_ms(lambda: [ops.furthest_point_sample(x, n) for x, n in inputs], 20),
        "plain_ms": cuda_ms(lambda: [ops.fps_plain(x, n) for x, n in inputs], 2),
        "library_ms": None,
    }
    # every step folds N distances into the cache and takes their argmax
    n_ops = sum(B * (n - 1) * N * (OPS_PAIR_ONE_WAY + 1) for N, n in calls)
    nbytes = sum(B * (N * 12 + n * 8) for N, n in calls)
    log(f"phase 2: fps runs {sum(n - 1 for _, n in calls)} dependent steps per request")
    return err, t, n_ops, nbytes


def check_gather(calls, g, dev):
    inputs = []
    for M, C, S in calls:
        table = torch.randn(B, M, C, generator=g).to(dev)
        idx = torch.randint(0, M, (B, S), generator=g).to(dev)
        inputs.append((table, idx))
    for M, C, S in ((2048, 3, 4096), (512, 64, 8192), (512, 384, 4096)):  # clamp probes
        table = torch.randn(B, M, C, generator=g).to(dev)
        idx = torch.randint(-4, M + 4, (B, S), generator=g).to(dev)
        idx[:, :3] = torch.tensor([-1, M, M + 10**6])
        got = ops.gather_rows(table, idx)
        require(torch.equal(got, ops.gather_rows_plain(table, idx)), f"gather clamp C={C}: differs")
        require(torch.equal(got[:, 0], table[:, 0]) and torch.equal(got[:, 2], table[:, M - 1]),
                f"gather clamp C={C}: out-of-range rows not clamped")
    err = 0.0
    for table, idx in inputs:
        got = ops.gather_rows(table, idx)
        err = max(err, float((got - ops.gather_rows_plain(table, idx)).abs().max()))
        require(err == 0.0, f"gather {tuple(table.shape)} S={idx.shape[1]}: values differ")
    rows = [torch.arange(B, device=dev)[:, None] for _ in inputs]
    t = {
        "ms": cuda_ms(lambda: [ops.gather_rows(tb, i) for tb, i in inputs], 50),
        "plain_ms": cuda_ms(lambda: [ops.gather_rows_plain(tb, i) for tb, i in inputs], 50),
        "library_ms": cuda_ms(lambda: [tb[r, i] for (tb, i), r in zip(inputs, rows)], 50),
    }
    nbytes = 0
    for table, idx in inputs:  # each row the indices name read once; indices read, rows written
        rows = sum(torch.unique(ix).numel() for ix in idx)
        nbytes += rows * table.shape[-1] * 4 + idx.numel() * (8 + table.shape[-1] * 4)
    return err, t, 0, nbytes


def check_bidir(calls, g, dev):
    (N, M), = calls
    x, y = torch.randn(B, N, 3, generator=g).to(dev), torch.randn(B, M, 3, generator=g).to(dev)
    i1, i2 = ops.nn_bidir_argmin(x, y)
    p1, p2 = ops.nn_bidir_argmin_plain(x, y)
    err = float(max((i1 - p1).abs().max(), (i2 - p2).abs().max()))
    require(err == 0.0, "nn_bidir_argmin random: indices differ")
    s1, s2 = sphere(g, 2, N, dev), sphere(g, 2, M, dev)
    i1, i2 = ops.nn_bidir_argmin(s1, s2)
    p1, p2 = ops.nn_bidir_argmin_plain(s1, s2)
    require(torch.equal(i1, p1) and torch.equal(i2, p2), "nn_bidir_argmin sphere: indices differ")
    same = torch.randn(2, N, 3, generator=g).to(dev)
    i1, i2 = ops.nn_bidir_argmin(same, same.clone())
    ident = torch.arange(N, device=dev).expand(2, N)
    require(torch.equal(i1, ident) and torch.equal(i2, ident), "identical clouds: argmin is not the identity")
    cd = float(ops.chamfer_l1(same, same.clone()))
    require(cd < 1e-9, f"identical clouds: CD-L1 {cd}")
    t = {
        "ms": cuda_ms(lambda: ops.nn_bidir_argmin(x, y), 10),
        "plain_ms": cuda_ms(lambda: ops.nn_bidir_argmin_plain(x, y), 1),
        "library_ms": None,
    }
    return err, t, B * N * M * OPS_PAIR_BIDIR, B * (N + M) * 12 + B * (N + M) * 8


# ------------------------------------------------------------- phase 3 path


def serve(model, cfg, batches, dev):
    """Answer each request; returns per-request seconds and the metrics."""
    secs, scores = [], []
    n_fine, nq = int(cfg.num_points), int(cfg.num_query)
    for partial, gt in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = torch.from_numpy(partial).to(dev)
            coarse, fine = model(x)
            f, l1, l2 = eval_metric_suite(fine, torch.from_numpy(gt).to(dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        n = partial.shape[0]
        require(tuple(coarse.shape) == (n, nq, 3), f"coarse shape {tuple(coarse.shape)}")
        require(tuple(fine.shape) == (n, n_fine, 3), f"fine shape {tuple(fine.shape)}")
        require(bool(torch.isfinite(coarse).all() and torch.isfinite(fine).all()), "non-finite output")
        scores.append((float(f), float(l1), float(l2)))
    return secs, scores


def cpu_agreement(model, cpu_model, partial, gt, dev) -> dict:
    """The card's answer to one cloud against the CPU's (same weights).

    Near-tied ranking scores (all about 0.5 at a random init) may be
    ordered differently on the two devices, which permutes the queries and
    their patches but not the clouds as sets; so the clouds are compared
    as sets: the share of points of each with a counterpart in the other
    within 1e-4 (float32 rounding through 14 blocks is far below that)."""
    with torch.inference_mode():
        gc, gf = model(torch.from_numpy(partial).to(dev))
        cc, cf = cpu_model(torch.from_numpy(partial))
        out = {}
        for name, a, b in (("coarse", gc, cc.to(dev)), ("fine", gf, cf.to(dev))):
            d1, d2, _, _ = ops.nn_distance_eval(a, b)
            out[f"{name}_matched"] = float(min((d1 < 1e-8).float().mean(), (d2 < 1e-8).float().mean()))
            out[f"{name}_hausdorff"] = float(max(d1.max(), d2.max()).sqrt())
        out["cd_l1_card"] = float(eval_metric_suite(gf, torch.from_numpy(gt).to(dev))[1])
        out["cd_l1_cpu"] = float(eval_metric_suite(cf, torch.from_numpy(gt))[1])
    return out


def profile_request(model, cfg, batch, dev) -> dict:
    """Device time of one request by kernel name (torch.profiler), the
    four ported kernels' share of it, and the device's idle share of the
    request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs, _ = serve(model, cfg, [batch], dev)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured: the profiler saw no device activity"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals, in us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total = sum(by_name.values())
    ours = sum(v for k, v in by_name.items() if any(n in k for n in ("nn_bidir", "knn_kernel", "fps_kernel", "gather_rows")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms": secs[0] * 1e3, "device_busy_ms": busy / 1e3, "kernel_sum_ms": total / 1e3,
        "idle_share": 1.0 - busy / 1e3 / (secs[0] * 1e3),
        "ported_kernels_share": ours / total, "launches": len(kernels),
        "top": [[k[:80], v / 1e3] for k, v in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # ---- phase 1: checks
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the port's numerics are fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: built {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.1f} s "
        f"({_build.build()})")

    # ---- phase 2: each kernel against its plain version
    cfg = cfg_from_yaml_file(CONFIG).model
    calls = request_calls(cfg)
    g = torch.Generator().manual_seed(args.seed)
    checks = {"knn": check_knn, "fps": check_fps, "gather_rows": check_gather,
              "nn_bidir_argmin": check_bidir}
    results = {}
    for name, check in checks.items():
        results[name] = err, t, _, _ = check(calls[name], g, dev)
        log(f"phase 2: {name}: equal to plain over {len(calls[name])} request shapes "
            f"and probes; per request {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']})")

    # ---- phase 3: the serving path at full width
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 3: {CONFIG} built on {dev}, {n_params} parameters, {time.perf_counter() - t0:.1f} s")
    data = SyntheticPCN({"N_POINTS": int(cfg.num_points), "N_PARTIAL": N_PARTIAL,
                         "LENGTH": B * (REQUESTS + 1), "SEED": args.seed,
                         "others": {"subset": "test"}})
    samples = [data.get(i, None)[2] for i in range(len(data))]
    batches = [
        (np.stack([s["partial"] for s in samples[r * B:(r + 1) * B]]),
         np.stack([s["gt"] for s in samples[r * B:(r + 1) * B]]))
        for r in range(REQUESTS + 1)
    ]
    serve(model, cfg, batches[:1], dev)  # warm-up request (cuBLAS handles, caches)
    _build.reset_launches()
    secs, scores = serve(model, cfg, batches[1:], dev)
    launches = _build.launches()
    for name in _build.KERNELS:
        want = len(calls[name]) * REQUESTS
        require(launches[name] == want,
                f"{name}: {launches[name]} launches on the main path, request table says {want}")
    for r, (s, (f, l1, l2)) in enumerate(zip(secs, scores)):
        log(f"phase 3: request {r}: {B}x{N_PARTIAL} -> {B}x{int(cfg.num_points)} in {s * 1e3:.1f} ms; "
            f"CD-L1 {l1:.4f} CD-L2 {l2:.4f} F@0.01 {f:.4f} (x1000 for CD)")
    log(f"phase 3: median request {statistics.median(secs) * 1e3:.1f} ms on {card}; "
        f"launches per request {json.dumps({k: v // REQUESTS for k, v in launches.items()})}")

    # one request against the same weights on the CPU, plain versions throughout
    agree = cpu_agreement(model, build_model(cfg, device="cpu", seed=args.seed),
                          batches[1][0][:1], batches[1][1][:1], dev)
    log("phase 3: card vs CPU on one cloud: " + json.dumps(agree))
    require(min(agree["coarse_matched"], agree["fine_matched"]) >= 0.99,
            "the card's clouds disagree with the CPU's")
    require(abs(agree["cd_l1_card"] - agree["cd_l1_cpu"]) <= 1e-2 * agree["cd_l1_cpu"],
            "the card's CD-L1 disagrees with the CPU's")
    log("phase 3: one profiled request: " + json.dumps(profile_request(model, cfg, batches[1], dev)))

    kernels = []
    for name in _build.KERNELS:
        err, t, n_ops, nbytes = results[name]
        op_ms, byte_ms = n_ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "launches_per_request": launches[name] // REQUESTS,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
