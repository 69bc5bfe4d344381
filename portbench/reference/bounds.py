"""The least time the chip needs for each call of the port's kernels, from
the call's shapes, against the published peaks of one H100 SXM.

Frozen copy of ``chip_smoke.py``'s bound arithmetic (``PEAK_BYTES``,
``PEAK_F32``, ``PEAK_BF16_TC``, ``OPS_PAIR_ONE_WAY``, ``OPS_PAIR_BIDIR``,
the per-kernel bytes), keyed by the C entry point and the integer
arguments ``imgadapointr_tpu_torch/ops/_build.py:launch`` passes it. Each
input byte is read once and each output byte written once; a gather reads
no more table rows than it writes. The estimated issue-slot and latency
floors of kNN and FPS are not used.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores
PEAK_BF16_TC = 989e12  # dense bf16 tensor-core FLOP/s
OPS_PAIR_ONE_WAY = 9  # 3 subtracts, 3 multiplies, 2 adds, a compare
OPS_PAIR_BIDIR = 10  # ... and a compare for the other direction

# the CUDA functions each kernel of the port launches, as the profiler names them
KERNEL_FUNCTIONS = {
    "knn": ("knn_kernel", "knn_merge_kernel"),
    "fps": ("fps_kernel",),
    "gather_rows": ("gather_rows_kernel",),
    "scatter_add_rows": ("scatter_add_rows_kernel",),
    "nn_bidir_argmin": ("nn_bidir_kernel",),
    "nn_one_direction": ("nn_one_direction_kernel", "nn_one_direction_init", "nn_one_direction_unpack"),
    "weighted_gather_sum": ("weighted_gather_sum_kernel",),
    "weighted_gather_sum_dfeats": ("dfeats_kernel",),
    "weighted_gather_sum_dweights": ("dweights_kernel",),
    "auction_top2": ("auction_top2_chunk_kernel", "auction_top2_merge_kernel"),
    "three_nn_interpolate": ("three_nn_interp_kernel",),
    "nn_bidir_mxu": ("nn_bidir_mxu_kernel", "nn_bidir_mxu_init", "nn_bidir_mxu_unpack"),
}


def kernel_of(function_name: str) -> str | None:
    """The port kernel whose CUDA function the profiler named, else None."""
    head = function_name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    ident = head[-1].split("::")[-1] if head else ""
    for kernel, fns in KERNEL_FUNCTIONS.items():
        if ident in fns or any(ident == f + "_unpack" for f in fns):
            return kernel
    return None


def _ints(args) -> list:
    return [a for a in args if isinstance(a, int) and not isinstance(a, bool)]


def work(entry: str, args) -> tuple | None:
    """(bytes, float32 operations) of one call of C entry ``entry`` with the
    arguments ``launch`` passed it (pointers as ints or None, then the
    sizes), or None for an entry with no bound here."""
    n = _ints(args)
    if entry == "knn_f32":  # xyz, new_xyz, dist, idx, [part], B, M, S, k, chunks
        B, M, S, k = n[-5:-1]
        return 12 * B * (M + S) + 12 * B * S * k, OPS_PAIR_ONE_WAY * B * S * M
    if entry == "fps_f32":  # xyz, out, B, N, npoint
        B, N, npoint = n[-3:]
        return 12 * B * N + 8 * B * npoint, (OPS_PAIR_ONE_WAY + 1) * B * (npoint - 1) * N
    if entry == "gather_rows_f32":  # table, idx, out, B, M, S, C
        B, M, S, C = n[-4:]
        return 8 * B * S + 4 * B * S * C + 4 * B * min(M, S) * C, 0
    if entry == "scatter_add_rows_f32":  # vals, idx, out, [scratch], B, S, n_rows, C
        B, S, rows, C = n[-4:]
        return 4 * B * S * C + 8 * B * S + 4 * B * rows * C, B * S * C
    if entry == "nn_bidir_argmin_f32":  # x, y, out, B, N, M
        B, N, M = n[-3:]
        return 20 * B * (N + M), OPS_PAIR_BIDIR * B * N * M
    if entry == "nn_one_direction_f32":  # x, y, [wy], idx, B, N, M
        B, N, M = n[-3:]
        weights = 4 * B * M if args[2] is not None else 0
        return 12 * B * (N + M) + weights + 8 * B * N, OPS_PAIR_ONE_WAY * B * N * M
    if entry == "weighted_gather_sum_f32":  # w, idx, feats, out, B, S, K, M, C
        B, S, K, M, C = n[-5:]
        return 12 * B * S * K + 4 * B * min(M, S * K) * C + 4 * B * S * C, 2 * B * S * K * C
    if entry == "weighted_gather_sum_dfeats_f32":  # w, idx, g, out, [scratch], B, S, K, rows, C, groups
        B, S, K, rows, C = n[-6:-1]
        return 12 * B * S * K + 4 * B * S * C + 4 * B * rows * C, 2 * B * S * K * C
    if entry == "weighted_gather_sum_dweights_f32":  # idx, g, feats, out, B, S, K, M, C
        B, S, K, M, C = n[-5:]
        return 12 * B * S * K + 4 * B * S * C + 4 * B * min(M, S * K) * C, 2 * B * S * K * C
    return None


def least_seconds(nbytes: float, f32_ops: float) -> float:
    return max(nbytes / PEAK_BYTES, f32_ops / PEAK_F32)
