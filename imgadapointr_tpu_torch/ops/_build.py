"""Build the port's CUDA kernels and call them through ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and linked into one shared library
with a plain C interface. The library is built at first use, into
``imgadapointr_tpu_torch/_build/<hash of the sources>/`` (listed in
``.gitignore``), and loaded with :mod:`ctypes`. Nothing here runs at import
time, so the CPU-only test environment imports this module freely.

Each C entry point takes raw device pointers and the CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0 and counts
the launch under the kernel's name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]
LIB_NAME = "libimgadapointr_kernels.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C entry point -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "gather_rows_f32": [_P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "knn_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "fps_f32": [_P, _P, _I64, _I64, _I64, _P],
    "nn_bidir_argmin_f32": [_P, _P, _P, _I64, _I64, _I64, _P],
    "scatter_add_rows_f32": [_P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "nn_one_direction_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "weighted_gather_sum_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "weighted_gather_sum_dfeats_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "weighted_gather_sum_dweights_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "auction_top2_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "three_nn_interpolate_f32": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_float, _P],
    "nn_bidir_mxu_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
}

# Launches per kernel since the last reset_launches(); launch() adds one
# each time it launches a kernel, and nothing else touches these counts.
KERNELS = ("nn_bidir_argmin", "knn", "fps", "gather_rows", "scatter_add_rows",
           "nn_one_direction", "weighted_gather_sum", "weighted_gather_sum_dfeats",
           "weighted_gather_sum_dweights", "auction_top2", "three_nn_interpolate",
           "nn_bidir_mxu")
_launches = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# C entry point -> its ctypes function, filled when the library loads
_entries: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def launches() -> dict[str, int]:
    return dict(_launches)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per file, in parallel) and link the
    shared library; returns its path. Reuses a finished build of the same
    sources."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in [p for p in _sources() if p.suffix == ".cu"]:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append(
                (src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ))
            )
        objs, failures = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{out}")
            objs.append(str(obj))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = tmp / LIB_NAME
        subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
            check=True, capture_output=True, text=True,
        )
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. The lock is taken
    only until the library has loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.kernels_error_string.argtypes = [ctypes.c_int]
                lib.kernels_error_string.restype = ctypes.c_char_p
                lib.fps_max_points.argtypes = []
                lib.fps_max_points.restype = ctypes.c_int64
                lib.auction_top2_chunks.argtypes = [_I64, _I64, _I64, _I64]
                lib.auction_top2_chunks.restype = ctypes.c_int64
                _lib = lib
                _entries.update((name, getattr(lib, name)) for name in _SIGNATURES)
    return _lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream; raise on a
    CUDA error and count one launch of ``kernel``. Each entry is resolved
    once, when the library loads; a device context is entered only when
    ``device`` is not the current device."""
    fn = _entries.get(entry)
    if fn is None:
        library()
        fn = _entries[entry]
    # the raw handle of the current stream, without building a
    # torch.cuda.Stream object (PyTorch's compiler reads it so)
    index, current = device.index, torch.cuda.current_device()
    if index is None or index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        msg = _lib.kernels_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
    _launches[kernel] += 1


def require_cuda_f32(name: str, device: torch.device, *tensors: torch.Tensor,
                     last_dim: int | None = None, ndim: int = 3) -> None:
    """Raise unless every tensor is what the kernels take: a contiguous
    float32 tensor on ``device`` with ``ndim`` dims (and last dim
    ``last_dim`` if given)."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if t.dim() != ndim or (last_dim is not None and t.shape[-1] != last_dim):
            raise ValueError(f"{name}: unexpected shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes a contiguous tensor")
