"""ctypes bindings of the port's native point-cloud reader
(``imgadapointr_tpu_torch/native/pcio.cpp``).

Counterpart of ``imgadapointr_tpu/datasets/native_io.py:28-106``. The
library is built at first use with ``g++ -O3 -std=c++17 -fPIC -shared
-pthread`` into ``imgadapointr_tpu_torch/_build/pcio-<hash of the source,
the compiler and the machine>/`` and loaded with ``ctypes.CDLL``, whose
calls release the GIL, so the loader's threads (``--worker_mode thread``)
read files in parallel. The build holds a file lock, so loader processes
or ranks that start together build it once; a tree copied to another
machine builds its own.

``IO.use_native`` (``utils/io_module.py``, on by default, as in the JAX
package) routes ``IO.get`` through it, in a loader's worker processes too.
There is no silent fallback, unlike JAX's: a failed build or load raises
with the compiler's message. A file variant the reader cannot parse
(:func:`read_cloud` returns None: a missing file, an ``.npy`` that is not
(N, 3) float32 or float64, a compressed PCD) goes to the Python parser for
that call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "pcio.cpp"
BUILD_ROOT = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
MAX_RAW_POINTS = 1 << 18  # load_batch's read buffer a cloud, as JAX's (GRNet's 64³ output fits)

_lock = threading.Lock()
_lib = None
_F32P = ctypes.POINTER(ctypes.c_float)


def _compiler(cxx: str) -> str:
    """The compiler's version banner; raises if it cannot be run."""
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} failed: cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed: {cxx} --version:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def build() -> Path:
    """Compile ``native/pcio.cpp`` (once per source, compiler and machine;
    under a file lock) and return the library's path. A tree copied to
    another machine builds its own. Raises with the compiler's output on
    failure."""
    cxx = os.environ.get("CXX", "g++")
    key = [SOURCE.read_bytes(), " ".join(CXX_FLAGS).encode(), _compiler(cxx).encode(), " ".join(os.uname()).encode()]
    digest = hashlib.sha256(b"\0".join(key)).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"pcio-{digest}"
    lib_path = out_dir / "libpcio.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # a second builder waits, then finds the library
        if not lib_path.exists():
            tmp = out_dir / f"libpcio.so.{os.getpid()}.tmp"
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE.name} failed ({cxx}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded reader, built on first use; raises if it cannot be built or loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                lib.pcio_read_cloud.restype = ctypes.c_int64
                lib.pcio_read_cloud.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64]
                lib.pcio_declared_points.restype = ctypes.c_int64
                lib.pcio_declared_points.argtypes = [ctypes.c_char_p]
                lib.pcio_load_batch.restype = ctypes.c_int64
                lib.pcio_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, _F32P,
                                                ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64]
                _lib = lib
    return _lib


def read_cloud(path: str) -> np.ndarray | None:
    """One cloud as (N, 3) float32, bit-equal to the port's Python parser;
    None where the reader cannot parse the file (the caller's parser then takes it)."""
    lib = library()
    raw = os.fsencode(path)
    capacity = MAX_RAW_POINTS
    while True:
        out = np.empty((capacity, 3), np.float32)
        n = lib.pcio_read_cloud(raw, out.ctypes.data_as(_F32P), capacity)
        if n != -2:
            break
        capacity = int(lib.pcio_declared_points(raw))  # a larger cloud: read it whole
    if n < 0:
        return None
    return out[:n].copy()


def load_batch(paths: list[str], n_points: int, seed: int) -> np.ndarray | None:
    """Parallel read and random sample (``RandomSamplePoints``: a shuffle
    by the file's seed, zero-padded) of a whole batch into (B, n_points, 3)
    float32, as JAX ``native_io.load_batch`` does; None if a file fails."""
    lib = library()
    B = len(paths)
    out = np.zeros((B, n_points, 3), np.float32)
    arr = (ctypes.c_char_p * B)(*[os.fsencode(p) for p in paths])
    ok = lib.pcio_load_batch(arr, B, out.ctypes.data_as(_F32P), n_points, seed & 0xFFFFFFFFFFFFFFFF,
                             MAX_RAW_POINTS)
    return out if ok == B else None
