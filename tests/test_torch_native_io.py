"""The port's native point-cloud reader (``datasets/native_io.py`` over
``imgadapointr_tpu_torch/native/pcio.cpp``) on the CPU.

- Bit-equal to the port's Python parsers (``IO.use_native = False``) on
  binary and ASCII ``.pcd``, binary and ASCII ``.ply`` (also with a face
  element after the vertices) and float32 / float64 ``.npy``, on values
  across 40 binades written in four text forms (``repr``, 17 and 6
  digits, 3-digit exponents): the ASCII values go through ``strtod`` and
  one rounding to float, as numpy parses them.
- ``IO.get`` with ``IO.use_native`` set takes the native path for those
  three formats, and the Python parser for a file the reader refuses (an
  ``.npy`` of another shape), with the same result either way.
- ``load_batch`` equals the JAX package's ``native_io.load_batch`` on the
  same files and seed, bit for bit; a missing file gives None from
  ``read_cloud`` and from ``load_batch``.
- A failed build raises with the compiler's message (no silent fallback).
- ``IO.use_native`` is on by default, as in the JAX package (the native
  reader answers).
"""

import os

import numpy as np
import pytest

from imgadapointr_tpu_torch.datasets import native_io
from imgadapointr_tpu_torch.utils.io_module import IO

FORMATS = {"repr": repr, "g17": lambda v: "%.17g" % v, "f6": lambda v: "%.6f" % v, "e3": lambda v: "%.3e" % v}


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(0)
    return (rng.randn(700, 3) * np.exp(rng.uniform(-14, 14, (700, 3)))).astype(np.float32)


def _ascii_pcd(path, pts, fmt):
    with open(path, "w") as f:
        f.write(f"# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(pts)}\nDATA ascii\n")
        for p in pts:
            f.write(" ".join(fmt(float(v)) for v in p) + "\n")


def _ascii_ply(path, pts, fmt, faces: bool):
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\nproperty float x\nproperty float y\n"
                "property float z\n" + ("element face 2\nproperty list uchar int vertex_indices\n" if faces else "")
                + "end_header\n")
        for p in pts:
            f.write(" ".join(fmt(float(v)) for v in p) + "\n")
        if faces:
            f.write("3 0 1 2\n3 2 3 4\n")


def _binary_ply_with_faces(path, pts):
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\nproperty float x\n"
                 "property float y\nproperty float z\nelement face 1\nproperty list uchar int vertex_indices\n"
                 "end_header\n").encode())
        f.write(np.ascontiguousarray(pts, "<f4").tobytes())
        f.write(bytes([3]) + np.array([0, 1, 2], "<i4").tobytes())


def _files(tmp, pts):
    """(path, what) of every variant the reader takes."""
    out = []
    p = os.path.join(tmp, "bin.pcd")
    IO.put(p, pts)
    out.append((p, "binary pcd"))
    p = os.path.join(tmp, "bin.ply")
    IO.put(p, pts)
    out.append((p, "binary ply"))
    p = os.path.join(tmp, "faces.ply")
    _binary_ply_with_faces(p, pts)
    out.append((p, "binary ply with faces"))
    for name, fmt in FORMATS.items():
        p = os.path.join(tmp, f"a_{name}.pcd")
        _ascii_pcd(p, pts, fmt)
        out.append((p, f"ascii pcd {name}"))
        for faces in (False, True):
            p = os.path.join(tmp, f"a_{name}_{faces}.ply")
            _ascii_ply(p, pts, fmt, faces)
            out.append((p, f"ascii ply {name} faces={faces}"))
    for dtype in (np.float32, np.float64):
        p = os.path.join(tmp, f"c_{np.dtype(dtype).name}.npy")
        np.save(p, pts.astype(dtype) * (1 + 1e-9 if dtype == np.float64 else 1))
        out.append((p, f"npy {np.dtype(dtype).name}"))
    return out


def _python(path):
    prev, IO.use_native = IO.use_native, False
    try:
        return IO.get(path)
    finally:
        IO.use_native = prev


def test_native_reader_is_bit_equal_to_the_python_parsers(tmp_path, cloud, monkeypatch):
    monkeypatch.setattr(IO, "use_native", True)
    for path, what in _files(str(tmp_path), cloud):
        got = native_io.read_cloud(path)
        assert got is not None, what
        want = _python(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == cloud.shape, what
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)
        assert np.array_equal(IO.get(path).view(np.uint32), want.view(np.uint32)), what


def test_refused_variants_take_the_python_parser(tmp_path, cloud, monkeypatch):
    """An .npy that is not (N, 3) is refused by the reader (None) and read by
    the Python parser through ``IO.get``; a missing file gives None."""
    calls = []
    real = native_io.read_cloud
    monkeypatch.setattr(native_io, "read_cloud", lambda p: calls.append(p) or real(p))
    monkeypatch.setattr(IO, "use_native", True)
    for arr in (cloud[:, :2], np.concatenate([cloud, cloud], 1), cloud[:, 0]):
        p = str(tmp_path / f"v{arr.ndim}_{arr.shape[-1]}.npy")
        np.save(p, arr)
        assert real(p) is None
        np.testing.assert_array_equal(IO.get(p), arr)
    assert len(calls) == 3
    assert real(str(tmp_path / "missing.pcd")) is None
    with pytest.raises(FileNotFoundError):
        IO.get(str(tmp_path / "missing.pcd"))


def test_large_cloud_is_read_whole(tmp_path):
    """A cloud past the first buffer (2^18 points) is read whole, not cut."""
    pts = np.random.RandomState(1).rand(native_io.MAX_RAW_POINTS + 5, 3).astype(np.float32)
    p = str(tmp_path / "big.pcd")
    IO.put(p, pts)
    np.testing.assert_array_equal(native_io.read_cloud(p), pts)


def test_load_batch_matches_jax(tmp_path, cloud):
    from imgadapointr_tpu.datasets import native_io as jax_native_io

    if jax_native_io.get_lib() is None:
        pytest.fail("the JAX package's native reader did not build")
    paths = []
    for i, n in enumerate((700, 300, 2048)):
        p = str(tmp_path / f"b{i}.pcd")
        IO.put(p, np.resize(cloud, (n, 3)))
        paths.append(p)
    for n_points, seed in ((512, 3), (1024, 2**40 + 7)):
        got = native_io.load_batch(paths, n_points, seed)
        want = jax_native_io.load_batch(paths, n_points, seed)
        assert got.shape == (3, n_points, 3)
        np.testing.assert_array_equal(got, want)
    assert native_io.load_batch(paths + [str(tmp_path / "missing.pcd")], 64, 0) is None


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "pcio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_io, "SOURCE", bad)
    monkeypatch.setattr(native_io, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed"):
        native_io.build()



def test_native_reader_is_on_by_default(tmp_path, cloud, monkeypatch):
    """``IO.get`` reads ``.pcd``, ``.ply`` and ``.npy`` with the native reader
    unless ``IO.use_native`` is cleared, as the JAX package does."""
    assert IO.use_native is True
    calls = []
    real = native_io.read_cloud
    monkeypatch.setattr(native_io, "read_cloud", lambda p: calls.append(p) or real(p))
    paths = [str(tmp_path / f"d.{ext}") for ext in ("pcd", "ply", "npy")]
    for p in paths:
        IO.put(p, cloud)
        np.testing.assert_array_equal(IO.get(p), cloud)
    assert calls == paths


def test_worker_processes_read_with_the_loaders_reader(monkeypatch):
    """A loader's worker processes take the ``IO.use_native`` it was made
    under (a class attribute, which a new process does not inherit)."""
    from imgadapointr_tpu_torch.datasets.loader import Loader

    for flag in (True, False):
        monkeypatch.setattr(IO, "use_native", flag)
        loader = Loader(list(range(4)), batch_size=2, shuffle=False, drop_last=False, num_workers=2,
                        worker_mode="process")
        monkeypatch.setattr(IO, "use_native", not flag)
        loader.worker_init_fn(0)
        assert IO.use_native is flag
        assert Loader(list(range(4)), batch_size=2, shuffle=False, drop_last=False).worker_init_fn is None
