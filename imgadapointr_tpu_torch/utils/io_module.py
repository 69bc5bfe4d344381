"""Point-cloud file IO: ``.npy``, ``.npz``, ``.pcd``, ``.ply``, ``.h5`` and
``.txt`` / ``.dat`` / ``.xyz``.

The port's own copy of the pure-Python parsers of
``imgadapointr_tpu/utils/io_module.py:55-167`` (ASCII and binary ``.pcd``,
ASCII and binary little-endian ``.ply``), so that a file reads into the same
float32 array in both packages. With ``IO.use_native`` set, as it is by
default in both packages, ``.pcd``, ``.ply`` and ``.npy`` go through the
port's native reader (``datasets/native_io.py``, a ctypes call that
releases the GIL); a file it cannot parse goes to these parsers, which it
matches bit for bit. Unlike JAX's, a reader that fails to build raises.
``.h5`` goes through ``utils/hdf5.py`` (numpy, ``struct`` and ``zlib``;
no h5py). Unlike the JAX parser, the ``.ply`` reader keeps the vertex
properties when another element (a mesh's faces) follows them.
:meth:`IO.put` writes every format :meth:`IO.get` reads: ``.pcd`` in the
binary layout the PCN dataset ships, ``.npz`` under the key ``pts``,
``.h5`` under the key ``data`` in the layout h5py writes by default.
"""

from __future__ import annotations

import os

import numpy as np

from . import hdf5

# PCD TYPE and SIZE -> numpy type
_PCD_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4",
              ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}
# PLY property type -> numpy type
_PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1", "uint8": "u1",
              "int": "i4", "int32": "i4", "short": "i2", "ushort": "u2"}


class IO:
    use_native = True  # .pcd, .ply and .npy through datasets/native_io.py, as in the JAX package

    @classmethod
    def get(cls, file_path: str) -> np.ndarray:
        ext = os.path.splitext(file_path)[-1].lower()
        if cls.use_native and ext in (".pcd", ".ply", ".npy"):
            from ..datasets.native_io import read_cloud

            arr = read_cloud(file_path)
            if arr is not None:
                return arr
        if ext == ".npy":
            return np.load(file_path).astype(np.float32)
        if ext == ".npz":
            return np.load(file_path)["pts"]
        if ext == ".pcd":
            return cls._read_pcd(file_path)
        if ext == ".ply":
            return cls._read_ply(file_path)
        if ext == ".h5":
            return hdf5.read(file_path).astype(np.float32)
        if ext in (".txt", ".dat", ".xyz"):
            return np.loadtxt(file_path).astype(np.float32)
        raise ValueError(f"Unsupported file extension: {ext}")

    @classmethod
    def put(cls, file_path: str, arr: np.ndarray) -> None:
        ext = os.path.splitext(file_path)[-1].lower()
        if ext == ".npy":
            np.save(file_path, arr)
        elif ext == ".npz":
            np.savez(file_path, pts=arr)
        elif ext == ".pcd":
            cls._write_pcd(file_path, arr)
        elif ext == ".ply":
            cls._write_ply(file_path, arr)
        elif ext == ".h5":
            hdf5.write(file_path, arr)
        elif ext in (".txt", ".dat", ".xyz"):
            np.savetxt(file_path, arr)
        else:
            raise ValueError(f"Unsupported file extension: {ext}")

    @classmethod
    def _read_pcd(cls, path: str) -> np.ndarray:
        """PCD v0.7, ASCII or binary; the x, y, z fields."""
        with open(path, "rb") as f:
            header = {}
            while True:
                raw = f.readline()
                if not raw:
                    raise ValueError(f"truncated PCD header (no DATA line): {path}")
                line = raw.decode("ascii", errors="replace").strip()
                if line.startswith("#") or not line:
                    continue
                key, _, val = line.partition(" ")
                header[key.upper()] = val
                if key.upper() == "DATA":
                    break
            fields = header.get("FIELDS", "x y z").split()
            sizes = [int(s) for s in header.get("SIZE", "4 4 4").split()]
            types = header.get("TYPE", "F F F").split()
            counts = [int(c) for c in header["COUNT"].split()] if "COUNT" in header else [1] * len(fields)
            n = int(header.get("POINTS", header.get("WIDTH", "0")))
            data_kind = header["DATA"].split()[0]
            if data_kind == "ascii":
                body = np.loadtxt(f, dtype=np.float32, max_rows=n).reshape(n, -1)
                return body[:, [fields.index(c) for c in ("x", "y", "z")]].astype(np.float32)
            if data_kind != "binary":
                raise ValueError(f"unsupported PCD DATA {data_kind} in {path}")
            dt = []
            for i, name in enumerate(fields):
                cnt = counts[i] if i < len(counts) else 1
                dt.append((name, _PCD_TYPES[(types[i], sizes[i])], (cnt,) if cnt > 1 else ()))
            raw = np.frombuffer(f.read(), dtype=np.dtype(dt), count=n)
            return np.stack([raw["x"], raw["y"], raw["z"]], axis=-1).astype(np.float32)

    @classmethod
    def _read_ply(cls, path: str) -> np.ndarray:
        """PLY, ASCII or binary little-endian; the vertex x, y, z properties."""
        with open(path, "rb") as f:
            if f.readline().strip() != b"ply":
                raise ValueError(f"not a PLY file: {path}")
            fmt, n_vertex, props, in_vertex = None, 0, [], False
            while True:
                raw = f.readline()
                if not raw:
                    raise ValueError(f"truncated PLY header: {path}")
                line = raw.decode("ascii").strip()
                if line.startswith("format"):
                    fmt = line.split()[1]
                elif line.startswith("element"):
                    in_vertex = line.startswith("element vertex")
                    if in_vertex:
                        n_vertex = int(line.split()[-1])
                elif line.startswith("property") and in_vertex:
                    parts = line.split()
                    props.append((parts[-1], parts[1]))
                elif line == "end_header":
                    break
            if fmt == "ascii":
                arr = np.array([f.readline().split() for _ in range(n_vertex)], dtype=np.float32)
                names = [p[0] for p in props]
                return arr[:, [names.index(c) for c in ("x", "y", "z")]]
            dt = np.dtype([(name, "<" + _PLY_TYPES[t]) for name, t in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt, count=n_vertex)
            return np.stack([raw["x"], raw["y"], raw["z"]], -1).astype(np.float32)

    @classmethod
    def _write_pcd(cls, path: str, arr: np.ndarray) -> None:
        """Binary PCD v0.7 of float32 x, y, z: the layout of the PCN dataset's files."""
        n = len(arr)
        header = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                  f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())

    @classmethod
    def _write_ply(cls, path: str, arr: np.ndarray) -> None:
        header = ("ply\nformat binary_little_endian 1.0\n"
                  f"element vertex {len(arr)}\n"
                  "property float x\nproperty float y\nproperty float z\nend_header\n")
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(np.ascontiguousarray(arr, dtype="<f4").tobytes())
