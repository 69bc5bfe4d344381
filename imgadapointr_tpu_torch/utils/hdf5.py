"""A reader and a writer of the HDF5 files point clouds come in, without h5py.

The JAX package reads a ``.h5`` cloud as ``h5py.File(path)["data"][()]``
(``imgadapointr_tpu/utils/io_module.py:62-67``). This module does the same
with the standard library and numpy, so the port reads and writes ``.h5``
clouds on a machine without ``h5py``. It reads one dataset of the root
group, in the layouts h5py writes by default:

- superblock version 0 or 1 (h5py's ``libver="earliest"``, its default),
  with a user block before it or none;
- version-1 object headers and their continuation blocks;
- a root group kept as a symbol table: the version-1 B-tree of group nodes,
  the local heap of link names and the symbol-table nodes (``SNOD``);
- dataspace message versions 1 and 2, scalar or simple;
- IEEE floating-point (16, 32 and 64 bits) and integer (8-64 bits, signed
  or not) datatypes, little- or big-endian;
- contiguous, compact and chunked layouts (layout message version 3); a
  chunked dataset's chunks are found through its version-1 B-tree and
  undone through the deflate and shuffle filters, and a chunk may run past
  the dataset's edge.

Anything else (superblock 2 or 3, which ``libver="latest"`` writes, version-2
object headers, groups of link messages, another datatype class, another
filter, a dataset whose storage was never written) raises
``NotImplementedError`` naming what it met; nothing falls back to h5py.

:func:`write` writes an array as the dataset ``data`` in the layout h5py
writes by default (superblock 0, a symbol-table root group, a contiguous
dataset), which h5py reads back bit for bit.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
# object header message types
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE, MSG_FILL, MSG_LINK = 0x1, 0x2, 0x3, 0x5, 0x6
MSG_LAYOUT, MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x8, 0xB, 0x10, 0x11
DATASET = "data"  # the one dataset a cloud file holds, as the JAX package reads it
DATATYPE_CLASSES = ("fixed-point", "floating-point", "time", "string", "bitfield", "opaque", "compound",
                    "reference", "enumerated", "variable-length", "array")
FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
# IEEE floats: size -> (exponent location, exponent size, mantissa size, bias)
IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
GROUP_LEAF_K, GROUP_INTERNAL_K = 4, 16  # the library's defaults, which h5py keeps


class _File:
    """The bytes of one file and the sizes its superblock sets."""

    def __init__(self, data: bytes):
        self.data = data
        for base in [0] + [512 << i for i in range(32)]:
            if base + 8 > len(data):
                raise ValueError("not an HDF5 file (no superblock signature)")
            if data[base:base + 8] == SIGNATURE:
                break
        version = data[base + 8]
        if version > 1:
            raise NotImplementedError(f"HDF5 superblock version {version} (h5py's libver='latest'); "
                                      "versions 0 and 1 are read")
        self.o, self.l = data[base + 13], data[base + 14]  # sizes of offsets and of lengths
        if (self.o, self.l) != (8, 8):
            raise NotImplementedError(f"HDF5 offsets of {self.o} bytes and lengths of {self.l}; 8 and 8 are read")
        pos = base + 24 + (4 if version == 1 else 0)
        self.base = 0
        self.base = self.addr(pos)
        root = pos + 4 * self.o  # base, free-space, end of file and driver addresses, then the root entry
        self.root_header = self.addr(root + self.o)
        self.root_scratch = (self.u32(root + 2 * self.o), root + 2 * self.o + 8)

    def u8(self, pos: int) -> int:
        return self.data[pos]

    def u16(self, pos: int) -> int:
        return struct.unpack_from("<H", self.data, pos)[0]

    def u32(self, pos: int) -> int:
        return struct.unpack_from("<I", self.data, pos)[0]

    def u64(self, pos: int) -> int:
        return struct.unpack_from("<Q", self.data, pos)[0]

    def addr(self, pos: int) -> int:
        """An address field: absolute in the file (the base added), or UNDEFINED."""
        a = self.u64(pos)
        return a if a == UNDEFINED else a + self.base

    def take(self, pos: int, n: int) -> bytes:
        if pos + n > len(self.data):
            raise ValueError(f"HDF5 file ends inside an object ({pos} + {n} > {len(self.data)} bytes)")
        return self.data[pos:pos + n]

    def messages(self, header: int) -> list:
        """``(type, flags, position of the data, size)`` of each message of
        the version-1 object header at ``header``, continuations followed."""
        if self.data[header:header + 4] == b"OHDR":
            raise NotImplementedError("HDF5 object header version 2 (h5py's libver='latest'); version 1 is read")
        version = self.u8(header)
        if version != 1:
            raise NotImplementedError(f"HDF5 object header version {version}; version 1 is read")
        count = self.u16(header + 2)
        blocks, out = [(header + 16, self.u32(header + 8))], []
        while blocks and len(out) < count:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and len(out) < count:
                kind, length, flags = self.u16(pos), self.u16(pos + 2), self.u8(pos + 4)
                if kind == MSG_CONTINUATION:
                    blocks.append((self.addr(pos + 8), self.u64(pos + 16)))
                out.append((kind, flags, pos + 8, length))
                pos += 8 + length
        return out

    def heap_name(self, heap: int, offset: int) -> str:
        if self.take(heap, 4) != b"HEAP":
            raise ValueError(f"HDF5: no local heap at {heap}")
        start = self.addr(heap + 24) + offset
        end = self.data.index(b"\0", start)
        return self.data[start:end].decode("utf-8")

    def group_entries(self, header: int, scratch=None) -> dict:
        """``{name: object header address}`` of the group at ``header``."""
        if scratch is not None and scratch[0] == 1:  # the root entry caches the B-tree and heap addresses
            tree, heap = self.addr(scratch[1]), self.addr(scratch[1] + self.o)
        else:
            msgs = {kind: pos for kind, _, pos, _ in self.messages(header)}
            if MSG_SYMBOL_TABLE not in msgs:
                if MSG_LINK in msgs or MSG_LINK_INFO in msgs:
                    raise NotImplementedError("HDF5 group of link messages (the new-style group layout); "
                                              "symbol-table groups are read")
                raise ValueError("HDF5: the object is not a group")
            tree, heap = self.addr(msgs[MSG_SYMBOL_TABLE]), self.addr(msgs[MSG_SYMBOL_TABLE] + self.o)
        out: dict = {}
        for snod in self._btree_children(tree, node_type=0, key_size=self.l):
            if self.take(snod, 4) != b"SNOD":
                raise ValueError(f"HDF5: no symbol-table node at {snod}")
            for i in range(self.u16(snod + 6)):
                entry = snod + 8 + i * (2 * self.o + 24)
                out[self.heap_name(heap, self.u64(entry))] = self.addr(entry + self.o)
        return out

    def _btree_children(self, node: int, node_type: int, key_size: int, keys: bool = False) -> list:
        """The leaf children of the version-1 B-tree at ``node``, in order;
        with ``keys``, ``(key position, child)`` pairs (the key before each
        child)."""
        if self.take(node, 4) != b"TREE":
            raise ValueError(f"HDF5: no B-tree node at {node}")
        if self.u8(node + 4) != node_type:
            raise ValueError(f"HDF5: B-tree node of type {self.u8(node + 4)}, {node_type} expected")
        level, used = self.u8(node + 5), self.u16(node + 6)
        out = []
        pos = node + 8 + 2 * self.o
        for _ in range(used):
            key, child = pos, self.addr(pos + key_size)
            pos += key_size + self.o
            if level > 0:
                out.extend(self._btree_children(child, node_type, key_size, keys))
            else:
                out.append((key, child) if keys else child)
        return out


def _dataspace(f: _File, pos: int) -> tuple:
    version, rank, flags = f.u8(pos), f.u8(pos + 1), f.u8(pos + 2)
    if version == 1:
        if flags & 2:
            raise NotImplementedError("HDF5 dataspace with a permutation index")
        start = pos + 8
    elif version == 2:
        kind = f.u8(pos + 3)
        if kind == 2:
            raise NotImplementedError("HDF5 null dataspace")
        start = pos + 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    return tuple(f.u64(start + 8 * i) for i in range(rank))


def _datatype(f: _File, pos: int) -> np.dtype:
    cls, bits, size = f.u8(pos) & 0x0F, f.take(pos + 1, 3), f.u32(pos + 4)
    name = DATATYPE_CLASSES[cls] if cls < len(DATATYPE_CLASSES) else f"class {cls}"
    if cls not in (0, 1):
        raise NotImplementedError(f"HDF5 {name} datatype; fixed- and floating-point types are read")
    order = "<" if bits[0] & 0x01 == 0 else ">"
    if cls == 1 and bits[0] & 0x40:
        raise NotImplementedError("HDF5 floating-point datatype in VAX byte order")
    offset, precision = f.u16(pos + 8), f.u16(pos + 10)
    if offset != 0 or precision != 8 * size:
        raise NotImplementedError(f"HDF5 {name} datatype of {precision} bits at bit {offset} in {size} bytes")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise NotImplementedError(f"HDF5 fixed-point datatype of {size} bytes")
        return np.dtype(f"{order}{'i' if bits[0] & 0x08 else 'u'}{size}")
    fields = (f.u8(pos + 12), f.u8(pos + 13), f.u8(pos + 15), f.u32(pos + 16))
    if size not in IEEE or fields != IEEE[size] or f.u8(pos + 14) != 0:
        raise NotImplementedError(f"HDF5 floating-point datatype of {size} bytes that is not IEEE {8 * size}-bit")
    return np.dtype(f"{order}f{size}")


def _filters(f: _File, pos: int) -> list:
    """``(id, client data)`` of each filter of a pipeline message, in the
    order they were applied when writing."""
    version, count = f.u8(pos), f.u8(pos + 1)
    if version not in (1, 2):
        raise NotImplementedError(f"HDF5 filter pipeline message version {version}")
    pos += 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid = f.u16(pos)
        named = version == 1 or fid >= 256
        name_len = f.u16(pos + 2) if named else 0
        pos += 4 if named else 2
        n_values = f.u16(pos + 2)
        pos += 4
        name = f.take(pos, name_len).split(b"\0")[0].decode("ascii", "replace") if name_len else ""
        pos += ((name_len + 7) // 8 * 8) if version == 1 else name_len
        values = [f.u32(pos + 4 * i) for i in range(n_values)]
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
            raise NotImplementedError(f"HDF5 filter {fid} ({name or FILTER_NAMES.get(fid, 'unknown')}); "
                                      "deflate and shuffle are read")
        out.append((fid, values))
    return out


def _unfilter(raw: bytes, filters: list, mask: int, itemsize: int) -> bytes:
    """A chunk's bytes with the pipeline undone, last filter first; a filter
    whose bit is set in ``mask`` was skipped for this chunk."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, _ = filters[i]
        if fid == FILTER_DEFLATE:
            raw = zlib.decompress(raw)
        else:  # shuffle: byte k of every element together, then the bytes left over
            n = len(raw) // itemsize
            body = np.frombuffer(raw, np.uint8, n * itemsize).reshape(itemsize, n).T
            raw = body.tobytes() + raw[n * itemsize:]
    return raw


def _chunked(f: _File, pos: int, shape: tuple, dtype: np.dtype, filters: list) -> np.ndarray:
    ndims = f.u8(pos)
    tree = f.addr(pos + 1)
    chunk = tuple(f.u32(pos + 1 + f.o + 4 * i) for i in range(ndims - 1))
    if len(chunk) != len(shape):
        raise ValueError(f"HDF5: chunks of rank {len(chunk)} in a dataset of rank {len(shape)}")
    out = np.zeros(shape, dtype)
    if tree == UNDEFINED:
        raise NotImplementedError("HDF5 chunked dataset whose chunks were never written")
    covered = 0
    for key, addr in f._btree_children(tree, node_type=1, key_size=8 + 8 * ndims, keys=True):
        size, mask = f.u32(key), f.u32(key + 4)
        start = tuple(f.u64(key + 8 + 8 * i) for i in range(ndims - 1))
        raw = _unfilter(f.take(addr, size), filters, mask, dtype.itemsize)
        block = np.frombuffer(raw, dtype, int(np.prod(chunk))).reshape(chunk)
        region = tuple(slice(s, min(s + c, n)) for s, c, n in zip(start, chunk, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
        covered += int(np.prod([r.stop - r.start for r in region]))
    if covered != int(np.prod(shape)):
        raise NotImplementedError("HDF5 chunked dataset with chunks never written (its fill value is not read)")
    return out


def read(path: str) -> np.ndarray:
    """The dataset ``data`` of the root group of the HDF5 file at ``path``,
    as h5py's ``f["data"][()]`` gives it (the file's dtype and shape)."""
    with open(path, "rb") as fh:
        f = _File(fh.read())
    entries = f.group_entries(f.root_header, f.root_scratch)
    if DATASET not in entries:
        raise KeyError(f"HDF5: no dataset {DATASET!r} in the root group of {path} (it holds {sorted(entries)})")
    msgs: dict = {}
    for kind, flags, pos, size in f.messages(entries[DATASET]):
        if flags & 0x02 and kind in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT, MSG_FILTERS):
            raise NotImplementedError(f"HDF5 shared message of type {kind} (a committed datatype)")
        msgs.setdefault(kind, pos)
    missing = [m for m in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT) if m not in msgs]
    if missing:
        raise ValueError(f"HDF5: {DATASET!r} in {path} is not a dataset (no message of type {missing})")
    shape, dtype = _dataspace(f, msgs[MSG_DATASPACE]), _datatype(f, msgs[MSG_DATATYPE])
    pos = msgs[MSG_LAYOUT]
    version, layout = f.u8(pos), f.u8(pos + 1)
    if version != 3:
        raise NotImplementedError(f"HDF5 data layout message version {version}; version 3 is read")
    n_bytes = int(np.prod(shape)) * dtype.itemsize
    filters = _filters(f, msgs[MSG_FILTERS]) if MSG_FILTERS in msgs else []
    if n_bytes == 0:
        return np.zeros(shape, dtype)
    if layout == 0:  # compact: the data inside the message
        raw = f.take(pos + 4, f.u16(pos + 2))
    elif layout == 1:
        addr = f.addr(pos + 2)
        if addr == UNDEFINED:
            raise NotImplementedError("HDF5 contiguous dataset whose data was never written")
        raw = f.take(addr, n_bytes)
    elif layout == 2:
        return _chunked(f, pos + 2, shape, dtype, filters)
    else:
        raise NotImplementedError(f"HDF5 data layout class {layout}")
    return np.frombuffer(raw, dtype, int(np.prod(shape))).reshape(shape).copy()


def _message(kind: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", kind, len(body), flags) + body


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind == "f" and size in IEEE:
        exp_loc, exp_size, mant_size, bias = IEEE[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, 8 * size - 1, 0, size, 0, 8 * size,
                           exp_loc, exp_size, 0, mant_size, bias)
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return struct.pack("<BBBBIHH", 0x10, order | (0x08 if dtype.kind == "i" else 0), 0, 0, size, 0, 8 * size)
    raise NotImplementedError(f"writing HDF5 data of dtype {dtype}; IEEE floats and integers are written")


def write(path: str, arr: np.ndarray) -> None:
    """``arr`` as the dataset ``data`` of a new HDF5 file at ``path``, laid
    out as h5py writes it by default: superblock 0, a root group of one
    symbol-table node, a contiguous dataset after the metadata."""
    arr = np.asarray(arr, order="C")  # 0-d stays 0-d (a scalar dataspace)
    if arr.dtype.byteorder == "=":
        arr = arr.astype(arr.dtype.newbyteorder("<" if np.little_endian else ">"))
    dtype_msg = _datatype_message(arr.dtype)
    # the local heap of link names: "" at 0, "data" at 8, then the 88-byte
    # segment's free block as the library leaves it (1 ends the free list)
    names = b"\0" * 8 + DATASET.encode("ascii").ljust(8, b"\0")
    heap_data = names + struct.pack("<QQ", 1, 88 - len(names)).ljust(88 - len(names), b"\0")

    superblock_size = 8 + 16 + 4 * 8 + 40
    root_oh = superblock_size
    root_size = 16 + 8 + 16
    tree = root_oh + root_size
    tree_size = 24 + (2 * GROUP_INTERNAL_K + 1) * 8 + 2 * GROUP_INTERNAL_K * 8
    heap = tree + tree_size
    heap_data_at = heap + 32
    dset_oh = heap_data_at + len(heap_data)
    space = struct.pack("<BBBxI", 1, arr.ndim, 0, 0) + b"".join(struct.pack("<Q", n) for n in arr.shape)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    messages = [_message(MSG_DATASPACE, space), _message(MSG_DATATYPE, dtype_msg, flags=1),
                _message(MSG_FILL, fill, flags=1)]
    layout_len = len(_message(MSG_LAYOUT, b"\0" * 18))
    snod = dset_oh + 16 + sum(len(m) for m in messages) + layout_len
    snod_size = 8 + 2 * GROUP_LEAF_K * 40
    data_at = snod + snod_size
    messages.append(_message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data_at if arr.nbytes else UNDEFINED,
                                                     arr.nbytes)))
    eof = data_at + arr.nbytes

    out = bytearray()
    out += SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, GROUP_LEAF_K, GROUP_INTERNAL_K, 0)
    out += struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED)
    out += struct.pack("<QQII", 0, root_oh, 1, 0) + struct.pack("<QQ", tree, heap)
    out += _object_header([_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", tree, heap))])
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEFINED, UNDEFINED) + struct.pack("<QQQ", 0, snod, 8)
    out += node + b"\0" * (tree_size - len(node))
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), len(names), heap_data_at)
    out += heap_data
    out += _object_header(messages)
    entry = struct.pack("<QQII16x", 8, dset_oh, 0, 0)
    sym = b"SNOD" + struct.pack("<BBH", 1, 0, 1) + entry
    out += sym + b"\0" * (snod_size - len(sym))
    assert len(out) == data_at
    out += arr.tobytes()
    with open(path, "wb") as fh:
        fh.write(bytes(out))
