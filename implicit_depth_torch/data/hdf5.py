"""Reading and writing the subset of HDF5 that ``h5py`` writes for plain
arrays, without h5py.

Both sides cover what ``f[name] = array`` and ``f.create_group(name)`` make
with h5py's default (earliest) file format: a version 0 superblock,
version 1 object headers, groups as symbol tables (a version 1 B-tree, a
local heap of names and symbol table nodes), and datasets of
little-endian integers or IEEE floats, stored contiguous or compact.
:func:`read_hdf5` returns every dataset as ``{"group/name": array}``;
:func:`write_hdf5` writes such a dict, h5py reads it back. Anything else
(chunked or filtered storage, newer object headers and link messages,
big-endian or compound types, external storage) raises a ``ValueError``
that names the feature.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_MSG_NAMES = {0x02: "link info", 0x06: "link", 0x07: "external data files",
              0x0A: "group info", 0x0B: "filter pipeline (e.g. deflate)",
              0x0D: "comment"}


class _Reader:
    def __init__(self, data: bytes, path: str):
        self.d, self.path = data, path

    def fail(self, what: str):
        raise ValueError(f"{self.path}: HDF5 {what} is not read")

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.d[pos:pos + n], "little")

    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        d = self.d
        if d[addr:addr + 4] == b"OHDR":
            self.fail("version 2 object header (a file written with "
                      "libver='latest')")
        if d[addr] != 1:
            self.fail(f"object header version {d[addr]}")
        nmsg = self.u(addr + 2, 2)
        blocks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while blocks and len(out) < nmsg:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and len(out) < nmsg:
                mtype, msize = self.u(pos, 2), self.u(pos + 2, 2)
                body = d[pos + 8:pos + 8 + msize]
                if mtype == 0x10:  # continuation
                    blocks.append((self.u(pos + 8, 8), self.u(pos + 16, 8)))
                out.append((mtype, body))
                pos += 8 + msize
        return out

    def heap(self, addr: int) -> int:
        if self.d[addr:addr + 4] != b"HEAP":
            self.fail("local heap without its signature")
        return self.u(addr + 24, 8)

    def name(self, heap_data: int, offset: int) -> str:
        start = heap_data + offset
        return self.d[start:self.d.index(b"\x00", start)].decode()

    def group(self, btree: int, heap: int, prefix: str, out: Dict):
        heap_data = self.heap(heap)
        for snod in self.leaves(btree):
            if self.d[snod:snod + 4] != b"SNOD":
                self.fail("symbol table node without its signature")
            for i in range(self.u(snod + 6, 2)):
                e = snod + 8 + 40 * i
                name = self.name(heap_data, self.u(e, 8))
                self.obj(self.u(e + 8, 8), f"{prefix}{name}", out)

    def leaves(self, node: int) -> List[int]:
        d = self.d
        if d[node:node + 4] != b"TREE" or d[node + 4] != 0:
            self.fail("group B-tree node of another kind")
        level, used = d[node + 5], self.u(node + 6, 2)
        kids = [self.u(node + 24 + 8 + 16 * i, 8) for i in range(used)]
        if level == 0:
            return kids
        return [leaf for k in kids for leaf in self.leaves(k)]

    def obj(self, addr: int, name: str, out: Dict):
        msgs = dict()
        for mtype, body in self.messages(addr):
            if mtype in _MSG_NAMES:
                self.fail(f"{_MSG_NAMES[mtype]} message (in {name or '/'})")
            msgs.setdefault(mtype, body)
        if 0x11 in msgs:
            body = msgs[0x11]
            self.group(int.from_bytes(body[:8], "little"),
                       int.from_bytes(body[8:16], "little"),
                       f"{name}/" if name else "", out)
        elif 0x08 in msgs:
            out[name] = self.dataset(msgs, name)

    def dataset(self, msgs: Dict[int, bytes], name: str) -> np.ndarray:
        shape = self.dataspace(msgs[0x01], name)
        dtype = self.datatype(msgs[0x03], name)
        lay = msgs[0x08]
        if lay[0] != 3:
            self.fail(f"layout message version {lay[0]} (in {name})")
        n = int(np.prod(shape)) * dtype.itemsize
        if lay[1] == 0:      # compact
            raw = lay[4:4 + int.from_bytes(lay[2:4], "little")]
        elif lay[1] == 1:    # contiguous
            addr = int.from_bytes(lay[2:10], "little")
            if addr == _UNDEF:  # never written: the fill value, 0
                return np.zeros(shape, dtype)
            raw = self.d[addr:addr + n]
        else:
            self.fail(("chunked" if lay[1] == 2 else "virtual")
                      + f" dataset storage (in {name})")
        if len(raw) != n:
            self.fail(f"dataset of {len(raw)} bytes for {n} (in {name})")
        return np.frombuffer(raw, dtype).reshape(shape).copy()

    def dataspace(self, b: bytes, name: str) -> Tuple[int, ...]:
        version, ndim = b[0], b[1]
        start = {1: 8, 2: 4}.get(version)
        if start is None:
            self.fail(f"dataspace version {version} (in {name})")
        if version == 2 and b[3] == 2:
            self.fail(f"null dataspace (in {name})")
        return tuple(int.from_bytes(b[start + 8 * i:start + 8 * i + 8],
                                    "little") for i in range(ndim))

    def datatype(self, b: bytes, name: str) -> np.dtype:
        cls, bits, size = b[0] & 15, b[1], self.u_bytes(b[4:8])
        if cls not in (0, 1):
            kinds = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 8: "enum (e.g. bool)",
                     9: "variable-length", 10: "array"}
            self.fail(f"{kinds.get(cls, f'class {cls}')} datatype "
                      f"(in {name})")
        if bits & 1:
            self.fail(f"big-endian datatype (in {name})")
        if cls == 0:
            return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}")
        if size not in (2, 4, 8):
            self.fail(f"{8 * size}-bit float (in {name})")
        return np.dtype(f"<f{size}")

    @staticmethod
    def u_bytes(b: bytes) -> int:
        return int.from_bytes(b, "little")


def read_hdf5(path: str) -> Dict[str, np.ndarray]:
    """Every dataset of the file, by its path from the root ("a",
    "camera/focal_length")."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not an HDF5 file (no signature at byte 0)")
    r = _Reader(data, path)
    if data[8] not in (0, 1):
        r.fail(f"superblock version {data[8]}")
    if data[13] != 8 or data[14] != 8:
        r.fail("file with offsets or lengths other than 8 bytes")
    root = 24 + 32 + (4 if data[8] == 1 else 0)
    out: Dict[str, np.ndarray] = {}
    r.obj(r.u(root + 8, 8), "", out)
    return out


# -- writing -------------------------------------------------------------------

_LEAF_K, _NODE_K = 4, 16


def _msg(mtype: int, body: bytes) -> bytes:
    body += bytes(-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(msgs: List[bytes]) -> bytes:
    body = b"".join(msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _datatype(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind in "iu":
        return struct.pack("<B3BIHH", 0x10, 8 if dt.kind == "i" else 0, 0, 0,
                           size, 0, 8 * size)
    exp_bits, mant_bits, bias = {2: (5, 10, 15), 4: (8, 23, 127),
                                 8: (11, 52, 1023)}[size]
    return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size, 0,
                       8 * size, mant_bits, exp_bits, 0, mant_bits, bias)


class _Writer:
    def __init__(self):
        self.buf = bytearray(96)  # the superblock, filled in last

    def put(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += data
        self.buf += bytes(-len(self.buf) % 8)
        return addr

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr)
        dt = arr.dtype
        if dt.kind not in "iuf" or dt.byteorder == ">" or (
                dt.kind == "f" and dt.itemsize not in (2, 4, 8)):
            raise ValueError(f"write_hdf5 writes little-endian integers and "
                             f"floats, not {dt}")
        data_addr = self.put(arr.tobytes()) if arr.nbytes else _UNDEF
        space = struct.pack("<BBBB4x", 1, arr.ndim, 0, 0) + b"".join(
            struct.pack("<Q", n) for n in arr.shape)
        layout = struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)
        return self.put(_object_header([_msg(0x01, space),
                                        _msg(0x03, _datatype(dt)),
                                        _msg(0x08, layout)]))

    def group(self, tree: Dict) -> Tuple[int, int, int]:
        names = sorted(tree)
        if len(names) > 2 * _LEAF_K * 2 * _NODE_K:
            raise ValueError(f"write_hdf5: a group of {len(names)} members "
                             f"(at most {4 * _LEAF_K * _NODE_K})")
        addrs = {n: (self.group(tree[n])[0] if isinstance(tree[n], dict)
                     else self.dataset(tree[n])) for n in names}
        # the local heap: "" at offset 0, then each name, 8-byte aligned
        heap, offs = bytearray(8), {}
        for n in names:
            offs[n] = len(heap)
            heap += n.encode() + b"\x00"
            heap += bytes(-len(heap) % 8)
        heap_data = self.put(bytes(heap))
        heap_addr = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap),
                                                   1, heap_data))
        leaves = [names[i:i + 2 * _LEAF_K]
                  for i in range(0, len(names), 2 * _LEAF_K)] or [[]]
        snods = []
        for leaf in leaves:
            ents = b"".join(struct.pack("<QQII16x", offs[n], addrs[n], 0, 0)
                            for n in leaf)
            ents += bytes(40 * 2 * _LEAF_K - len(ents))
            snods.append(self.put(b"SNOD" + struct.pack("<BBH", 1, 0,
                                                        len(leaf)) + ents))
        keys = [0] + [offs[leaf[-1]] if leaf else 0 for leaf in leaves]
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), _UNDEF,
                                     _UNDEF)
        node += struct.pack("<Q", keys[0])
        for child, key in zip(snods, keys[1:]):
            node += struct.pack("<QQ", child, key)
        node += bytes(24 + 8 + 16 * 2 * _NODE_K - len(node))
        btree = self.put(node)
        header = self.put(_object_header(
            [_msg(0x11, struct.pack("<QQ", btree, heap_addr))]))
        return header, btree, heap_addr


def _nest(arrays: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, arr in arrays.items():
        parts = key.strip("/").split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"write_hdf5: {key} under a dataset")
        node[parts[-1]] = np.asarray(arr)
    return tree


def write_hdf5(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``{"name": array, "group/name": array}`` as h5py's ``f[name] =
    array`` would (contiguous datasets in symbol-table groups)."""
    w = _Writer()
    root, btree, heap = w.group(_nest(arrays))
    eof = len(w.buf)
    sb = _SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                  _LEAF_K, _NODE_K, 0)
    sb += struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
    sb += struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree,
                                                            heap)
    w.buf[:96] = sb
    with open(path, "wb") as f:
        f.write(bytes(w.buf))
