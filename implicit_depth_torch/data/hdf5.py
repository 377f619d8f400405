"""Reading and writing the subset of HDF5 that ``h5py`` writes for plain
arrays, without h5py.

Both sides cover what ``f[name] = array`` and ``f.create_group(name)`` make
with h5py's default (earliest) file format: a version 0 superblock,
version 1 object headers, groups as symbol tables (a version 1 B-tree, a
local heap of names and symbol table nodes), and datasets of integers or
IEEE floats. The reader also takes big-endian ones, h5py's bool (an enum
over int8) as numpy ``bool``, and every layout h5py writes in that format:
compact, contiguous, and chunked (a version 1 B-tree of the chunks; edge
chunks cut to the dataset's shape, chunks never written read as the fill
value), through the filter pipeline of ``compression="gzip"`` (deflate),
``shuffle`` and ``fletcher32`` (its checksum checked).
:func:`read_hdf5` returns every dataset as ``{"group/name": array}``;
:func:`write_hdf5` writes such a dict (contiguous, little-endian), h5py
reads it back. Anything else (other filters: szip, n-bit, scale-offset,
lzf; newer object headers and link messages of ``libver='latest'``;
compound, string, variable-length and other enum types; external storage)
raises a ``ValueError`` that names the feature.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_MSG_NAMES = {0x02: "link info", 0x06: "link", 0x07: "external data files",
              0x0A: "group info", 0x0D: "comment"}
# the filters of the pipeline message, by id; those not read are named in
# the error
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "n-bit", 6: "scale-offset", 32000: "lzf", 32001: "blosc",
            32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}


def _fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): big-endian 16-bit
    words, sums folded every 360 words."""
    words = np.frombuffer(data[:len(data) // 2 * 2], ">u2").astype(np.int64)
    sum1 = sum2 = 0
    for i in range(0, len(words), 360):
        block = words[i:i + 360]
        n = len(block)
        sum2 += n * sum1 + int((block * np.arange(n, 0, -1)).sum())
        sum1 += int(block.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


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
        dtype, to_bool = self.datatype(msgs[0x03], name)
        lay = msgs[0x08]
        if lay[0] != 3:
            self.fail(f"layout message version {lay[0]} (in {name})")
        n = int(np.prod(shape)) * dtype.itemsize
        if 0x0B in msgs and lay[1] != 2:
            self.fail(f"filter pipeline on unchunked storage (in {name})")
        if lay[1] == 0:      # compact
            raw = lay[4:4 + int.from_bytes(lay[2:4], "little")]
        elif lay[1] == 1:    # contiguous
            addr = int.from_bytes(lay[2:10], "little")
            if addr == _UNDEF:  # never written: the fill value
                raw = self.fill(msgs, dtype, name).tobytes() * int(
                    np.prod(shape))
            else:
                raw = self.d[addr:addr + n]
        elif lay[1] == 2:
            arr = self.chunked(msgs, lay, shape, dtype, name)
            return arr.astype(bool) if to_bool else arr
        else:
            self.fail(f"virtual dataset storage (in {name})")
        if len(raw) != n:
            self.fail(f"dataset of {len(raw)} bytes for {n} (in {name})")
        arr = np.frombuffer(raw, dtype).reshape(shape).copy()
        return arr.astype(bool) if to_bool else arr

    def fill(self, msgs: Dict[int, bytes], dtype: np.dtype,
             name: str) -> np.ndarray:
        """The dataset's fill value (one element): the fill value message's
        when it defines one, else 0."""
        value = b""
        if 0x05 in msgs:
            b = msgs[0x05]
            if b[0] in (1, 2):
                defined, at = b[3], 4
                if b[0] == 1 or defined:
                    value = b[at + 4:at + 4 + self.u_bytes(b[at:at + 4])]
            elif b[0] == 3:
                if b[1] & 0x20:
                    value = b[6:6 + self.u_bytes(b[2:6])]
            else:
                self.fail(f"fill value message version {b[0]} (in {name})")
        elif 0x04 in msgs:
            b = msgs[0x04]
            value = b[4:4 + self.u_bytes(b[:4])]
        if not value:
            return np.zeros(1, dtype)
        if len(value) != dtype.itemsize:
            self.fail(f"fill value of {len(value)} bytes (in {name})")
        return np.frombuffer(value, dtype).copy()

    def filters(self, b: bytes, name: str) -> List[Tuple[int, List[int]]]:
        """The pipeline message's (filter id, client data) in order."""
        version, count, out = b[0], b[1], []
        if version not in (1, 2):
            self.fail(f"filter pipeline message version {version} "
                      f"(in {name})")
        pos = 8 if version == 1 else 2
        for _ in range(count):
            fid = self.u_bytes(b[pos:pos + 2])
            if version == 1 or fid >= 256:
                name_len = self.u_bytes(b[pos + 2:pos + 4])
                pos += 4
            else:
                name_len = 0
                pos += 2
            nvals = self.u_bytes(b[pos + 2:pos + 4])
            pos += 4
            pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
            vals = [self.u_bytes(b[pos + 4 * i:pos + 4 * i + 4])
                    for i in range(nvals)]
            pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2, 3):
                self.fail(f"filter {_FILTERS.get(fid, f'id {fid}')} "
                          f"(in {name})")
            out.append((fid, vals))
        return out

    def unfilter(self, raw: bytes, pipeline, mask: int, name: str) -> bytes:
        """A chunk's bytes with the pipeline's filters undone, last first;
        a filter whose bit is set in the chunk's mask was not applied."""
        for i in reversed(range(len(pipeline))):
            if mask >> i & 1:
                continue
            fid, vals = pipeline[i]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                size = vals[0] if vals else 1
                n = len(raw) // size * size
                planes = np.frombuffer(raw[:n], np.uint8).reshape(size, -1)
                raw = planes.T.tobytes() + raw[n:]
            else:
                stored = self.u_bytes(raw[-4:])
                got = _fletcher32(raw[:-4])
                # files of HDF5 before 1.6.3 stored its bytes reversed
                if stored not in (got, int.from_bytes(
                        got.to_bytes(4, "little"), "big")):
                    self.fail(f"chunk whose fletcher32 checksum does not "
                              f"match (in {name})")
                raw = raw[:-4]
        return raw

    def chunked(self, msgs: Dict[int, bytes], lay: bytes,
                shape: Tuple[int, ...], dtype: np.dtype,
                name: str) -> np.ndarray:
        """A chunked dataset: its chunks, found through the version 1
        B-tree, filtered back and laid into the array (edge chunks cut to
        its shape; chunks never written, the fill value)."""
        ndims = lay[2]
        btree = int.from_bytes(lay[3:11], "little")
        chunk = tuple(self.u_bytes(lay[11 + 4 * i:15 + 4 * i])
                      for i in range(ndims))
        if ndims != len(shape) + 1 or chunk[-1] != dtype.itemsize:
            self.fail(f"chunk dimensions {chunk} for shape {shape} "
                      f"(in {name})")
        chunk = chunk[:-1]
        pipeline = self.filters(msgs[0x0B], name) if 0x0B in msgs else []
        out = np.empty(shape, dtype)
        out[...] = self.fill(msgs, dtype, name)[0]
        if btree == _UNDEF or 0 in shape:
            return out
        nbytes = int(np.prod(chunk)) * dtype.itemsize
        for size, mask, offset, addr in self.chunk_leaves(btree, ndims):
            raw = self.unfilter(self.d[addr:addr + size], pipeline, mask,
                                name)
            if len(raw) != nbytes:
                self.fail(f"chunk of {len(raw)} bytes for {nbytes} "
                          f"(in {name})")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            cut = tuple(slice(0, min(c, n - o))
                        for c, n, o in zip(chunk, shape, offset))
            out[tuple(slice(o, o + c.stop) for o, c in zip(offset, cut))] = \
                block[cut]
        return out

    def chunk_leaves(self, node: int, ndims: int):
        """(size, filter mask, offset, address) of each chunk under a
        version 1 B-tree node of type 1."""
        d = self.d
        if d[node:node + 4] != b"TREE" or d[node + 4] != 1:
            self.fail("chunk B-tree node of another kind")
        level, used = d[node + 5], self.u(node + 6, 2)
        key = 8 + 8 * ndims
        out = []
        for i in range(used):
            k = node + 24 + i * (key + 8)
            child = self.u(k + key, 8)
            if level:
                out += self.chunk_leaves(child, ndims)
            else:
                offset = tuple(self.u(k + 8 + 8 * j, 8)
                               for j in range(ndims - 1))
                out.append((self.u(k, 4), self.u(k + 4, 4), offset, child))
        return out

    def dataspace(self, b: bytes, name: str) -> Tuple[int, ...]:
        version, ndim = b[0], b[1]
        start = {1: 8, 2: 4}.get(version)
        if start is None:
            self.fail(f"dataspace version {version} (in {name})")
        if version == 2 and b[3] == 2:
            self.fail(f"null dataspace (in {name})")
        return tuple(int.from_bytes(b[start + 8 * i:start + 8 * i + 8],
                                    "little") for i in range(ndim))

    def datatype(self, b: bytes, name: str) -> Tuple[np.dtype, bool]:
        """(numpy dtype, whether it is h5py's bool)."""
        cls, bits, size = b[0] & 15, b[1], self.u_bytes(b[4:8])
        if cls == 8:  # enum: h5py's bool only
            members = b[1] | b[2] << 8
            base, _ = self.datatype(b[8:20], name)
            names, pos = [], 20
            for _ in range(members):
                end = b.index(b"\x00", pos)
                names.append(b[pos:end].decode())
                pos = end + 1 if b[0] >> 4 == 3 else pos + (
                    end - pos + 8) // 8 * 8
            values = np.frombuffer(b[pos:pos + members * base.itemsize],
                                   base).tolist()
            if base.itemsize != 1 or dict(zip(names, values)) != {
                    "FALSE": 0, "TRUE": 1}:
                self.fail(f"enum datatype other than h5py's bool (in {name})")
            return base, True
        if cls not in (0, 1):
            kinds = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 9: "variable-length",
                     10: "array"}
            self.fail(f"{kinds.get(cls, f'class {cls}')} datatype "
                      f"(in {name})")
        order = ">" if bits & 1 else "<"
        if cls == 0:
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), False
        if size not in (2, 4, 8) or bits & 0x40:
            self.fail(f"{8 * size}-bit float of this byte order (in {name})")
        return np.dtype(f"{order}f{size}"), False

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
