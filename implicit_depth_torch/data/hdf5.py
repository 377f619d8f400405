"""Reading and writing the subset of HDF5 that ``h5py`` writes for plain
arrays, without h5py.

The reader takes both file formats h5py writes. The default (earliest)
one: a version 0 or 1 superblock, version 1 object headers, groups as
symbol tables (a version 1 B-tree, a local heap of names and symbol table
nodes), chunks indexed by a version 1 B-tree. That of ``libver='latest'``
(and the parts of it that ``track_order=True`` brings into the default
one): version 2 and 3 superblocks, version 2 object headers (``OHDR``,
continued in ``OCHK`` blocks), groups of link messages, in the header
(compact) or, past 8 members, in a fractal heap whose links a version 2
B-tree indexes by their names' hashes (dense), and the version 4 layout
message with its five chunk indexes: a single chunk, implicit (chunks in
order), a fixed array (paged past 1024 chunks), an extensible array (one
unlimited dimension) and a version 2 B-tree (two or more). Every checksum
of that format (Jenkins' lookup3) is checked.

Datasets hold integers (of any precision and bit offset) or IEEE floats,
little- or big-endian, or h5py's bool (an enum over int8, read as numpy
``bool``), stored compact, contiguous or chunked (edge chunks cut to the
dataset's shape; chunks never written read as the fill value), through the
filters h5py writes: deflate (``compression="gzip"``), ``shuffle``,
``fletcher32`` (its checksum checked), ``lzf``, ``scaleoffset`` (integers'
minimum bits, floats' decimal scaling) and n-bit.

:func:`read_hdf5` returns the datasets it is asked for (all by default) as
``{"group/name": array}``, the arrays h5py reads, and decodes no other
dataset: one that it cannot read raises only when it is asked for, with a
``ValueError`` that names the feature (szip and other filters; string,
compound, variable-length and other enum types; external and virtual
storage; shared messages). :func:`write_hdf5` writes such a dict
(contiguous, little-endian, the earliest format); h5py reads it back.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
# the filters of the pipeline message, by id; those not read are named in
# the error
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "n-bit", 6: "scale-offset", 32000: "lzf", 32001: "blosc",
            32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
_READ_FILTERS = (1, 2, 3, 5, 6, 32000)
# dataset messages whose body may be shared (stored elsewhere)
_SHAREABLE = {0x01: "dataspace", 0x03: "datatype", 0x05: "fill value",
              0x0B: "filter pipeline"}
_M32 = 0xFFFFFFFF


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


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def _lookup3(data: bytes) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` with seed 0, HDF5's metadata
    checksum (``H5_checksum_lookup3``)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    if n == 0:
        return c
    words = np.frombuffer(data + bytes(-n % 12), "<u4").tolist()
    last = (len(words) - 3)
    for i in range(0, last, 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8)
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4)
        b = (b + a) & _M32
    # the last 1-12 bytes, zero-padded
    a = (a + words[last]) & _M32
    b = (b + words[last + 1]) & _M32
    c = (c + words[last + 2]) & _M32
    c = (c ^ b) - _rot(b, 14) & _M32
    a = (a ^ c) - _rot(c, 11) & _M32
    b = (b ^ a) - _rot(a, 25) & _M32
    c = (c ^ b) - _rot(b, 16) & _M32
    a = (a ^ c) - _rot(c, 4) & _M32
    b = (b ^ a) - _rot(a, 14) & _M32
    c = (c ^ b) - _rot(b, 24) & _M32
    return c


def _enc_size(n: int) -> int:
    """Bytes HDF5 gives a count up to ``n`` (``H5VM_limit_enc_size``)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _bits_at(buf: bytes, pos: np.ndarray, width: int) -> np.ndarray:
    """The ``width``-bit (at most 57) fields of ``buf`` that start at the
    bit positions ``pos``, most significant bit first, as uint64."""
    b = np.frombuffer(buf + bytes(8), np.uint8)
    byte = (pos >> np.uint64(3)).astype(np.int64)
    word = np.zeros(len(pos), np.uint64)
    for k in range(8):
        word = (word << np.uint64(8)) | b[byte + k].astype(np.uint64)
    shift = np.uint64(64 - width) - (pos & np.uint64(7))
    return (word >> shift) & np.uint64((1 << width) - 1)


def _unpack_bits(buf: bytes, n: int, bits: int) -> np.ndarray:
    """``n`` unsigned values of ``bits`` bits each, packed one after another
    most significant bit first (as the n-bit and scale-offset filters pack
    them), as uint64."""
    if bits == 0:
        return np.zeros(n, np.uint64)
    if len(buf) * 8 < n * bits:
        raise ValueError("HDF5: packed chunk shorter than its values")
    pos = np.arange(n, dtype=np.uint64) * np.uint64(bits)
    if bits <= 57:
        return _bits_at(buf, pos, bits)
    hi = _bits_at(buf, pos, bits - 32)
    return (hi << np.uint64(32)) | _bits_at(buf, pos + np.uint64(bits - 32),
                                            32)


def _lzf(src: bytes, size: int) -> bytes:
    """LZF decompression (h5py's ``lzf`` filter: liblzf's format)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:  # a literal run
            out += src[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += src[i]
            i += 1
        ref = len(out) - ((ctrl & 0x1F) << 8) - src[i] - 1
        i += 1
        length += 2
        if ref < 0:
            raise ValueError("HDF5: lzf chunk refers before its start")
        while length:  # a back reference may overlap what it writes
            piece = out[ref:ref + length]
            out += piece
            ref += len(piece)
            length -= len(piece)
    if len(out) != size:
        raise ValueError(f"HDF5: lzf chunk of {len(out)} bytes for {size}")
    return bytes(out)


def _cd_bytes(vals: List[int], start: int, size: int) -> bytes:
    """``size`` bytes packed into the 32-bit filter parameters from
    ``start`` on (a fill value, as the scale-offset filter stores it)."""
    return b"".join(v.to_bytes(4, "little") for v in vals[start:])[:size]


def _scale_offset(raw: bytes, vals: List[int], dtype: np.dtype,
                  fail) -> np.ndarray:
    """Undo HDF5's scale-offset filter (``H5Zscaleoffset.c``): a 21-byte
    header (the minimum bits, the minimum), then each value's offset from
    the minimum in that many bits; for floats D-scaled by ``10**D``; all
    ones where the fill value is defined stands for the fill value."""
    scale_type, d_val, n, cls, size, _, _, filavail = vals[:8]
    if scale_type == 1:
        fail("scale-offset filter with E-scaling")
    if size != dtype.itemsize or cls != (dtype.kind == "f"):
        fail("scale-offset filter of another datatype")
    minbits = int.from_bytes(raw[:4], "little")
    minval = int.from_bytes(raw[5:5 + min(raw[4], 8)], "little")
    out_t = dtype.newbyteorder("<")
    if minbits == 8 * size:  # stored whole
        return np.frombuffer(raw[21:21 + n * size], out_t).astype(dtype)
    u = _unpack_bits(raw[21:], n, minbits)
    fill = None
    if filavail:
        fill = np.frombuffer(_cd_bytes(vals, 8, size), out_t)[0]
    mask = np.uint64((1 << minbits) - 1)
    bits = np.dtype(f"<u{size}")
    if cls == 0:  # integers: value + minimum, wrapping as the type
        out = (u + np.uint64(minval)).astype(bits).view(out_t)
    else:         # floats: as a signed integer / 10**D + minimum
        ftype = np.dtype(f"<f{size}")
        low = np.frombuffer(minval.to_bytes(8, "little")[:size], ftype)[0]
        scale = ftype.type(10.0 ** d_val)
        out = (u.astype(np.dtype(f"<i{size}")).astype(ftype) / scale
               + low).astype(ftype)
    if fill is not None:
        out = np.where(u == mask, fill, out).astype(out_t)
    return out.astype(dtype)


def _nbit(raw: bytes, vals: List[int], dtype: np.dtype, fail) -> np.ndarray:
    """Undo HDF5's n-bit filter (``H5Znbit.c``) for an atomic datatype:
    each value's ``precision`` significant bits, from bit ``offset`` on,
    packed one after another."""
    if vals[1]:  # the datatype has no unused bits: stored as it is
        return np.frombuffer(raw, dtype)
    n, cls, size, _, precision, offset = vals[2:8]
    if cls != 1 or size != dtype.itemsize:
        fail("n-bit filter of a non-atomic datatype")
    u = _unpack_bits(raw, n, precision) << np.uint64(offset)
    return u.astype(np.dtype(f"<u{size}")).view(dtype.newbyteorder("<")
                                                 ).astype(dtype)


class _Reader:
    def __init__(self, data: bytes, path: str):
        self.d, self.path = data, path
        self.heaps: Dict[int, Dict[str, int]] = {}
        self.seen: set = set()

    def fail(self, what: str):
        raise ValueError(f"{self.path}: HDF5 {what} is not read")

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.d[pos:pos + n], "little")

    @staticmethod
    def u_bytes(b: bytes) -> int:
        return int.from_bytes(b, "little")

    def checked(self, addr: int, size: int, what: str) -> None:
        """Raise unless the ``size`` bytes at ``addr`` end in the lookup3
        checksum of those before it."""
        if _lookup3(self.d[addr:addr + size - 4]) != self.u(addr + size - 4,
                                                            4):
            raise ValueError(f"{self.path}: HDF5 {what} at {addr} whose "
                             "checksum does not match")

    def signature(self, addr: int, sig: bytes, what: str) -> None:
        if self.d[addr:addr + 4] != sig:
            self.fail(f"{what} without its signature at {addr}")

    # -- object headers ---------------------------------------------------

    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, body) of each message of the object header at
        ``addr``, continuation blocks included."""
        d = self.d
        if d[addr:addr + 4] == b"OHDR":
            return self.messages_v2(addr)
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
                out.append((mtype, d[pos + 4], body))
                pos += 8 + msize
        return out

    def messages_v2(self, addr: int) -> List[Tuple[int, int, bytes]]:
        d = self.d
        if d[addr + 4] != 2:
            self.fail(f"object header version {d[addr + 4]}")
        flags = d[addr + 5]
        pos = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10
                                                         else 0)
        width = 1 << (flags & 3)
        size = self.u(pos, width)
        pos += width
        self.checked(addr, pos + size + 4 - addr, "object header")
        head = 6 if flags & 0x04 else 4  # creation order tracked
        blocks, out = [(pos, pos + size)], []
        while blocks:
            pos, end = blocks.pop(0)
            while end - pos >= head:
                mtype, msize, mflags = d[pos], self.u(pos + 1, 2), d[pos + 3]
                body = d[pos + head:pos + head + msize]
                if mtype == 0x10:
                    cont, length = self.u_bytes(body[:8]), self.u_bytes(
                        body[8:16])
                    self.signature(cont, b"OCHK",
                                   "object header continuation block")
                    self.checked(cont, length,
                                 "object header continuation block")
                    blocks.append((cont + 4, cont + length - 4))
                out.append((mtype, mflags, body))
                pos += head + msize
        return out

    # -- groups -----------------------------------------------------------

    def walk(self, addr: int, prefix: str, out: Dict[str, int]) -> None:
        """Every dataset under the group or dataset whose header is at
        ``addr``, by path, into ``out``: {path: header address}."""
        if addr in self.seen:  # an object reached by a second link
            return
        self.seen.add(addr)
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        if 0x08 in types:
            out[prefix.rstrip("/")] = addr
            return
        if 0x11 in types:
            body = next(b for t, _, b in msgs if t == 0x11)
            links = self.symbol_table(self.u_bytes(body[:8]),
                                      self.u_bytes(body[8:16]))
        elif 0x02 in types:
            links = self.new_style_links(msgs, prefix or "/")
        else:
            return  # neither group nor dataset (a committed datatype)
        for name, child in links:
            if child is not None:  # soft and external links are not followed
                self.walk(child, f"{prefix}{name}/", out)

    def symbol_table(self, btree: int, heap: int) -> List[Tuple[str, int]]:
        d = self.d
        self.signature(heap, b"HEAP", "local heap")
        heap_data = self.u(heap + 24, 8)
        out = []
        for snod in self.group_leaves(btree):
            self.signature(snod, b"SNOD", "symbol table node")
            for i in range(self.u(snod + 6, 2)):
                e = snod + 8 + 40 * i
                start = heap_data + self.u(e, 8)
                name = d[start:d.index(b"\x00", start)].decode()
                out.append((name, self.u(e + 8, 8)))
        return out

    def group_leaves(self, node: int) -> List[int]:
        d = self.d
        if d[node:node + 4] != b"TREE" or d[node + 4] != 0:
            self.fail("group B-tree node of another kind")
        level, used = d[node + 5], self.u(node + 6, 2)
        kids = [self.u(node + 24 + 8 + 16 * i, 8) for i in range(used)]
        if level == 0:
            return kids
        return [leaf for k in kids for leaf in self.group_leaves(k)]

    def new_style_links(self, msgs, where: str
                        ) -> List[Tuple[str, Optional[int]]]:
        """A group's links: its link messages, or with a fractal heap in
        its link info message (dense storage) each link of the heap through
        the name index (a version 2 B-tree of type 5)."""
        info = next(b for t, _, b in msgs if t == 0x02)
        if info[0] != 0:
            self.fail(f"link info message version {info[0]} (in {where})")
        at = 2 + (8 if info[1] & 1 else 0)
        heap = self.u_bytes(info[at:at + 8])
        if heap == _UNDEF:
            return [self.link(b, where) for t, _, b in msgs if t == 0x06]
        index = self.u_bytes(info[at + 8:at + 16])
        return [self.link(self.heap_object(heap, rec[4:]), where)
                for rec in self.btree2(index, 5)]

    def link(self, b: bytes, where: str) -> Tuple[str, Optional[int]]:
        """(name, object header address) of a link message; the address is
        None for a soft or external link."""
        if b[0] != 1:
            self.fail(f"link message version {b[0]} (in {where})")
        flags, at, kind = b[1], 2, 0
        if flags & 0x08:
            kind = b[at]
            at += 1
        at += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        length = self.u_bytes(b[at:at + width])
        at += width
        name = b[at:at + length].decode()
        return name, (self.u_bytes(b[at + length:at + length + 8])
                      if kind == 0 else None)

    # -- fractal heaps ------------------------------------------------------

    def heap(self, addr: int) -> Dict[str, int]:
        """The fractal heap header at ``addr``: what locating its objects
        needs."""
        if addr in self.heaps:
            return self.heaps[addr]
        self.signature(addr, b"FRHP", "fractal heap header")
        filtered = self.u(addr + 7, 2)
        if filtered:
            self.fail("fractal heap with I/O filters")
        self.checked(addr, 146, "fractal heap header")
        h = {"flags": self.d[addr + 9], "max_man": self.u(addr + 10, 4),
             "width": self.u(addr + 110, 2), "start": self.u(addr + 112, 8),
             "max_direct": self.u(addr + 120, 8),
             "bits": self.u(addr + 128, 2), "root": self.u(addr + 132, 8),
             "rows": self.u(addr + 140, 2)}
        h["off_size"] = (h["bits"] + 7) // 8
        h["len_size"] = min((h["max_direct"].bit_length() + 6) // 8,
                            _enc_size(h["max_man"]))
        h["direct_rows"] = (h["max_direct"].bit_length()
                            - h["start"].bit_length() + 2)
        self.heaps[addr] = h
        return h

    def heap_object(self, addr: int, hid: bytes) -> bytes:
        """The object of the fractal heap at ``addr`` whose heap ID is
        ``hid``: managed (in a direct block) or tiny (in the ID)."""
        h = self.heap(addr)
        kind = hid[0] >> 4 & 3
        if hid[0] >> 6 or kind == 1:
            self.fail("fractal heap object other than managed and tiny")
        if kind == 2:
            return hid[1:2 + (hid[0] & 0x0F)]
        off = self.u_bytes(hid[1:1 + h["off_size"]])
        size = self.u_bytes(hid[1 + h["off_size"]:
                                1 + h["off_size"] + h["len_size"]])
        if h["rows"] == 0:
            block, block_size = h["root"], h["start"]
        else:
            block, block_size = self.direct_block(h, h["root"], h["rows"],
                                                  off)
        self.signature(block, b"FHDB", "fractal heap direct block")
        block_off = self.u(block + 13, h["off_size"])
        if h["flags"] & 2:
            at = block + 13 + h["off_size"]
            image = bytearray(self.d[block:block + block_size])
            image[at - block:at - block + 4] = bytes(4)
            if _lookup3(bytes(image)) != self.u(at, 4):
                raise ValueError(f"{self.path}: HDF5 fractal heap direct "
                                 f"block at {block} whose checksum does "
                                 "not match")
        pos = block + off - block_off
        return self.d[pos:pos + size]

    def direct_block(self, h: Dict[str, int], iblock: int, nrows: int,
                     off: int) -> Tuple[int, int]:
        """(address, size) of the direct block holding heap offset ``off``,
        under the indirect block at ``iblock`` of ``nrows`` rows."""
        self.signature(iblock, b"FHIB", "fractal heap indirect block")
        width, start = h["width"], h["start"]
        entries = iblock + 13 + h["off_size"]
        n_direct = min(nrows, h["direct_rows"]) * width
        n_indirect = max(nrows - h["direct_rows"], 0) * width
        self.checked(iblock, entries - iblock + 8 * (n_direct + n_indirect)
                     + 4, "fractal heap indirect block")
        rel = off - self.u(iblock + 13, h["off_size"])
        if rel < width * start:
            row, size, row_start = 0, start, 0
        else:
            row = (rel // (width * start)).bit_length()
            size = start << (row - 1)
            row_start = width * size
        entry = row * width + (rel - row_start) // size
        if row < h["direct_rows"]:
            return self.u(entries + 8 * entry, 8), size
        child = self.u(entries + 8 * entry, 8)
        return self.direct_block(h, child, size.bit_length()
                                 - (start * width).bit_length() + 1, off)

    # -- version 2 B-trees ------------------------------------------------

    def btree2(self, addr: int, rtype: Iterable[int]) -> List[bytes]:
        """The records of the version 2 B-tree at ``addr``, whose type must
        be one of ``rtype``, in order."""
        d = self.d
        self.signature(addr, b"BTHD", "version 2 B-tree header")
        rtypes = (rtype,) if isinstance(rtype, int) else tuple(rtype)
        if d[addr + 4] != 0 or d[addr + 5] not in rtypes:
            self.fail(f"version 2 B-tree of type {d[addr + 5]}")
        self.checked(addr, 38, "version 2 B-tree header")
        node_size, rec = self.u(addr + 6, 4), self.u(addr + 10, 2)
        depth, root = self.u(addr + 12, 2), self.u(addr + 16, 8)
        if root == _UNDEF:
            return []
        # the widths of the record counts in internal nodes' child pointers
        cum = [(node_size - 10) // rec]
        nrec_size, cum_size = _enc_size(cum[0]), [0]
        for level in range(1, depth + 1):
            ptr = 8 + nrec_size + cum_size[-1]
            most = (node_size - 10 - ptr) // (rec + ptr)
            cum.append((most + 1) * cum[-1] + most)
            cum_size.append(_enc_size(cum[-1]))
        out: List[bytes] = []

        def node(at: int, n: int, level: int):
            recs = [d[at + 6 + i * rec:at + 6 + (i + 1) * rec]
                    for i in range(n)]
            if level == 0:
                self.signature(at, b"BTLF", "version 2 B-tree leaf")
                self.checked(at, 10 + n * rec, "version 2 B-tree leaf")
                out.extend(recs)
                return
            self.signature(at, b"BTIN", "version 2 B-tree internal node")
            ptr = 8 + nrec_size + cum_size[level - 1]
            kids = at + 6 + n * rec
            self.checked(at, kids - at + (n + 1) * ptr + 4,
                         "version 2 B-tree internal node")
            for i in range(n + 1):
                p = kids + i * ptr
                node(self.u(p, 8), self.u(p + 8, nrec_size), level - 1)
                if i < n:
                    out.append(recs[i])

        node(root, self.u(addr + 24, 2), depth)
        return out

    # -- datasets ---------------------------------------------------------

    def dataset(self, addr: int, name: str) -> np.ndarray:
        msgs = self.messages(addr)
        by_type: Dict[int, bytes] = {}
        for mtype, mflags, body in msgs:
            if mflags & 0x02 and mtype in _SHAREABLE:
                self.fail(f"shared {_SHAREABLE[mtype]} message (in {name})")
            by_type.setdefault(mtype, body)
        if 0x07 in by_type:
            self.fail(f"external data files message (in {name})")
        shape, maxshape = self.dataspace(by_type[0x01], name)
        dtype, as_read = self.datatype(by_type[0x03], name)
        lay = by_type[0x08]
        if lay[0] not in (3, 4):
            self.fail(f"layout message version {lay[0]} (in {name})")
        n = math.prod(shape) * dtype.itemsize
        if 0x0B in by_type and lay[1] != 2:
            self.fail(f"filter pipeline on unchunked storage (in {name})")
        if lay[1] == 0:      # compact
            raw = lay[4:4 + self.u_bytes(lay[2:4])]
        elif lay[1] == 1:    # contiguous
            at = self.u_bytes(lay[2:10])
            if at == _UNDEF:  # never written: the fill value
                raw = self.fill(by_type, dtype, name).tobytes() * math.prod(
                    shape)
            else:
                raw = self.d[at:at + n]
        elif lay[1] == 2:
            return as_read(self.chunked(by_type, lay, shape, maxshape,
                                        dtype, name))
        else:
            self.fail(f"virtual dataset storage (in {name})")
        if len(raw) != n:
            self.fail(f"dataset of {len(raw)} bytes for {n} (in {name})")
        return as_read(np.frombuffer(raw, dtype).reshape(shape).copy())

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
            if fid not in _READ_FILTERS:
                self.fail(f"filter {_FILTERS.get(fid, f'id {fid}')} "
                          f"(in {name})")
            out.append((fid, vals))
        return out

    def unfilter(self, raw: bytes, pipeline, mask: int, dtype: np.dtype,
                 nbytes: int, name: str) -> bytes:
        """A chunk's bytes with the pipeline's filters undone, last first;
        a filter whose bit is set in the chunk's mask was not applied."""
        fail = lambda what: self.fail(f"{what} (in {name})")  # noqa: E731
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
            elif fid == 3:
                stored = self.u_bytes(raw[-4:])
                got = _fletcher32(raw[:-4])
                # files of HDF5 before 1.6.3 stored its bytes reversed
                if stored not in (got, int.from_bytes(
                        got.to_bytes(4, "little"), "big")):
                    self.fail(f"chunk whose fletcher32 checksum does not "
                              f"match (in {name})")
                raw = raw[:-4]
            elif fid == 32000:
                raw = _lzf(raw, nbytes)
            elif fid == 6:
                raw = _scale_offset(raw, vals, dtype, fail).tobytes()
            else:
                raw = _nbit(raw, vals, dtype, fail).tobytes()
        return raw

    def chunked(self, msgs: Dict[int, bytes], lay: bytes,
                shape: Tuple[int, ...], maxshape: Tuple[int, ...],
                dtype: np.dtype, name: str) -> np.ndarray:
        """A chunked dataset: its chunks, found through its chunk index,
        filtered back and laid into the array (edge chunks cut to its
        shape; chunks never written, the fill value)."""
        if lay[0] == 3:
            ndims, at = lay[2], 11
            dims = [self.u_bytes(lay[at + 4 * i:at + 4 * i + 4])
                    for i in range(ndims)]
        else:
            if lay[2] & 1:
                self.fail(f"chunks of the edge left unfiltered (in {name})")
            ndims, width, at = lay[3], lay[4], 5
            dims = [self.u_bytes(lay[at + width * i:at + width * (i + 1)])
                    for i in range(ndims)]
            at += width * ndims
        if ndims != len(shape) + 1 or dims[-1] != dtype.itemsize:
            self.fail(f"chunk dimensions {tuple(dims)} for shape {shape} "
                      f"(in {name})")
        chunk = tuple(dims[:-1])
        pipeline = self.filters(msgs[0x0B], name) if 0x0B in msgs else []
        out = np.empty(shape, dtype)
        out[...] = self.fill(msgs, dtype, name)[0]
        nbytes = math.prod(chunk) * dtype.itemsize
        if 0 in shape:
            return out
        if lay[0] == 3:
            btree = self.u_bytes(lay[3:11])
            found = [] if btree == _UNDEF else self.chunk_leaves(btree,
                                                                 ndims)
        else:
            found = self.indexed_chunks(lay, at, chunk, maxshape, nbytes,
                                        bool(pipeline), name)
        for size, mask, offset, addr in found:
            if any(o >= n for o, n in zip(offset, shape)):
                continue  # past a dimension the dataset was shrunk to
            raw = self.unfilter(self.d[addr:addr + size], pipeline, mask,
                                dtype, nbytes, name)
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

    def indexed_chunks(self, lay: bytes, at: int, chunk: Tuple[int, ...],
                       maxshape: Tuple[int, ...], nbytes: int,
                       filtered: bool, name: str):
        """(size, filter mask, offset, address) of each chunk written, from
        a version 4 layout message's chunk index (its type at ``at``)."""
        kind = lay[at]
        rank = len(chunk)
        # chunks are numbered row-major over the grid the maximum shape
        # gives; an extensible array's unlimited dimension goes first
        grid = [-(-m // c) for m, c in zip(maxshape, chunk)]
        order = list(range(rank))
        if kind == 1:    # one chunk
            params = lay[at + 1:at + 13] if lay[2] & 2 else b""
            addr = self.u_bytes(lay[at + 1 + len(params):
                                    at + 9 + len(params)])
            if addr == _UNDEF:
                return []
            size, mask = (self.u_bytes(params[:8]), self.u_bytes(params[8:])
                          ) if params else (nbytes, 0)
            return [(size, mask, (0,) * rank, addr)]
        if kind == 2:    # implicit: every chunk, in order
            base = self.u_bytes(lay[at + 1:at + 9])
            if base == _UNDEF:
                return []
            count = math.prod(grid)
            elements = [(base + i * nbytes).to_bytes(8, "little")
                        for i in range(count)]
        elif kind == 3:  # fixed array
            elements = self.fixed_array(self.u_bytes(lay[at + 2:at + 10]))
        elif kind == 4:  # extensible array
            unlim = [i for i, m in enumerate(maxshape) if m == _UNDEF]
            order = unlim + [i for i in range(rank) if i not in unlim]
            elements = self.extensible_array(
                self.u_bytes(lay[at + 6:at + 14]))
        elif kind == 5:  # version 2 B-tree of the chunks' scaled offsets
            recs = self.btree2(self.u_bytes(lay[at + 7:at + 15]),
                               (11 if filtered else 10,))
            out = []
            for r in recs:
                scaled = np.frombuffer(r[len(r) - 8 * rank:], "<u8")
                size, mask = ((self.u_bytes(r[8:len(r) - 8 * rank - 4]),
                               self.u_bytes(r[len(r) - 8 * rank - 4:
                                              len(r) - 8 * rank]))
                              if filtered else (nbytes, 0))
                out.append((size, mask, tuple(int(s) * c for s, c in zip(
                    scaled, chunk)), self.u_bytes(r[:8])))
            return out
        else:
            self.fail(f"chunk index type {kind} (in {name})")
        out = []
        for i, e in enumerate(elements):
            if e is None or self.u_bytes(e[:8]) == _UNDEF:
                continue
            coords, rest = [0] * rank, i
            for k in reversed(order[1:]):
                coords[k] = rest % grid[k]
                rest //= grid[k]
            coords[order[0]] = rest
            size, mask = ((self.u_bytes(e[8:-4]), self.u_bytes(e[-4:]))
                          if filtered else (nbytes, 0))
            out.append((size, mask, tuple(c * k for c, k in zip(coords,
                                                                   chunk)),
                        self.u_bytes(e[:8])))
        return out

    def elements(self, at: int, n: int, esize: int, page_n: int,
                 paged: bool, init: bytes, first: int, what: str
                 ) -> List[Optional[bytes]]:
        """``n`` elements of ``esize`` bytes from ``at``: in pages of
        ``page_n`` elements, each followed by its checksum, when ``paged``
        (``init``: the bitmap of pages written, most significant bit
        first, this block's first page at bit ``first``; a page not written
        holds no element), else one run (checked with its block)."""
        if not paged:
            return [self.d[at + i * esize:at + (i + 1) * esize]
                    for i in range(n)]
        out: List[Optional[bytes]] = []
        for page in range(-(-n // page_n)):
            count = min(page_n, n - page * page_n)
            bit = first + page
            if not init[bit // 8] >> (7 - bit % 8) & 1:
                out += [None] * count
                continue
            p = at + page * (page_n * esize + 4)
            self.checked(p, count * esize + 4, f"{what} page")
            out += [self.d[p + i * esize:p + (i + 1) * esize]
                    for i in range(count)]
        return out

    def fixed_array(self, addr: int) -> List[Optional[bytes]]:
        """The elements of the fixed array whose header is at ``addr``."""
        self.signature(addr, b"FAHD", "fixed array header")
        self.checked(addr, 28, "fixed array header")
        esize, page_bits = self.d[addr + 6], self.d[addr + 7]
        n, block = self.u(addr + 8, 8), self.u(addr + 16, 8)
        if block == _UNDEF:
            return []
        self.signature(block, b"FADB", "fixed array data block")
        page_n = 1 << page_bits
        paged = n > page_n
        head = 14 + ((-(-n // page_n) + 7) // 8 if paged else 0)
        self.checked(block, head + (0 if paged else n * esize) + 4,
                     "fixed array data block")
        return self.elements(block + head + (4 if paged else 0), n, esize,
                             page_n, paged, self.d[block + 14:block + head],
                             0, "fixed array data block")

    def extensible_array(self, addr: int) -> List[Optional[bytes]]:
        """The elements of the extensible array whose header is at
        ``addr``, up to the highest one set."""
        d = self.d
        self.signature(addr, b"EAHD", "extensible array header")
        self.checked(addr, 72, "extensible array header")
        esize, max_bits, in_index, dblk_min, sblk_min, page_bits = \
            d[addr + 6:addr + 12]
        count, iblock = self.u(addr + 44, 8), self.u(addr + 60, 8)
        if iblock == _UNDEF:
            return []
        self.signature(iblock, b"EAIB", "extensible array index block")
        off_size = (max_bits + 7) // 8
        page_n = 1 << page_bits
        n_sblks = 1 + max_bits - (dblk_min.bit_length() - 1)
        in_iblock = 2 * (sblk_min.bit_length() - 1)
        dblk_addrs = 2 * (sblk_min - 1)
        at = iblock + 14 + in_index * esize
        self.checked(iblock, at - iblock + 8 * (dblk_addrs + n_sblks
                                                - in_iblock) + 4,
                     "extensible array index block")
        out = self.elements(iblock + 14, min(in_index, count), esize, 1, False,
                            b"", 0, "")
        dblock = 0
        for s in range(n_sblks):
            if len(out) >= count:
                break
            n_dblks, per = 1 << s // 2, dblk_min << (s + 1) // 2
            paged = per > page_n
            init = b""
            if s < in_iblock:
                if paged:
                    self.fail("paged data block of an extensible array's "
                              "index block")
                addrs = [self.u(at + 8 * (dblock + j), 8)
                         for j in range(n_dblks)]
                dblock += n_dblks
            else:
                sblk = self.u(at + 8 * (dblk_addrs + s - in_iblock), 8)
                if sblk == _UNDEF:
                    addrs = [_UNDEF] * n_dblks
                else:
                    self.signature(sblk, b"EASB",
                                   "extensible array super block")
                    size = (-(-per // page_n) + 7) // 8 if paged else 0
                    init = d[sblk + 14 + off_size:
                             sblk + 14 + off_size + n_dblks * size]
                    first = sblk + 14 + off_size + n_dblks * size
                    self.checked(sblk, first - sblk + 8 * n_dblks + 4,
                                 "extensible array super block")
                    addrs = [self.u(first + 8 * j, 8) for j in range(n_dblks)]
            for j, a in enumerate(addrs):
                want = min(per, count - len(out))
                if want <= 0:
                    break
                if a == _UNDEF:
                    out += [None] * want
                    continue
                self.signature(a, b"EADB", "extensible array data block")
                head = 14 + off_size
                self.checked(a, head + (0 if paged else per * esize) + 4,
                             "extensible array data block")
                pages = -(-per // page_n)
                out += self.elements(a + head + (4 if paged else 0), per,
                                     esize, page_n, paged, init,
                                     j * pages, "extensible array data "
                                     "block")[:want]
        return out

    def dataspace(self, b: bytes, name: str
                  ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(shape, maximum shape; _UNDEF where unlimited)."""
        version, ndim, flags = b[0], b[1], b[2]
        start = {1: 8, 2: 4}.get(version)
        if start is None:
            self.fail(f"dataspace version {version} (in {name})")
        if version == 2 and b[3] == 2:
            self.fail(f"null dataspace (in {name})")
        dims = [self.u_bytes(b[start + 8 * i:start + 8 * i + 8])
                for i in range(2 * ndim if flags & 1 else ndim)]
        return tuple(dims[:ndim]), tuple(dims[ndim:] or dims)

    def datatype(self, b: bytes, name: str):
        """(numpy dtype, a function from the stored array to the one h5py
        reads: h5py's bool as numpy bool, integers of fewer bits than their
        size shifted down and sign-extended)."""
        cls, bits, size = b[0] & 15, b[1], self.u_bytes(b[4:8])
        if cls == 8:  # enum: h5py's bool only
            members = b[1] | b[2] << 8
            base, _ = self.datatype(b[8:20], name)
            names, pos = [], 20
            for _ in range(members):
                end = b.index(b"\x00", pos)
                names.append(b[pos:end].decode())
                pos = end + 1 if b[0] >> 4 >= 3 else pos + (
                    end - pos + 8) // 8 * 8
            values = np.frombuffer(b[pos:pos + members * base.itemsize],
                                   base).tolist()
            if base.itemsize != 1 or dict(zip(names, values)) != {
                    "FALSE": 0, "TRUE": 1}:
                self.fail(f"enum datatype other than h5py's bool (in {name})")
            return base, lambda a: a.astype(bool)
        if cls not in (0, 1):
            kinds = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 9: "variable-length",
                     10: "array"}
            self.fail(f"{kinds.get(cls, f'class {cls}')} datatype "
                      f"(in {name})")
        order = ">" if bits & 1 else "<"
        offset, precision = self.u_bytes(b[8:10]), self.u_bytes(b[10:12])
        if cls == 1:
            if size not in (2, 4, 8) or bits & 0x40 or (
                    offset, precision) != (0, 8 * size):
                self.fail(f"{precision}-bit float of {size} bytes of this "
                          f"layout (in {name})")
            return np.dtype(f"{order}f{size}"), lambda a: a
        signed = bool(bits & 8)
        dtype = np.dtype(f"{order}{'i' if signed else 'u'}{size}")
        if (offset, precision) == (0, 8 * size):
            return dtype, lambda a: a

        def significant(a):
            v = (a.astype(dtype.newbyteorder("=")).view(f"u{size}")
                 .astype(np.uint64) >> np.uint64(offset)) & np.uint64(
                     (1 << precision) - 1)
            if signed:  # sign-extend from the top significant bit
                v = v.astype(np.int64) - ((v >> np.uint64(precision - 1))
                                          .astype(np.int64) << precision)
            return v.astype(dtype)
        return dtype, significant


def _datasets(path: str) -> Tuple[_Reader, Dict[str, int]]:
    """A reader of the file and {dataset path: its object header's
    address}."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not an HDF5 file (no signature at byte 0)")
    r = _Reader(data, path)
    version = data[8]
    if version not in (0, 1, 2, 3):
        r.fail(f"superblock version {version}")
    if version < 2:
        sizes, root = data[13:15], r.u(24 + 32 + 4 * version + 8, 8)
    else:
        r.checked(0, 48, "superblock")
        sizes, root = data[9:11], r.u(36, 8)
    if sizes != b"\x08\x08":
        r.fail("file with offsets or lengths other than 8 bytes")
    found: Dict[str, int] = {}
    r.walk(root, "", found)
    return r, found


def read_hdf5(path: str, names: Optional[Iterable[str]] = None
              ) -> Dict[str, np.ndarray]:
    """The datasets ``names`` of the file (every dataset when None), by
    their path from the root ("a", "camera/focal_length"); no other dataset
    is decoded. A name the file does not hold raises ``KeyError``."""
    r, found = _datasets(path)
    wanted = list(found) if names is None else list(names)
    missing = [n for n in wanted if n.strip("/") not in found]
    if missing:
        raise KeyError(f"{path}: no dataset {missing}")
    return {n: r.dataset(found[n.strip("/")], n) for n in wanted}


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
