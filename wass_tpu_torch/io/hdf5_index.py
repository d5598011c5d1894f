"""HDF5 on-disk structures behind io/hdf5.py's reader: chunk indexes,
filter pipelines, version 2 B-trees and fractal heaps (stdlib + numpy).

Each structure follows the HDF5 File Format Specification 3.0 and is
read through a `read(address, nbytes) -> bytes` callable; every checksum
a structure carries is verified.

* The filter pipeline message (IV.A.2.l, versions 1 and 2): deflate
  through zlib, shuffle, fletcher32 (its checksum verified, then
  stripped); a chunk's filter mask skips the filters whose bits it sets.
  Any other filter raises a LayoutError that names it.
* The data layout message (IV.A.2.i), versions 3 and 4, and the five
  chunk indexes of version 4: single chunk, implicit, fixed array
  (III.H: FAHD/FADB, paged or not), extensible array (III.H: EAHD, EAIB,
  EASB, EADB, paged data blocks) and the version 2 B-tree (record types
  10 and 11).  Each gives the same map, chunk origin -> (address, bytes,
  filter mask).
* The version 2 B-tree (III.A.2): header, internal and leaf nodes, with
  the byte widths of the child record counts derived from the node size
  as the specification fixes them.
* The fractal heap (III.G): header, direct and indirect blocks over the
  doubling table, managed and tiny objects.  Huge objects and heaps with
  I/O filters raise a LayoutError.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address

Read = Callable[[int, int], bytes]
Index = Dict[Tuple[int, ...], Tuple[int, int, int]]  # chunk origin -> (address, bytes, filter mask)


class LayoutError(ValueError):
    """A file this module reads but does not edit (or does not read)."""


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 hashlittle, the checksum of HDF5 metadata."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & 0xFFFFFFFF
    m = 0xFFFFFFFF
    pos = 0
    while n - pos > 12:
        x, y, z = struct.unpack_from("<3I", data, pos)
        a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
        a = ((a - c) & m) ^ _rot(c, 4); c = (c + b) & m
        b = ((b - a) & m) ^ _rot(a, 6); a = (a + c) & m
        c = ((c - b) & m) ^ _rot(b, 8); b = (b + a) & m
        a = ((a - c) & m) ^ _rot(c, 16); c = (c + b) & m
        b = ((b - a) & m) ^ _rot(a, 19); a = (a + c) & m
        c = ((c - b) & m) ^ _rot(b, 4); b = (b + a) & m
        pos += 12
    if n - pos == 0:
        return c
    x, y, z = struct.unpack("<3I", data[pos:].ljust(12, b"\0"))
    a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
    c = (c ^ b) - _rot(b, 14) & m
    a = (a ^ c) - _rot(c, 11) & m
    b = (b ^ a) - _rot(a, 25) & m
    c = (c ^ b) - _rot(b, 16) & m
    a = (a ^ c) - _rot(c, 4) & m
    b = (b ^ a) - _rot(a, 14) & m
    c = (c ^ b) - _rot(b, 24) & m
    return c


def checked(block: bytes, what: str, signature: bytes = b"") -> bytes:
    """block (signature first, lookup3 checksum last) after verifying both."""
    if signature and block[:4] != signature:
        raise ValueError(f"{what}: signature {block[:4]!r}, expected {signature!r}")
    if lookup3(block[:-4]) != struct.unpack_from("<I", block, len(block) - 4)[0]:
        raise ValueError(f"{what}: checksum mismatch")
    return block


def _uint(data: bytes, p: int, width: int) -> int:
    return int.from_bytes(data[p:p + width], "little")


def _bytes_for(n: int) -> int:
    """The bytes the library encodes a count up to n in: log2(n) / 8 + 1."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


# -- the filter pipeline (IV.A.2.l) ---------------------------------------------

FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                32000: "lzf", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}


@dataclasses.dataclass(frozen=True)
class Filter:
    id: int
    values: Tuple[int, ...]  # the client data

    @property
    def name(self) -> str:
        return FILTER_NAMES.get(self.id, "unregistered")


def parse_filters(d: bytes) -> List[Filter]:
    """The filters of a filter pipeline message, in the order they were
    applied on writing."""
    version, n = d[0], d[1]
    if version not in (1, 2):
        raise LayoutError(f"filter pipeline message version {version} is not read")
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", d, p)[0]
        if version == 1 or fid >= 256:  # id, name length, flags, client values
            name_len, nvals = struct.unpack_from("<H2xH", d, p + 2)
            p += 8
        else:
            name_len, nvals = 0, struct.unpack_from("<H", d, p + 4)[0]
            p += 6
        p += (name_len + 7) & ~7 if version == 1 else name_len
        vals = struct.unpack_from(f"<{nvals}I", d, p)
        p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        out.append(Filter(fid, vals))
    return out


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit
    words, the sums folded every 360 words."""
    n = len(data)
    words = np.frombuffer(data[:n - n % 2], ">u2").astype(np.uint64)
    s1 = s2 = 0
    for p in range(0, len(words), 360):
        blk = words[p:p + 360]
        c = np.cumsum(blk)
        s2 += int(c.sum()) + len(blk) * s1
        s1 += int(c[-1])
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if n % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _unshuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    body = np.frombuffer(data, np.uint8, count=n * size).reshape(size, n).T.tobytes()
    return body + data[n * size:]


def unfilter(data: bytes, filters: List[Filter], mask: int, what: str) -> bytes:
    """A chunk's bytes through its pipeline in reverse; filter i is skipped
    where bit i of mask is set."""
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        f = filters[i]
        if f.id == 1:
            data = zlib.decompress(data)
        elif f.id == 2:
            data = _unshuffle(data, f.values[0] if f.values else 1)
        elif f.id == 3:
            if len(data) < 4 or fletcher32(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
                raise ValueError(f"{what}: fletcher32 checksum mismatch")
            data = data[:-4]
        else:
            raise LayoutError(f"{what}: filter {f.id} ({f.name}) is not read")
    return data


# -- the data layout message (IV.A.2.i) -----------------------------------------

SINGLE, IMPLICIT, FIXED_ARRAY, EXTENSIBLE_ARRAY, BTREE2, BTREE1 = 1, 2, 3, 4, 5, 0


@dataclasses.dataclass
class Layout:
    """A data layout message: compact (data), contiguous (address, size)
    or chunked (chunk shape, index type and address; the indexes' own
    headers repeat their parameters)."""

    kind: str  # compact, contiguous, chunked
    address: int = UNDEF  # contiguous data, or the chunk index (the single chunk)
    size: int = 0  # contiguous bytes
    data: bytes = b""  # compact data
    chunks: Tuple[int, ...] = ()
    index: int = BTREE1
    single_size: int = 0  # a filtered single chunk's bytes and filter mask
    single_mask: int = 0
    partial_unfiltered: bool = False  # "don't filter partial edge chunks"


def parse_layout(d: bytes, what: str) -> Layout:
    version, cls = d[0], d[1]
    if version not in (3, 4):
        raise LayoutError(f"{what}: a version {version} layout message is not read")
    if cls == 0:
        n = struct.unpack_from("<H", d, 2)[0]
        return Layout("compact", data=d[4:4 + n])
    if cls == 1:
        addr, size = struct.unpack_from("<QQ", d, 2)
        return Layout("contiguous", addr, size)
    if cls != 2:
        raise LayoutError(f"{what}: layout class {cls} (virtual) is not read")
    if version == 3:
        ndims = d[2]
        return Layout("chunked", struct.unpack_from("<Q", d, 3)[0],
                      chunks=struct.unpack_from(f"<{ndims}I", d, 11)[:-1])
    flags, ndims, width = d[2], d[3], d[4]
    dims = tuple(_uint(d, 5 + i * width, width) for i in range(ndims))
    p = 5 + ndims * width
    index = d[p]
    p += 1
    lay = Layout("chunked", chunks=dims[:-1], index=index, partial_unfiltered=bool(flags & 1))
    if index == SINGLE and flags & 2:
        lay.single_size, lay.single_mask = struct.unpack_from("<QI", d, p)
    # The index type's parameters: page bits (fixed array); max bits, index
    # elements, min pointers, min elements, page bits (extensible array);
    # node size, split and merge percent (version 2 B-tree).
    params = {SINGLE: 12 if flags & 2 else 0, IMPLICIT: 0, FIXED_ARRAY: 1, EXTENSIBLE_ARRAY: 5, BTREE2: 6}
    if index not in params:
        raise LayoutError(f"{what}: chunk index type {index} is not read")
    lay.address = struct.unpack_from("<Q", d, p + params[index])[0]
    return lay


# -- version 2 B-trees (III.A.2) ---------------------------------------------------


def btree2_records(read: Read, addr: int) -> Tuple[int, List[bytes]]:
    """(record type, every record) of the version 2 B-tree at addr."""
    head = checked(read(addr, 38), f"v2 B-tree header at {addr}", b"BTHD")
    btype, node_size, rec_size, depth = struct.unpack_from("<BIHH", head, 5)
    root, root_n = struct.unpack_from("<QH", head, 16)
    # The widths of the child pointers' record counts (III.A.2): a leaf
    # holds (node size - 10) / record size records; an internal node of
    # depth d the most that fits with its pointers, whose widths follow.
    max_nrec = [(node_size - 10) // rec_size]
    cum = [max_nrec[0]]
    nrec_size = _bytes_for(max_nrec[0])
    cum_size = [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
        cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
        cum_size.append(_bytes_for(cum[d]))
    out: List[bytes] = []

    def node(at: int, n: int, d: int) -> None:
        if at == UNDEF or n == 0:
            return
        if d == 0:
            blk = checked(read(at, 6 + n * rec_size + 4), f"v2 B-tree leaf at {at}", b"BTLF")
            out.extend(blk[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(n))
            return
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        blk = checked(read(at, 6 + n * rec_size + (n + 1) * ptr + 4), f"v2 B-tree node at {at}", b"BTIN")
        out.extend(blk[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(n))
        p = 6 + n * rec_size
        for _ in range(n + 1):
            child = struct.unpack_from("<Q", blk, p)[0]
            node(child, _uint(blk, p + 8, nrec_size), d - 1)
            p += ptr

    node(root, root_n, depth)
    return btype, out


# -- fractal heaps (III.G) ---------------------------------------------------------


class FractalHeap:
    """A fractal heap's managed and tiny objects, by heap ID."""

    def __init__(self, read: Read, addr: int):
        self._read = read
        p = 14 + 8 + 8 + 8 + 8 + 8 * 8  # next huge ID, huge B-tree, free space and its manager, counters
        hdr = read(addr, p + 36)  # the header of a heap without I/O filters
        if hdr[:4] != b"FRHP":
            raise ValueError(f"fractal heap at {addr}: bad signature")
        self.id_len, filter_len, self.flags, self.max_man = struct.unpack_from("<HHBI", hdr, 5)
        if filter_len:
            raise LayoutError(f"fractal heap at {addr}: a heap with I/O filters is not read")
        self.width = struct.unpack_from("<H", hdr, p)[0]
        self.start, self.max_direct = struct.unpack_from("<QQ", hdr, p + 2)
        self.max_bits, self.root_rows0 = struct.unpack_from("<HH", hdr, p + 18)
        root, root_rows = struct.unpack_from("<QH", hdr, p + 22)
        checked(hdr, f"fractal heap header at {addr}")
        self.addr = addr
        self.off_size = (self.max_bits + 7) // 8
        self.len_size = min((self.max_direct.bit_length() - 1 + 7) // 8, _bytes_for(self.max_man))
        self.max_direct_rows = (self.max_direct.bit_length() - 1) - (self.start.bit_length() - 1) + 2
        self.first_row_bits = (self.start.bit_length() - 1) + (self.width.bit_length() - 1)
        self._blocks: List[Tuple[int, int, int]] = []  # (heap offset, size, address) of direct blocks
        if root != UNDEF:
            if root_rows == 0:
                self._blocks.append((0, self.start, root))
            else:
                self._indirect(root, 0, root_rows)
        self._blocks.sort()
        self._starts = [b[0] for b in self._blocks]
        self._cache: Dict[int, bytes] = {}

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _indirect(self, at: int, offset: int, nrows: int) -> None:
        n_direct = min(nrows, self.max_direct_rows)
        size = 4 + 1 + 8 + self.off_size + self.width * nrows * 8 + 4
        blk = checked(self._read(at, size), f"fractal heap indirect block at {at}", b"FHIB")
        p = 5 + 8 + self.off_size
        for r in range(nrows):
            rs = self._row_size(r)
            for _ in range(self.width):
                child = struct.unpack_from("<Q", blk, p)[0]
                p += 8
                if child != UNDEF:
                    if r < n_direct:
                        self._blocks.append((offset, rs, child))
                    else:
                        self._indirect(child, offset, (rs.bit_length() - 1) - self.first_row_bits + 1)
                offset += rs

    def _block(self, at: int, size: int) -> bytes:
        blk = self._cache.get(at)
        if blk is None:
            blk = self._read(at, size)
            if blk[:4] != b"FHDB":
                raise ValueError(f"fractal heap direct block at {at}: bad signature")
            if self.flags & 2:  # the checksum covers the whole block, its own field zeroed
                p = 5 + 8 + self.off_size
                want = struct.unpack_from("<I", blk, p)[0]
                if lookup3(blk[:p] + b"\0\0\0\0" + blk[p + 4:]) != want:
                    raise ValueError(f"fractal heap direct block at {at}: checksum mismatch")
            self._cache[at] = blk
        return blk

    def get(self, heap_id: bytes) -> bytes:
        kind = heap_id[0] >> 4 & 3
        if heap_id[0] >> 6:
            raise LayoutError(f"fractal heap ID version {heap_id[0] >> 6} is not read")
        if kind == 2:  # tiny: the length in the ID's first byte (or first 12 bits)
            if self.id_len - 1 <= 16:
                return heap_id[1:1 + (heap_id[0] & 0x0F) + 1]
            return heap_id[2:2 + ((heap_id[0] & 0x0F) << 8 | heap_id[1]) + 1]
        if kind != 0:
            raise LayoutError(f"fractal heap at {self.addr}: huge objects are not read")
        off = _uint(heap_id, 1, self.off_size)
        n = _uint(heap_id, 1 + self.off_size, self.len_size)
        i = bisect_right(self._starts, off) - 1
        if i < 0:
            raise ValueError(f"fractal heap at {self.addr}: no block holds offset {off}")
        start, size, at = self._blocks[i]
        if off + n > start + size:
            raise ValueError(f"fractal heap at {self.addr}: object at {off} ({n} bytes) crosses its block")
        return self._block(at, size)[off - start:off - start + n]


def dense_messages(read: Read, heap_addr: int, name_index: int, order_index: int, attrs: bool) -> List[bytes]:
    """The link (or attribute) messages of dense storage: the fractal heap's
    objects that the name index's records point to, in creation order
    where the order index is present, else in the name index's order.
    Records: links type 5 (name hash, ID) and 6 (creation order, ID);
    attributes type 8 (ID, flags, creation order, name hash) and 9 (ID,
    flags, creation order)."""
    heap = FractalHeap(read, heap_addr)
    btype, recs = btree2_records(read, name_index)
    if btype != (8 if attrs else 5):
        raise ValueError(f"name index at {name_index}: record type {btype}")
    ids = [r[:8] if attrs else r[4:] for r in recs]
    if attrs and any(r[8] & 0x02 for r in recs):
        raise LayoutError("shared attribute messages (a shared-message table) are not read")
    if order_index != UNDEF:
        btype, orecs = btree2_records(read, order_index)
        if btype != (9 if attrs else 6):
            raise ValueError(f"creation order index at {order_index}: record type {btype}")
        keyed = sorted((struct.unpack_from("<I" if attrs else "<Q", r, 9 if attrs else 0)[0],
                        r[:8] if attrs else r[8:]) for r in orecs)
        if sorted(k for _, k in keyed) != sorted(ids):
            raise ValueError(f"dense storage at {heap_addr}: the name and creation order indexes disagree")
        ids = [k for _, k in keyed]
    return [heap.get(i) for i in ids]


# -- chunk indexes ---------------------------------------------------------------


def _entry_reader(elem_size: int, filtered: bool, chunk_bytes: int):
    """Decodes one index element: (address, bytes, filter mask)."""
    if not filtered:
        return lambda b, p: (struct.unpack_from("<Q", b, p)[0], chunk_bytes, 0)
    w = elem_size - 12  # the chunk size's width: 1 + (log2(unfiltered chunk bytes) + 8) / 8, at most 8

    def entry(b, p):
        return struct.unpack_from("<Q", b, p)[0], _uint(b, p + 8, w), struct.unpack_from("<I", b, p + 8 + w)[0]

    return entry


def _origins(linear: int, down: Tuple[int, ...], chunks: Tuple[int, ...], order: Tuple[int, ...]) -> Tuple[int, ...]:
    scaled = [0] * len(chunks)
    for ax, step in zip(order, down):
        scaled[ax], linear = divmod(linear, step)
    return tuple(s * c for s, c in zip(scaled, chunks))


def _down(counts: List[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for c in reversed(counts):
        out.append(acc)
        acc *= c
    return tuple(reversed(out))


def chunk_index(read: Read, lay: Layout, shape: Tuple[int, ...], maxshape: Tuple[int, ...], elem_size: int,
                filtered: bool, what: str) -> Index:
    """A chunked dataset's chunks: origin -> (address, bytes, filter mask),
    allocated chunks only, whatever the index type."""
    cs = lay.chunks
    chunk_bytes = int(np.prod(cs, dtype=np.int64)) * elem_size
    nd = len(cs)
    out: Index = {}
    if lay.address == UNDEF:
        return out
    # The linear chunk order of the implicit, fixed and extensible array
    # indexes: row-major over the chunks the maximum dimensions hold, an
    # unlimited dimension (the extensible array's one) moved to the front.
    unlim = [i for i, m in enumerate(maxshape) if m == UNDEF]
    counts = [-(-(shape[i] if maxshape[i] == UNDEF else maxshape[i]) // cs[i]) for i in range(nd)]
    order = tuple(range(nd))
    if lay.index == EXTENSIBLE_ARRAY and unlim and unlim[0] > 0:
        u = unlim[0]
        order = (u,) + tuple(i for i in range(nd) if i != u)
    down = _down([counts[a] for a in order])

    def put(linear: int, entry) -> None:
        if entry[0] != UNDEF:
            o = _origins(linear, down, cs, order)
            if all(a < n for a, n in zip(o, shape)):
                out[o] = entry

    if lay.index == BTREE1:
        for key, child in btree1_leaves(read, lay.address, 1, 8 + 8 * (nd + 1)):
            nbytes, mask = struct.unpack_from("<II", key)
            out[struct.unpack_from(f"<{nd}Q", key, 8)] = (child, nbytes, mask)
    elif lay.index == SINGLE:
        out[(0,) * nd] = (lay.address, lay.single_size, lay.single_mask) if filtered else (lay.address, chunk_bytes, 0)
    elif lay.index == IMPLICIT:
        for i in range(int(np.prod(counts, dtype=np.int64))):
            put(i, (lay.address + i * chunk_bytes, chunk_bytes, 0))
    elif lay.index == FIXED_ARRAY:
        for i, e in _fixed_array(read, lay.address, filtered, chunk_bytes):
            put(i, e)
    elif lay.index == EXTENSIBLE_ARRAY:
        for i, e in _extensible_array(read, lay.address, filtered, chunk_bytes):
            put(i, e)
    elif lay.index == BTREE2:
        btype, recs = btree2_records(read, lay.address)
        if btype != (11 if filtered else 10):
            raise ValueError(f"{what}: chunk B-tree record type {btype}")
        w = len(recs[0]) - 12 - 8 * nd if recs else 0
        for r in recs:
            scaled = struct.unpack_from(f"<{nd}Q", r, len(r) - 8 * nd)
            addr = struct.unpack_from("<Q", r)[0]
            entry = (addr, _uint(r, 8, w), struct.unpack_from("<I", r, 8 + w)[0]) if filtered else (addr, chunk_bytes, 0)
            out[tuple(s * c for s, c in zip(scaled, cs))] = entry
    else:
        raise LayoutError(f"{what}: chunk index type {lay.index} is not read")
    return out


def btree1_leaves(read: Read, addr: int, node_type: int, key_size: int):
    """The (key, child address) pairs of a version 1 B-tree's leaves (III.A.1)."""
    head = read(addr, 24)
    if head[:4] != b"TREE" or head[4] != node_type:
        raise ValueError(f"B-tree node at {addr}: bad signature or type")
    level, n = head[5], struct.unpack_from("<H", head, 6)[0]
    body = read(addr + 24, n * (key_size + 8) + key_size)
    for i in range(n):
        key = body[i * (key_size + 8):i * (key_size + 8) + key_size]
        child = struct.unpack_from("<Q", body, i * (key_size + 8) + key_size)[0]
        if level:
            yield from btree1_leaves(read, child, node_type, key_size)
        else:
            yield key, child


def _bit(bitmap: bytes, i: int) -> bool:
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _elements(read: Read, at: int, n: int, elem_size: int, entry, what: str, prefix: int, paged: Optional[int],
              init: Optional[Callable[[int], bool]] = None):
    """(i, entry) of the n elements of an array data block whose elements
    start at `at + prefix` (unpaged) or lie in pages of `paged` elements
    after the block's prefix and checksum (paged)."""
    if paged is None:
        blk = checked(read(at, prefix + n * elem_size + 4), what)
        for i in range(n):
            yield i, entry(blk, prefix + i * elem_size)
        return
    p = at + prefix + 4
    for page in range(-(-n // paged)):
        m = min(paged, n - page * paged)
        if init(page):
            blk = checked(read(p, m * elem_size + 4), f"{what} page {page}")
            for i in range(m):
                yield page * paged + i, entry(blk, i * elem_size)
        p += paged * elem_size + 4


def _fixed_array(read: Read, addr: int, filtered: bool, chunk_bytes: int):
    hdr = checked(read(addr, 4 + 3 + 1 + 8 + 8 + 4), f"fixed array header at {addr}", b"FAHD")
    client, elem_size, page_bits = hdr[5], hdr[6], hdr[7]
    n, dblk = struct.unpack_from("<QQ", hdr, 8)
    if client != int(filtered):
        raise ValueError(f"fixed array at {addr}: client {client} for a {'' if filtered else 'un'}filtered dataset")
    entry = _entry_reader(elem_size, filtered, chunk_bytes)
    if dblk == UNDEF:
        return
    page = 1 << page_bits
    head = read(dblk, 14)
    if head[:4] != b"FADB":
        raise ValueError(f"fixed array data block at {dblk}: bad signature")
    if n <= page:
        yield from _elements(read, dblk, n, elem_size, entry, f"fixed array data block at {dblk}", 14, None)
        return
    npages = -(-n // page)
    nb = (npages + 7) // 8
    pre = checked(read(dblk, 14 + nb + 4), f"fixed array data block at {dblk}")
    bitmap = pre[14:14 + nb]
    yield from _elements(read, dblk, n, elem_size, entry, f"fixed array data block at {dblk}", 14 + nb, page,
                         lambda i: _bit(bitmap, i))


def _extensible_array(read: Read, addr: int, filtered: bool, chunk_bytes: int):
    hdr = checked(read(addr, 12 + 6 * 8 + 8 + 4), f"extensible array header at {addr}", b"EAHD")
    client, elem_size, max_bits, idx_elmts, min_elmts, min_ptrs, page_bits = hdr[5:12]
    iblk = struct.unpack_from("<Q", hdr, 12 + 6 * 8)[0]
    if client != int(filtered):
        raise ValueError(f"extensible array at {addr}: client {client} for a {'' if filtered else 'un'}filtered "
                         f"dataset")
    entry = _entry_reader(elem_size, filtered, chunk_bytes)
    if iblk == UNDEF:
        return
    # The super blocks: s holds 2^(s/2) data blocks of 2^((s+1)/2) * min_elmts
    # elements; the index block points at the data blocks of the first
    # 2 log2(min_ptrs) super blocks and at the secondary blocks of the rest.
    nsblks = 1 + max_bits - (min_elmts.bit_length() - 1)
    sblk = [(1 << (s // 2), (1 << ((s + 1) // 2)) * min_elmts) for s in range(nsblks)]
    iblk_sblks = 2 * (min_ptrs.bit_length() - 1)
    n_dblk_addrs = 2 * (min_ptrs - 1)
    n_sblk_addrs = nsblks - iblk_sblks
    off_size = (max_bits + 7) // 8
    page = 1 << page_bits
    ib = checked(read(iblk, 14 + idx_elmts * elem_size + 8 * (n_dblk_addrs + n_sblk_addrs) + 4),
                 f"extensible array index block at {iblk}", b"EAIB")
    for i in range(idx_elmts):
        yield i, entry(ib, 14 + i * elem_size)
    p = 14 + idx_elmts * elem_size
    dblk_addrs = struct.unpack_from(f"<{n_dblk_addrs}Q", ib, p)
    sblk_addrs = struct.unpack_from(f"<{n_sblk_addrs}Q", ib, p + 8 * n_dblk_addrs)
    start = idx_elmts
    prefix = 14 + off_size

    def dblock(at, nelmts, base, init):
        what = f"extensible array data block at {at}"
        if nelmts > page:
            for i, e in _elements(read, at, nelmts, elem_size, entry, what, prefix, page, init):
                yield base + i, e
        else:
            if read(at, 4) != b"EADB":
                raise ValueError(f"{what}: bad signature")
            for i, e in _elements(read, at, nelmts, elem_size, entry, what, prefix, None):
                yield base + i, e

    k = 0
    for s, (ndblks, nelmts) in enumerate(sblk):
        if s < iblk_sblks:
            for _ in range(ndblks):
                if dblk_addrs[k] != UNDEF:
                    yield from dblock(dblk_addrs[k], nelmts, start, None)
                k += 1
                start += nelmts
            continue
        at = sblk_addrs[s - iblk_sblks]
        if at != UNDEF:
            npages = nelmts // page if nelmts > page else 0
            init_size = (npages + 7) // 8 if npages else 0
            sb = checked(read(at, prefix + ndblks * init_size + 8 * ndblks + 4),
                         f"extensible array secondary block at {at}", b"EASB")
            bitmap = sb[prefix:prefix + ndblks * init_size]
            addrs = struct.unpack_from(f"<{ndblks}Q", sb, prefix + ndblks * init_size)
            for j, a in enumerate(addrs):
                if a != UNDEF:
                    yield from dblock(a, nelmts, start + j * nelmts,
                                      (lambda pg, j=j: _bit(bitmap, j * npages + pg)) if npages else None)
        start += ndblks * nelmts
