"""A minimal HDF5 writer and reader (stdlib + numpy), for the gridded cube.

The port writes netCDF-4 files without h5py.  A netCDF-4 file is an HDF5
file that follows the netCDF conventions, and this module writes only the
part of HDF5 that such a cube needs:

* superblock version 2 and version 2 object headers, each sealed with the
  Jenkins lookup3 checksum (HDF5 File Format Specification, sections II.A
  and IV.A.1.b);
* groups with compact link storage (Link Info, Group Info and Link
  messages in the group's header);
* datasets with contiguous layout, allocated when they are created, so
  that a caller can stream data into them at fixed offsets;
* attributes stored compactly in their object's header;
* one global heap collection for every variable-length value: a VLEN
  dataset element gets a collection of its own when it is written, the
  attributes' strings and object references share one written at close.

Datatypes: little-endian integers and IEEE floats, fixed-length and
variable-length strings, variable-length sequences, object references,
and the compound REFERENCE_LIST type of the dimension-scale convention.

The reader takes the files this writer makes (and no other layout: a
chunked or dense-link file raises): `H5File(path)["/Z"]` is a dataset
with `shape`, `dtype`, `attrs` and numpy indexing; object references
read back as the referenced object's path.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
SIGNATURE = b"\x89HDF\r\n\x1a\n"
SUPERBLOCK_SIZE = 48  # version 2, 8-byte offsets and lengths
HEAP_MIN = 4096  # the library reads a global heap collection's first 4096 bytes
MAX_COMPACT = 8  # the library's default phase changes (compact below, dense above)
MIN_DENSE = 6

# Object header message types.
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK, _LAYOUT, _GROUP_INFO, _ATTRIBUTE, _CONTINUATION = (
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A, 0x0C, 0x10)
_CONSTANT = 0x01  # message flag: the message does not change


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


# -- datatypes ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DType:
    """An HDF5 datatype: its message bytes, its element size, and how an
    element is encoded ("fixed": numpy bytes; "vstr", "vseq": a VLEN
    heap descriptor; "ref": an object address; "reflist": (object, int))."""

    message: bytes
    size: int
    kind: str
    numpy: Optional[np.dtype] = None  # the element dtype of "fixed" and "vseq"


def _fixed_point(size: int, signed: bool) -> bytes:
    return struct.pack("<BBBBIHH", 0x10, 0x08 if signed else 0x00, 0, 0, size, 0, 8 * size)


def _float(size: int) -> bytes:
    if size == 4:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 31, 0, 4, 0, 32, 23, 8, 0, 23, 127)
    return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 63, 0, 8, 0, 64, 52, 11, 0, 52, 1023)


def numeric(dtype) -> DType:
    """A little-endian integer or IEEE float type."""
    dt = np.dtype(dtype).newbyteorder("<")
    if dt.kind == "f" and dt.itemsize in (4, 8):
        return DType(_float(dt.itemsize), dt.itemsize, "fixed", dt)
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return DType(_fixed_point(dt.itemsize, dt.kind == "i"), dt.itemsize, "fixed", dt)
    raise TypeError(f"no HDF5 type for {dtype}")


def fixed_string(n: int) -> DType:
    """An n-byte null-terminated ASCII string (the dimension scales' CLASS and NAME)."""
    return DType(struct.pack("<BBBBI", 0x13, 0x00, 0, 0, n), n, "fixed", np.dtype(f"S{n}"))


VLEN_STR = DType(struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + _fixed_point(1, False), 16, "vstr")
OBJ_REF = DType(struct.pack("<BBBBI", 0x17, 0, 0, 0, 8), 8, "ref")


def vlen(base: DType) -> DType:
    """A variable-length sequence of base elements."""
    return DType(struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + base.message, 16, "vseq", base.numpy)


VLEN_U8 = vlen(numeric(np.uint8))
VLEN_REF = DType(VLEN_U8.message[:8] + OBJ_REF.message, 16, "vseq")
# {dataset: object reference at 0, dimension: int32 at 8}, 16 bytes: the
# dimension-scale library's ds_list_t with its C padding.
REF_LIST = DType(
    struct.pack("<BBBBI", 0x36, 2, 0, 0, 16)
    + b"dataset\0" + bytes([0]) + OBJ_REF.message
    + b"dimension\0" + bytes([8]) + _fixed_point(4, True),
    16, "reflist",
)


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    if not shape:
        return bytes([2, 0, 0, 0])
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return bytes([2, len(shape), 1, 1]) + dims + dims  # maximum dimensions = dimensions


def _object_header(messages: Sequence[Tuple[int, int, bytes]], n_attrs: int = 0) -> bytes:
    """A version 2 object header holding messages [(type, flags, data)] in one chunk."""
    body = b"".join(struct.pack("<BHB", t, len(d), fl) + d for t, fl, d in messages)
    flags = 0
    phase = b""
    if n_attrs > MAX_COMPACT:
        flags |= 0x10
        phase = struct.pack("<HH", n_attrs, MIN_DENSE)
    width = next(w for w in (1, 2, 4, 8) if len(body) < 1 << (8 * w))
    flags |= {1: 0, 2: 1, 4: 2, 8: 3}[width]
    head = b"OHDR" + bytes([2, flags]) + phase + len(body).to_bytes(width, "little")
    out = head + body
    return out + struct.pack("<I", lookup3(out))


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _heap_collection(objects: Sequence[bytes]) -> bytes:
    """A global heap collection holding objects 1..n, at least HEAP_MIN bytes."""
    parts = []
    for i, obj in enumerate(objects, 1):
        parts.append(struct.pack("<HHIQ", i, 0, 0, len(obj)) + obj.ljust(_pad8(len(obj)), b"\0"))
    used = 16 + sum(len(p) for p in parts)
    size = max(HEAP_MIN, used)
    free = size - used
    if free >= 16:  # the free-space object (its size counts its own header)
        parts.append(struct.pack("<HHIQ", 0, 0, 0, free) + b"\0" * (free - 16))
    else:  # too small for an object header: the library takes it as free space
        parts.append(b"\0" * free)
    return b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + b"".join(parts)


# -- writer -------------------------------------------------------------------


@dataclasses.dataclass
class _Attr:
    dtype: DType
    shape: Tuple[int, ...]
    value: object  # bytes (fixed), or a list of elements (vstr, vseq, reflist)


class _Node:
    def __init__(self, path: str):
        self.path = path
        self.attrs: Dict[str, _Attr] = {}
        self.addr = UNDEF  # the object header's address, known at close


class Group(_Node):
    def __init__(self, path: str):
        super().__init__(path)
        self.children: Dict[str, _Node] = {}


class Dataset(_Node):
    def __init__(self, path: str, shape, dtype: DType, data_addr: int):
        super().__init__(path)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.data_addr = data_addr
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) * dtype.size


class Writer:
    """Builds an HDF5 file: datasets are allocated (and may be written)
    as they are created; object headers, attributes and the superblock
    are written by close()."""

    def __init__(self, path):
        self._f = open(path, "w+b")
        self._f.write(b"\0" * SUPERBLOCK_SIZE)
        self._eof = SUPERBLOCK_SIZE
        self.root = Group("/")
        self._closed = False

    # -- raw space
    def _alloc(self, nbytes: int) -> int:
        addr = _pad8(self._eof)
        self._eof = addr + nbytes
        return addr

    def write_at(self, addr: int, data) -> None:
        self._f.seek(addr)
        self._f.write(data)

    # -- objects
    def create_group(self, parent: Group, name: str) -> Group:
        g = Group(parent.path.rstrip("/") + "/" + name)
        parent.children[name] = g
        return g

    def create_dataset(self, parent: Group, name: str, shape, dtype: DType, data=None) -> Dataset:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.size
        ds = Dataset(parent.path.rstrip("/") + "/" + name, shape, dtype, self._alloc(n) if n else UNDEF)
        parent.children[name] = ds
        if data is not None:
            self.write(ds, data)
        return ds

    def write(self, ds: Dataset, data, index: int = 0) -> None:
        """Write data (numpy, converted to the dataset's type) from the
        dataset's element `index` on, in C order."""
        buf = np.ascontiguousarray(data, dtype=ds.dtype.numpy).tobytes()
        if index * ds.dtype.size + len(buf) > ds.nbytes:
            raise ValueError(f"{ds.path}: {len(buf)} bytes at element {index} overrun {ds.nbytes}")
        self.write_at(ds.data_addr + index * ds.dtype.size, buf)

    def write_vlen(self, ds: Dataset, index: int, data: bytes) -> None:
        """Element `index` of a VLEN uint8 dataset: the bytes go to a global
        heap collection of their own, appended to the file."""
        if ds.dtype is not VLEN_U8:
            raise TypeError(f"{ds.path} is not a VLEN uint8 dataset")
        if not 0 <= index < ds.shape[0]:
            raise IndexError(f"{ds.path}: element {index} of {ds.shape[0]}")
        coll = _heap_collection([bytes(data)])
        addr = self._alloc(len(coll))
        self.write_at(addr, coll)
        self.write_at(ds.data_addr + 16 * index, struct.pack("<IQI", len(data), addr, 1))

    def set_attr(self, node: _Node, name: str, value, dtype: Optional[DType] = None) -> None:
        """An attribute with h5py's typing: str -> variable-length UTF-8
        string, Python int -> int64, Python float -> float64, numpy values
        keep their dtype; or value converted to dtype, a fixed type
        (fixed_string)."""
        if dtype is None and isinstance(value, str):
            node.attrs[name] = _Attr(VLEN_STR, (), [value.encode()])
            return
        arr = np.asarray(value) if dtype is None else np.asarray(value, dtype.numpy)
        if arr.dtype.kind not in "iufS":
            raise TypeError(f"attribute {name}: unsupported value {value!r}")
        dtype = dtype or numeric(arr.dtype)
        node.attrs[name] = _Attr(dtype, arr.shape, np.ascontiguousarray(arr, dtype.numpy).tobytes())

    def make_scale(self, ds: Dataset, name: str) -> None:
        """Tag ds as a dimension scale named `name` (H5DSset_scale)."""
        self.set_attr(ds, "CLASS", b"DIMENSION_SCALE", fixed_string(16))
        self.set_attr(ds, "NAME", name.encode(), fixed_string(len(name) + 1))

    def attach_scale(self, ds: Dataset, axis: int, scale: Dataset) -> None:
        """Attach `scale` to axis `axis` of ds (H5DSattach_scale): ds's
        DIMENSION_LIST and the scale's REFERENCE_LIST both record it."""
        dl = ds.attrs.get("DIMENSION_LIST")
        if dl is None:
            dl = _Attr(VLEN_REF, (len(ds.shape),), [[] for _ in ds.shape])
            ds.attrs["DIMENSION_LIST"] = dl
        dl.value[axis].append(scale)
        rl = scale.attrs.setdefault("REFERENCE_LIST", _Attr(REF_LIST, (0,), []))
        rl.value.append((ds, axis))
        rl.shape = (len(rl.value),)

    # -- close: heap, headers, superblock
    def _nodes(self) -> List[_Node]:
        out, todo = [], [self.root]
        while todo:
            node = todo.pop(0)
            out.append(node)
            if isinstance(node, Group):
                todo.extend(node.children.values())
        return out

    def _attr_data(self, attr: _Attr, heap_addr: int, heap_index: Dict[Tuple[int, int], int]) -> bytes:
        if attr.dtype.kind == "fixed":
            return attr.value
        if attr.dtype.kind == "reflist":
            return b"".join(struct.pack("<QiI", node.addr, axis, 0) for node, axis in attr.value)
        out = []
        for i, elem in enumerate(attr.value):
            n = len(elem)
            if attr.dtype.kind == "vseq" and n == 0:
                out.append(struct.pack("<IQI", 0, 0, 0))
            else:
                out.append(struct.pack("<IQI", n, heap_addr, heap_index[id(attr), i]))
        return b"".join(out)

    def _header(self, node: _Node, heap_addr: int, heap_index) -> bytes:
        msgs = []
        if isinstance(node, Group):
            msgs.append((_LINK_INFO, 0, bytes([0, 0]) + struct.pack("<QQ", UNDEF, UNDEF)))
            n_links = len(node.children)
            if n_links > MAX_COMPACT:  # keep the links compact: raise the phase change to their count
                msgs.append((_GROUP_INFO, _CONSTANT, bytes([0, 1]) + struct.pack("<HH", n_links, MIN_DENSE)))
            else:
                msgs.append((_GROUP_INFO, _CONSTANT, bytes([0, 0])))
            for name, child in node.children.items():
                nb = name.encode()
                msgs.append((_LINK, 0, bytes([1, 0, len(nb)]) + nb + struct.pack("<Q", child.addr)))
        else:
            fill = 0x02 if node.dtype.kind == "vseq" else 0x0A  # allocation late; write if set (as libhdf5)
            msgs += [
                (_DATASPACE, 0, _dataspace(node.shape)),
                (_DATATYPE, _CONSTANT, node.dtype.message),
                (_FILL, _CONSTANT, bytes([3, fill])),
                (_LAYOUT, 0, bytes([3, 1]) + struct.pack("<QQ", node.data_addr, node.nbytes)),
            ]
        for name, attr in node.attrs.items():
            nb = name.encode() + b"\0"
            dt, sp = attr.dtype.message, _dataspace(attr.shape)
            data = self._attr_data(attr, heap_addr, heap_index)
            msgs.append((_ATTRIBUTE, 0, struct.pack("<BBHHHB", 3, 0, len(nb), len(dt), len(sp), 0) + nb + dt + sp
                         + data))
        return _object_header(msgs, len(node.attrs))

    def _heap_objects(self, nodes) -> Tuple[List, Dict]:
        """The attributes' variable-length elements in heap order (bytes, or
        a list of referenced nodes), and {(id(attr), element): heap index}."""
        elems, index = [], {}
        for node in nodes:
            for attr in node.attrs.values():
                if attr.dtype.kind not in ("vstr", "vseq"):
                    continue
                for i, elem in enumerate(attr.value):
                    if attr.dtype.kind == "vseq" and not elem:
                        continue
                    elems.append(elem)
                    index[id(attr), i] = len(elems)
        return elems, index

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            nodes = self._nodes()
            elems, index = self._heap_objects(nodes)
            sizes = [len(e) if isinstance(e, bytes) else 8 * len(e) for e in elems]
            heap_addr = self._alloc(len(_heap_collection([b"\0" * n for n in sizes]))) if elems else UNDEF
            # Header sizes do not depend on the addresses: place, then encode.
            for node in nodes:
                node.addr = 0
            placed = [(node, len(self._header(node, heap_addr, index))) for node in nodes]
            for node, size in placed:
                node.addr = self._alloc(size)
            if elems:
                objs = [e if isinstance(e, bytes) else b"".join(struct.pack("<Q", n.addr) for n in e) for e in elems]
                self.write_at(heap_addr, _heap_collection(objs))
            for node, size in placed:
                hdr = self._header(node, heap_addr, index)
                assert len(hdr) == size
                self.write_at(node.addr, hdr)
            eof = self._eof
            self._f.truncate(eof)
            sb = SIGNATURE + bytes([2, 8, 8, 0]) + struct.pack("<QQQQ", 0, UNDEF, eof, self.root.addr)
            self.write_at(0, sb + struct.pack("<I", lookup3(sb)))
        finally:
            self._f.close()


# -- reader -------------------------------------------------------------------


class H5Object:
    def __init__(self, file: "H5File", path: str, addr: int):
        self.file = file
        self.path = path
        self.addr = addr
        self.attrs: Dict[str, object] = {}


class H5Group(H5Object):
    def __init__(self, file, path, addr):
        super().__init__(file, path, addr)
        self.links: Dict[str, int] = {}

    def keys(self):
        return list(self.links)

    def __getitem__(self, name: str):
        return self.file[name if name.startswith("/") else self.path.rstrip("/") + "/" + name]


class H5Dataset(H5Object):
    def __init__(self, file, path, addr):
        super().__init__(file, path, addr)
        self.shape: Tuple[int, ...] = ()
        self.dtype = None  # numpy dtype; object for VLEN data
        self.data_addr = UNDEF
        self.data_size = 0
        self._type = None

    def read(self) -> np.ndarray:
        n = int(np.prod(self.shape, dtype=np.int64))
        if self._type.kind == "fixed":
            if n == 0:
                return np.zeros(self.shape, self.dtype)
            raw = self.file._read(self.data_addr, n * self._type.size)
            return np.frombuffer(raw, self.dtype).reshape(self.shape).copy()
        raw = self.file._read(self.data_addr, n * 16) if n else b""
        out = np.empty(n, dtype=object)  # element by element: equal lengths must not make a 2-d array
        for i, elem in enumerate(self.file._decode_elems(self._type, raw, n)):
            out[i] = elem
        return out.reshape(self.shape)

    def __getitem__(self, key):
        return self.read()[key]


@dataclasses.dataclass
class _ReadType:
    kind: str  # fixed, vstr, vseq, ref, reflist
    size: int
    numpy: Optional[np.dtype] = None
    base: Optional["_ReadType"] = None


class H5File:
    """The objects of a file this module's Writer made, parsed on open."""

    def __init__(self, path):
        self._f = open(path, "rb")
        sb = self._read(0, SUPERBLOCK_SIZE)
        if sb[:8] != SIGNATURE or sb[8] not in (2, 3) or sb[9:11] != b"\x08\x08":
            raise ValueError(f"{path}: not an HDF5 file with a version 2/3 superblock and 8-byte addresses")
        if lookup3(sb[:44]) != struct.unpack_from("<I", sb, 44)[0]:
            raise ValueError(f"{path}: superblock checksum mismatch")
        _, _, _, root = struct.unpack_from("<QQQQ", sb, 12)
        self._objects: Dict[str, H5Object] = {}
        self._paths: Dict[int, str] = {}
        self._pending: List[Tuple[H5Object, list]] = []
        self._load("/", root)
        for obj, attr_msgs in self._pending:  # references resolve once every path is known
            for data in attr_msgs:
                name, value = self._decode_attr(data)
                obj.attrs[name] = value

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read(self, addr: int, n: int) -> bytes:
        self._f.seek(addr)
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"short read at {addr}: {len(data)} of {n} bytes")
        return data

    def __getitem__(self, path: str) -> H5Object:
        path = "/" + path.strip("/") if path != "/" else "/"
        return self._objects[path]

    # -- object headers
    def _messages(self, addr: int) -> List[Tuple[int, bytes]]:
        head = self._read(addr, 6)
        if head[:4] != b"OHDR" or head[4] != 2:
            raise ValueError(f"object header at {addr}: not a version 2 header")
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = int.from_bytes(self._read(addr + pos, width), "little")
        pos += width
        body = self._read(addr + pos, size)
        whole = self._read(addr, pos + size + 4)
        if lookup3(whole[:-4]) != struct.unpack_from("<I", whole, len(whole) - 4)[0]:
            raise ValueError(f"object header at {addr}: checksum mismatch")
        msgs, p, step = [], 0, 6 if flags & 0x04 else 4
        while p + 4 <= len(body):
            t, n = body[p], struct.unpack_from("<H", body, p + 1)[0]
            if t == _CONTINUATION:
                raise ValueError(f"object header at {addr}: continuation blocks are not read")
            msgs.append((t, body[p + step: p + step + n]))
            p += step + n
        return msgs

    def _load(self, path: str, addr: int) -> None:
        msgs = self._messages(addr)
        types = {t for t, _ in msgs}
        if _LINK_INFO in types or _GROUP_INFO in types:
            obj = H5Group(self, path, addr)
            for t, d in msgs:
                if t == _LINK_INFO and struct.unpack_from("<Q", d, 2 + (8 if d[1] & 1 else 0))[0] != UNDEF:
                    raise ValueError(f"{path}: dense link storage is not read")
                if t == _LINK:
                    name, target = self._decode_link(d)
                    obj.links[name] = target
        else:
            obj = H5Dataset(self, path, addr)
            for t, d in msgs:
                if t == _DATASPACE:
                    obj.shape = self._decode_dataspace(d)
                elif t == _DATATYPE:
                    obj._type, _ = self._decode_type(d, 0)
                elif t == _LAYOUT:
                    if d[0] != 3 or d[1] != 1:
                        raise ValueError(f"{path}: only contiguous layout (version 3) is read")
                    obj.data_addr, obj.data_size = struct.unpack_from("<QQ", d, 2)
            obj.dtype = obj._type.numpy if obj._type.kind == "fixed" else np.dtype(object)
        self._objects[path] = obj
        self._paths[addr] = path
        self._pending.append((obj, [d for t, d in msgs if t == _ATTRIBUTE]))
        if isinstance(obj, H5Group):
            for name, target in obj.links.items():
                self._load(path.rstrip("/") + "/" + name, target)

    @staticmethod
    def _decode_link(d: bytes) -> Tuple[str, int]:
        flags = d[1]
        p = 2
        if flags & 0x08:
            if d[p] != 0:
                raise ValueError("only hard links are read")
            p += 1
        p += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        w = 1 << (flags & 3)
        n = int.from_bytes(d[p:p + w], "little")
        p += w
        return d[p:p + n].decode(), struct.unpack_from("<Q", d, p + n)[0]

    @staticmethod
    def _decode_dataspace(d: bytes) -> Tuple[int, ...]:
        if d[0] != 2:
            raise ValueError("only version 2 dataspaces are read")
        rank = d[1]
        return struct.unpack_from(f"<{rank}Q", d, 4) if d[3] == 1 else ()

    def _decode_type(self, d: bytes, p: int) -> Tuple[_ReadType, int]:
        """The datatype at d[p:] and the offset after it."""
        cls, b0, b1 = d[p] & 0x0F, d[p + 1], d[p + 2]
        nmemb = d[p + 1] | d[p + 2] << 8
        size = struct.unpack_from("<I", d, p + 4)[0]
        q = p + 8
        if cls == 0:
            return _ReadType("fixed", size, np.dtype(f"<{'i' if b0 & 0x08 else 'u'}{size}")), q + 4
        if cls == 1:
            return _ReadType("fixed", size, np.dtype(f"<f{size}")), q + 12
        if cls == 3:
            return _ReadType("fixed", size, np.dtype(f"S{size}")), q
        if cls == 7:
            return _ReadType("ref", size), q
        if cls == 9:
            base, q = self._decode_type(d, q)
            return _ReadType("vstr" if b0 & 0x0F == 1 else "vseq", size, base.numpy, base), q
        if cls == 6:
            members = []
            for _ in range(nmemb):
                end = d.index(b"\0", q)
                name = d[q:end].decode()
                q = end + 1
                off = d[q]  # compound version 3: the offset in one byte (size < 256)
                mtype, q = self._decode_type(d, q + 1)
                members.append((name, off, mtype))
            if [(m[0], m[1], m[2].kind) for m in members] != [("dataset", 0, "ref"), ("dimension", 8, "fixed")]:
                raise ValueError(f"unsupported compound type {members}")
            return _ReadType("reflist", size), q
        raise ValueError(f"unsupported datatype class {cls}")

    def _heap_object(self, addr: int, index: int) -> bytes:
        size = struct.unpack_from("<Q", self._read(addr + 8, 8))[0]
        coll = self._read(addr, size)
        p = 16
        while p + 16 <= size:
            idx, _, _, n = struct.unpack_from("<HHIQ", coll, p)
            if idx == 0:
                break
            if idx == index:
                return coll[p + 16:p + 16 + n]
            p += 16 + _pad8(n)
        raise ValueError(f"global heap {addr}: no object {index}")

    def _decode_elems(self, t: _ReadType, raw: bytes, n: int) -> list:
        out = []
        for i in range(n):
            if t.kind == "ref":
                out.append(self._paths[struct.unpack_from("<Q", raw, 8 * i)[0]])
            elif t.kind == "reflist":
                addr, axis, _ = struct.unpack_from("<QiI", raw, 16 * i)
                out.append((self._paths[addr], axis))
            else:
                length, addr, index = struct.unpack_from("<IQI", raw, 16 * i)
                data = self._heap_object(addr, index) if addr else b""
                if t.kind == "vstr":
                    out.append(data.decode())
                elif t.base.kind == "ref":
                    out.append(self._decode_elems(t.base, data, length))
                else:
                    out.append(np.frombuffer(data, t.base.numpy, count=length).copy())
        return out

    def _decode_attr(self, d: bytes) -> Tuple[str, object]:
        if d[0] != 3:
            raise ValueError("only version 3 attribute messages are read")
        nlen, tlen, slen = struct.unpack_from("<HHH", d, 2)
        p = 9
        name = d[p:p + nlen - 1].decode()
        p += nlen
        t, _ = self._decode_type(d, p)
        shape = self._decode_dataspace(d[p + tlen:p + tlen + slen])
        raw = d[p + tlen + slen:]
        n = int(np.prod(shape, dtype=np.int64))
        if t.kind == "fixed":
            arr = np.frombuffer(raw, t.numpy, count=n).reshape(shape)
            return name, arr[()] if shape == () else arr.copy()
        elems = self._decode_elems(t, raw, n)
        return name, elems[0] if shape == () else elems
