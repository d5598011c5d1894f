"""A minimal HDF5 writer, reader and editor (stdlib + numpy), for the
gridded cube.

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

`H5File` reads those files and the layouts that h5py and the netCDF-C
library write (superblocks 0-3, version 1 and 2 object headers,
symbol-table groups, compact and dense links and attributes, committed
datatypes, compact, contiguous and chunked datasets under every chunk
index, deflate, shuffle and fletcher32; the on-disk structures are in
io/hdf5_index.py), and edits files of this module's layout in place
(`H5File(path, "r+")`, see its docstring); `copy_to_port_layout`
rewrites any file it reads in this module's layout.  Not read, each with
a LayoutError that says so: filters other than those three (szip, N-bit,
scale-offset, LZF and plugins, named by their id), huge objects and I/O
filters in a fractal heap, shared-message (SOHM) tables, shared
dataspaces, virtual datasets, big-endian numbers.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from wass_tpu_torch.io import hdf5_index
from wass_tpu_torch.io.hdf5_index import UNDEF, LayoutError, lookup3

SIGNATURE = b"\x89HDF\r\n\x1a\n"
SUPERBLOCK_SIZE = 48  # version 2, 8-byte offsets and lengths
HEAP_MIN = 4096  # the library reads a global heap collection's first 4096 bytes
MAX_COMPACT = 8  # the library's default phase changes (compact below, dense above)
MIN_DENSE = 6

# Object header message types.
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK, _LAYOUT, _GROUP_INFO, _ATTRIBUTE, _CONTINUATION = (
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A, 0x0C, 0x10)
_CONSTANT = 0x01  # message flag: the message does not change


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


def _dataset_messages(shape: Tuple[int, ...], dtype: DType, data_addr: int, nbytes: int) -> list:
    """A contiguous dataset's header messages before its attributes."""
    fill = 0x02 if dtype.kind == "vseq" else 0x0A  # allocation late; write if set (as libhdf5)
    return [
        (_DATASPACE, 0, _dataspace(shape)),
        (_DATATYPE, _CONSTANT, dtype.message),
        (_FILL, _CONSTANT, bytes([3, fill])),
        (_LAYOUT, 0, bytes([3, 1]) + struct.pack("<QQ", data_addr, nbytes)),
    ]


def _group_info(n_links: int) -> Tuple[int, int, bytes]:
    """A Group Info message; above MAX_COMPACT links it raises the phase
    change to their count, so that the links stay compact."""
    if n_links > MAX_COMPACT:
        return _GROUP_INFO, _CONSTANT, bytes([0, 1]) + struct.pack("<HH", n_links, MIN_DENSE)
    return _GROUP_INFO, _CONSTANT, bytes([0, 0])


def _link_message(name: str, addr: int) -> Tuple[int, int, bytes]:
    nb = name.encode()
    return _LINK, 0, bytes([1, 0, len(nb)]) + nb + struct.pack("<Q", addr)


def _attr_message(name: str, dtype: DType, shape: Tuple[int, ...], data: bytes) -> Tuple[int, int, bytes]:
    """A version 3 attribute message holding the encoded elements `data`."""
    nb = name.encode() + b"\0"
    dt, sp = dtype.message, _dataspace(shape)
    return _ATTRIBUTE, 0, struct.pack("<BBHHHB", 3, 0, len(nb), len(dt), len(sp), 0) + nb + dt + sp + data


# -- writer -------------------------------------------------------------------


@dataclasses.dataclass
class _Attr:
    dtype: DType
    shape: Tuple[int, ...]
    value: object  # bytes (fixed), or a list of elements (vstr, vseq, reflist)


def make_attr(name: str, value, dtype: Optional[DType] = None) -> _Attr:
    """An attribute with h5py's typing: str -> variable-length UTF-8
    string, Python int -> int64, Python float -> float64, numpy values
    keep their dtype; or value converted to dtype, a fixed type
    (fixed_string)."""
    if dtype is None and isinstance(value, str):
        return _Attr(VLEN_STR, (), [value.encode()])
    arr = np.asarray(value) if dtype is None else np.asarray(value, dtype.numpy)
    if arr.dtype.kind not in "iufS":
        raise TypeError(f"attribute {name}: unsupported value {value!r}")
    dtype = dtype or numeric(arr.dtype)
    return _Attr(dtype, arr.shape, np.ascontiguousarray(arr, dtype.numpy).tobytes())


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
        """An attribute typed as `make_attr` types it."""
        node.attrs[name] = make_attr(name, value, dtype)

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
            msgs.append(_group_info(len(node.children)))
            msgs += [_link_message(name, child.addr) for name, child in node.children.items()]
        else:
            msgs += _dataset_messages(node.shape, node.dtype, node.data_addr, node.nbytes)
        for name, attr in node.attrs.items():
            msgs.append(_attr_message(name, attr.dtype, attr.shape, self._attr_data(attr, heap_addr, heap_index)))
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


# -- reader and editor ----------------------------------------------------------

_NIL, _FILL_OLD, _FILTERS, _SHARED_TABLE, _SYMBOL_TABLE, _ATTR_INFO = 0x00, 0x04, 0x0B, 0x0F, 0x11, 0x15
_SHARED = 0x02  # message flag: the message is shared (it lies in another object's header)


@dataclasses.dataclass
class _ReadType:
    kind: str  # fixed, vstr, vseq, ref, reflist
    size: int
    numpy: Optional[np.dtype] = None
    base: Optional["_ReadType"] = None
    message: bytes = b""  # the encoded datatype


def _join(parent: str, name: str) -> str:
    return parent.rstrip("/") + "/" + name


def _split(path: str) -> Tuple[str, str]:
    parent, _, name = path.rpartition("/")
    return parent or "/", name


def _norm(path: str) -> str:
    return "/" + path.strip("/") if path.strip("/") else "/"


def _readback(attr: _Attr):
    """The value an attribute reads back as (the reader's decoding)."""
    if attr.dtype.kind == "vstr":
        return attr.value[0].decode() if attr.shape == () else [v.decode() for v in attr.value]
    arr = np.frombuffer(attr.value, attr.dtype.numpy).reshape(attr.shape)
    return arr[()] if attr.shape == () else arr.copy()


class Attrs(dict):
    """An object's attributes, name -> decoded value.  In a file opened
    "r+", setting one records it; the file's close writes it."""

    def __init__(self, obj: "H5Object"):
        super().__init__()
        self._obj = obj

    def __setitem__(self, name: str, value) -> None:
        attr = self._obj.file._set_attr(self._obj, name, value)
        super().__setitem__(name, _readback(attr))


class H5Object:
    def __init__(self, file: "H5File", path: str, addr: int):
        self.file = file
        self.path = path
        self.addr = addr
        self.attrs = Attrs(self)
        self._version = 2  # the object header's version
        self._chunk0 = None  # (address, bytes) of a version 2 header's first chunk
        self._msgs: List[Tuple[int, int, bytes]] = []  # the header's messages but attributes
        self._attr_msgs: Dict[str, Tuple[int, bytes]] = {}  # name -> (flags, data) as read
        self._attr_types: Dict[str, Tuple[_ReadType, Tuple[int, ...]]] = {}
        self._new_attrs: Dict[str, _Attr] = {}  # set since the file was opened
        self._dirty = False  # the header must be written anew


class H5Group(H5Object):
    def __init__(self, file, path, addr):
        super().__init__(file, path, addr)
        self.links: Dict[str, int] = {}  # name -> object header address (as read)

    def keys(self):
        return list(self.links)

    def __contains__(self, name: str) -> bool:
        return name in self.links

    def __getitem__(self, name: str):
        return self.file[name if name.startswith("/") else _join(self.path, name)]


def _box(shape: Tuple[int, ...], key) -> Tuple[list, tuple]:
    """Basic indexing of `shape` as a box [(start, stop)] per axis and the
    index that takes the result from the box (integers drop their axis,
    strided slices keep their step)."""
    key = key if isinstance(key, tuple) else (key,)
    if any(k is Ellipsis for k in key):
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1:]
    key = key + (slice(None),) * (len(shape) - len(key))
    if len(key) != len(shape):
        raise IndexError(f"{len(key)} indices for a dataset of rank {len(shape)}")
    box, post = [], []
    for k, n in zip(key, shape):
        if isinstance(k, (int, np.integer)):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {k} out of range for an axis of {n}")
            box.append((i, i + 1))
            post.append(0)
        elif isinstance(k, slice):
            a, b, step = k.indices(n)
            if step == 1:
                box.append((a, max(a, b)))
                post.append(slice(None))
            else:
                box.append((0, n))
                post.append(k)
        else:
            raise TypeError(f"a dataset takes integers, slices and ... as indices, not {k!r}")
    return box, tuple(post)


class H5Dataset(H5Object):
    def __init__(self, file, path, addr):
        super().__init__(file, path, addr)
        self.shape: Tuple[int, ...] = ()
        self.dtype = None  # numpy dtype; object for VLEN data
        self.layout = "contiguous"  # or "chunked", "compact"
        self.chunks: Optional[Tuple[int, ...]] = None
        self.maxshape: Tuple[int, ...] = ()  # UNDEF on an unlimited axis
        self.data_addr = UNDEF
        self.data_size = 0
        self.chunk_decodes = 0  # chunks read and decoded since the file was opened
        self._type: Optional[_ReadType] = None
        self._compact = b""
        self._layout: Optional[hdf5_index.Layout] = None
        self._filters: List[hdf5_index.Filter] = []
        self._index = None  # chunk origin -> (address, bytes, filter mask)
        self._cache: Dict[Tuple[int, ...], Optional[np.ndarray]] = {}  # decoded chunks of one row along axis 0
        self._cache_row = -1
        self._fill = b""

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def read(self) -> np.ndarray:
        return self[...]

    def _memmap(self, mode: str) -> np.memmap:
        return np.memmap(self.file.filename, dtype=self.dtype, mode=mode, offset=self.data_addr, shape=self.shape)

    def __getitem__(self, key):
        if self._type.kind == "fixed" and self.layout == "contiguous" and self.size and self.shape:
            if self.data_addr == UNDEF:
                box, post = _box(self.shape, key)
                return self._filled([b - a for a, b in box])[post]
            return np.array(self._memmap("r")[key])
        box, post = _box(self.shape, key)
        return self._read_box(box)[post]

    def __setitem__(self, key, value) -> None:
        """Write into a contiguous dataset of a file opened "r+"."""
        self.file._require_edit()
        if self._type.kind != "fixed" or self.layout != "contiguous" or self.data_addr == UNDEF:
            raise LayoutError(f"{self.path}: only allocated contiguous numeric datasets are written")
        mm = self._memmap("r+")
        mm[key] = value
        mm.flush()
        del mm

    def _filled(self, shape) -> np.ndarray:
        if self._type.kind != "fixed":
            out = np.empty(int(np.prod(shape, dtype=np.int64)), dtype=object)
            for i in range(out.size):
                out[i] = np.zeros(0, self._type.base.numpy) if self._type.kind == "vseq" else ""
            return out.reshape(shape)
        fill = np.frombuffer(self._fill, self.dtype)[0] if len(self._fill) == self._type.size else 0
        return np.full(shape, fill, self.dtype)

    def _elements(self, raw: bytes, n: int) -> np.ndarray:
        if self._type.kind == "fixed":
            return np.frombuffer(raw, self.dtype, count=n).copy()
        out = np.empty(n, dtype=object)  # element by element: equal lengths must not make a 2-d array
        for i, elem in enumerate(self.file._decode_elems(self._type, raw, n)):
            out[i] = elem
        return out

    def _read_box(self, box: list) -> np.ndarray:
        shape = [b - a for a, b in box]
        if not self.shape:  # scalar
            raw = self._compact if self.layout == "compact" else self.file._read(self.data_addr, self._type.size)
            return self._elements(raw, 1).reshape(())
        if 0 in shape:
            return self._filled(shape)
        if self.layout == "chunked":
            return self._read_chunked(box, shape)
        if self.layout == "compact":
            return self._elements(self._compact, self.size).reshape(self.shape)[tuple(slice(a, b) for a, b in box)]
        if self.data_addr == UNDEF:
            return self._filled(shape)
        # Contiguous VLEN: the descriptors of the rows of the box.
        row = self._type.size * int(np.prod(self.shape[1:], dtype=np.int64))
        a, b = box[0]
        raw = self.file._read(self.data_addr + a * row, (b - a) * row)
        arr = self._elements(raw, (b - a) * row // self._type.size).reshape((b - a,) + self.shape[1:])
        return arr[(slice(None),) + tuple(slice(a, b) for a, b in box[1:])]

    def _chunk(self, origin: Tuple[int, ...]) -> Optional[np.ndarray]:
        """The chunk at origin, read and decoded; None where none was written
        (the fill value).  A partial edge chunk of a dataset whose layout
        says so was stored unfiltered."""
        entry = self._index.get(origin)
        if entry is None:
            return None
        addr, nbytes, mask = entry
        cs = self.chunks
        n = int(np.prod(cs, dtype=np.int64))
        raw = self.file._read(addr, nbytes)
        edge = any(o + c > s for o, c, s in zip(origin, cs, self.shape))
        if self._filters and not (edge and self._layout.partial_unfiltered):
            raw = hdf5_index.unfilter(raw, self._filters, mask, f"{self.path}: chunk {origin}")
        if len(raw) != n * self._type.size:
            raise ValueError(f"{self.path}: chunk {origin} holds {len(raw)} bytes, not {n * self._type.size}")
        self.chunk_decodes += 1
        return self._elements(raw, n).reshape(cs)

    def _read_chunked(self, box: list, shape: list) -> np.ndarray:
        """The box from the chunks it intersects, each decoded once: the
        decoded chunks of the last row along the first axis are kept while
        they fit the post stage's memory budget, so that consecutive slabs
        inside one row of chunks decode it once."""
        from wass_tpu_torch.post.ooc import memory_budget_bytes

        if self._index is None:
            self._index = self.file._chunk_index(self)
        out = self._filled(shape)
        cs = self.chunks
        chunk_bytes = int(np.prod(cs, dtype=np.int64)) * max(self.dtype.itemsize, self._type.size)
        budget = memory_budget_bytes()
        ranges = [range(a // c, (b - 1) // c + 1) for (a, b), c in zip(box, cs)]
        for idx in itertools.product(*ranges):
            if idx[0] != self._cache_row:
                self._cache.clear()
                self._cache_row = idx[0]
            origin = tuple(i * c for i, c in zip(idx, cs))
            if origin in self._cache:
                chunk = self._cache[origin]
            else:
                chunk = self._chunk(origin)
                if (len(self._cache) + 1) * chunk_bytes <= budget:
                    self._cache[origin] = chunk
            if chunk is None:
                continue
            src = tuple(slice(max(a, o) - o, min(b, o + c) - o) for (a, b), o, c in zip(box, origin, cs))
            dst = tuple(slice(max(a, o) - a, min(b, o + c) - a) for (a, b), o, c in zip(box, origin, cs))
            out[dst] = chunk[src]
        return out


def _v2_messages(body: bytes, flags: int) -> list:
    """[(type, flags, data, creation order)] of a version 2 header chunk; the
    creation order is 0 unless the header tracks attribute creation order."""
    step = 6 if flags & 0x04 else 4
    msgs, p = [], 0
    while p + step <= len(body):
        t, n, fl = body[p], struct.unpack_from("<H", body, p + 1)[0], body[p + 3]
        order = struct.unpack_from("<H", body, p + 4)[0] if flags & 0x04 else 0
        msgs.append((t, fl, body[p + step:p + step + n], order))
        p += step + n
    return msgs


def _continuation_block(msgs) -> bytes:
    """A version 2 continuation block holding msgs [(type, flags, data)]."""
    out = b"OCHK" + b"".join(struct.pack("<BHB", t, len(d), fl) + d for t, fl, d in msgs)
    return out + struct.pack("<I", lookup3(out))


def _first_chunk(total: int, cont_addr: int, cont_len: int, n_attrs: int) -> bytes:
    """A version 2 header's first chunk of `total` bytes whose only message
    is a continuation to (cont_addr, cont_len); the rest is a NIL message."""
    flags, phase = 0, b""
    if n_attrs > MAX_COMPACT:
        flags, phase = 0x10, struct.pack("<HH", n_attrs, MIN_DENSE)
    for w in (1, 2, 4, 8):
        body_len = total - 6 - len(phase) - w - 4
        if body_len < 1 << (8 * w):
            break
    cont = struct.pack("<BHB", _CONTINUATION, 16, 0) + struct.pack("<QQ", cont_addr, cont_len)
    rest = body_len - len(cont)
    if rest < 0:
        raise LayoutError(f"an object header of {total} bytes has no room for a continuation")
    pad = struct.pack("<BHB", _NIL, rest - 4, 0) + b"\0" * (rest - 4) if rest >= 4 else b"\0" * rest
    out = b"OHDR" + bytes([2, flags | {1: 0, 2: 1, 4: 2, 8: 3}[w]]) + phase + body_len.to_bytes(w, "little")
    out += cont + pad
    return out + struct.pack("<I", lookup3(out))


class H5File:
    """An HDF5 file's objects, parsed on open.

    Reads this module's layout (superblock 2, version 2 object headers,
    compact links, contiguous datasets), h5py's default one (superblock
    0, version 1 object headers with continuation blocks, symbol-table
    groups, chunked datasets indexed by a version 1 B-tree) and the
    netCDF-C library's (superblock 2 or 3, dense links and attributes in
    fractal heaps, committed datatypes, version 4 layouts with deflate and
    shuffle).  `f["/Z"]` is a dataset with `shape`, `dtype`, `attrs` and
    numpy basic indexing that reads only what it selects (a chunked one
    decodes the chunks the selection meets); object references read back
    as the referenced object's path, attributes come in h5py's order
    (creation order where the object tracks it, else by name) and
    committed datatypes are not listed as objects.

    Opened "r+" (this module's layout only), a file is edited without a
    copy: a dataset is written in place (`ds[key] = value`),
    `create_dataset` allocates a new one at the end of the file, `attrs`
    are set, `del f[name]` removes a link and `move` renames one.  close()
    writes what changed: a changed group gets a new header at the end of
    the file, and so do its parents up to the root, then the superblock
    is written last (its root address and end of file), so that a command
    cut short leaves the old file readable.  A changed dataset keeps its
    address, which object references hold: its messages go to a
    continuation block at the end of the file, and its first chunk is
    rewritten in place, after the superblock, to point there.  Space that
    a delete or a rewrite frees is left unused, as HDF5 leaves it without
    a repack.
    """

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "r+"):
            raise ValueError(f"mode {mode!r}: 'r' or 'r+'")
        self.filename = str(path)
        self.mode = mode
        self._f = open(path, "rb" if mode == "r" else "r+b")
        try:
            self._open()
        except BaseException:
            self._f.close()
            raise

    def _open(self) -> None:
        path = self.filename
        head = self._read(0, 16)
        if head[:8] != SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file")
        self.superblock_version = head[8]
        if head[8] in (0, 1):
            if head[13:15] != b"\x08\x08":
                raise ValueError(f"{path}: not an HDF5 file with 8-byte addresses and lengths")
            p = 24 + (4 if head[8] == 1 else 0)
            sb = self._read(0, p + 72)
            base, _, eof, _ = struct.unpack_from("<QQQQ", sb, p)
            root = struct.unpack_from("<Q", sb, p + 40)[0]  # the root's symbol-table entry: name offset, header
        elif head[8] in (2, 3):
            if head[9:11] != b"\x08\x08":
                raise ValueError(f"{path}: not an HDF5 file with 8-byte addresses and lengths")
            sb = self._read(0, SUPERBLOCK_SIZE)
            if lookup3(sb[:44]) != struct.unpack_from("<I", sb, 44)[0]:
                raise ValueError(f"{path}: superblock checksum mismatch")
            base, ext, eof, root = struct.unpack_from("<QQQQ", sb, 12)
            self._sb = sb
            if ext != UNDEF and any(t == _SHARED_TABLE for t, _, _ in self._header(ext)[1]):
                raise LayoutError(f"{path}: shared object header messages (a shared-message table) are not read")
        else:
            raise ValueError(f"{path}: superblock version {head[8]} is not read")
        if base != 0:
            raise ValueError(f"{path}: a base address of {base} is not read")
        self._eof = max(eof, os.path.getsize(path))
        self._objects: Dict[str, H5Object] = {}
        self._paths: Dict[int, str] = {}
        self._committed: Dict[int, _ReadType] = {}  # committed datatypes by object header address
        self.editable = head[8] >= 2  # this module's layout, checked object by object below
        pending = []
        self._load("/", root, pending)
        for obj, attr_msgs, tracked in pending:  # references resolve once every path is known
            decoded = [(fl, data, self._decode_attr(data)) for fl, data in attr_msgs]
            if not tracked:  # h5py's order: creation order where tracked, else names
                decoded.sort(key=lambda a: a[2][0])
            for fl, data, (name, rtype, shape, value) in decoded:
                dict.__setitem__(obj.attrs, name, value)
                obj._attr_types[name] = (rtype, shape)
                obj._attr_msgs[name] = (fl, data)
        if self.mode == "r+" and not self.editable:
            raise LayoutError(f"{path}: only this module's layout (superblock 2, version 2 headers, compact "
                              f"links, contiguous datasets) is edited; copy it with copy_to_port_layout first")

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            if self.mode == "r+":
                self._commit()
        finally:
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
        return self._objects[_norm(path)]

    def __contains__(self, path: str) -> bool:
        return _norm(path) in self._objects

    def visititems(self, fn):
        """fn(name, obj) for every object below the root, depth first in
        name order (h5py's order), until fn returns something."""

        def walk(group):
            for name in sorted(group.links):
                obj = self._objects[_join(group.path, name)]
                out = fn(obj.path.lstrip("/"), obj)
                if out is None and isinstance(obj, H5Group):
                    out = walk(obj)
                if out is not None:
                    return out
            return None

        return walk(self["/"])

    # -- object headers
    def _header(self, addr: int) -> Tuple[int, list, Optional[Tuple[int, int]]]:
        """(version, messages [(type, flags, data)] of every chunk, the first
        chunk's (address, bytes) for version 2); NIL and continuation
        messages are dropped."""
        head = self._read(addr, 16)
        conts, msgs, chunk0 = [], [], None
        if head[:4] == b"OHDR":
            if head[4] != 2:
                raise ValueError(f"object header at {addr}: version {head[4]}")
            flags = head[5]
            pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size = int.from_bytes(self._read(addr + pos, width), "little")
            whole = self._read(addr, pos + width + size + 4)
            if lookup3(whole[:-4]) != struct.unpack_from("<I", whole, len(whole) - 4)[0]:
                raise ValueError(f"object header at {addr}: checksum mismatch")
            chunk0 = (addr, len(whole))
            todo = _v2_messages(whole[pos + width:-4], flags)
            attrs = []
            while True:
                for t, fl, d, order in todo:
                    if t == _CONTINUATION:
                        conts.append(struct.unpack_from("<QQ", d))
                    elif t == _ATTRIBUTE:
                        attrs.append((order, len(attrs), (t, fl, d)))
                    elif t != _NIL:
                        msgs.append((t, fl, d))
                if not conts:
                    break
                caddr, clen = conts.pop(0)
                block = self._read(caddr, clen)
                if block[:4] != b"OCHK" or lookup3(block[:-4]) != struct.unpack_from("<I", block, clen - 4)[0]:
                    raise ValueError(f"continuation block at {caddr}: bad signature or checksum")
                todo = _v2_messages(block[4:-4], flags)
            return 2, msgs + [m for _, _, m in sorted(attrs)], chunk0  # attributes in creation order
        if head[0] != 1:
            raise ValueError(f"object header at {addr}: not a version 1 or 2 header")
        size = struct.unpack_from("<I", head, 8)[0]
        conts.append((addr + 16, size))
        while conts:
            caddr, clen = conts.pop(0)
            block = self._read(caddr, clen)
            p = 0
            while p + 8 <= clen:
                t, n, fl = struct.unpack_from("<HHB", block, p)
                d = block[p + 8:p + 8 + n]
                if t == _CONTINUATION:
                    conts.append(struct.unpack_from("<QQ", d))
                elif t != _NIL:
                    msgs.append((t, fl, d))
                p += 8 + n
        return 1, msgs, None

    def _load(self, path: str, addr: int, pending: list) -> bool:
        """Load the object at addr and below; False for a committed datatype,
        which is kept by address and not linked as an object."""
        version, msgs, chunk0 = self._header(addr)
        types = {t for t, _, _ in msgs}
        if _LAYOUT in types:
            obj = H5Dataset(self, path, addr)
            self._load_dataset(obj, msgs)
        elif types & {_LINK_INFO, _GROUP_INFO, _LINK, _SYMBOL_TABLE} or not msgs:
            obj = H5Group(self, path, addr)
            for t, fl, d in msgs:
                if t == _LINK_INFO:
                    links = self._dense(d, attrs=False)
                    for m in links:
                        name, target = self._decode_link(m)
                        obj.links[name] = target
                    self.editable &= not links
                elif t == _LINK:
                    name, target = self._decode_link(d)
                    obj.links[name] = target
                elif t == _SYMBOL_TABLE:
                    obj.links.update(self._symbol_table(*struct.unpack_from("<QQ", d)))
        elif _DATATYPE in types and _DATASPACE not in types:
            self._committed_type(addr, msgs)
            self.editable = False
            return False
        else:
            raise LayoutError(f"{path}: an object that is neither a group nor a dataset (message types {types})")
        attr_msgs = [(fl, d) for t, fl, d in msgs if t == _ATTRIBUTE]
        tracked = False
        for t, fl, d in msgs:
            if t == _ATTR_INFO:
                tracked = bool(d[1] & 1)
                dense = self._dense(d, attrs=True)
                attr_msgs += [(0, m) for m in dense]
                self.editable &= not dense
        obj._version, obj._chunk0 = version, chunk0
        obj._msgs = [(t, fl, d) for t, fl, d in msgs if t != _ATTRIBUTE]
        self.editable &= version == 2 and not (isinstance(obj, H5Dataset) and obj.layout == "chunked")
        self._objects[path] = obj
        self._paths[addr] = path
        pending.append((obj, attr_msgs, tracked))
        if isinstance(obj, H5Group):
            for name, target in list(obj.links.items()):
                if not self._load(_join(path, name), target, pending):
                    del obj.links[name]
        return True

    def _dense(self, d: bytes, attrs: bool) -> List[bytes]:
        """The messages of a Link Info (IV.A.2.c) or Attribute Info
        (IV.A.2.v) message's dense storage: a fractal heap with a name
        index and, where creation order is indexed, an order index."""
        flags = d[1]
        p = 2 + ((2 if attrs else 8) if flags & 1 else 0)
        heap, names = struct.unpack_from("<QQ", d, p)
        order = struct.unpack_from("<Q", d, p + 16)[0] if flags & 2 else UNDEF
        if heap == UNDEF:
            return []
        return hdf5_index.dense_messages(self._read, heap, names, order, attrs)

    def _shared_type(self, d: bytes) -> _ReadType:
        """The datatype a shared message (IV.A.2 "shared messages",
        versions 1-3) points to: a committed datatype's object header."""
        version, kind = d[0], d[1]
        if version == 1:
            addr = struct.unpack_from("<Q", d, 8)[0]
        elif version == 2 or (version == 3 and kind == 2):
            addr = struct.unpack_from("<Q", d, 2)[0]
        elif version == 3 and kind == 1:
            raise LayoutError("a message in the shared-message heap is not read")
        else:
            raise LayoutError(f"shared message version {version}, type {kind} is not read")
        return self._committed_type(addr)

    def _committed_type(self, addr: int, msgs: Optional[list] = None) -> _ReadType:
        """The committed datatype whose object header is at addr (its
        messages when already read)."""
        if addr not in self._committed:
            found = [d for t, _, d in (msgs or self._header(addr)[1]) if t == _DATATYPE]
            if not found:
                raise ValueError(f"committed datatype at {addr}: no datatype message")
            self._committed[addr] = self._decode_type(found[0], 0)[0]
        return self._committed[addr]

    def _load_dataset(self, obj: H5Dataset, msgs: list) -> None:
        for t, fl, d in msgs:
            if fl & _SHARED and t != _DATATYPE:
                raise LayoutError(f"{obj.path}: a shared message of type {t} is not read")
            if t == _DATASPACE:
                obj.shape = self._decode_dataspace(d)
                obj.maxshape = self._decode_maxshape(d)
            elif t == _DATATYPE:
                obj._type = self._shared_type(d) if fl & _SHARED else self._decode_type(d, 0)[0]
            elif t == _FILTERS:
                obj._filters = hdf5_index.parse_filters(d)
            elif t == _FILL:
                obj._fill = self._decode_fill(d)
            elif t == _LAYOUT:
                lay = obj._layout = hdf5_index.parse_layout(d, obj.path)
                obj.layout = lay.kind
                if lay.kind == "compact":
                    obj._compact = lay.data
                elif lay.kind == "contiguous":
                    obj.data_addr, obj.data_size = lay.address, lay.size
                else:
                    obj.chunks = lay.chunks
        obj.dtype = obj._type.numpy if obj._type.kind == "fixed" else np.dtype(object)

    @staticmethod
    def _decode_fill(d: bytes) -> bytes:
        """A fill value message's value bytes; empty for the default (zeros)."""
        if d[0] in (1, 2):
            if d[0] == 2 and not d[3]:
                return b""
            n = struct.unpack_from("<I", d, 4)[0]
            return d[8:8 + n]
        if d[0] == 3 and d[1] & 0x20:
            n = struct.unpack_from("<I", d, 2)[0]
            return d[6:6 + n]
        return b""

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        """A symbol-table group's links, from its B-tree's symbol nodes and its local heap."""
        h = self._read(heap, 32)
        if h[:4] != b"HEAP":
            raise ValueError(f"local heap at {heap}: bad signature")
        size, _, data_addr = struct.unpack_from("<QQQ", h, 8)
        names = self._read(data_addr, size)
        links = {}
        for _, snod in hdf5_index.btree1_leaves(self._read, btree, 0, 8):
            head = self._read(snod, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"symbol table node at {snod}: bad signature")
            n = struct.unpack_from("<H", head, 6)[0]
            entries = self._read(snod + 8, 40 * n)
            for i in range(n):
                off, target = struct.unpack_from("<QQ", entries, 40 * i)
                links[names[off:names.index(b"\0", off)].decode()] = target
        return links

    def _chunk_index(self, ds: H5Dataset) -> dict:
        """A chunked dataset's chunks: origin -> (address, bytes, filter mask)."""
        return hdf5_index.chunk_index(self._read, ds._layout, ds.shape, ds.maxshape or ds.shape, ds._type.size,
                                      bool(ds._filters), ds.path)

    @staticmethod
    def _decode_link(d: bytes) -> Tuple[str, int]:
        flags = d[1]
        p = 2
        if flags & 0x08:
            if d[p] != 0:
                raise LayoutError("only hard links are read")
            p += 1
        p += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        w = 1 << (flags & 3)
        n = int.from_bytes(d[p:p + w], "little")
        p += w
        return d[p:p + n].decode(), struct.unpack_from("<Q", d, p + n)[0]

    @staticmethod
    def _decode_dataspace(d: bytes) -> Tuple[int, ...]:
        rank = d[1]
        if d[0] == 1:
            return struct.unpack_from(f"<{rank}Q", d, 8)
        if d[0] == 2:
            if d[3] == 2:
                raise LayoutError("null dataspaces are not read")
            return struct.unpack_from(f"<{rank}Q", d, 4) if d[3] == 1 else ()
        raise LayoutError(f"dataspace version {d[0]} is not read")

    @classmethod
    def _decode_maxshape(cls, d: bytes) -> Tuple[int, ...]:
        """A dataspace's maximum dimensions (UNDEF: unlimited); its
        dimensions where it gives none."""
        shape = cls._decode_dataspace(d)
        if not d[2] & 1:
            return shape
        return struct.unpack_from(f"<{len(shape)}Q", d, (8 if d[0] == 1 else 4) + 8 * len(shape))

    def _decode_type(self, d: bytes, p: int) -> Tuple[_ReadType, int]:
        """The datatype at d[p:] and the offset after it."""
        cls, version, b0 = d[p] & 0x0F, d[p] >> 4, d[p + 1]
        nmemb = d[p + 1] | d[p + 2] << 8
        size = struct.unpack_from("<I", d, p + 4)[0]
        q = p + 8
        if cls in (0, 1) and b0 & 0x01:
            raise LayoutError("big-endian numbers are not read")
        if cls == 0:
            return _ReadType("fixed", size, np.dtype(f"<{'i' if b0 & 0x08 else 'u'}{size}"), message=d[p:q + 4]), q + 4
        if cls == 1:
            return _ReadType("fixed", size, np.dtype(f"<f{size}"), message=d[p:q + 12]), q + 12
        if cls == 3:
            return _ReadType("fixed", size, np.dtype(f"S{size}"), message=d[p:q]), q
        if cls == 7:
            if b0 & 0x0F != 0:
                raise LayoutError("only object references are read")
            return _ReadType("ref", size), q
        if cls == 9:
            base, q = self._decode_type(d, q)
            return _ReadType("vstr" if b0 & 0x0F == 1 else "vseq", size, base.numpy, base), q
        if cls == 6:
            members = []
            for _ in range(nmemb):
                end = d.index(b"\0", q)
                name = d[q:end].decode()
                if version < 3:  # the name padded to a multiple of 8 bytes, the offset in 4
                    q += _pad8(end - q + 1)
                    off = struct.unpack_from("<I", d, q)[0]
                    q += 4 + (28 if version == 1 else 0)  # version 1: dimensionality, permutation, sizes
                else:
                    q = end + 1
                    w = next(w for w in (1, 2, 3, 4) if size < 1 << (8 * w))
                    off = int.from_bytes(d[q:q + w], "little")
                    q += w
                mtype, q = self._decode_type(d, q)
                members.append((name, off, mtype))
            if [(m[0], m[1], m[2].kind) for m in members] != [("dataset", 0, "ref"), ("dimension", 8, "fixed")]:
                raise LayoutError(f"unsupported compound type {[(m[0], m[1]) for m in members]}")
            return _ReadType("reflist", size), q
        raise LayoutError(f"datatype class {cls} is not read")

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
            if t.kind == "ref":  # None for an object no link reaches (as h5py's name)
                out.append(self._paths.get(struct.unpack_from("<Q", raw, 8 * i)[0]))
            elif t.kind == "reflist":
                addr, axis = struct.unpack_from("<Qi", raw, t.size * i)
                out.append((self._paths.get(addr), axis))
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

    def _decode_attr(self, d: bytes) -> tuple:
        """(name, type, shape, value) of an attribute message (versions 1-3)."""
        version = d[0]
        if version not in (1, 2, 3):
            raise LayoutError(f"attribute message version {version} is not read")
        if version > 1 and d[1] & 0x02:
            raise LayoutError("attributes with shared dataspaces are not read")
        nlen, tlen, slen = struct.unpack_from("<HHH", d, 2)
        pad = _pad8 if version == 1 else (lambda n: n)
        p = {1: 8, 2: 8, 3: 9}[version]
        name = d[p:p + nlen].split(b"\0")[0].decode()
        p += pad(nlen)
        t = self._shared_type(d[p:p + tlen]) if version > 1 and d[1] & 0x01 else self._decode_type(d, p)[0]
        p += pad(tlen)
        shape = self._decode_dataspace(d[p:p + slen])
        raw = d[p + pad(slen):]
        n = int(np.prod(shape, dtype=np.int64))
        if t.kind == "fixed":
            arr = np.frombuffer(raw, t.numpy, count=n).reshape(shape)
            return name, t, shape, arr[()] if shape == () else arr.copy()
        elems = self._decode_elems(t, raw, n)
        return name, t, shape, elems[0] if shape == () else elems

    # -- editing ("r+")
    def _require_edit(self) -> None:
        if self.mode != "r+":
            raise ValueError(f"{self.filename} is open read-only")

    def _alloc(self, nbytes: int) -> int:
        addr = _pad8(self._eof)
        self._eof = addr + nbytes
        return addr

    def _write(self, addr: int, data: bytes) -> None:
        self._f.seek(addr)
        self._f.write(data)

    def _set_attr(self, obj: H5Object, name: str, value) -> _Attr:
        self._require_edit()
        attr = make_attr(name, value)
        obj._attr_msgs.pop(name, None)
        obj._new_attrs[name] = attr
        obj._attr_types.pop(name, None)
        obj._dirty = True
        return attr

    def _parent(self, path: str) -> Tuple[H5Group, str]:
        parent, name = _split(path)
        group = self._objects.get(parent)
        if not isinstance(group, H5Group):
            raise KeyError(f"{parent} is not a group")
        return group, name

    def create_dataset(self, name: str, shape, dtype) -> H5Dataset:
        """A contiguous numeric dataset, allocated at the end of the file
        (zeros until written)."""
        self._require_edit()
        path = _norm(name)
        group, base = self._parent(path)
        if base in group.links:
            raise ValueError(f"{path} exists")
        dt = numeric(dtype)
        shape = tuple(int(s) for s in shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.size
        ds = H5Dataset(self, path, UNDEF)
        ds.shape, ds.dtype, ds.data_size = shape, dt.numpy, nbytes
        ds._type = _ReadType("fixed", dt.size, dt.numpy, message=dt.message)
        if nbytes:
            ds.data_addr = self._alloc(nbytes)
            self._f.truncate(self._eof)
        ds._msgs = _dataset_messages(shape, dt, ds.data_addr, nbytes)
        ds._dirty = True
        group.links[base] = UNDEF
        group._dirty = True
        self._objects[path] = ds
        return ds

    def _drop(self, path: str) -> None:
        for p in [p for p in self._objects if p == path or p.startswith(path + "/")]:
            del self._objects[p]

    def __delitem__(self, name: str) -> None:
        """Remove a link; its object's space is left unused."""
        self._require_edit()
        path = _norm(name)
        group, base = self._parent(path)
        del group.links[base]
        group._dirty = True
        self._drop(path)

    def move(self, source: str, dest: str) -> None:
        """Rename a link (the object and its address stay)."""
        self._require_edit()
        src, dst = _norm(source), _norm(dest)
        gs, bs = self._parent(src)
        gd, bd = self._parent(dst)
        if bd in gd.links:
            raise ValueError(f"{dst} exists")
        gd.links[bd] = gs.links.pop(bs)
        gs._dirty = gd._dirty = True
        for p in [p for p in self._objects if p == src or p.startswith(src + "/")]:
            obj = self._objects.pop(p)
            obj.path = dst + p[len(src):]
            self._objects[obj.path] = obj

    def _commit(self) -> None:
        objs = list(self._objects.values())
        if not any(o._dirty for o in objs):
            return
        # The new attributes' strings: one global heap collection.
        elems, index = [], {}
        for o in objs:
            for attr in o._new_attrs.values():
                if attr.dtype.kind == "vstr":
                    for i, e in enumerate(attr.value):
                        elems.append(e)
                        index[id(attr), i] = len(elems)
        heap_addr = UNDEF
        if elems:
            coll = _heap_collection(elems)
            heap_addr = self._alloc(len(coll))
            self._write(heap_addr, coll)

        def attr_msgs(o: H5Object) -> list:
            out = [(_ATTRIBUTE, fl, d) for fl, d in o._attr_msgs.values()]
            for name, attr in o._new_attrs.items():
                data = attr.value if attr.dtype.kind == "fixed" else b"".join(
                    struct.pack("<IQI", len(e), heap_addr, index[id(attr), i]) for i, e in enumerate(attr.value))
                out.append(_attr_message(name, attr.dtype, attr.shape, data))
            return out

        # Datasets: a new one gets a header at the end of the file, a changed
        # one a continuation block there (its first chunk is rewritten last).
        rewrites = []
        for o in objs:
            if isinstance(o, H5Dataset) and o._dirty:
                msgs = o._msgs + attr_msgs(o)
                n_attrs = len(msgs) - len(o._msgs)
                if o.addr == UNDEF:
                    hdr = _object_header(msgs, n_attrs)
                    o.addr = self._alloc(len(hdr))
                    self._write(o.addr, hdr)
                else:
                    block = _continuation_block(msgs)
                    at = self._alloc(len(block))
                    self._write(at, block)
                    rewrites.append((o._chunk0[0], _first_chunk(o._chunk0[1], at, len(block), n_attrs)))
        # Groups, deepest first: a changed group moves, so its parent changes.
        groups = [o for o in objs if isinstance(o, H5Group)]
        groups.sort(key=lambda g: 0 if g.path == "/" else g.path.count("/"), reverse=True)
        for g in groups:
            if not g._dirty:
                continue
            links = [_link_message(name, self._objects[_join(g.path, name)].addr) for name in g.links]
            own = [m for m in g._msgs if m[0] not in (_GROUP_INFO, _LINK)]
            attrs = attr_msgs(g)
            hdr = _object_header(own + [_group_info(len(links))] + links + attrs, len(attrs))
            g.addr = self._alloc(len(hdr))
            self._write(g.addr, hdr)
            if g.path != "/":
                self._parent(g.path)[0]._dirty = True
        # Everything new is in place: commit it with the superblock.
        self._f.truncate(self._eof)
        self._f.flush()
        os.fsync(self._f.fileno())
        sb = self._sb[:28] + struct.pack("<QQ", self._eof, self["/"].addr)
        self._write(0, sb + struct.pack("<I", lookup3(sb)))
        self._f.flush()
        for addr, chunk in rewrites:
            self._write(addr, chunk)
        self._f.flush()
        for o in objs:
            o._dirty = False


def copy_to_port_layout(src_path, dst_path, budget_bytes: int = 512 << 20) -> None:
    """Write the file at src_path (any layout H5File reads) again in this
    module's layout at dst_path: the same groups, datasets (contiguous:
    filtered chunks decoded), values and attributes (compact: dense links
    and attributes become compact ones), a committed VLEN uint8 type
    inline, object references mapped to the copies.  Data are copied in
    slabs along the first axis of at most budget_bytes."""
    with H5File(src_path) as src:
        w = Writer(dst_path)
        try:
            nodes: Dict[str, _Node] = {"/": w.root}

            def copy(name, obj):
                parent = nodes[_split(obj.path)[0]]
                base = _split(obj.path)[1]
                if isinstance(obj, H5Group):
                    nodes[obj.path] = w.create_group(parent, base)
                    return None
                t = obj._type
                if t.kind == "fixed":
                    dt = DType(t.message, t.size, "fixed", t.numpy)
                elif t.kind == "vseq" and t.base.kind == "fixed" and t.base.numpy == np.uint8:
                    dt = VLEN_U8
                else:
                    raise LayoutError(f"{obj.path}: a dataset of {t.kind} elements is not copied")
                ds = w.create_dataset(parent, base, obj.shape, dt)
                nodes[obj.path] = ds
                if not obj.shape:
                    w.write(ds, obj[()])
                elif dt is VLEN_U8:
                    for i in range(obj.shape[0]):
                        elem = obj[i]
                        if len(elem):
                            w.write_vlen(ds, i, elem.tobytes())
                else:
                    row = t.size * int(np.prod(obj.shape[1:], dtype=np.int64))
                    step = max(1, budget_bytes // max(2 * row, 1))
                    for t0 in range(0, obj.shape[0], step):
                        block = obj[t0:t0 + step]
                        w.write(ds, block, t0 * (row // t.size))
                return None

            src.visititems(copy)
            for path, obj in src._objects.items():
                for name, (t, shape) in obj._attr_types.items():
                    value = obj.attrs[name]
                    if t.kind == "fixed":
                        attr = _Attr(DType(t.message, t.size, "fixed", t.numpy), shape,
                                     np.ascontiguousarray(value, t.numpy).tobytes())
                    elif t.kind == "vstr":
                        attr = _Attr(VLEN_STR, shape, [v.encode() for v in ([value] if shape == () else value)])
                    elif t.kind == "vseq" and t.base.kind == "ref":  # references to unlinked objects are dropped
                        attr = _Attr(VLEN_REF, shape, [[nodes[p] for p in refs if p in nodes] for refs in value])
                    elif t.kind == "reflist":
                        value = [(nodes[p], int(axis)) for p, axis in value if p in nodes]
                        attr = _Attr(REF_LIST, (len(value),), value)
                    else:
                        raise LayoutError(f"{path}: attribute {name} of {t.kind} elements is not copied")
                    nodes[path].attrs[name] = attr
        finally:
            w.close()
