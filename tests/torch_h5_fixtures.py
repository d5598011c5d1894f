"""Write the HDF5 fixtures of the port's reader with h5py (not collected).

    python tests/torch_h5_fixtures.py [OUTDIR]

writes into OUTDIR (default tests/torch_h5_fixtures/) files in the layouts
that netCDF-C and h5py write and that wass_tpu_torch/io/hdf5.py reads,
from fixed numpy seeds, and MANIFEST.json: each file's datasets (shape,
dtype and the sha256 of their C-order bytes) and attributes (the sha256
of each value), in the forms of wass_tpu_torch.testing.h5_manifest.  The
committed copies are what a host without h5py checks its reader against.

* netcdfc_cube.nc: a gridded cube as netCDF-C writes one: superblock 3,
  creation-order-tracked links and attributes (dense links at the root),
  _NCProperties, _Netcdf4Dimid and _Netcdf4Coordinates, dimension scales
  (X and Y with netCDF's "not a netCDF variable" NAME), a committed VLEN
  uint8 type for cam0images and cam0masks (two small JPEGs), Z of
  tests/torch_post_data.py's wave field (N = 32, 64 frames, NaN holes)
  chunked (32, 32, 32) with deflate and shuffle on an unlimited count (an
  extensible array index), and the meta group.
* indexes.h5: one dataset for each chunk index of the version 4 layout
  (single chunk, implicit, fixed array unpaged and paged with a page left
  unwritten, extensible array into its secondary blocks, version 2 B-tree
  with an internal level), each also filtered where the index allows it;
  fletcher32; deflate skipped by one chunk's filter mask (a direct chunk
  write); partial edge chunks left unfiltered; the default (version 1
  B-tree) layout with deflate.
* dense.h5: dense attributes (with and without creation order) and dense
  links (with and without creation order, enough of them for an indirect
  block in the fractal heap and an internal level in the name index).
* unsupported.h5: LZF and scale-offset filters, which the reader refuses.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import sys
import tempfile
from pathlib import Path

import cv2
import h5py
import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from wass_tpu_torch.testing.h5_manifest import digest  # noqa: E402

NOT_A_VARIABLE = "This is a netCDF dimension but not a netCDF variable"
NC_PROPERTIES = b"version=2,netcdf=4.9.2,hdf5=1.14.3"
N_FRAMES, N_GRID, Z_CHUNK = 64, 32, 32


def _libhdf5():
    """h5py's own libhdf5, for the creation options h5py does not expose
    (H5Pset_chunk_opts, H5Pset_shared_mesg_*), each declared."""
    libs = glob.glob(os.path.join(os.path.dirname(h5py.__file__), "..", "h5py.libs", "libhdf5-*.so*"))
    libs += glob.glob(os.path.join(os.path.dirname(h5py.__file__), "*.libs", "libhdf5*.so*"))
    lib = ctypes.CDLL(libs[0]) if libs else ctypes.CDLL("libhdf5.so")
    hid, u = ctypes.c_int64, ctypes.c_uint
    for name, args in (("H5Pset_chunk_opts", [hid, u]), ("H5Pset_shared_mesg_nindexes", [hid, u]),
                       ("H5Pset_shared_mesg_index", [hid, u, u, u])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _jpeg(seed: int, shape=(24, 32)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:shape[0], :shape[1]]
    img = np.clip(128 + 60 * np.sin(x / 5.0 + seed) + 20 * rng.standard_normal(shape), 0, 255).astype(np.uint8)
    return np.frombuffer(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes(), np.uint8)


def netcdfc_cube(path: Path) -> None:
    from torch_post_data import write_post_cube

    with tempfile.TemporaryDirectory() as tmp:
        src = write_post_cube(tmp, n_frames=N_FRAMES, N=N_GRID)
        with h5py.File(src, "r") as s:
            data = {k: s[k][()] for k in ("X_grid", "Y_grid", "Kx", "Ky", "Z", "maskZ", "time", "scale")}
            attrs = {k: dict(s[k].attrs) for k in s if isinstance(s[k], h5py.Dataset)}
            meta = {k: s["meta"][k][()] for k in s["meta"]}
            meta_attrs = dict(s["meta"].attrs)
    images = [_jpeg(1), _jpeg(2)]
    with h5py.File(path, "w", libver="latest", track_order=True) as f:
        f.attrs.create("_NCProperties", NC_PROPERTIES, dtype=h5py.string_dtype("ascii", len(NC_PROPERTIES)))
        f["ImageBytes"] = h5py.vlen_dtype(np.uint8)  # netCDF-C commits a user-defined VLEN type
        vtype = f["ImageBytes"]

        def var(name, shape, dtype, **kw):
            ds = f.create_dataset(name, shape, dtype, track_order=True, **kw)
            for k, v in attrs.get(name, {}).items():
                if k not in ("DIMENSION_LIST", "REFERENCE_LIST", "CLASS", "NAME"):
                    ds.attrs[k] = v
            return ds

        X = var("X", (N_GRID,), "f4")
        Y = var("Y", (N_GRID,), "f4")
        count = var("count", (N_FRAMES,), "u4", maxshape=(None,), chunks=(1024,))
        for i, d in enumerate((X, Y, count)):
            d.make_scale(d.name[1:] if d is count else f"{NOT_A_VARIABLE}{N_GRID:10d}")
            d.attrs["_Netcdf4Dimid"] = np.int32(i)
        count[...] = np.arange(N_FRAMES)
        var("scale", (), "f8")[()] = data["scale"]
        time = var("time", (N_FRAMES,), "f4", maxshape=(None,), chunks=(1024,))
        time[...] = data["time"]
        var("workdir", (N_FRAMES,), "u8", maxshape=(None,), chunks=(1024,))[...] = np.arange(N_FRAMES)
        two_d = []
        for name in ("X_grid", "Y_grid", "Kx", "Ky"):
            ds = var(name, (N_GRID, N_GRID), "f8")
            ds[...] = data[name]
            two_d.append(ds)
        Z = var("Z", (N_FRAMES, N_GRID, N_GRID), "f4", maxshape=(None, N_GRID, N_GRID),
                chunks=(Z_CHUNK, N_GRID, N_GRID), compression="gzip", compression_opts=4, shuffle=True)
        Z[...] = data["Z"]
        Z.attrs["_Netcdf4Coordinates"] = np.array([2, 0, 1], np.int32)
        mask = var("maskZ", (N_GRID, N_GRID), "f4")
        mask[...] = data["maskZ"]
        two_d.append(mask)
        cam0 = var("cam0images", (N_FRAMES,), vtype, maxshape=(None,), chunks=(16,))
        masks = var("cam0masks", (N_FRAMES,), vtype, maxshape=(None,), chunks=(16,))
        for i in range(N_FRAMES):
            cam0[i] = images[i % 2]
        masks[0] = images[1]
        masks[1] = images[0]
        for ds in two_d:
            ds.dims[0].attach_scale(X)
            ds.dims[1].attach_scale(Y)
        Z.dims[0].attach_scale(count)
        Z.dims[1].attach_scale(X)
        Z.dims[2].attach_scale(Y)
        for ds in (time, f["workdir"], cam0, masks):
            ds.dims[0].attach_scale(count)
        g = f.create_group("meta", track_order=True)
        for k, v in meta.items():
            g.create_dataset(k, data=v, track_order=True)
        for k, v in meta_attrs.items():
            g.attrs[k] = v
        g.attrs["image_width"] = np.int64(32)
        g.attrs["image_height"] = np.int64(24)


def indexes(path: Path) -> None:
    rng = np.random.default_rng(14)
    with h5py.File(path, "w", libver="latest") as f:
        def ds(name, data, **kw):
            f.create_dataset(name, data=data, **kw)

        a = rng.standard_normal((37, 29)).astype(np.float32)
        ds("fixed", a, chunks=(8, 8))
        ds("fixed_gzip", a, chunks=(8, 8), compression="gzip", shuffle=True)
        # 48 x 48 chunks of one element: three pages of 1024 entries; the
        # middle page (rows 21-42) is never written.
        fp = f.create_dataset("fixed_paged", (48, 48), "i2", chunks=(1, 1), fillvalue=-7)
        b = rng.integers(-1000, 1000, (48, 48)).astype(np.int16)
        fp[:20] = b[:20]
        fp[44:] = b[44:]
        fpg = f.create_dataset("fixed_paged_gzip", (40, 40), "i4", chunks=(1, 1), compression="gzip")
        fpg[...] = rng.integers(0, 9, (40, 40))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((6, 5))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        imp = h5py.h5d.create(f.id, b"implicit", h5py.h5t.NATIVE_DOUBLE, h5py.h5s.create_simple((17, 23)), dcpl=dcpl)
        c = rng.standard_normal((17, 23))
        imp.write(h5py.h5s.ALL, h5py.h5s.ALL, c)
        ds("single", c, chunks=c.shape)
        ds("single_gzip", c, chunks=c.shape, compression="gzip")
        # 300 chunks along the unlimited axis: past the index block's 244
        # elements into the secondary blocks.
        e = rng.integers(0, 255, (300, 6), dtype=np.uint8)
        ds("earray", e, chunks=(1, 6), maxshape=(None, 6))
        ds("earray_gzip", e, chunks=(1, 6), maxshape=(None, 6), compression="gzip", shuffle=True)
        ds("earray_second_axis", e.T.copy(), chunks=(3, 1), maxshape=(6, None))
        # Two unlimited axes: a version 2 B-tree; 25 x 10 chunks is past
        # one leaf.
        t = rng.standard_normal((50, 40)).astype(np.float32)
        ds("btree2", t, chunks=(2, 4), maxshape=(None, None))
        ds("btree2_gzip", t, chunks=(2, 4), maxshape=(None, None), compression="gzip", shuffle=True)
        ds("fletcher32", t, chunks=(16, 16), fletcher32=True, compression="gzip")
        ds("fletcher32_only", t[:, :33], chunks=(7, 11), fletcher32=True)
        sk = f.create_dataset("mask_skipped", (16, 16), "f4", chunks=(8, 8), compression="gzip")
        sk[...] = t[:16, :16]
        sk.id.write_direct_chunk((8, 0), t[20:28, 20:28].tobytes(), filter_mask=1)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((8, 8))
        dcpl.set_deflate(6)
        if _libhdf5().H5Pset_chunk_opts(dcpl.id, 0x0002) < 0:  # H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS
            raise RuntimeError("H5Pset_chunk_opts failed")
        pe = h5py.h5d.create(f.id, b"partial_edge_unfiltered", h5py.h5t.NATIVE_FLOAT,
                             h5py.h5s.create_simple((21, 19)), dcpl=dcpl)
        pe.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(t[:21, :19]))
    with h5py.File(path.with_name("default_gzip.h5"), "w") as f:
        f.create_dataset("Z", data=rng.standard_normal((70, 10, 12)).astype(np.float32), chunks=(64, 10, 12),
                         compression="gzip", shuffle=True, maxshape=(None, 10, 12))
        f.create_dataset("fletcher", data=rng.integers(0, 100, (30, 30)).astype(np.int32), chunks=(16, 16),
                         fletcher32=True)


def dense(path: Path) -> None:
    rng = np.random.default_rng(7)
    with h5py.File(path, "w", libver="latest") as f:
        for name, order in (("attrs_by_name", False), ("attrs_by_order", True)):
            d = f.create_dataset(name, data=np.arange(5.0), track_order=order)
            for i in rng.permutation(20):
                d.attrs[f"attr_{i:02d}_{'x' * int(i)}"] = rng.standard_normal(int(i) % 4 + 1)
            d.attrs["text"] = "a variable-length string"
            d.attrs["fixed"] = np.bytes_(b"fixed text")
        for name, order in (("links_by_name", False), ("links_by_order", True)):
            g = f.create_group(name, track_order=order)
            for i in rng.permutation(120):
                g.create_dataset(f"member_{i:03d}_{'long_name_' * (int(i) % 5)}", data=np.full(3, i, np.int16))
            g.attrs["n"] = 120


def unsupported(path: Path) -> None:
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("lzf", data=np.arange(400, dtype=np.float32).reshape(20, 20), chunks=(10, 10),
                         compression="lzf")
        f.create_dataset("scaleoffset", data=np.arange(400, dtype=np.int32).reshape(20, 20), chunks=(10, 10),
                         scaleoffset=0)
        f.create_dataset("plain", data=np.arange(6))


WRITERS = {"netcdfc_cube.nc": netcdfc_cube, "indexes.h5": indexes, "dense.h5": dense,
           "unsupported.h5": unsupported}
REFUSED = {"unsupported.h5": ("/lzf", "/scaleoffset")}  # datasets the reader refuses (no digest of data)


def port_form(f: h5py.File, value):
    """h5py's value in the port reader's form: object references as the
    referenced object's path, variable-length strings as str."""
    if isinstance(value, h5py.Reference):
        return f[value].name if value else None
    if isinstance(value, bytes) and not isinstance(value, np.bytes_):
        return value.decode()
    if isinstance(value, np.ndarray) and value.dtype.names == ("dataset", "dimension"):
        return [(f[r].name, int(d)) for r, d in value]
    if isinstance(value, np.ndarray) and value.dtype == object:
        items = [port_form(f, v) for v in value.ravel()]
        if all(isinstance(v, str) for v in items):
            return items
        out = np.empty(len(items), object)
        for i, v in enumerate(items):
            out[i] = v
        return out.reshape(value.shape)
    return value


def h5py_manifest(path: Path) -> dict:
    out = {"datasets": {}, "attrs": {}}
    with h5py.File(path, "r") as f:
        objs = [("/", f)]
        f.visititems(lambda name, obj: objs.append(("/" + name, obj)) if not isinstance(obj, h5py.Datatype)
                     else None)
        for name, obj in objs:
            if obj.attrs:
                out["attrs"][name] = {k: digest(port_form(f, obj.attrs[k])) for k in obj.attrs}
            if isinstance(obj, h5py.Dataset) and name not in REFUSED.get(path.name, ()):
                out["datasets"][name] = [list(obj.shape), str(obj.dtype), digest(port_form(f, obj[()]))]
    return out


def main(argv) -> int:
    out = Path(argv[1]) if len(argv) > 1 else HERE / "torch_h5_fixtures"
    out.mkdir(parents=True, exist_ok=True)
    for name, writer in WRITERS.items():
        writer(out / name)
    manifest = {p.name: h5py_manifest(p) for p in sorted(out.iterdir()) if p.suffix in (".nc", ".h5")}
    (out / "MANIFEST.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    for p in sorted(out.iterdir()):
        print(f"{p.name}: {p.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
