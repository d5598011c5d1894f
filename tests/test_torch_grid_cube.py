"""The port's gridded.nc (its own HDF5 writer, wass_tpu_torch/io/hdf5.py)
against the JAX package's h5py cube, both fed the same arrays: h5py and
the JAX package's netCDF-4 reader see the same variables, values, dtypes,
attributes, meta group and dimension scales.  The two stated
differences: `count` is a fixed dimension (the JAX cube's is unlimited)
and every dataset is contiguous (the JAX cube chunks its record
variables)."""

import h5py
import numpy as np
import pytest

from wass_tpu.grid.gridding import _force_zero_mean_chunked as jax_zero_mean
from wass_tpu.grid.netcdf import NetCDFWriter as JaxWriter
from wass_tpu.io.netcdf4_reader import Dataset as NCDataset

from wass_tpu_torch.grid.gridding import _force_zero_mean_chunked as port_zero_mean
from wass_tpu_torch.grid.netcdf import NetCDFReader, NetCDFWriter
from wass_tpu_torch.io import hdf5

T = 4


def _fill(w, M, N, seed=0):
    """The calls grid_sequence makes, on random arrays; frame 1 has no
    image and frames 0 and 2 have masks."""
    rng = np.random.default_rng(seed)
    w.scale = 2.5
    XX, YY = np.meshgrid(np.linspace(-4, 4, N), np.linspace(-20, -12, M))
    w.set_grids(XX * 1000.0, YY * 1000.0)
    w.set_kxky(XX * 0.5, YY * 0.25)
    w.set_intrinsics(np.eye(3) * 2, np.eye(3) * 3, np.zeros(5), np.zeros(5), rng.standard_normal((4, 4)),
                     rng.standard_normal((4, 4)), rng.standard_normal((3, 4)), rng.standard_normal((3, 4)),
                     rng.standard_normal((4, 4)), rng.standard_normal((4, 4)))
    w.add_meta_attribute("generator", "wass_tpu")
    w.add_meta_attribute("baseline", 2.5)
    w.add_meta_attribute("fps", 4.0)
    mask = (rng.random((M, N)) > 0.2).astype(np.float32)
    w.set_mask(mask)
    Zs = []
    for t in range(T):
        Z = (rng.standard_normal((M, N)) * 100).astype(np.float32)
        Z[rng.random((M, N)) < 0.1] = np.nan
        Zs.append(Z)
        img = rng.integers(0, 255, 40 + t, dtype=np.uint8).tobytes() if t != 1 else None
        msk = rng.integers(0, 255, 9, dtype=np.uint8).tobytes() if t in (0, 2) else None
        w.add_meta_attribute("image_width", 96)
        w.add_meta_attribute("image_height", 64)
        w.push_Z(Z, time=t / 4.0, workdir=t + 7, image=img, imagemask=msk)
    w.add_meta_attribute("zmin", -312.5)
    w.add_meta_attribute("zmax", 312.5)
    w.close()
    return Zs, mask


def _cubes(tmp_path, M, N):
    jp, pp = tmp_path / "jax.nc", tmp_path / "port.nc"
    Zs, mask = _fill(JaxWriter(jp, M=M, N=N), M, N)
    _fill(NetCDFWriter(pp, M=M, N=N, count=T), M, N)
    return jp, pp, Zs, mask


def _attr_value(f, v):
    """An h5py attribute with object references resolved to paths."""
    if isinstance(v, np.ndarray) and v.dtype.names == ("dataset", "dimension"):
        return [(f[r].name, int(d)) for r, d in v]
    if isinstance(v, np.ndarray) and v.dtype == object:  # DIMENSION_LIST
        return [[f[r].name for r in refs] for refs in v]
    return v


def _walk(f):
    out = {}
    f.visititems(lambda name, obj: out.setdefault("/" + name, obj))
    out["/"] = f
    return out


SHAPES = [(12, 10), (8, 8), (5, 13)]


@pytest.mark.parametrize("M, N", SHAPES)
def test_h5py_reads_the_same_cube(tmp_path, M, N):
    jp, pp, Zs, mask = _cubes(tmp_path, M, N)
    with h5py.File(jp, "r") as fj, h5py.File(pp, "r") as fp:
        oj, op = _walk(fj), _walk(fp)
        assert sorted(oj) == sorted(op)
        for name, a in oj.items():
            b = op[name]
            assert type(a) is type(b), name
            if isinstance(a, h5py.Dataset):
                assert a.shape == b.shape and a.dtype == b.dtype, name
                assert b.chunks is None and b.maxshape == b.shape, name  # contiguous, fixed count
                va, vb = a[()], b[()]
                if a.dtype == object:
                    assert len(va) == len(vb) and all(np.array_equal(x, y) for x, y in zip(va, vb)), name
                else:
                    assert np.array_equal(va, vb, equal_nan=a.dtype.kind == "f"), name
            assert sorted(a.attrs) == sorted(b.attrs), name
            for k in a.attrs:
                x, y = _attr_value(fj, a.attrs[k]), _attr_value(fp, b.attrs[k])
                assert type(x) is type(y), (name, k)
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and np.array_equal(x, y), (name, k)
                else:
                    assert x == y, (name, k)
        assert fj["count"].maxshape == (None,)  # the JAX cube's unlimited record dimension
        # Z holds each frame transposed: (count, N=X, M=Y).
        np.testing.assert_array_equal(fp["Z"][...], np.stack([z.T for z in Zs]))
        np.testing.assert_array_equal(fp["maskZ"][...], mask.T)


@pytest.mark.parametrize("M, N", SHAPES)
def test_dimension_scales_resolve(tmp_path, M, N):
    """As tests/test_grid_parity.py:28-48 checks the JAX cube."""
    _, pp, _, _ = _cubes(tmp_path, M, N)
    with h5py.File(pp, "r") as f:
        for dim in ("X", "Y", "count"):
            assert f[dim].attrs["CLASS"] == b"DIMENSION_SCALE"
            assert f[dim].is_scale
        expect = {"Z": ["/count", "/X", "/Y"], "time": ["/count"], "workdir": ["/count"],
                  "cam0images": ["/count"], "cam0masks": ["/count"]}
        expect.update({v: ["/X", "/Y"] for v in ("X_grid", "Y_grid", "Kx", "Ky", "maskZ")})
        for var, dims in expect.items():
            assert [f[ref[0]].name for ref in f[var].attrs["DIMENSION_LIST"]] == dims, var
            assert [d[0].name for d in f[var].dims] == dims, var  # h5py's own resolution


@pytest.mark.parametrize("M, N", SHAPES)
def test_netcdf4_reader_sees_the_same_dimensions(tmp_path, M, N):
    jp, pp, _, _ = _cubes(tmp_path, M, N)
    with NCDataset(jp) as dj, NCDataset(pp) as dp:
        assert dj.dimensions == dp.dimensions == {"X": N, "Y": M, "count": T}
        assert sorted(dj.variables) == sorted(dp.variables)
        for name, v in dj.variables.items():
            w = dp.variables[name]
            assert v.dimensions == w.dimensions and v.shape == w.shape, name
            assert sorted(v.ncattrs()) == sorted(w.ncattrs()), name
            for k in v.ncattrs():
                assert v.getncattr(k) == w.getncattr(k), (name, k)
        mj, mp = dj.groups["meta"], dp.groups["meta"]
        assert sorted(mj.ncattrs()) == sorted(mp.ncattrs())
        for k in mj.ncattrs():
            assert mj.getncattr(k) == mp.getncattr(k), k
        assert sorted(mj.variables) == sorted(mp.variables)
        for name in mj.variables:
            assert np.array_equal(mj[name][...], mp[name][...]), name


@pytest.mark.parametrize("M, N", SHAPES)
def test_port_reader_matches_h5py(tmp_path, M, N):
    _, pp, _, _ = _cubes(tmp_path, M, N)
    cube = NetCDFReader(pp)
    with h5py.File(pp, "r") as f:
        objs = _walk(f)
        for name, obj in objs.items():
            mine = cube.f[name]
            assert sorted(mine.attrs) == sorted(obj.attrs), name
            for k, v in obj.attrs.items():
                want, got = _attr_value(f, v), mine.attrs[k]
                if isinstance(want, np.ndarray):
                    assert np.array_equal(want, got), (name, k)
                else:
                    assert want == got and type(want) is type(got), (name, k)
            if isinstance(obj, h5py.Dataset):
                assert mine.shape == obj.shape, name
                if obj.dtype == object:
                    assert mine.dtype == object
                    assert all(np.array_equal(x, y) for x, y in zip(mine[...], obj[()])), name
                else:
                    assert mine.dtype == obj.dtype
                    assert np.array_equal(mine[...], obj[()], equal_nan=obj.dtype.kind == "f"), name
        assert sorted(cube.f["/"].keys()) == sorted(f.keys())
        assert np.array_equal(cube.meta("P0cam"), f["meta/P0cam"][...])
        assert cube.meta_attr("generator") == "wass_tpu" and cube.meta_attr("fps") == 4.0
        assert cube.Z.shape == (T, N, M) and cube["time"][2] == np.float32(0.5)
    cube.close()


@pytest.mark.parametrize("block", [1, 3, 64])
@pytest.mark.parametrize("M, N", [(12, 10), (5, 13)])
def test_force_zero_mean_matches_jax(tmp_path, M, N, block):
    """The in-place rewrite of the contiguous Z, `block` frames at a time,
    is bit-equal to the JAX package's chunked h5py rewrite."""
    jp, pp, Zs, _ = _cubes(tmp_path, M, N)
    mean = np.nanmean(np.stack(Zs), axis=0).astype(np.float32)
    jax_zero_mean(jp, mean)
    port_zero_mean(pp, mean, block=block)
    with h5py.File(jp, "r") as fj, h5py.File(pp, "r") as fp:
        assert np.array_equal(fj["Z"][...], fp["Z"][...], equal_nan=True)
        assert np.array_equal(fj["time"][...], fp["time"][...])  # nothing else moved


def test_equal_length_images_read_back(tmp_path):
    """VLEN elements of one length stay a 1-d array of arrays."""
    w = NetCDFWriter(tmp_path / "a.nc", M=2, N=3, count=3)
    for t in range(3):
        w.push_Z(np.zeros((2, 3)), time=t, workdir=t, image=bytes([t] * 5))
    w.close()
    with NetCDFReader(tmp_path / "a.nc") as cube:
        imgs = cube["cam0images"][...]
        assert imgs.shape == (3,) and all(np.array_equal(imgs[t], [t] * 5) for t in range(3))
        assert np.array_equal(cube["cam0images"][1], [1] * 5)


def test_writer_refuses_misfits(tmp_path):
    w = NetCDFWriter(tmp_path / "a.nc", M=4, N=3, count=1)
    with pytest.raises(ValueError, match="grid"):
        w.push_Z(np.zeros((3, 3)), time=0.0, workdir=0)
    w.push_Z(np.zeros((4, 3)), time=0.0, workdir=0)
    with pytest.raises(IndexError, match="holds 1 frames"):
        w.push_Z(np.zeros((4, 3)), time=0.0, workdir=1)
    w.close()
    with h5py.File(tmp_path / "a.nc", "r") as f:
        assert f["Z"].shape == (1, 3, 4)


@pytest.mark.parametrize("data, initval, want", [
    (b"", 0, 0xDEADBEEF),
    (b"", 0xDEADBEEF, 0xBD5B7DDE),
    (b"Four score and seven years ago", 0, 0x17770551),
    (b"Four score and seven years ago", 1, 0xCD628161),
])
def test_lookup3_reference_values(data, initval, want):
    """Bob Jenkins' published hashlittle values (the self-test in lookup3.c)."""
    assert hdf5.lookup3(data, initval) == want


def test_reader_rejects_a_corrupt_header(tmp_path):
    path = tmp_path / "a.nc"
    NetCDFWriter(path, M=3, N=2, count=1).close()
    raw = bytearray(path.read_bytes())
    at = raw.index(b"OHDR") + 8
    raw[at] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        hdf5.H5File(path)
