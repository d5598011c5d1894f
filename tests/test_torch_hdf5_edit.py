"""The port's HDF5 editor and its reader of h5py's default layout
(wass_tpu_torch/io/hdf5.py).

* After appended datasets, attribute changes, deletes and renames, the
  port's file reads the same through h5py, the JAX package's netCDF-4
  reader and the port's reader, and nothing it did not touch moved; the
  cube was not copied (the file grew by the new data and headers only).
* A cube the JAX package wrote (h5py defaults: superblock 0, version 1
  object headers, symbol-table groups, Z chunked 64 frames deep; 70
  frames, so two chunks along time) reads through the port's reader equal
  to h5py's, whole and in slices.
* A write command of the port's console converts such a cube first and
  says so; the read-only commands read it as it is.
"""

import h5py
import numpy as np
import pytest

from wass_tpu.grid.netcdf import NetCDFWriter as JaxWriter
from wass_tpu.io.netcdf4_reader import Dataset as NCDataset

from wass_tpu_torch.cli.post import main
from wass_tpu_torch.grid.netcdf import NetCDFWriter
from wass_tpu_torch.io import hdf5

T = 70


def _fill(w, M=12, N=10, seed=0):
    rng = np.random.default_rng(seed)
    w.scale = 2.5
    XX, YY = np.meshgrid(np.linspace(-4, 4, N), np.linspace(-20, -12, M))
    w.set_grids(XX * 1000.0, YY * 1000.0)
    w.set_kxky(XX * 0.5, YY * 0.25)
    w.set_intrinsics(np.eye(3) * 2, np.eye(3) * 3, np.zeros(5), np.zeros(5), rng.standard_normal((4, 4)),
                     rng.standard_normal((4, 4)), rng.standard_normal((3, 4)), rng.standard_normal((3, 4)),
                     rng.standard_normal((4, 4)), rng.standard_normal((4, 4)))
    w.add_meta_attribute("generator", "wass_tpu")
    w.add_meta_attribute("fps", 4.0)
    w.set_mask(np.ones((M, N), np.float32))
    for t in range(T):
        Z = (rng.standard_normal((M, N)) * 100).astype(np.float32)
        Z[rng.random((M, N)) < 0.1] = np.nan
        w.push_Z(Z, time=t / 4.0, workdir=t, image=rng.integers(0, 255, 5 + t % 7, dtype=np.uint8).tobytes())
    w.close()


@pytest.fixture
def jax_cube(tmp_path):
    path = tmp_path / "jax.nc"
    _fill(JaxWriter(path, M=12, N=10))
    return path


@pytest.fixture
def port_cube(tmp_path):
    path = tmp_path / "port.nc"
    _fill(NetCDFWriter(path, M=12, N=10, count=T))
    return path


def _attr(f, v):
    if isinstance(v, np.ndarray) and v.dtype.names == ("dataset", "dimension"):
        return [(f[r].name, int(d)) for r, d in v]
    if isinstance(v, np.ndarray) and v.dtype == object:
        return [[f[r].name for r in refs] for refs in v]
    return v


def assert_reads_as_h5py(path):
    """The port's reader sees what h5py sees: every object in h5py's
    order, attributes (references as paths), shapes, dtypes and values."""
    with hdf5.H5File(path) as mine, h5py.File(path, "r") as f:
        names, mnames = [], []
        f.visititems(lambda n, o: names.append(n))
        mine.visititems(lambda n, o: mnames.append(n))
        assert names == mnames
        for name in [""] + names:
            obj, m = (f[name], mine["/" + name]) if name else (f, mine["/"])
            assert sorted(obj.attrs) == sorted(m.attrs), name
            for k, v in obj.attrs.items():
                want, got = _attr(f, v), m.attrs[k]
                if isinstance(want, np.ndarray):
                    assert want.dtype == got.dtype and np.array_equal(want, got), (name, k)
                else:
                    assert want == got and type(want) is type(got), (name, k)
            if isinstance(obj, h5py.Dataset):
                assert m.shape == obj.shape and m.dtype == obj.dtype, name
                a, b = obj[()], m[...]
                if obj.dtype == object:
                    assert all(np.array_equal(x, y) for x, y in zip(a, b)), name
                else:
                    assert np.array_equal(a, b, equal_nan=obj.dtype.kind == "f"), name


def test_jax_cube_reads_as_h5py(jax_cube):
    assert_reads_as_h5py(jax_cube)
    with hdf5.H5File(jax_cube) as mine, h5py.File(jax_cube, "r") as f:
        z = mine["Z"]
        assert z.layout == "chunked" and z.chunks == f["Z"].chunks == (64, 10, 12) and not mine.editable
        for key in [np.s_[5:67, 2:7, 3], np.s_[-1], np.s_[::3, 1], np.s_[60:70], np.s_[63:65, -2:], np.s_[0, 0, 0]]:
            np.testing.assert_array_equal(z[key], f["Z"][key])
        assert np.array_equal(mine["cam0images"][66], f["cam0images"][66])
    with pytest.raises(hdf5.LayoutError, match="copy_to_port_layout"):
        hdf5.H5File(jax_cube, "r+")


def test_copy_to_port_layout(jax_cube, tmp_path):
    out = tmp_path / "copy.nc"
    hdf5.copy_to_port_layout(jax_cube, out, budget_bytes=4096)  # Z copied 8 frames at a time
    assert hdf5.H5File(out).editable
    assert_reads_as_h5py(out)
    with h5py.File(jax_cube, "r") as a, h5py.File(out, "r") as b:
        assert b["Z"].chunks is None and b["count"].maxshape == (T,)  # contiguous; count a fixed dimension
        np.testing.assert_array_equal(a["Z"][...], b["Z"][...])
        assert [d[0].name for d in b["Z"].dims] == ["/count", "/X", "/Y"]
    with NCDataset(jax_cube) as dj, NCDataset(out) as dp:
        assert dj.dimensions == dp.dimensions and sorted(dj.variables) == sorted(dp.variables)
        for name, v in dj.variables.items():
            assert v.dimensions == dp.variables[name].dimensions, name


def test_edits_read_the_same_everywhere(port_cube, tmp_path):
    before = port_cube.stat().st_size
    with h5py.File(port_cube, "r") as f:
        old = {n: f[n][()] for n in ("Z", "X_grid", "count", "meta/P0plane")}
    with hdf5.H5File(port_cube, "r+") as f:
        z = f["Z"]
        zf = f.create_dataset("Z_filtered", z.shape, "f4")
        zf[:, :4] = z[:, :4] * 2
        zf[:, 4:] = z[:, 4:] * 2
        zf.attrs["frequency_filter_cutoff"] = 1.0
        occ = f.create_dataset("occlusion_cam0", z.shape, "u1")
        occ[3] = 1
        f["meta"].attrs["fps"] = 7.5
        f["meta"].attrs["note"] = "edited"
        f["Z"].attrs["frequency_filter_cutoff"] = 0.5  # an attribute on a referenced dataset
        for i in range(9):  # past the compact attribute phase change
            f["X_grid"].attrs[f"a{i}"] = np.arange(i + 1, dtype=np.int16)
        f.move("maskZ", "maskZ2")
        del f["cam0masks"]
        f["time"][...] = np.arange(T) / 7.5
    grown = port_cube.stat().st_size - before
    assert grown < 2 * 70 * 12 * 10 * 5 + 20000  # the new data and headers, no copy of the cube
    assert_reads_as_h5py(port_cube)
    with h5py.File(port_cube, "r") as f:
        assert "cam0masks" not in f and "maskZ" not in f and f["maskZ2"].shape == (10, 12)
        np.testing.assert_array_equal(f["Z_filtered"][...], 2 * old["Z"])
        assert f["occlusion_cam0"][3].all() and not f["occlusion_cam0"][4].any()
        for n, v in old.items():
            np.testing.assert_array_equal(f[n][()], v)
        assert f["meta"].attrs["fps"] == 7.5 and f["meta"].attrs["note"] == "edited"
        assert f["Z"].attrs["frequency_filter_cutoff"] == 0.5 and f["Z"].attrs["units"] == "millimeter"
        assert [d[0].name for d in f["Z"].dims] == ["/count", "/X", "/Y"]
        assert np.array_equal(f["X_grid"].attrs["a8"], np.arange(9))
        np.testing.assert_array_equal(f["time"][...], (np.arange(T) / 7.5).astype(np.float32))
    with NCDataset(port_cube) as d:
        assert d.variables["Z"].dimensions == ("count", "X", "Y")
        assert d.groups["meta"].getncattr("fps") == 7.5
        assert d.variables["Z"].getncattr("frequency_filter_cutoff") == 0.5
    # A second round of edits on the same objects (the continuation rewritten).
    with hdf5.H5File(port_cube, "r+") as f:
        f["Z"].attrs["frequency_filter_cutoff"] = 0.25
        del f["Z_filtered"]
        f.create_dataset("Z_filtered", (T, 10, 12), "f4")
    assert_reads_as_h5py(port_cube)
    with h5py.File(port_cube, "r") as f:
        assert f["Z"].attrs["frequency_filter_cutoff"] == 0.25 and not f["Z_filtered"][...].any()


def test_an_interrupted_edit_leaves_the_old_file(port_cube, monkeypatch):
    with h5py.File(port_cube, "r") as f:
        fps = f["meta"].attrs["fps"]
    f = hdf5.H5File(port_cube, "r+")
    f.create_dataset("Z_new", (T, 10, 12), "f4")[...] = 1.0
    f["meta"].attrs["fps"] = 9.0
    f["Z"].attrs["x"] = 1.0

    def cut(*_):
        raise KeyboardInterrupt

    monkeypatch.setattr(hdf5.os, "fsync", cut)  # just before the superblock is written
    with pytest.raises(KeyboardInterrupt):
        f.close()
    assert_reads_as_h5py(port_cube)
    with h5py.File(port_cube, "r") as g:
        assert "Z_new" not in g and g["meta"].attrs["fps"] == fps and "x" not in g["Z"].attrs


def test_write_commands_convert_a_jax_cube(jax_cube, capsys):
    with h5py.File(jax_cube, "r") as f:
        Z = f["Z"][...]
    assert main(["info", str(jax_cube), "--device", "cpu"]) == 0
    assert main(["spectrum", str(jax_cube), "--nperseg", "16", "--rangespan", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Z: shape=(70, 10, 12)" in out and "Hm0" in out and "converted" not in out
    assert not hdf5.H5File(jax_cube).editable
    assert main(["setfps", str(jax_cube), "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"converted {jax_cube} to the port's layout" in out and "fps set to 5.0" in out
    assert hdf5.H5File(jax_cube).editable
    assert_reads_as_h5py(jax_cube)
    with h5py.File(jax_cube, "r") as f:
        np.testing.assert_array_equal(f["Z"][...], Z)
        assert f["meta"].attrs["fps"] == 5.0 and f["time"][2] == np.float32(0.4)
