"""The port's HDF5 reader (wass_tpu_torch/io/hdf5.py, io/hdf5_index.py) on
the layouts that h5py and netCDF-C write, against h5py.

The committed fixtures (tests/torch_h5_fixtures/, written by
tests/torch_h5_fixtures.py) hold deflate, shuffle and fletcher32 chunks,
a chunk whose filter mask skips deflate, partial edge chunks stored
unfiltered, every chunk index of the version 4 layout (single chunk,
implicit, fixed array unpaged and paged with an unwritten page,
extensible array into its secondary blocks, version 2 B-tree with an
internal level), dense links and attributes with and without creation
order, and a committed VLEN type (the netCDF-C-like cube).  Each object
of each fixture is one case: its datasets whole and in slabs across chunk
edges and partial edge chunks, and its attributes, bit-equal to h5py,
with the same names, shapes and dtypes, in the file and in its
copy_to_port_layout copy.  Files made here with h5py cover what is too
large to commit: an extensible array's paged data blocks, a version 2
B-tree two levels deep, and a shared-message table (refused).  Each
layout raised a LayoutError before the reader read it."""

import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from wass_tpu_torch.io import hdf5
from wass_tpu_torch.testing.h5_manifest import digest, file_manifest

import torch_h5_fixtures as fx

FIXTURES = Path(__file__).resolve().parent / "torch_h5_fixtures"
READ = ("netcdfc_cube.nc", "indexes.h5", "dense.h5", "default_gzip.h5")


def _objects(path) -> list:
    names = ["/"]
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: names.append("/" + n) if not isinstance(o, h5py.Datatype) else None)
    return names


# The 240 members of dense.h5's two link groups are read by their group's case.
CASES = [(name, obj) for name in READ for obj in _objects(FIXTURES / name) if not obj.startswith("/links_by_")
         or obj.count("/") == 1]


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    """Each fixture's copy_to_port_layout copy (slabs of 64 KB)."""
    root = tmp_path_factory.mktemp("port_layout")
    out = {}
    for name in READ:
        out[name] = root / name
        hdf5.copy_to_port_layout(FIXTURES / name, out[name], 1 << 16)
    return out


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) and a.dtype == object:
        return a.shape == b.shape and all(np.array_equal(x, y) for x, y in zip(a.ravel(), b.ravel()))
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _slabs(shape, chunks, seed: int) -> list:
    """Selections across chunk edges and into the partial edge chunks, an
    integer index, a strided slice and random boxes."""
    if not shape:
        return [()]
    chunks = chunks or shape
    keys = [tuple(slice(max(c - 1, 0), c + 2) for c in chunks),
            tuple(slice(max(n - 3, 0), n) for n in shape),
            (shape[0] - 1,), (slice(None, None, 3),)]
    rng = np.random.default_rng(seed)
    for _ in range(4):
        a = [int(rng.integers(0, n)) for n in shape]
        keys.append(tuple(slice(x, int(rng.integers(x + 1, n + 1))) for x, n in zip(a, shape)))
    return keys


def _check_object(port_file, h5_file, path: str, ordered: bool = True) -> None:
    po, ho = port_file[path], h5_file[path]
    if ordered:  # h5py's order (a copy's attributes are not creation-ordered: by name)
        assert list(po.attrs) == list(ho.attrs), path
    assert sorted(po.attrs) == sorted(ho.attrs), path
    for k in ho.attrs:
        want = fx.port_form(h5_file, ho.attrs[k])
        got = po.attrs[k]
        if isinstance(got, (list, str)) or (isinstance(got, np.ndarray) and got.dtype == object):
            assert digest(got) == digest(want), (path, k, got, want)  # strings, references
        else:
            assert type(got) is type(want) and _equal(got, want), (path, k, got, want)
    if isinstance(ho, h5py.Group):
        assert isinstance(po, hdf5.H5Group)
        assert sorted(po.keys()) == sorted(n for n in ho if ho.get(n, getclass=True) is not h5py.Datatype), path
        for n in po.keys():
            if isinstance(ho[n], h5py.Dataset):
                assert _equal(po[n][()], ho[n][()]) and po[n].dtype == ho[n].dtype, (path, n)
        return
    assert isinstance(po, hdf5.H5Dataset) and po.shape == ho.shape and po.dtype == ho.dtype, path
    assert _equal(po[()], ho[()]), path
    for key in _slabs(ho.shape, ho.chunks, len(path)):
        assert _equal(po[key], ho[key]), (path, key)


@pytest.mark.parametrize("name,path", CASES, ids=[f"{n}:{p}" for n, p in CASES])
def test_object_reads_as_h5py(name, path, copies):
    with hdf5.H5File(FIXTURES / name) as pf, h5py.File(FIXTURES / name, "r") as hf:
        _check_object(pf, hf, path)
    with hdf5.H5File(copies[name]) as pf, h5py.File(FIXTURES / name, "r") as hf:
        _check_object(pf, hf, path, ordered=False)
    with h5py.File(copies[name], "r") as cf, h5py.File(FIXTURES / name, "r") as hf:  # h5py reads the copy alike
        if isinstance(hf[path], h5py.Dataset):
            assert _equal(cf[path][()], hf[path][()]) and cf[path].dtype == hf[path].dtype


@pytest.mark.parametrize("name", READ)
def test_manifest_matches_h5py_and_port(name, copies):
    """MANIFEST.json is what h5py reads now, and what the port reads from
    the fixture and from its copy."""
    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())[name]
    assert fx.h5py_manifest(FIXTURES / name) == manifest
    assert file_manifest(FIXTURES / name) == manifest
    assert file_manifest(copies[name]) == manifest


def test_layouts_cover_the_indexes():
    """The fixtures hold what they say they hold."""
    from wass_tpu_torch.io import hdf5_index as hi

    with hdf5.H5File(FIXTURES / "indexes.h5") as f:
        kinds = {p: (f[p]._layout.index, [x.name for x in f[p]._filters], f[p]._layout.partial_unfiltered)
                 for p in f["/"].keys()}
        masks = {m for _, _, m in f._chunk_index(f["mask_skipped"]).values()}
    assert {k[0] for k in kinds.values()} == {hi.SINGLE, hi.IMPLICIT, hi.FIXED_ARRAY, hi.EXTENSIBLE_ARRAY,
                                              hi.BTREE2}
    assert kinds["fletcher32"][1] == ["deflate", "fletcher32"] and kinds["partial_edge_unfiltered"][2]
    assert masks == {0, 1}
    with hdf5.H5File(FIXTURES / "netcdfc_cube.nc") as f:
        z = f["Z"]
        assert z._layout.index == hi.EXTENSIBLE_ARRAY and [x.name for x in z._filters] == ["shuffle", "deflate"]
        assert z.chunks == (32, 32, 32) and z.maxshape[0] == hdf5.UNDEF
        assert f._committed and "ImageBytes" not in f["/"] and not f.editable


@pytest.mark.parametrize("dataset,filter_name", [("lzf", "32000 \\(lzf\\)"), ("scaleoffset", "6 \\(scaleoffset\\)")])
def test_unsupported_filter_is_named(dataset, filter_name):
    with hdf5.H5File(FIXTURES / "unsupported.h5") as f:
        assert np.array_equal(f["plain"][()], np.arange(6))
        with pytest.raises(hdf5.LayoutError, match=f"filter {filter_name} is not read"):
            f[dataset][()]
        with pytest.raises(hdf5.LayoutError, match=f"filter {filter_name}"):
            f[dataset][12:14, 12:14]  # never fill values for a chunk that was not decoded


def test_chunk_decodes_counted(monkeypatch):
    """A slab decodes the chunks it meets, once each: the last row of
    chunks along the first axis stays decoded while it fits the budget."""
    with hdf5.H5File(FIXTURES / "netcdfc_cube.nc") as f:
        z = f["Z"]  # (64, 32, 32) in chunks of (32, 32, 32)
        counts = []
        for key in (np.s_[0:10], np.s_[10:20], np.s_[30:40], np.s_[40:50], np.s_[0:5], np.s_[:, 3, 3]):
            z[key]
            counts.append(z.chunk_decodes)
        assert counts == [1, 1, 2, 2, 3, 4]
    monkeypatch.setenv("WASS_POST_MEMORY_MB", "0.1")  # under one 128 KB chunk: nothing kept
    with hdf5.H5File(FIXTURES / "netcdfc_cube.nc") as f:
        z = f["Z"]
        for key, want in ((np.s_[0:10], 1), (np.s_[10:20], 2), (np.s_[30:40], 4), (np.s_[...], 6)):
            z[key]
            assert z.chunk_decodes == want


def test_extensible_array_paged_data_blocks(tmp_path):
    """Past 131060 chunks the extensible array's data blocks hold two
    pages of 1024 entries; one page left unwritten reads as the fill."""
    path = tmp_path / "ea_paged.h5"
    n = 134000
    data = np.random.default_rng(3).integers(1, 255, n, dtype=np.uint8)
    with h5py.File(path, "w", libver="latest") as f:
        ds = f.create_dataset("e", (n,), "u1", chunks=(1,), maxshape=(None,), fillvalue=0)
        ds[:132084] = data[:132084]
        ds[133108:] = data[133108:]
    want = data.copy()
    want[132084:133108] = 0
    with hdf5.H5File(path) as f:
        assert np.array_equal(f["e"][()], want)
        assert np.array_equal(f["e"][132000:133200], want[132000:133200])


def test_btree2_two_levels(tmp_path):
    """A version 2 B-tree of 6400 chunk records: internal nodes whose child
    pointers carry both record counts."""
    path = tmp_path / "bt2.h5"
    data = np.random.default_rng(4).standard_normal((80, 80)).astype(np.float32)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("t", data=data, chunks=(1, 1), maxshape=(None, None))
        f.create_dataset("g", data=data, chunks=(1, 1), maxshape=(None, None), compression="gzip")
    with hdf5.H5File(path) as f:
        import struct

        assert struct.unpack_from("<H", f._read(f["t"]._layout.address, 16), 12)[0] == 2
        assert np.array_equal(f["t"][()], data) and np.array_equal(f["g"][()], data)


def test_shared_message_table_refused(tmp_path):
    """A file with shared object header messages (SOHM, H5Pset_shared_mesg_*)
    raises a LayoutError that says so."""
    lib = fx._libhdf5()
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    assert lib.H5Pset_shared_mesg_nindexes(fcpl.id, 1) >= 0
    # Index 0 shares datatype and attribute messages of any size.
    assert lib.H5Pset_shared_mesg_index(fcpl.id, 0, 0x0002 | 0x0010, 1) >= 0
    path = tmp_path / "sohm.h5"
    fid = h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    with h5py.File(fid) as f:
        for i in range(3):
            f.create_dataset(f"d{i}", data=np.arange(4.0)).attrs["units"] = "m"
    with pytest.raises(hdf5.LayoutError, match="shared-message table"):
        hdf5.H5File(path)


def test_huge_heap_object_refused(tmp_path):
    """An attribute over the heap's largest managed object (24 KB against
    4 KB) is a huge object in dense storage: a LayoutError says so."""
    path = tmp_path / "huge.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("d", data=np.arange(3))
        for i in range(10):
            d.attrs[f"a{i}"] = i
        d.attrs["big"] = np.arange(3000, dtype=np.float64)
    with pytest.raises(hdf5.LayoutError, match="huge objects are not read"):
        hdf5.H5File(path)
