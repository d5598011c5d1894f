"""The port's wass-tpu-torch-post (--device cpu) against the JAX package's
click console (h5py) on the committed netCDF-C-like cube
(tests/torch_h5_fixtures/netcdfc_cube.nc: dense links, creation-ordered
attributes, a committed VLEN type for cam0images, Z deflated and
shuffled in (32, 32, 32) chunks under an extensible array index; written
by tests/torch_h5_fixtures.py).

Each command runs on two copies of the cube: the JAX console edits its
copy in place through h5py, the port's first rewrites its copy in the
port's layout (and says so), then edits it.  Both results are read with
h5py and held to tests/test_torch_post_cli.py's tolerances: info's lines
equal; spectrum's S within 1e-5 of its maximum; zeromean and filter
exact; visibilitymap's occlusion at most 0.1% of the cells apart,
incidence within 1e-4 degrees.  The committed type is the one object
the port's copy does not hold (its cam0images are inline VLEN uint8)."""

import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest
from click.testing import CliRunner

from wass_tpu.cli.post import cli as jax_cli

from test_torch_post_cli import JAX_SECONDS, _attr, run_port, time_limit

CUBE = Path(__file__).resolve().parent / "torch_h5_fixtures" / "netcdfc_cube.nc"
CONVERTED = "converted {} to the port's layout (contiguous datasets, compact links) before writing\n"


@pytest.fixture(autouse=True)
def tiny_budget(monkeypatch):
    monkeypatch.setenv("WASS_POST_MEMORY_MB", "0.05")  # every streaming path; no chunk row stays decoded


def run_both(tmp_path, args):
    jp, pp = tmp_path / "jax.nc", tmp_path / "port.nc"
    shutil.copy(CUBE, jp)
    shutil.copy(CUBE, pp)
    with time_limit(JAX_SECONDS):
        r = CliRunner().invoke(jax_cli, [args[0], str(jp), *args[1:]])
    assert r.exit_code == 0, r.output
    rc, out, err = run_port([args[0], str(pp), *args[1:]])
    assert rc == 0, err
    return jp, pp, r.output.replace(str(jp.with_suffix("")), "NC"), out.replace(str(pp.with_suffix("")), "NC")


def _objects(f) -> list:
    names = []
    f.visititems(lambda n, o: names.append(n) if not isinstance(o, h5py.Datatype) else None)
    return names


def compare(jp, pp, tol=None, occ_share=None):
    """Every dataset and group of the two cubes (the committed type aside):
    names, shapes, dtypes, attributes and values."""
    tol, occ_share = tol or {}, occ_share or {}
    with h5py.File(jp, "r") as fj, h5py.File(pp, "r") as fp:
        assert sorted(_objects(fj)) == sorted(_objects(fp))
        for name in [""] + _objects(fj):
            a, b = (fj[name], fp[name]) if name else (fj, fp)
            assert sorted(a.attrs) == sorted(b.attrs), name
            for k in a.attrs:
                x, y = _attr(fj, a.attrs[k]), _attr(fp, b.attrs[k])
                assert np.array_equal(x, y), (name, k, x, y)
            if not isinstance(a, h5py.Dataset):
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, name
            va, vb = a[()], b[()]
            if a.dtype == object:
                assert all(np.array_equal(x, y) for x, y in zip(va, vb)), name
            elif name in occ_share:
                assert np.mean(va != vb) <= occ_share[name], (name, np.mean(va != vb))
            elif name in tol:
                assert np.array_equal(np.isnan(va), np.isnan(vb)), name
                assert np.nanmax(np.abs(va.astype(np.float64) - vb)) <= tol[name], name
            else:
                assert np.array_equal(va, vb, equal_nan=True), name


def test_info_matches_jax(tmp_path):
    _, _, out_j, out_p = run_both(tmp_path, ["info"])
    assert out_j == out_p
    assert "  Z: shape=(64, 32, 32) dtype=float32" in out_p and "  cam0images: shape=(64,) dtype=object" in out_p
    assert "ImageBytes" not in out_p and "  meta.fps = 4.0" in out_p


def test_spectrum_matches_jax(tmp_path):
    jp, pp, out_j, out_p = run_both(tmp_path, ["spectrum", "--nperseg", "32", "--rangespan", "3"])
    assert out_j == out_p and out_p.splitlines()[-1] == "plot saved to NC.spectrum.png"
    sj, sp = (np.loadtxt(p.with_suffix(".spectrum.csv"), delimiter=";") for p in (jp, pp))
    np.testing.assert_array_equal(sj[:, 0], sp[:, 0])
    assert np.abs(sj[:, 1] - sp[:, 1]).max() <= 1e-5 * sj[:, 1].max()


def test_zeromean_matches_jax(tmp_path):
    jp, pp, out_j, out_p = run_both(tmp_path, ["zeromean"])
    assert out_p == CONVERTED.format("NC.nc") + out_j
    compare(jp, pp)


@pytest.mark.parametrize("args", [["filter"], ["filter", "--highpass", "--cutoff", "0.3", "--overwrite"]])
def test_filter_matches_jax(tmp_path, args):
    jp, pp, out_j, out_p = run_both(tmp_path, args)
    assert out_p == CONVERTED.format("NC.nc") + out_j
    compare(jp, pp)


def test_visibilitymap_matches_jax(tmp_path):
    jp, pp, out_j, out_p = run_both(tmp_path, ["visibilitymap", "--numframes", "16"])
    assert out_p.startswith(CONVERTED.format("NC.nc")) and out_p.splitlines()[-1].split("(")[0] == \
        out_j.splitlines()[-1].split("(")[0]
    compare(jp, pp, tol={"incident_angles_cam0": 1e-4}, occ_share={"occlusion_cam0": 1e-3})
