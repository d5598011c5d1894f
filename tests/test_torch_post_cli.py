"""The port's wass-tpu-torch-post (--device cpu) against the JAX package's
click console on copies of one cube that the port's NetCDFWriter made
(40 x 40, 96 frames at 4 Hz, NaN holes; tests/torch_post_data.py), with a
tiny WASS_POST_MEMORY_MB so that every streaming path runs.  h5py edits
the port's file in place, so the JAX console runs on a plain copy.  Both
results are read with h5py: the same variables, shapes, dtypes and
attributes, and values within each command's tolerance:

* exact: filter (the same scipy sosfiltfilt on the same column blocks),
  setfps, zeromean, clip, renamevar, and bgimage and radiance_threshold
  on the same radiance;
* spatial_lowpass: 1e-5 of Z's range (float32 FFTs of two libraries);
* spectrum and spectrum3d: S within 1e-5 of its maximum;
* visibilitymap: at most 0.1% of the cells' occlusion differ (the jitted
  JAX normalisations contract into FMAs; the port runs them op by op),
  incidence within 1e-4 degrees;
* radiance: 1e-6 (intensities in [0, 1]; float32 bilinear weights).

Each test that runs the JAX console has a time limit of its own."""

import contextlib
import io
import shutil
import signal

import cv2
import h5py
import numpy as np
import pytest
from click.testing import CliRunner

from wass_tpu.cli.post import cli as jax_cli

from wass_tpu_torch.cli.post import main

from torch_post_data import write_post_cube

N_FRAMES = 96
JAX_SECONDS = 120  # the limit of each test that runs the JAX console
EXACT = 0.0


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    return write_post_cube(tmp_path_factory.mktemp("postcube"), n_frames=N_FRAMES)


@pytest.fixture(autouse=True)
def tiny_budget(monkeypatch):
    monkeypatch.setenv("WASS_POST_MEMORY_MB", "0.05")  # ~50 KB: column blocks of 2 rows, slabs of 1-10 frames


@contextlib.contextmanager
def time_limit(seconds: int):
    def expire(*_):
        raise TimeoutError(f"over the test's {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_port(args) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([*args, "--device", "cpu"])
    return rc, out.getvalue(), err.getvalue()


def run_both(cube, tmp_path, args, prepare=()):
    """`prepare` (port commands) on a copy of the cube, then two copies of
    that: the JAX console runs `args` on one, the port's on the other.
    Returns (jax path, port path, jax output, port output)."""
    base = tmp_path / "base.nc"
    shutil.copy(cube, base)
    for p in prepare:
        assert run_port([p[0], str(base), *p[1:]])[0] == 0
    jp, pp = tmp_path / "jax.nc", tmp_path / "port.nc"
    shutil.copy(base, jp)
    shutil.copy(base, pp)
    with time_limit(JAX_SECONDS):
        r = CliRunner().invoke(jax_cli, [args[0], str(jp), *args[1:]])
    assert r.exit_code == 0, r.output
    rc, out, err = run_port([args[0], str(pp), *args[1:]])
    assert rc == 0, err
    return jp, pp, r.output.replace(str(jp.with_suffix("")), "NC"), out.replace(str(pp.with_suffix("")), "NC")


def _names(f) -> list:
    names = []
    f.visititems(lambda name, obj: names.append(name))
    return names


def _attr(f, v):
    if isinstance(v, np.ndarray) and v.dtype.names == ("dataset", "dimension"):
        return [(f[r].name, int(d)) for r, d in v]
    if isinstance(v, np.ndarray) and v.dtype == object:
        return [[f[r].name for r in refs] for refs in v]
    return v


def compare_cubes(jp, pp, tol=None, occ_share=None):
    """Every object of the two cubes: names, shapes, dtypes, attributes and
    values; tol maps a dataset to its absolute tolerance (default exact)."""
    tol = tol or {}
    with h5py.File(jp, "r") as fj, h5py.File(pp, "r") as fp:
        assert _names(fj) == _names(fp)
        for name in [""] + _names(fj):
            a, b = (fj[name], fp[name]) if name else (fj, fp)
            assert sorted(a.attrs) == sorted(b.attrs), name
            for k in a.attrs:
                x, y = _attr(fj, a.attrs[k]), _attr(fp, b.attrs[k])
                assert type(x) is type(y) and np.array_equal(x, y), (name, k, x, y)
            if not isinstance(a, h5py.Dataset):
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, name
            va, vb = a[()], b[()]
            if a.dtype == object:
                assert all(np.array_equal(x, y) for x, y in zip(va, vb)), name
            elif name in (occ_share or {}):
                assert np.mean(va != vb) <= occ_share[name], (name, np.mean(va != vb))
            elif tol.get(name, EXACT) == EXACT:
                assert np.array_equal(va, vb, equal_nan=True), (name, np.nanmax(np.abs(va - vb)))
            else:
                assert np.array_equal(np.isnan(va), np.isnan(vb)), name
                assert np.nanmax(np.abs(va.astype(np.float64) - vb)) <= tol[name], (name, np.nanmax(np.abs(va - vb)))


def test_info_matches_jax(cube, tmp_path):
    _, _, out_j, out_p = run_both(cube, tmp_path, ["info"])
    assert out_j == out_p
    assert "  Z: shape=(96, 40, 40) dtype=float32" in out_p and "  meta.fps = 4.0" in out_p


@pytest.mark.parametrize("args", [["filter"], ["filter", "--highpass", "--cutoff", "0.3", "--overwrite"],
                                  ["filter", "--cutoff", "0.5", "--filter-variable", "Z"]])
def test_filter_matches_jax(cube, tmp_path, args):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, args)
    assert out_j == out_p
    compare_cubes(jp, pp)
    with h5py.File(pp, "r") as f:
        name = "Z" if "--overwrite" in args else "Z_filtered"
        assert f[name].attrs["frequency_filter_cutoff"] == float(args[args.index("--cutoff") + 1] if "--cutoff" in args
                                                                 else 1.0)


def test_filter_refuses_a_short_cube(tmp_path):
    short = write_post_cube(tmp_path, n_frames=10)
    rc, _, err = run_port(["filter", str(short)])
    assert rc == 1 and "I need more than 10 frames" in err
    r = CliRunner().invoke(jax_cli, ["filter", str(short)])
    assert r.exit_code == 1 and "I need more than 10 frames" in r.output


def test_spatial_lowpass_matches_jax(cube, tmp_path):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, ["spatial-lowpass", "--cutoff-in-hz", "0.2"])
    assert out_j == out_p == "wrote Z_slp\n"
    with h5py.File(pp, "r") as f:
        zrange = float(np.nanmax(f["Z"][...]) - np.nanmin(f["Z"][...]))
    compare_cubes(jp, pp, {"Z_slp": 1e-5 * zrange})


def test_spectrum_matches_jax(cube, tmp_path):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, ["spectrum", "--nperseg", "32", "--rangespan", "3"])
    assert out_j.splitlines()[:4] == out_p.splitlines()[:4]
    assert out_p.splitlines()[-1].startswith("(plot skipped: the port has no plotting library")
    sj, sp = (np.loadtxt(p.with_suffix(".spectrum.csv"), delimiter=";") for p in (jp, pp))
    np.testing.assert_array_equal(sj[:, 0], sp[:, 0])
    assert np.abs(sj[:, 1] - sp[:, 1]).max() <= 1e-5 * sj[:, 1].max()
    compare_cubes(jp, pp)


def test_spectrum3d_matches_jax(cube, tmp_path):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, ["spectrum3d", "--segments", "4"])
    assert out_j == out_p
    with np.load(jp.with_suffix(".spectrum3d.npz")) as a, np.load(pp.with_suffix(".spectrum3d.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == ["KX", "KY", "S", "f"]
        for k in ("KX", "KY", "f"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["S"].shape == b["S"].shape and a["S"].dtype == b["S"].dtype == np.float64
        assert np.abs(a["S"] - b["S"]).max() <= 1e-5 * a["S"].max()


@pytest.mark.parametrize("args", [["setfps", "5"], ["zeromean"], ["clip", "--zmin", "-50", "--zmax", "60"],
                                  ["renamevar", "Z", "Zr"]])
def test_edits_match_jax(cube, tmp_path, args):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, args)
    assert out_j == out_p
    compare_cubes(jp, pp)
    if args[0] == "zeromean":
        with h5py.File(pp, "r") as f:
            assert np.nanmax(np.abs(np.nanmean(f["Z"][...].astype(np.float64), axis=0))) < 1e-3


def test_visibilitymap_matches_jax(cube, tmp_path):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, ["visibilitymap", "--numframes", "50", "--outputdir",
                                                     str(tmp_path / "occ")])
    compare_cubes(jp, pp, {"incident_angles_cam0": 1e-4}, occ_share={"occlusion_cam0": 1e-3})
    assert out_p.startswith("wrote occlusion_cam0 + incident_angles_cam0 over 50 frames (")
    pngs = sorted((tmp_path / "occ").glob("*.png"))
    assert len(pngs) == 50 and pngs[0].name == "00000000_occlusion_mask_cam0.png"


def test_radiance_matches_jax(cube, tmp_path):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, ["radiance"])
    assert out_j == out_p == f"wrote radiance_cam0 ({N_FRAMES} frames)\n"
    compare_cubes(jp, pp, {"radiance_cam0": 1e-6})


@pytest.mark.parametrize("args, prepare", [
    (["bgimage", "--filtersize", "9"], [["radiance"]]),
    (["radiance-threshold"], [["radiance"], ["bgimage", "--filtersize", "9"]]),
    (["radiance-threshold", "--use-vats", "--threshold-val", "0.2"], [["radiance"], ["bgimage"]]),
])
def test_radiance_family_matches_jax(cube, tmp_path, args, prepare):
    jp, pp, out_j, out_p = run_both(cube, tmp_path, args, prepare)
    assert out_j == out_p
    compare_cubes(jp, pp)


def test_stated_refusals(cube, tmp_path):
    """polarimetric_setup refuses (no Stokes TIFFs); radiance refuses a
    JPEG cam0images frame (the JAX package's cubes)."""
    rc, _, err = run_port(["polarimetric_setup", str(cube), "--wassdir", str(tmp_path), "--outputdir",
                           str(tmp_path / "p")])
    assert rc == 1 and "Stokes TIFFs" in err
    ok, jpg = cv2.imencode(".jpg", np.zeros((8, 8), np.uint8))
    c = tmp_path / "jpeg.nc"
    shutil.copy(cube, c)
    with h5py.File(c, "r+") as f:
        f["cam0images"][0] = np.frombuffer(jpg.tobytes(), np.uint8)
    rc, _, err = run_port(["radiance", str(c)])
    assert rc == 1 and "JPEG" in err
