"""The port's wass-tpu-torch-gridsurface (--device cpu) against the JAX
package's click command on the same frame workdirs: config.mat, and every
variable of the two gridded.nc cubes, with the port drawing the JAX
package's subsamples and initial DCT coefficients.

Tolerances (Z in mm): DCT 0.1% of Z's range (the Rprop fit, as in
tests/test_torch_grid.py), IDW 1e-3 mm (1e-6 m), LinearND 1e-4 mm (host
scipy on points that agree to 1e-14 m, then a float32 cast); the rest is
exact.  cam0images hold PNG in the port and JPEG in the JAX package: the
decoded sizes must match, and the port's must decode to the undistorted
frame."""

import io

import h5py
import imageio.v3 as iio
import numpy as np
import pytest
from click.testing import CliRunner

from wass_tpu.cli.gridsurface import cli as jax_cli

from wass_tpu_torch.cli.gridsurface import main
from wass_tpu_torch.io import png

from torch_grid_data import AREA, BASELINE, use_jax_draws, write_grid_sequence

N = 32
SETUP = ["--action", "setup", "--baseline", str(BASELINE), "--area_center", AREA[0], "--area_size", AREA[1],
         "-N", str(N), "--fps", "4"]


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("gridcli")
    write_grid_sequence(root, n_frames=3)
    return root


def _both(seq, tmp_path, args, monkeypatch, setup=SETUP):
    """Run setup and then `args` through both consoles; returns the two
    output directories."""
    use_jax_draws(monkeypatch)
    jd, pd = tmp_path / "jax", tmp_path / "port"
    runner = CliRunner()
    for a in (setup, args):
        r = runner.invoke(jax_cli, [str(seq), str(jd), *a])
        assert r.exit_code == 0, r.output
        assert main([str(seq), str(pd), *a, "--device", "cpu"]) == 0
    return jd, pd


def test_setup_matches_jax(seq, tmp_path, monkeypatch, capsys):
    jd, pd = _both(seq, tmp_path, SETUP, monkeypatch)
    assert (jd / "config.mat").read_bytes()[128:] == (pd / "config.mat").read_bytes()[128:]
    out = capsys.readouterr().out
    assert "grid setup saved to" in out and "area plot skipped" in out


def _z_tol(args, Zj):
    if "IDW" in args:
        return 1e-3
    if "LinearND" in args:
        return 1e-4
    return 1e-3 * float(np.nanmax(Zj) - np.nanmin(Zj))


GRID_CASES = {
    "dct": [],
    "idw": ["--ia", "IDW"],
    "linearnd": ["--ia", "LinearND", "--subsample", "10"],
    "median3": ["-mf", "3"],
    "outliers": ["--filter-outliers"],
    "zeromean": ["--force-zero-mean"],
    "noimages": ["--no-images", "--ia", "IDW"],
    "mask": ["--ia", "IDW"],
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_matches_jax(seq, tmp_path, monkeypatch, case):
    args = ["--action", "grid", *GRID_CASES[case]]
    if case == "mask":
        mask = np.full((N, N), 255, np.uint8)
        mask[4:11, 6:25] = 0
        png.write_gray(tmp_path / "mask.png", mask)
        args += ["--mask", str(tmp_path / "mask.png")]
    jd, pd = _both(seq, tmp_path, args, monkeypatch)
    with h5py.File(jd / "gridded.nc", "r") as fj, h5py.File(pd / "gridded.nc", "r") as fp:
        assert sorted(fj) == sorted(fp)
        Zj, Zp = fj["Z"][...], fp["Z"][...]
        assert Zj.shape == Zp.shape == (3, N, N)
        assert np.array_equal(np.isnan(Zj), np.isnan(Zp))
        assert np.isfinite(Zp).mean() > 0.3
        tol = _z_tol(args, Zj)
        np.testing.assert_allclose(Zp, Zj, rtol=0, atol=tol, equal_nan=True)
        for name in ("count", "time", "workdir", "X", "Y", "X_grid", "Y_grid", "Kx", "Ky", "maskZ", "scale"):
            assert np.array_equal(fj[name][()], fp[name][()]), name
        if case == "mask":
            assert (fp["maskZ"][...] == 0).sum() == 7 * 19
        assert sorted(fj["meta"]) == sorted(fp["meta"])
        for name in fj["meta"]:
            assert np.array_equal(fj["meta"][name][()], fp["meta"][name][()]), name
        mj, mp = fj["meta"].attrs, fp["meta"].attrs
        assert sorted(mj) == sorted(mp)
        for k in mj:
            if k in ("zmin", "zmax"):
                assert abs(mj[k] - mp[k]) <= tol * 1e-3, k  # meters
            else:
                assert mj[k] == mp[k] and type(mj[k]) is type(mp[k]), k
        for t in range(3):
            a, b = fj["cam0images"][t], fp["cam0images"][t]
            assert fj["cam0masks"][t].size == fp["cam0masks"][t].size == 0
            if "--no-images" in args:
                assert a.size == b.size == 0
                continue
            frame = png.read_gray(seq / f"{t:06d}_wd" / "undistorted" / "00000000.png")
            assert np.array_equal(png.decode_gray(b.tobytes()), frame)
            assert iio.imread(io.BytesIO(a.tobytes())).shape == frame.shape
    gj, gp = iio.imread(jd / "grid_img.png"), png.read_gray(pd / "grid_img.png")
    assert gj.shape == gp.shape and np.abs(gj.astype(int) - gp).max() <= 1


def test_grid_draws_its_own_samples(seq, tmp_path):
    """Without the JAX draws the port's cube is its own (other samples,
    other DCT start): the same run twice gives the same bytes of Z."""
    out = tmp_path / "g"
    assert main([str(seq), str(out), *SETUP, "--device", "cpu"]) == 0
    zs = []
    for _ in range(2):
        assert main([str(seq), str(out), "--action", "grid", "--device", "cpu"]) == 0
        with h5py.File(out / "gridded.nc", "r") as f:
            zs.append(f["Z"][...].tobytes())
    assert zs[0] == zs[1]


def test_console_refusals(seq, tmp_path, capsys):
    out = tmp_path / "g"
    with pytest.raises(RuntimeError, match="CUDA"):  # the default device is the card
        main([str(seq), str(out), *SETUP])
    assert main([str(seq), str(out), "--action", "setup", "--device", "cpu"]) == 1
    assert main([str(seq), str(out), "--action", "grid", "--device", "cpu"]) == 1  # no config.mat yet
    assert main([str(seq), str(out), "--action", "grid", "--refine", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "--baseline is required" in err and "run --action setup first" in err and "ROADMAP.md" in err
    assert main([str(seq), str(out), *SETUP, "--device", "cpu"]) == 0
    png.write_gray(tmp_path / "m.png", np.zeros((N, N + 1), np.uint8))
    assert main([str(seq), str(out), "--action", "grid", "--mask", str(tmp_path / "m.png"), "--device", "cpu"]) == 1
    assert "--mask shape" in capsys.readouterr().err
