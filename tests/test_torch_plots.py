"""The port's diagnostic plots, drawn with OpenCV (wass_tpu_torch/utils/
plotting.py, post/plotting.py, cli/gridsurface.py:area_figure,
grid/gridding.py:grid_figure), against matplotlib and the JAX consoles.

The pixels are not matplotlib's, so the checks are of the data each
figure shows: its viridis table within one level of matplotlib's in each
channel; the spectrum's red dashed line in the column of fp (within one
pixel's width in log f); area_grid.png's rectangle at xmin, xmax, ymin
and ymax (within a pixel) and each scatter pixel's colour decoding to the
z of the last point drawn there (within 1/255 of [zmin, zmax]);
gridded.png's cells decoding to Z the same way, NaN cells white.  Two
renders give the same bytes, and the consoles write the JAX file names
and print the JAX lines."""

import contextlib
import io
import shutil

import cv2
import matplotlib
import numpy as np
import pytest
from click.testing import CliRunner

from wass_tpu.cli.gridsurface import cli as jax_grid_cli
from wass_tpu.cli.post import cli as jax_post_cli

from wass_tpu_torch.cli.gridsurface import area_figure, main as grid_main
from wass_tpu_torch.cli.post import main as post_main
from wass_tpu_torch.grid.gridding import grid_figure
from wass_tpu_torch.grid.setup import GridSetup, align_on_sea_plane
from wass_tpu_torch.io.workdir import frame_workdirs
from wass_tpu_torch.io.xyzc import load_camera_mesh
from wass_tpu_torch.post.plotting import spectrum_figure
from wass_tpu_torch.utils import plotting as pl

from torch_grid_data import BASELINE, write_grid_sequence
from torch_post_data import write_post_cube

SETUP = ["--action", "setup", "--baseline", str(BASELINE), "--area_center=0,-16", "--area_size", "10", "-N", "32",
         "--fps", "4"]


def _read_rgb(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert img is not None, path
    return img[..., ::-1]


def _decode(rgb: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """z of viridis colours (the mean index of the table's equal entries,
    at the centre of its bin); NaN where the colour is not viridis'."""
    flat = rgb.reshape(-1, 3).astype(np.int32)
    match = np.all(flat[:, None, :] == pl.VIRIDIS[None].astype(np.int32), axis=-1)
    n = match.sum(1)
    idx = np.where(n > 0, (match * np.arange(256)).sum(1) / np.maximum(n, 1), np.nan)
    return (vmin + (idx + 0.5) / 256 * (vmax - vmin)).reshape(rgb.shape[:-1])


def _run_centres(line: np.ndarray, a: int, b: int) -> np.ndarray:
    """The centres of the runs of True in line[a:b], as indices of line."""
    idx = np.nonzero(line[a:b])[0] + a
    runs = np.split(idx, np.nonzero(np.diff(idx) > 1)[0] + 1)
    return np.array([(r[0] + r[-1]) / 2 for r in runs if len(r)])


def test_viridis_within_one_level_of_matplotlib():
    want = np.array(matplotlib.colormaps["viridis"](np.arange(256))[:, :3]) * 255
    assert pl.VIRIDIS.shape == (256, 3) and np.abs(pl.VIRIDIS - want).max() <= 1.0
    x = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(pl.colormap(x, 0.0, 1.0),
                                  pl.VIRIDIS[np.clip((x * 256).astype(int), 0, 255)])  # matplotlib's binning
    assert tuple(pl.colormap(np.array([np.nan]), 0.0, 1.0)[0]) == pl.WHITE


@pytest.fixture(scope="module")
def spectrum(tmp_path_factory):
    """The port's and the JAX console's spectrum on copies of one cube."""
    root = tmp_path_factory.mktemp("spec")
    cube = write_post_cube(root, n_frames=96)
    jp, pp = root / "jax.nc", root / "port.nc"
    shutil.copy(cube, jp)
    shutil.copy(cube, pp)
    args = ["spectrum", "--nperseg", "32", "--rangespan", "3"]
    r = CliRunner().invoke(jax_post_cli, [args[0], str(jp), *args[1:]])
    assert r.exit_code == 0, r.output
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert post_main([args[0], str(pp), *args[1:], "--device", "cpu"]) == 0
    return jp, pp, r.output, out.getvalue()


def test_spectrum_console_writes_the_jax_plot(spectrum):
    jp, pp, out_j, out_p = spectrum
    assert out_j.splitlines()[-1] == f"plot saved to {jp.with_suffix('.spectrum.png')}"
    assert out_p.splitlines()[-1] == f"plot saved to {pp.with_suffix('.spectrum.png')}"
    assert "plotting library" not in out_p
    assert _read_rgb(pp.with_suffix(".spectrum.png")).shape == (720, 1200, 3)  # 10 x 6 in at 120 dpi


def test_spectrum_fp_line_maps_to_fp(spectrum):
    _, pp, _, _ = spectrum
    fr, S = np.loadtxt(pp.with_suffix(".spectrum.csv"), delimiter=";").T
    ax = spectrum_figure(fr, S)
    img = _read_rgb(pp.with_suffix(".spectrum.png"))
    assert img.tobytes() == ax.fig.image.tobytes()  # the file is this render
    assert spectrum_figure(fr, S).fig.image.tobytes() == img.tobytes()  # and renders repeat
    cols = np.unique(np.nonzero(np.all(img == pl.RED, axis=-1))[1])
    assert len(cols) == 1
    m = (fr > 0) & (S > 0)
    fp = fr[m][np.argmax(S[m])]
    f_col = ax.data(cols[0] + 0.5, 0)[0]
    px_width = (np.log10(ax.xlim[1]) - np.log10(ax.xlim[0])) / (ax.box[2] - ax.box[0])
    assert abs(np.log10(f_col) - np.log10(fp)) <= px_width
    # The spectrum's points lie on black pixels.
    u, v = ax.px(fr[m], S[m])
    assert np.all(np.all(img[np.floor(v).astype(int), np.floor(u).astype(int)] < 80, axis=-1) |
                  np.all(img[np.floor(v).astype(int), np.floor(u).astype(int)] == pl.RED, axis=-1))


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """Both consoles' setup and grid (DCT) on one workdir."""
    root = tmp_path_factory.mktemp("gridplots")
    seq = root / "seq"
    write_grid_sequence(seq, n_frames=1)
    outs = {}
    for name in ("jax", "port"):
        d = root / name
        for a in (SETUP, ["--action", "grid"]):
            if name == "jax":
                r = CliRunner().invoke(jax_grid_cli, [str(seq), str(d), *a])
                assert r.exit_code == 0, r.output
                text = r.output
            else:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert grid_main([str(seq), str(d), *a, "--device", "cpu"]) == 0
                text = buf.getvalue()
            outs[name, a[1]] = text
    return seq, root / "jax", root / "port", outs


def test_grid_consoles_write_the_jax_plots(grid_run):
    _, jd, pd, outs = grid_run
    for name in ("area_grid.png", "gridded.png", "grid_img.png"):
        assert (jd / name).exists() and (pd / name).exists(), name
    assert _read_rgb(pd / "area_grid.png").shape == (1200, 1200, 3)  # 12 x 12 in at 100 dpi
    assert _read_rgb(pd / "gridded.png").shape == (800, 800, 3)  # 8 x 8 in at 100 dpi
    for action in ("setup", "grid"):
        assert outs["port", action] == outs["jax", action].replace(str(jd), str(pd))
        assert "skipped" not in outs["port", action]


def test_area_plot_maps_rectangle_and_points(grid_run):
    seq, _, pd, _ = grid_run
    setup = GridSetup.load_mat(pd / "config.mat")
    wd = seq / "000000_wd"
    meanplane = frame_workdirs(seq)[0].load_plane()  # one frame, no planes.txt: the console's mean plane
    ma = align_on_sea_plane(load_camera_mesh(wd / "mesh_cam.xyzC"), meanplane) * setup.baseline
    ax = area_figure(ma, setup, f"WASS point cloud {wd}")
    img = _read_rgb(pd / "area_grid.png")
    assert img.tobytes() == ax.fig.image.tobytes()
    assert area_figure(ma, setup, f"WASS point cloud {wd}").fig.image.tobytes() == img.tobytes()
    l, t, r, b = ax._clip()
    # The rectangle: black runs inside the frame along its middle row and column.
    black = np.all(img == pl.BLACK, axis=-1)
    px_x = (ax.xlim[1] - ax.xlim[0]) / (ax.box[2] - ax.box[0])
    px_y = abs(ax.ylim[1] - ax.ylim[0]) / (ax.box[3] - ax.box[1])
    row = int(np.floor(ax.px(0, (setup.ymin + setup.ymax) / 2)[1]))
    col = int(np.floor(ax.px((setup.xmin + setup.xmax) / 2, 0)[0]))
    xs = ax.data(_run_centres(black[row], l + 3, r - 3) + 0.5, 0)[0]
    ys = ax.data(0, _run_centres(black[:, col], t + 3, b - 3) + 0.5)[1]
    assert len(xs) == len(ys) == 2
    assert abs(xs[0] - setup.xmin) <= px_x and abs(xs[1] - setup.xmax) <= px_x
    assert abs(max(ys) - setup.ymax) <= px_y and abs(min(ys) - setup.ymin) <= px_y  # y inverted
    # Each scatter pixel shows the last point drawn over it.
    x, y, z = ma[:, ::50]
    ok = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    x, y, z = x[ok], y[ok], z[ok]
    u, v = (np.floor(c).astype(int) for c in ax.px(x, y))
    last = {}
    for i in range(len(x)):
        for du in (-1, 0):
            for dv in (-1, 0):
                last[v[i] + dv, u[i] + du] = i
    pix = np.array([p for p in last if t <= p[0] < b and l <= p[1] < r])
    dec = _decode(img[pix[:, 0], pix[:, 1]][:, None], setup.zmin, setup.zmax)[:, 0]
    shown = ~np.isnan(dec)
    assert shown.sum() > 0.8 * len(pix)  # the rest lie under the rectangle
    want = np.clip(z[[last[tuple(p)] for p in pix[shown]]], setup.zmin, setup.zmax)
    assert np.abs(dec[shown] - want).max() <= (setup.zmax - setup.zmin) / 255


def test_gridded_plot_maps_cells(grid_run):
    _, _, pd, _ = grid_run
    from wass_tpu_torch.io.png import read_gray

    assert read_gray(pd / "grid_img.png").shape == (32, 32)
    Z = np.random.default_rng(5).standard_normal((32, 40))
    Z[3:6, 7:9] = np.nan
    ax = grid_figure(Z)
    assert grid_figure(Z).fig.image.tobytes() == ax.fig.image.tobytes()
    img = ax.fig.image
    r, c = np.mgrid[:32, :40]
    u, v = (np.floor(p).astype(int) for p in ax.px(c.ravel(), r.ravel()))
    shown = img[v, u]
    nan = np.isnan(Z.ravel())
    assert np.all(shown[nan] == pl.WHITE)
    zmin, zmax = np.nanmin(Z), np.nanmax(Z)
    dec = _decode(shown[~nan][:, None], zmin, zmax)[:, 0]
    assert np.abs(dec - Z.ravel()[~nan]).max() <= (zmax - zmin) / 255
