"""The port's debug renders (wass_tpu_torch/utils/render.py) against the JAX
package's (wass_tpu/utils/render.py), the renders of the port's stereo
loop, and the CLI rest: `measure` and stereo/meshops.py against the JAX
package's command and functions.

Tolerance: every render image is bit-equal to the JAX function's uint8
image (captured by monkeypatching wass_tpu.utils.render._save, which
clips and casts as the JAX package writes), and so are the quantized
disparity (dense.py:_jit_disp_u16 / 16) and the uint8 images
(dense.py:_jit_u8) the JAX loop renders from.  Written JPEGs are checked
by their decoded colours only (lossy).  measure prints the JAX command's
lines, digit for digit (float32 distance); laplacian_smooth and crop_grid
are bit-equal to the JAX functions run eagerly."""

import io

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wass_tpu.utils.render as jr
from click.testing import CliRunner
from wass_tpu.cli.main import cli as jax_cli
from wass_tpu.stereo import dense as jd
from wass_tpu.stereo import meshops as jm

from wass_tpu_torch.cli.main import main as torch_main
from wass_tpu_torch.cli.pipeline import SequencePipeline
from wass_tpu_torch.stereo import dense as td
from wass_tpu_torch.stereo import meshops as tm
from wass_tpu_torch.testing import make_scene, write_sequence
from wass_tpu_torch.utils import render

from torch_registries import reset_registries  # noqa: F401  (autouse)

H, W = 45, 67
RENDER_NAMES = ("disparity_coverage.jpg", "disparity_final_scaled.jpg", "graph_components.jpg", "stereo.jpg",
                "stereo_input.jpg", "triangulation_failmap.jpg")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_image(monkeypatch):
    """Runs a JAX render function and returns the uint8 image it saves."""
    saved = []
    monkeypatch.setattr(jr, "_save", lambda path, img: saved.append(np.clip(img, 0, 255).astype(np.uint8)))

    def run(fn, *args, **kw):
        fn("unused.jpg", *args, **kw)
        return saved.pop()

    return run


def _same(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _disparity(rng, case):
    d = rng.uniform(-5, 90, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < 0.3] = 0
    if case == "zeros":
        d[:] = 0
    elif case == "single":
        d[:] = 0
        d[H // 2, W // 3] = 17.3
    elif case == "clipped":
        d[:5] = 5000.0  # past the uint16 range at 1/16 px
    return d


@pytest.mark.parametrize("case", ["random", "zeros", "single", "clipped"])
def test_disparity_render_matches_jax(rng, jax_image, case):
    d = _disparity(rng, case)
    want_q = np.asarray(jd._jit_disp_u16(jnp.asarray(d))) / 16.0
    got_q = render.disparity_u16(torch.from_numpy(d))
    assert got_q.dtype == torch.float64
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    _same(render.render_disparity(got_q), jax_image(jr.render_disparity, want_q))


def test_u8_matches_jax(rng):
    img = rng.uniform(-40, 300, (H, W)).astype(np.float32)
    img[3, 4] = np.nan
    _same(render.to_u8(torch.from_numpy(img)), np.asarray(jd._jit_u8(jnp.asarray(img))))


@pytest.mark.parametrize("vertical", [False, True])
@pytest.mark.parametrize("height", [H, 13])  # 13 rows: a scanline every row
def test_stereo_render_matches_jax(rng, jax_image, vertical, height):
    L = rng.integers(0, 256, (height, W), dtype=np.uint8)
    R = rng.integers(0, 256, (height, W), dtype=np.uint8)
    _same(render.render_stereo(torch.from_numpy(L), torch.from_numpy(R), vertical=vertical),
          jax_image(jr.render_stereo, L, R, vertical=vertical))


@pytest.mark.parametrize("roi", [None, (5, 4, 40, 30), (0, 0, W, H), (W - 6, H - 4, 20, 20), (-3, 2, 10, 10)],
                         ids=["none", "inside", "whole", "border", "negative"])
def test_coverage_render_matches_jax(rng, jax_image, roi):
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    d = render.disparity_u16(torch.from_numpy(_disparity(rng, "random")))
    _same(render.render_coverage(torch.from_numpy(img), d, roi=roi),
          jax_image(jr.render_coverage, img, d.numpy(), roi=roi))


def test_coverage_render_refuses_an_roi_off_the_image(rng):
    """An ROI column past the image raises IndexError, as numpy does (a CUDA
    gather would not)."""
    img = torch.zeros((H, W), dtype=torch.uint8)
    with pytest.raises(IndexError):
        render.render_coverage(img, torch.zeros((H, W), dtype=torch.float64), roi=(W + 2, 0, 5, 5))


@pytest.mark.parametrize("base", [None, "u8", "float"])
def test_failure_map_matches_jax(rng, jax_image, base):
    reasons = rng.integers(0, 8, (H, W)).astype(np.uint8)  # every FAIL_* code
    assert set(np.unique(reasons)) == set(range(8))
    gray = {None: None, "u8": rng.integers(0, 256, (H, W), dtype=np.uint8),
            "float": rng.uniform(-20, 280, (H, W)).astype(np.float32)}[base]
    got = render.render_failure_map(torch.from_numpy(reasons), None if gray is None else torch.from_numpy(gray))
    _same(got, jax_image(jr.render_failure_map, reasons, gray))
    assert render.FAIL_COLORS[td.FAIL_TOO_DISTANT] == (255, 0, 0)
    assert (td.FAIL_OK, td.FAIL_TOO_DISTANT) == (jd.FAIL_OK, jd.FAIL_TOO_DISTANT)


def test_failure_map_jpeg_is_red_where_too_distant(tmp_path):
    """The written JPEG, decoded in RGB order: red where FAIL_TOO_DISTANT,
    blue where FAIL_TOO_CLOSE (an RGB/BGR swap would show blue and red)."""
    reasons = np.full((64, 96), td.FAIL_OK, np.uint8)
    reasons[8:32, 8:40] = td.FAIL_TOO_DISTANT
    reasons[32:56, 48:88] = td.FAIL_TOO_CLOSE
    render.save(tmp_path / "f.jpg", render.render_failure_map(torch.from_numpy(reasons)))
    img = iio.imread(tmp_path / "f.jpg").astype(int)
    red, blue = img[12:28, 12:36].reshape(-1, 3), img[36:52, 52:84].reshape(-1, 3)
    assert (red[:, 0] > 200).all() and (red[:, 1:] < 60).all()
    assert (blue[:, 2] > 200).all() and (blue[:, :2] < 60).all()


def test_components_render_matches_jax(rng):
    valid = rng.random((H, W)) < 0.6
    want = np.clip(valid.astype(np.uint8) * 255, 0, 255).astype(np.uint8)  # the JAX loop's _save argument
    _same(render.render_components(torch.from_numpy(valid)), want)


def test_matches_render_matches_jax(rng, jax_image):
    img0 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    img1 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    uv0 = rng.uniform(-10, W + 10, (40, 2)) * [1, H / W]
    uv1 = rng.uniform(-10, W + 10, (40, 2)) * [1, H / W]  # some leave the image
    uv0[0], uv1[0] = (-30.0, -30.0), (W + 90.0, H + 50.0)
    _same(render.render_matches(img0, img1, uv0, uv1), jax_image(jr.render_matches, img0, img1, uv0, uv1))


@pytest.fixture(scope="module")
def small_sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("renders")
    sc = make_scene(seed=5, width=128, height=96, wave_amplitude=0.25)
    write_sequence(root, sc.img0, sc.img1, sc.rig, 1)
    (root / "stereo_config.txt").write_text("MAX_DISPARITY=48\n")
    return root


def test_stereo_loop_writes_renders(small_sequence):
    """The loop's six renders (the JAX loop's file names), decodable at the
    frame's shape; off with debug_renders=False."""
    assert torch_main(["stereo", str(small_sequence), "--device", "cpu"]) == 0
    wd = small_sequence / "000000_wd"
    assert sorted(p.name for p in wd.glob("*.jpg")) == sorted(RENDER_NAMES)
    assert iio.imread(wd / "stereo_input.jpg").shape == (192, 128, 3)
    assert iio.imread(wd / "disparity_final_scaled.jpg").shape == (96, 128)
    assert "debug renders failed" not in (wd / "wass_stereo_log.txt").read_text()
    for p in wd.glob("*.jpg"):
        p.unlink()
    pipe = SequencePipeline(small_sequence)
    pipe.cfg.device, pipe.cfg.debug_renders = "cpu", False
    pipe.cfg.stereo = td.DenseStereoConfig(num_disp=48)
    pipe.stereo(progress_stream=io.StringIO())
    assert not list(wd.glob("*.jpg")) and pipe.loop_stats["render_s"] == []


def test_render_error_is_logged_not_raised(small_sequence, monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("no image")

    monkeypatch.setattr(render, "render_stereo", broken)
    assert torch_main(["stereo", str(small_sequence), "--device", "cpu"]) == 0
    wd = small_sequence / "000000_wd"
    assert "[INFO] debug renders failed: no image" in (wd / "wass_stereo_log.txt").read_text()
    assert (wd / "mesh_cam.xyzC").stat().st_size > 0


@pytest.mark.parametrize("args", [["40", "30", "90", "60"], ["64.5", "47.25", "10", "80", "--baseline", "2.5"],
                                  ["5", "5", "120", "90", "--radius", "40"]])
def test_measure_matches_jax(small_sequence, capsys, args):
    wd = small_sequence / "000000_wd"
    if not (wd / "mesh_cam.xyzC").exists():
        assert torch_main(["stereo", str(small_sequence), "--device", "cpu"]) == 0
    r = CliRunner().invoke(jax_cli, ["measure", str(wd), *args])
    assert r.exit_code == 0, r.output
    capsys.readouterr()
    assert torch_main(["measure", str(wd), *args]) == 0
    out = capsys.readouterr().out
    assert out == r.output and "distance:" in out


def test_measure_refusals(small_sequence, capsys):
    wd = str(small_sequence / "000000_wd")
    if not (small_sequence / "000000_wd" / "mesh_cam.xyzC").exists():
        assert torch_main(["stereo", str(small_sequence), "--device", "cpu"]) == 0
    with pytest.raises(SystemExit, match="no reconstructed point within 0.5 px"):
        torch_main(["measure", wd, "-500", "-500", "40", "30", "--radius", "0.5"])
    for argv in (["measure", wd, "--interactive"], ["measure", wd, "1", "2", "3"]):
        with pytest.raises(SystemExit):
            torch_main(argv)
    err = capsys.readouterr().err
    assert "matplotlib" in err and "expected 4 coordinates" in err


@pytest.mark.parametrize("steps", [1, 3])
def test_laplacian_smooth_matches_jax(rng, steps):
    pts = rng.normal(0, 1, (H, W, 3)).astype(np.float32)
    valid = rng.random((H, W)) < 0.7
    want = np.asarray(jm.laplacian_smooth(jnp.asarray(pts), jnp.asarray(valid), steps))
    got = tm.laplacian_smooth(torch.from_numpy(pts), torch.from_numpy(valid), steps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [(3, 4, 30, 50), (0, 0, H, W), (-2, 10, 5, W + 9), (20, 20, 10, 10)])
def test_crop_grid_matches_jax(rng, window):
    valid = rng.random((H, W)) < 0.7
    want = np.asarray(jm.crop_grid(jnp.asarray(valid), *window))
    np.testing.assert_array_equal(tm.crop_grid(torch.from_numpy(valid), *window).numpy(), want)


def test_measure_distance_matches_jax(rng):
    for _ in range(20):
        p1, p2 = rng.normal(0, 30, 3), rng.normal(0, 30, 3)
        want = np.asarray(jm.measure_distance(p1, p2))
        got = tm.measure_distance(p1, p2)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert got.item() == want.item()
