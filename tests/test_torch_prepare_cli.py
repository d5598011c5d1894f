"""The port's prepare and genconfig commands against the JAX package's
click CLI, and the whole chain prepare -> genconfig -> stereo of both, on
raw 256x192 frames seen through a known lens distortion (CPU).

Both stereo runs draw the same RANSAC pixel picks and the JAX float stages
run op by op, as in test_torch_pipeline.py."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from wass_tpu.cli.main import cli as jax_cli
from wass_tpu.io.workdir import Workdir as JWorkdir
from wass_tpu.io.xyzc import load_camera_mesh
from wass_tpu.stereo import dense as jd
from wass_tpu.testing import make_rig, make_scene
from wass_tpu_torch.cli.main import main as torch_main
from wass_tpu_torch.io.workdir import Workdir as TWorkdir
from wass_tpu_torch.stereo import plane as tplane
from wass_tpu_torch.testing import distort_image, write_raw_sequence
from torch_registries import reset_registries  # noqa: F401  (autouse)

N_FRAMES = 2
DIST0 = [-0.04, 0.01, 4e-4, -2e-4, 0.0]
DIST1 = [0.03, -0.005, 0.0, 0.0, 0.0]
XML = ("intrinsics_00000000.xml", "intrinsics_00000001.xml", "ext_R.xml", "ext_T.xml")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Raw frames of two scenes (one rig), distorted, and their calib dir;
    and the same frames undistorted (no distortion files)."""
    root = tmp_path_factory.mktemp("raw")
    rig = make_rig(width=256, height=192)
    scenes = [make_scene(seed=50 + i, width=256, height=192, wave_amplitude=0.25, rig=rig, time=i * 0.2)
              for i in range(N_FRAMES)]
    out = {}
    for name, d0, d1 in (("distorted", DIST0, DIST1), ("identity", None, None)):
        raw = [(sc.img0, sc.img1) if d0 is None
               else (distort_image(sc.img0, rig.K0, d0), distort_image(sc.img1, rig.K1, d1)) for sc in scenes]
        cam0, cam1, calib = write_raw_sequence(root / name, *raw[0], rig, 1, d0, d1)
        # frame i of the sequence is scene i
        (cam0 / "000000.png").rename(cam0 / "a.png")
        (cam1 / "000000.png").rename(cam1 / "a.png")
        c0b, c1b, _ = write_raw_sequence(root / f"{name}_b", *raw[1], rig, 1, d0, d1)
        shutil.copy(c0b / "000000.png", cam0 / "b.png")
        shutil.copy(c1b / "000000.png", cam1 / "b.png")
        out[name] = (cam0, cam1, calib)
    return out


def _prepare_both(raw_dirs, tmp_path):
    cam0, cam1, calib = (str(d) for d in raw_dirs)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    r = CliRunner().invoke(jax_cli, ["prepare", cam0, cam1, calib, str(jout)])
    assert r.exit_code == 0, r.output
    assert torch_main(["prepare", cam0, cam1, calib, str(tout), "--device", "cpu"]) == 0
    return jout, tout


@pytest.mark.parametrize("case", ["distorted", "identity"])
def test_prepare_cli_matches_jax(raw, tmp_path, case, capsys):
    """Workdirs as in test_torch_prepare.py: XML files byte-identical, the
    identity case's images identical, the distorted case's PNG pixels
    within 1 gray level on at most 0.1% of the pixels; progress lines in
    order."""
    jout, tout = _prepare_both(raw[case], tmp_path)
    assert [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[P|")] == ["[P|1|2]", "[P|2|2]"]
    for i in range(N_FRAMES):
        wj, wt = jout / f"{i:06d}_wd", tout / f"{i:06d}_wd"
        for name in XML:
            assert (wt / name).read_bytes() == (wj / name).read_bytes(), name
        for cam in (0, 1):
            pj, pt = JWorkdir(wj).load_undistorted(cam), TWorkdir(wt).load_undistorted(cam)
            diff = np.abs(pt.astype(np.int16) - pj.astype(np.int16))
            if case == "identity":
                assert diff.max() == 0
            else:
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def _convert(frame: np.ndarray, fmt: str, path_stem):
    """A raw gray frame written in another format; returns the path."""
    import cv2
    import imageio.v3 as iio

    rgb = np.stack([frame, 255 - frame, np.roll(frame, 9, axis=1)], axis=-1)  # unequal channels
    if fmt == "colour.png":
        cv2.imwrite(f"{path_stem}.png", rgb[..., ::-1])
    elif fmt == "colour.jpg":
        iio.imwrite(f"{path_stem}.jpg", rgb, quality=95)
    elif fmt == "gray16.png":
        cv2.imwrite(f"{path_stem}.png", frame.astype(np.uint16) * 257)
    elif fmt == "float32.tiff":
        iio.imwrite(f"{path_stem}.tiff", frame.astype(np.float32) + 0.25)
    elif fmt == "uint16.tiff":
        iio.imwrite(f"{path_stem}.tiff", frame.astype(np.uint16) * 257)
    return next(path_stem.parent.glob(f"{path_stem.name}.*"))


@pytest.mark.parametrize("fmt", ["colour.png", "colour.jpg", "gray16.png", "float32.tiff", "uint16.tiff"])
def test_prepare_cli_matches_jax_other_formats(raw, tmp_path, fmt):
    """Raw frames that are not 8-bit grayscale PNG (refused by the port
    before): colour PNG (libpng's grey weights), colour JPEG (the channel
    mean), 16-bit PNG (the high byte), float32 and 16-bit TIFF.  Without a
    lens the workdirs' images must equal the JAX command's exactly; a
    16-bit TIFF saturates at 255 in both packages (prepare clips)."""
    from wass_tpu_torch.io.png import read_gray

    cam0, cam1, calib = raw["identity"]
    dirs = []
    for cam in (cam0, cam1):
        d = tmp_path / f"{fmt}_{cam.name}"
        d.mkdir()
        for src in sorted(cam.glob("*.png")):
            _convert(read_gray(src), fmt, d / src.stem)
        dirs.append(d)
    jout, tout = _prepare_both((*dirs, calib), tmp_path)
    for i in range(N_FRAMES):
        wj, wt = jout / f"{i:06d}_wd", tout / f"{i:06d}_wd"
        for cam in (0, 1):
            pj, pt = JWorkdir(wj).load_undistorted(cam), TWorkdir(wt).load_undistorted(cam)
            np.testing.assert_array_equal(pt, pj)
            if fmt == "uint16.tiff":
                assert (pt == 255).mean() > 0.9
        for name in XML:
            assert (wt / name).read_bytes() == (wj / name).read_bytes(), name


def test_prepare_rejects_other_formats_and_counts(raw, tmp_path):
    """A frame that does not decode is refused, naming the file; so are
    camera folders of different frame counts."""
    cam0, cam1, calib = raw["identity"]
    bad0 = tmp_path / "bad0"
    shutil.copytree(cam0, bad0)
    (bad0 / "c.png").write_bytes(b"GIF89a not a png")
    bad1 = tmp_path / "bad1"
    shutil.copytree(cam1, bad1)
    with pytest.raises(SystemExit, match="different frame counts"):
        torch_main(["prepare", str(bad0), str(cam1), str(calib), str(tmp_path / "o1"), "--device", "cpu"])
    (bad1 / "c.png").write_bytes((bad1 / "a.png").read_bytes())
    with pytest.raises(SystemExit, match="cannot read the raw frame .*c.png"):
        torch_main(["prepare", str(bad0), str(bad1), str(calib), str(tmp_path / "o2"), "--device", "cpu"])


@pytest.mark.parametrize("stage", ["prepare", "stereo"])
def test_genconfig_matches_jax(tmp_path, stage):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert CliRunner().invoke(jax_cli, ["genconfig", str(tmp_path / "j"), "--stage", stage]).exit_code == 0
    assert torch_main(["genconfig", str(tmp_path / "t"), "--stage", stage]) == 0
    name = f"{stage}_config.txt"
    assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


def _jax_picks(rounds, H, W, seed):
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.asarray(jax.random.randint(k1, (rounds, 3, 2), 0, jnp.array([W, H]))))


def test_prepare_stereo_chain_matches_jax(raw, tmp_path, monkeypatch):
    """prepare -> genconfig -> stereo, each package on its own: planes within
    1e-3 of the JAX chain's, mesh point counts within 0.1%."""
    from wass_tpu.cli.main import _load_pipeline

    jout, tout = _prepare_both(raw["distorted"], tmp_path)
    for out, run in ((jout, lambda a: CliRunner().invoke(jax_cli, a).exit_code), (tout, torch_main)):
        assert run(["genconfig", str(out), "--stage", "stereo"]) == 0
        cfg = out / "stereo_config.txt"
        cfg.write_text(cfg.read_text().replace("MAX_DISPARITY=640", "MAX_DISPARITY=96"))

    pipe = _load_pipeline(jout)
    pipe.cfg.debug_renders = False
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])  # the one-device loop
    monkeypatch.setattr(jd, "_jit_triangulate", jd._jit_triangulate.__wrapped__)
    monkeypatch.setattr(jd, "_stage_plane", jd._stage_plane.__wrapped__)
    pipe.stereo()
    monkeypatch.setattr(tplane, "draw_pixels", _jax_picks)
    assert torch_main(["stereo", str(tout), "--device", "cpu"]) == 0

    pj = np.loadtxt(jout / "output" / "planes.txt", ndmin=2)
    pt = np.loadtxt(tout / "output" / "planes.txt", ndmin=2)
    assert pj.shape == pt.shape == (N_FRAMES, 4)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-3)
    for i in range(N_FRAMES):
        mj = load_camera_mesh(jout / f"{i:06d}_wd" / "mesh_cam.xyzC")
        mt = load_camera_mesh(tout / f"{i:06d}_wd" / "mesh_cam.xyzC")
        assert mj.shape[1] > 10000
        assert abs(mt.shape[1] - mj.shape[1]) <= 0.001 * mj.shape[1]


def test_prepare_needs_cuda(raw, tmp_path):
    """No fallback: prepare on the card without one raises, before any frame."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cam0, cam1, calib = (str(d) for d in raw["identity"])
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["prepare", cam0, cam1, calib, str(tmp_path / "out")])
    assert not (tmp_path / "out" / "000000_wd").exists()
