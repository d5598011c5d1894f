"""The port's copies of the JAX package's host modules (config.py,
io/{matrices,xyzc,workdir}.py, testing/synthetic.py) against their
originals: scenes bit-equal, workdir files byte-identical and readable
both ways, the stereo option registry equal."""

import dataclasses

import numpy as np
import pytest

from wass_tpu import config as jconfig
from wass_tpu.cli import options as joptions
from wass_tpu.io import xyzc as jxyzc
from wass_tpu.io.workdir import Workdir as JWorkdir
from wass_tpu.io.workdir import frame_workdirs as jframe_workdirs
from wass_tpu.testing import synthetic as jsyn
from wass_tpu_torch import config as tconfig
from wass_tpu_torch.cli import options as toptions
from wass_tpu_torch.io import xyzc as txyzc
from wass_tpu_torch.io.workdir import Workdir as TWorkdir
from wass_tpu_torch.io.workdir import frame_workdirs as tframe_workdirs
from wass_tpu_torch.testing import synthetic as tsyn
from torch_registries import reset_registries  # noqa: F401  (autouse)

SCENE_FIELDS = ("img0", "img1", "depth0", "points0")
RIG_FIELDS = ("K0", "K1", "R0", "T0", "R1", "T1", "R", "T")


@pytest.mark.parametrize("seed", [3, 11])
def test_make_scene_bit_equal(seed):
    kw = dict(seed=seed, width=48, height=32, wave_amplitude=0.2)
    a, b = jsyn.make_scene(**kw), tsyn.make_scene(**kw)
    for name in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    for name in RIG_FIELDS:
        np.testing.assert_array_equal(getattr(b.rig, name), getattr(a.rig, name), err_msg=name)
    for f in dataclasses.fields(a.waves):
        np.testing.assert_array_equal(getattr(b.waves, f.name), getattr(a.waves, f.name))
    assert b.texture_scale == a.texture_scale
    pts = a.points0.reshape(-1, 3)[::5] * 1.002
    plane = a.rig.plane_cam0()
    np.testing.assert_array_equal(b.elevation_error(pts, plane), a.elevation_error(pts, plane))


def test_render_pair_matches_make_scene():
    """The torch tracer (phase M of chip_smoke.py renders its pooled scenes
    with it on the card) gives the JAX package's make_scene images: on the
    CPU to within float64 rounding of the float32 images."""
    rig = jsyn.make_rig(width=64, height=48)
    ref = jsyn.make_scene(seed=12, rig=rig, wave_amplitude=0.25)
    img0, img1 = tsyn.render_pair(12, tsyn.make_rig(width=64, height=48), "cpu", wave_amplitude=0.25)
    np.testing.assert_allclose(img0, ref.img0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(img1, ref.img1, rtol=0, atol=1e-4)


def _frame_arrays(rng):
    rig = jsyn.make_rig(width=40, height=24)
    pts = rng.normal(size=(500, 3)) * [3.0, 2.0, 0.2] + [0, 0, 30]
    Rinv = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    Tinv = rng.normal(size=3)
    plane = np.array([0.01, -0.99, 0.1, 2.5]) / np.linalg.norm([0.01, -0.99, 0.1])
    return rig, pts, Rinv, Tinv, plane


def _write(Workdir, path, rig, pts, Rinv, Tinv, plane):
    wd = Workdir(path).create()
    wd.save_intrinsics(0, rig.K0)
    wd.save_intrinsics(1, rig.K1)
    wd.save_extrinsics(rig.R, rig.T)
    wd.save_plane(plane)
    wd.save_mesh(pts, Rinv, Tinv)
    wd.save_projection_matrices(np.hstack([rig.K0, np.zeros((3, 1))]), np.hstack([rig.K1, rig.T.reshape(3, 1)]))
    return wd


WORKDIR_FILES = ("intrinsics_00000000.xml", "intrinsics_00000001.xml", "ext_R.xml", "ext_T.xml", "plane.txt",
                 "mesh_cam.xyzC", "P0cam.txt", "P1cam.txt")


def test_workdir_files_byte_identical(rng, tmp_path):
    arrays = _frame_arrays(rng)
    j = _write(JWorkdir, tmp_path / "jax" / "000000_wd", *arrays)
    t = _write(TWorkdir, tmp_path / "port" / "000000_wd", *arrays)
    for name in WORKDIR_FILES:
        assert (t.path / name).read_bytes() == (j.path / name).read_bytes(), name
    j.save_plane(None)
    t.save_plane(None)
    assert (t.path / "plane.txt").read_bytes() == (j.path / "plane.txt").read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_workdir_read_by_the_other(rng, tmp_path, writer):
    """A workdir written by one package reads back through the other as
    through the writer itself: intrinsics, extrinsics, plane, mesh."""
    rig, pts, Rinv, Tinv, plane = _frame_arrays(rng)
    W, R = (TWorkdir, JWorkdir) if writer == "port" else (JWorkdir, TWorkdir)
    _write(W, tmp_path / "000000_wd", rig, pts, Rinv, Tinv, plane)
    w, r = W(tmp_path / "000000_wd"), R(tmp_path / "000000_wd")
    for cam in (0, 1):
        np.testing.assert_array_equal(r.load_intrinsics(cam), w.load_intrinsics(cam))
    for a, b in zip(r.load_extrinsics(), w.load_extrinsics()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r.load_plane(), w.load_plane())
    np.testing.assert_array_equal(r.load_mesh_cam(), w.load_mesh_cam())
    for a, b in zip(r.load_projection_matrices(), w.load_projection_matrices()):
        np.testing.assert_array_equal(a, b)
    frames = tframe_workdirs(tmp_path) if writer == "jax" else jframe_workdirs(tmp_path)
    assert [f.path for f in frames] == [tmp_path / "000000_wd"]


def test_xyz_quantized_byte_identical(rng, tmp_path):
    quant = rng.integers(0, 65536, size=(3, 200), dtype=np.uint16)
    scales, mins = rng.uniform(1e3, 5e4, size=3), rng.normal(size=3)
    Rinv, Tinv = np.linalg.qr(rng.normal(size=(3, 3)))[0], rng.normal(size=3)
    jxyzc.save_xyz_quantized(tmp_path / "j.xyzC", quant, scales, mins, Rinv, Tinv)
    txyzc.save_xyz_quantized(tmp_path / "t.xyzC", quant, scales, mins, Rinv, Tinv)
    assert (tmp_path / "t.xyzC").read_bytes() == (tmp_path / "j.xyzC").read_bytes()
    np.testing.assert_array_equal(txyzc.load_camera_mesh(tmp_path / "j.xyzC"),
                                  jxyzc.load_camera_mesh(tmp_path / "t.xyzC"))


def _options(reg):
    return [(o.name, o.type, o.default, o.description) for o in reg._options.values()]


def test_stereo_registry_equal():
    """After each package's register_all, the stereo registries hold the
    same options (names, types, defaults, descriptions) in the same order,
    and both write the same genconfig text."""
    joptions.register_all()
    toptions.register_all()
    assert tconfig.stereo_cfg is not jconfig.stereo_cfg
    assert _options(tconfig.stereo_cfg) == _options(jconfig.stereo_cfg)
    jconfig.stereo_cfg.reset()
    tconfig.stereo_cfg.reset()
    assert tconfig.stereo_cfg.to_config_string() == jconfig.stereo_cfg.to_config_string()


@pytest.mark.parametrize("text,error", [
    ("MAX_DISPARITY=96\n# comment\nSAVE_AS_PLY=yes\nUNKNOWN_KEY=3\n", None),
    ("MAX_DISPARITY=ninety\n", ValueError),
    ("MAX_DISPARITY\n", ValueError),
])
def test_registry_loads_like_the_original(text, error):
    """A config text sets both registries alike, or both refuse it."""
    joptions.register_all()
    toptions.register_all()
    results = []
    for reg in (jconfig.stereo_cfg, tconfig.stereo_cfg):
        reg.reset()
        if error is None:
            reg.load_string(text)
            results.append(reg.as_dict())
        else:
            with pytest.raises(error):
                reg.load_string(text)
        reg.reset()
    if error is None:
        assert results[0] == results[1]
        assert results[1]["MAX_DISPARITY"] == 96 and results[1]["SAVE_AS_PLY"] is True
