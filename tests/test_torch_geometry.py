"""Port parity: geometry, triangulation, rectification, degradation, the
stereo options and the state conversion (wass_tpu_torch/core, prepare,
cli/options.py, convert.py) against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.cli import options as joptions
from wass_tpu.config import ConfigRegistry, registry
from wass_tpu.core import geometry as jgeom
from wass_tpu.core import rectify as jrect
from wass_tpu.core.triangulate import triangulate_normalized as j_tri
from wass_tpu.prepare import degradation as jdeg
from wass_tpu.stereo import dense as jdense
from wass_tpu.testing import make_rig
from wass_tpu_torch import convert
from wass_tpu_torch.cli import options as toptions
from wass_tpu_torch.core import geometry as tgeom
from wass_tpu_torch.core import rectify as trect
from wass_tpu_torch.core.triangulate import triangulate_normalized as t_tri
from wass_tpu_torch.prepare import degradation as tdeg
from wass_tpu_torch.stereo import dense as tdense


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_homogeneous_transform(rng):
    Hm = np.array([[1.1, 0.02, 3.0], [0.01, 0.95, -2.0], [1e-4, 2e-4, 1.0]], np.float32)
    pts = (rng.random((20, 30, 2)) * 100).astype(np.float32)
    ref = np.asarray(jgeom.homogeneous_transform(jnp.asarray(Hm), jnp.asarray(pts)))
    np.testing.assert_allclose(tgeom.homogeneous_transform(_t(Hm), _t(pts)).numpy(), ref, rtol=1e-6)


def test_rt_from_plane():
    plane = np.array([0.02, 0.9, 0.43, -4.1], np.float32)
    plane[:3] /= np.linalg.norm(plane[:3])
    for a, b in zip(jgeom.rt_from_plane(jnp.asarray(plane)), tgeom.rt_from_plane(_t(plane))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_solve3x3_and_normalize(rng):
    A = rng.normal(size=(50, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    ref = np.asarray(jgeom.solve3x3(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(tgeom.solve3x3(_t(A), _t(b)).numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgeom.normalize(_t(b)).numpy(), np.asarray(jgeom.normalize(jnp.asarray(b))), rtol=1e-6)


def test_triangulate_normalized(rng):
    rig = make_rig()
    R, T = rig.R.astype(np.float32), (rig.T / np.linalg.norm(rig.T)).astype(np.float32)
    p = (rng.random((40, 2)) * 0.6 - 0.3).astype(np.float32)
    q = (p + rng.random((40, 2)).astype(np.float32) * 0.05).astype(np.float32)
    ref = np.asarray(j_tri(jnp.asarray(p), jnp.asarray(q), jnp.asarray(R), jnp.asarray(T)))
    np.testing.assert_allclose(t_tri(_t(p), _t(q), _t(R), _t(T)).numpy(), ref, rtol=1e-5, atol=1e-6)


def test_rectify_homographies_identical():
    rig = make_rig(width=320, height=240)
    args = (rig.K0, rig.K1, rig.R.T, -rig.R.T @ rig.T, (320, 240))
    a, b = jrect.stereo_rectify_homographies(*args), trect.stereo_rectify_homographies(*args)
    np.testing.assert_array_equal(a.HL, b.HL)
    np.testing.assert_array_equal(a.HR, b.HR)
    assert a.roi == b.roi and a.angle_deg == b.angle_deg


def test_frame_geometry_and_pack():
    rig = make_rig(width=192, height=144)
    gj = jdense.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (192, 144))
    gt = tdense.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (192, 144))
    for f in dataclasses.fields(gj):
        np.testing.assert_array_equal(np.asarray(getattr(gt, f.name)), np.asarray(getattr(gj, f.name)))
    pj = convert.geom_pack_from_numpy({k: np.asarray(v) for k, v in jdense.build_geom_pack(gj, (144, 192)).items()})
    pt = tdense.build_geom_pack(gt, (144, 192), "cpu")
    assert pj.keys() == pt.keys() and pj["base_is_cam0"] == pt["base_is_cam0"]
    for k in pj:
        if k != "base_is_cam0":
            assert torch.equal(pj[k], pt[k]), k


@pytest.mark.parametrize("noise", [0.0, 3.0])
def test_resolve_smooth_sigma(rng, noise):
    yy, xx = np.mgrid[0:120, 0:160]
    img = 120 + 50 * np.sin(xx / 9.0) * np.cos(yy / 11.0) + noise * rng.normal(size=xx.shape)
    for cfg_sigma in (-1.0, 0.5):
        for stage in ("dense", "match"):
            assert tdeg.resolve_smooth_sigma(cfg_sigma, img, stage) == jdeg.resolve_smooth_sigma(cfg_sigma, img, stage)


@pytest.mark.parametrize("text", ["", "MAX_DISPARITY=96\nDENSE_P2_MULT=40\nRANDOM_SEED=5\nDENSE_INPUT_SMOOTH_SIGMA=0\n"])
def test_stereo_options_match(text, monkeypatch):
    """The port's copy of the stereo options, registered on a registry of
    its own, has the JAX package's names and defaults and maps a config
    file to the same DenseStereoConfig."""
    joptions.register_all()
    own = ConfigRegistry("stereo")
    monkeypatch.setattr(toptions, "stereo_cfg", own)
    toptions.register_all()
    jreg = registry("stereo")
    try:
        jreg.reset()
        assert own.as_dict() == {k: jreg.as_dict()[k] for k in own.names()}
        for reg in (jreg, own):
            reg.load_string(text)
        ref = convert.config_from_jax(joptions.stereo_config_from_registry())
        assert toptions.stereo_config_from_registry() == ref
    finally:
        jreg.reset()


def test_config_from_jax_round_trip():
    jcfg = jdense.DenseStereoConfig(num_disp=96, p2=80, directions=5, input_smooth_sigma=0.0)
    tcfg = convert.config_from_jax(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert convert.config_from_jax(jdense.DenseStereoConfig()) == tdense.DenseStereoConfig()
