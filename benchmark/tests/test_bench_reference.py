"""The plain reference agrees with the port's CPU path on a small c2f frame,
and imports nothing of the program."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import ast
import dataclasses
from pathlib import Path

import numpy as np
import torch

import scene
from reference import options, pipeline
from reference.frame import _c2f_active

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "wass_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_the_chip_runs_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not (_imports(path) & (FORBIDDEN | {"wass_tpu_torch"})), path


def _pair(seed=11, w=256, h=192):
    rig = scene.make_rig(w, h)
    img0, img1, _ = scene.Sea(seed, rig, "cpu", 0.25).pair(0.0)
    return rig, scene.to_u8(img0), scene.to_u8(img1)


def test_reference_frame_equals_the_port_on_a_c2f_frame():
    from wass_tpu_torch.cli.options import register_all, stereo_config_from_registry
    from wass_tpu_torch.config import stereo_cfg
    from wass_tpu_torch.stereo.dense import dense_stereo_frame, export_u16

    torch.set_num_threads(1)
    rig, img0, img1 = _pair()
    cfg = options.stereo_config({"MAX_DISPARITY": 160})
    register_all()
    stereo_cfg.reset()
    stereo_cfg.load_string(options.stereo_config_text({"MAX_DISPARITY": 160}))
    port_cfg = stereo_config_from_registry()
    assert {k: v for k, v in vars(port_cfg).items()} == {k: v for k, v in vars(cfg).items()}
    assert _c2f_active(cfg, img0.shape)
    cfg = dataclasses.replace(cfg, input_smooth_sigma=pipeline.smooth_sigma(cfg, img0))
    ref = pipeline.frame(img0, img1, rig.K0, rig.K1, rig.R, rig.T, cfg, "cpu")
    port, _geom = dense_stereo_frame(img0.astype(np.float32), img1.astype(np.float32), rig.K0, rig.K1, rig.R, rig.T,
                                     port_cfg, device="cpu")
    assert ref["c2f"]["fallback"] is False
    for a, b in ((ref["res"].points, port.points), (ref["res"].valid, port.valid),
                 (ref["res"].disparity, port.disparity), (ref["res"].plane, port.plane)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    q, mins, scales = export_u16(port.points, port.valid, port.plane.to(torch.float32), int(port.n_points))
    np.testing.assert_array_equal(ref["rows"], q.numpy().astype(np.uint16))
    np.testing.assert_array_equal(ref["scales"], scales.numpy().astype(np.float64))
