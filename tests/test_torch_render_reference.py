"""The stereo loop's six debug renders against the benchmark's plain
reference (benchmark/reference: pipeline.frame, pipeline.render_images and
render.py, which import nothing of the port), on the CPU.

The loop runs as `wass-tpu-torch stereo` builds it (load_pipeline, renders
on, two writers) on two consecutive pairs of a seeded synthetic sea at
256x192 with the 5 MP configuration's settings and MAX_DISPARITY 160, so
that c2f still runs (H a multiple of 32, the 128 window inside the
range).  Each frame's six uint8 images, as its writer builds them, equal
the reference's from the same 8-bit pair, rig and settings, and each JPEG
the writer wrote is byte-equal to the reference's encoding of its image.
The renders alone are held to the reference's on a failure-code map that
holds every FAIL_* code, with NaN and out-of-range disparities and
rectified images, and ROIs at the image's edges."""

import dataclasses
import io
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import options as ref_options
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import render as ref_render
from wass_tpu_torch.cli.main import load_pipeline
from wass_tpu_torch.cli.pipeline import SequencePipeline
from wass_tpu_torch.io.image import encode_jpeg
from wass_tpu_torch.stereo import dense
from wass_tpu_torch.testing import write_pairs
from wass_tpu_torch.testing.synthetic import make_rig, make_scene
from wass_tpu_torch.utils import render

from torch_registries import reset_registries  # noqa: F401  (autouse)

W, H = 256, 192
CONFIG = Path(__file__).resolve().parent.parent / "benchmark" / "configs" / "wass-5mp.json"
RENDER_NAMES = {"stereo_input.jpg", "disparity_final_scaled.jpg", "stereo.jpg", "disparity_coverage.jpg",
                "graph_components.jpg", "triangulation_failmap.jpg"}
FAIL_CODES = (dense.FAIL_NO_DISPARITY, dense.FAIL_OUTSIDE_IMAGE, dense.FAIL_OUTSIDE_BBOX, dense.FAIL_BURNED,
              dense.FAIL_ANGLE, dense.FAIL_TOO_CLOSE, dense.FAIL_TOO_DISTANT)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _settings():
    config = json.loads(CONFIG.read_text())
    return config, dict(config["stereo"], MAX_DISPARITY=160)


def _loop_renders(seq: Path, monkeypatch) -> dict:
    """Runs the loop over seq's workdirs; returns each frame's render
    images (workdir name -> file name -> uint8 array) as its writer built
    them."""
    local, kept = threading.local(), {}
    write = SequencePipeline._write_renders
    build = render.stereo_renders

    def write_kept(wd, geom, res, extras):
        local.name = wd.path.name
        return write(wd, geom, res, extras)

    def build_kept(*args, **kwargs):
        images = build(*args, **kwargs)
        kept[local.name] = {name: render.fetch(img).copy() for name, img in images.items()}
        return images

    monkeypatch.setattr(SequencePipeline, "_write_renders", staticmethod(write_kept))
    monkeypatch.setattr(render, "stereo_renders", build_kept)
    pipe = load_pipeline(seq, "cpu")
    assert pipe.cfg.debug_renders and pipe.cfg.writer_threads == 2
    pipe.stereo(progress_stream=io.StringIO())
    return kept


@pytest.mark.parametrize("seed", [3, 17, 40])
def test_loop_renders_equal_the_reference(tmp_path, monkeypatch, seed):
    config, stereo = _settings()
    rig = make_rig(width=W, height=H)
    scenes = [make_scene(seed=seed, width=W, height=H, wave_amplitude=config["wave_amplitude"], rig=rig,
                         time=k / 15.0) for k in range(2)]
    pairs = [tuple(np.clip(img, 0, 255).astype(np.uint8) for img in (s.img0, s.img1)) for s in scenes]
    seq = tmp_path / "seq"
    wds = write_pairs(seq, pairs, rig)
    (seq / "stereo_config.txt").write_text(ref_options.stereo_config_text(stereo))
    kept = _loop_renders(seq, monkeypatch)

    cfg = ref_options.stereo_config(stereo)
    ref_options.check_fixed(cfg, config["dense_fixed"])
    cfg = dataclasses.replace(cfg, input_smooth_sigma=ref_pipeline.smooth_sigma(cfg, pairs[0][0]))
    for wd, (img0, img1) in zip(wds, pairs):
        assert "debug renders failed" not in (wd / "wass_stereo_log.txt").read_text()
        ref = ref_pipeline.frame(img0, img1, rig.K0, rig.K1, rig.R, rig.T, cfg, "cpu")
        assert ref["c2f"] is not None, "c2f did not run"
        want = ref_pipeline.render_images(ref)
        got = kept[wd.name]
        assert set(got) == set(want) == RENDER_NAMES
        for name, img in want.items():
            assert got[name].dtype == np.uint8 and np.array_equal(got[name], img), (wd.name, name)
            assert (wd / name).read_bytes() == ref_pipeline.jpeg_bytes(img), (wd.name, name)


def _render_inputs(seed: int):
    """Seeded render inputs with every failure code, NaN and out-of-range
    disparities and rectified values, as (disparity, valid, codes, imgs,
    rect) tensors."""
    rng = np.random.default_rng(seed)
    disp = rng.uniform(-5.0, 170.0, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.1] = np.nan
    disp[:, :7] = np.nan
    codes = rng.choice(np.array((0, *FAIL_CODES), np.uint8), (H, W))
    codes[0, :len(FAIL_CODES)] = FAIL_CODES
    valid = (codes == 0) & np.isfinite(disp)
    imgs = tuple(rng.integers(0, 256, (H, W), dtype=np.uint8) for _ in range(2))
    rect = []
    for _ in range(2):
        r = rng.uniform(-20.0, 280.0, (H, W)).astype(np.float32)
        r[rng.random((H, W)) < 0.05] = np.nan
        rect.append(r)
    t = torch.from_numpy
    return t(disp), t(valid), t(codes), tuple(map(t, imgs)), tuple(map(t, rect))


@pytest.mark.parametrize("roi", [(0, 0, W, H), (W - 50, 9, 80, H), (0, H - 1, 31, 1)],
                         ids=["whole_frame", "past_the_right_and_bottom", "last_row"])
def test_stereo_renders_equal_the_reference(roi):
    disp, valid, codes, imgs, rect = _render_inputs(sum(roi))
    got = render.stereo_renders(disp, valid, codes, imgs, rect, roi)
    want = ref_render.stereo_renders(disp, valid, codes, imgs, rect, roi)
    assert set(got) == set(want) == RENDER_NAMES
    for name, img in want.items():
        g, w = render.fetch(got[name]), img.numpy()
        assert g.dtype == np.uint8 and np.array_equal(g, w), name
        assert encode_jpeg(g) == ref_pipeline.jpeg_bytes(w), name
    # Every failure colour shows in the map.
    failmap = render.fetch(got["triangulation_failmap.jpg"])
    assert {tuple(failmap[0, k]) for k in range(len(FAIL_CODES))} == set(render.FAIL_COLORS.values())
