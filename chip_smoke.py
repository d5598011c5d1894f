#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wass_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. The card: `nvidia-smi` name and power limit, torch's device name.
2. Build the CUDA kernels from wass_tpu_torch/csrc with nvcc (sm_90a).
3. Each kernel against its plain PyTorch version on the card, at the
   slice's shapes (2048x1536, D = 640, 8 paths) and at a ragged shape
   (1001x777, D = 52): bit-equal outputs, times from CUDA events.
4. The main path: a synthetic 2048x1536 wave-field pair (rendered once and
   cached in wass_tpu_torch/_build/) written as 3 frame workdirs, then
   `python -m wass_tpu_torch.cli.main stereo <outdir>`'s entry point with
   the stereo defaults (MAX_DISPARITY = 640).  Every frame must give a
   plane.txt and a mesh_cam.xyzC that read back through the workdir
   contract (wass_tpu.io, via wass_tpu_torch.testing.read_frame), a
   trimmed-mean elevation error below 0.02 baseline units, and must have
   launched every kernel.
5. A JSON line of per-kernel results, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Exits non-zero without a result when there is no CUDA device or when the
port's package is not next to this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, D = 2048, 1536, 640
RAGGED = (777, 1001, 52)  # (H, W, D)
N_FRAMES = 3
SCENE_SEED = 7
ELEVATION_GATE = 0.02  # verify_meshes trimmed-mean gate, baseline units

KERNELS = {
    "census_cost": ("wass_tpu_torch/csrc/census_cost.cu", "wass_tpu/stereo/sgm_pallas.py:710"),
    "sgm_wta_fused": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:633"),
    "label_propagate": ("wass_tpu_torch/csrc/components.cu", "wass_tpu/ops/components_pallas.py:103"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of fn() over reps runs (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, kernel_out, plain_out) -> float:
    """Max |kernel - plain|; raises unless the two are bit-equal."""
    import torch

    torch.cuda.synchronize()
    if kernel_out.shape != plain_out.shape or kernel_out.dtype != plain_out.dtype:
        raise AssertionError(f"{name}: {kernel_out.shape}/{kernel_out.dtype} vs {plain_out.shape}/{plain_out.dtype}")
    err = (kernel_out.double() - plain_out.double()).abs().max().item() if kernel_out.numel() else 0.0
    if not torch.equal(kernel_out, plain_out):
        raise AssertionError(f"{name}: kernel differs from the plain version (max abs err {err})")
    return err


def check_kernels(img_pair, dev) -> dict:
    """Phase 3: kernel vs plain at the slice's and a ragged shape."""
    import torch

    from wass_tpu_torch.ops import components_kernels as ck
    from wass_tpu_torch.stereo import sgm_kernels as sk
    from wass_tpu_torch.stereo.cost import census_cost_volume, census_transform
    from wass_tpu_torch.stereo.sgm import sgm_wta_fused_plain

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    gen = torch.Generator().manual_seed(0)
    ragged_h, ragged_w, ragged_d = RAGGED
    cases = [
        ("slice", torch.as_tensor(img_pair[0]), torch.as_tensor(img_pair[1]), D),
        ("ragged", torch.rand((ragged_h, ragged_w), generator=gen) * 255,
         torch.rand((ragged_h, ragged_w), generator=gen) * 255, ragged_d),
    ]
    for tag, a, b, nd in cases:
        base, match = a.to(dev, torch.float32), b.to(dev, torch.float32)
        cb, cm = census_transform(base, (7, 9), 0.8), census_transform(match, (7, 9), 0.8)
        shape = f"{tuple(base.shape)} D={nd}"

        cost = sk.census_cost_volume(cb, cm, nd, 1)
        err = compare(f"census_cost {tag}", cost, census_cost_volume(cb, cm, nd, 1))
        results["census_cost"]["max_abs_err"] = max(results["census_cost"]["max_abs_err"], err)
        log(f"kernel census_cost {tag} {shape}: bit-equal")

        for dirs in (5, 8):  # the 8-path disparity feeds the label check
            disp = sk.sgm_wta_fused(cost, 8, 96, dirs, 1, 1)
            err = compare(f"sgm_wta_fused {tag} dirs={dirs}", disp, sgm_wta_fused_plain(cost, 8, 96, dirs, 1, 1))
            results["sgm_wta_fused"]["max_abs_err"] = max(results["sgm_wta_fused"]["max_abs_err"], err)
            log(f"kernel sgm_wta_fused {tag} {shape} directions={dirs}: bit-equal")

        # Labels of the valid-disparity mask, 4-neighbours joined where the
        # disparity steps by less than one pixel (a z-gap-like gate).
        valid = disp > 0
        idx = torch.arange(valid.numel(), dtype=torch.int32, device=dev).reshape(valid.shape)
        init = torch.where(valid, idx, torch.iinfo(torch.int32).max)
        conn_v = torch.zeros_like(valid, dtype=torch.uint8)
        conn_h = torch.zeros_like(valid, dtype=torch.uint8)
        conn_v[1:] = (valid[1:] & valid[:-1] & ((disp[:-1] - disp[1:]).abs() < 1)).to(torch.uint8)
        conn_h[:, 1:] = (valid[:, 1:] & valid[:, :-1] & ((disp[:, :-1] - disp[:, 1:]).abs() < 1)).to(torch.uint8)
        k_lab = ck.propagate_labels(init, conn_v, conn_h, 24)
        err = compare(f"label_propagate {tag}", k_lab, ck.propagate_labels_plain(init, conn_v, conn_h, 24))
        results["label_propagate"]["max_abs_err"] = max(results["label_propagate"]["max_abs_err"], err)
        n_comp = int(torch.unique(k_lab[valid]).numel())
        log(f"kernel label_propagate {tag} {tuple(valid.shape)}: bit-equal ({n_comp} components)")

        if tag == "slice":  # times at the main path's shapes
            t = results
            t["census_cost"]["ms"] = cuda_ms(lambda: sk.census_cost_volume(cb, cm, nd, 1), 5)
            t["census_cost"]["plain_ms"] = cuda_ms(lambda: census_cost_volume(cb, cm, nd, 1))
            t["sgm_wta_fused"]["ms"] = cuda_ms(lambda: sk.sgm_wta_fused(cost, 8, 96, 8, 1, 1), 3)
            t["sgm_wta_fused"]["plain_ms"] = cuda_ms(lambda: sgm_wta_fused_plain(cost, 8, 96, 8, 1, 1))
            t["label_propagate"]["ms"] = cuda_ms(lambda: ck.propagate_labels(init, conn_v, conn_h, 24), 3)
            t["label_propagate"]["plain_ms"] = cuda_ms(lambda: ck.propagate_labels_plain(init, conn_v, conn_h, 24))
            for name in KERNELS:
                log(f"time {name} {shape}: kernel {t[name]['ms']:.3f} ms, plain {t[name]['plain_ms']:.3f} ms")
        del cost
        torch.cuda.empty_cache()
    return results


def run_main_path(seq: Path, scene) -> dict:
    """Phase 4: the stereo CLI over N_FRAMES workdirs, with checks."""
    import numpy as np

    import wass_tpu_torch
    from wass_tpu_torch.cli.main import main as cli_main
    from wass_tpu_torch.testing import read_frame, trimmed_elevation_error

    wass_tpu_torch.reset_launch_counts()
    t0 = time.time()
    rc = cli_main(["stereo", str(seq)])
    wall = time.time() - t0
    launches = wass_tpu_torch.launch_counts()
    if rc != 0:
        raise AssertionError(f"stereo CLI returned {rc}")
    log(f"main path: {N_FRAMES} frames in {wall:.2f} s = {N_FRAMES / wall:.3f} frames/s "
        f"(PNG decode to .xyzC, first frame included); launches {launches}")

    wds = sorted(seq.glob("*_wd"))
    if len(wds) != N_FRAMES:
        raise AssertionError(f"expected {N_FRAMES} workdirs, found {len(wds)}")
    for i, wd in enumerate(wds):
        plane, mesh, per_frame = read_frame(wd)
        missing = [k for k in KERNELS if per_frame.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"frame {i}: kernels not launched: {missing} ({per_frame})")
        if not np.all(np.isfinite(plane)):
            raise AssertionError(f"frame {i}: no plane (plane_ok false)")
        if mesh.shape[1] != 3 or len(mesh) < 0.5 * W * H or not np.isfinite(mesh).all():
            raise AssertionError(f"frame {i}: mesh of shape {mesh.shape} is too small or not finite")
        err = trimmed_elevation_error(scene, mesh, plane)
        log(f"frame {i}: {len(mesh)} points, plane {' '.join(f'{v:.6f}' for v in plane)}, "
            f"trimmed-mean elevation error {err:.5f} (gate {ELEVATION_GATE}), launches {per_frame}")
        if not err < ELEVATION_GATE:
            raise AssertionError(f"frame {i}: elevation error {err} >= {ELEVATION_GATE}")
    return launches


def main() -> int:
    if not (ROOT / "wass_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository (wass_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # Phase 2: build.
    from wass_tpu_torch import _build
    from wass_tpu_torch.device import require_cuda

    dev = require_cuda()
    t0 = time.time()
    lib_path, _ = _build.build()
    _build.load()
    log(f"build: {lib_path.name} in {time.time() - t0:.1f} s")

    from wass_tpu_torch.testing import load_or_make_scene, write_sequence

    t0 = time.time()
    scene = load_or_make_scene(W, H, SCENE_SEED, _build.BUILD_DIR)
    img0, img1, rig = scene.img0, scene.img1, scene.rig
    log(f"scene: {W}x{H} seed {SCENE_SEED} ready in {time.time() - t0:.1f} s")

    # Phase 3: kernels vs plain, on the rectified slice pair.
    from wass_tpu_torch.stereo.dense import prepare_frame_geometry, rectify_on_device

    geom = prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
    rect = (
        rectify_on_device(torch.as_tensor(b_img, device=dev), geom.H_base, (H, W)).cpu(),
        rectify_on_device(torch.as_tensor(m_img, device=dev), geom.H_match, (H, W)).cpu(),
    )
    results = check_kernels(rect, dev)

    # Phase 4: the main path.
    seq = _build.BUILD_DIR / "smoke_seq"
    write_sequence(seq, img0, img1, rig, N_FRAMES)
    launches = run_main_path(seq, scene)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
        }
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
