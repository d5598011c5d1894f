"""Sequence-level dense stereo (the wass_stereo stage over every frame).

Counterpart of SequencePipeline.stereo in wass_tpu/cli/pipeline.py: the
AUTO smoothing sigma is resolved once from frame 0, each frame is
rectified and reconstructed on the device, and one writer thread
finalizes a frame (plane.txt, mesh_cam.xyzC, P0cam/P1cam, poses,
stereo_config.txt, wass_stereo_log.txt) while the next one is decoded and
computed.  output/planes.txt collects the planes.

Not ported yet: the prepare / match / autocalibrate stages, the
frame-sharded multi-device runner, the optical-flow path, debug renders
and the delta-coded wire format (the .xyzC payload is always the direct
u16 export).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from wass_tpu_torch.io.workdir import Workdir, frame_workdirs
from wass_tpu_torch.io.xyzc import save_xyz_quantized
from wass_tpu_torch.core.geometry import rt_from_plane
from wass_tpu_torch.io.png import read_gray
from wass_tpu_torch.stereo.dense import (
    DenseStereoConfig,
    DenseStereoPipeline,
    build_geom_pack,
    export_u16,
    prepare_frame_geometry,
    rectify_on_device,
)


@dataclasses.dataclass
class SequenceConfig:
    stereo: DenseStereoConfig = dataclasses.field(default_factory=DenseStereoConfig)
    # "cuda" runs the kernels and needs a card; "cpu" runs the plain
    # versions (tests).  No fallback from one to the other.
    device: str = "cuda"


class SequencePipeline:
    def __init__(self, outdir, cfg: Optional[SequenceConfig] = None):
        self.outdir = Path(outdir)
        self.cfg = cfg or SequenceConfig()
        self.outdir.mkdir(parents=True, exist_ok=True)

    def workdirs(self) -> List[Workdir]:
        return frame_workdirs(self.outdir)

    def _device(self) -> torch.device:
        if self.cfg.device == "cuda":
            from wass_tpu_torch.device import require_cuda

            return require_cuda()
        return torch.device(self.cfg.device)

    def _frame_geometry(self, cache: dict, K0, K1, R, T, shape, device):
        """Geometry + device pack, cached by rig parameters."""
        key = (K0.tobytes(), K1.tobytes(), np.asarray(R).tobytes(), np.asarray(T).tobytes(), shape)
        hit = cache.get(key)
        if hit is None:
            H, W = shape
            geom = prepare_frame_geometry(K0, K1, R, T, (W, H), cam_distance=self.cfg.stereo.cam_distance)
            hit = (geom, build_geom_pack(geom, shape, device))
            cache[key] = hit
        return hit

    def _finalize_stereo_frame(self, wd: Workdir, geom, res, K0, K1, launches: dict,
                               c2f: Optional[dict]) -> np.ndarray:
        """Per-frame outputs; the first host sync of this frame's results.
        c2f: the frame's resolved coarse-to-fine diagnostics, or None."""
        t0 = time.time()
        log_lines = [
            "kernel launches: " + " ".join(f"{k}={v}" for k, v in sorted(launches.items()))
        ]
        if c2f is not None:
            log_lines.append(
                f"c2f window coverage: {c2f['coverage']:.4f} "
                f"coherent-offband: {c2f['offband']:.5f} "
                + ("FALLBACK to full-range SGM" if c2f["fallback"] else "windowed")
            )
        P0 = K0 @ np.hstack([np.eye(3), np.zeros((3, 1))])
        P1 = K1 @ np.hstack([geom.R, geom.T.reshape(3, 1)])
        wd.save_projection_matrices(P0, P1)
        wd.save_camera_poses(np.eye(3), np.zeros(3), geom.R, geom.T)
        with open(wd.path / "stereo_config.txt", "w") as f:
            for k, v in dataclasses.asdict(self.cfg.stereo).items():
                f.write(f"{k.upper()}={v}\n")

        n_points = int(res.n_points)
        log_lines.append(f"triangulated+filtered points: {n_points}")
        # MIN_TRIANGULATED_POINTS gate: mark the frame failed and go on.
        if n_points < self.cfg.stereo.min_triangulated:
            wd.save_plane(None)
            wd.save_mesh(np.zeros((0, 3)), np.eye(3), np.zeros(3))
            log_lines.append("FRAME FAILED: below MIN_TRIANGULATED_POINTS")
            self._write_stereo_log(wd, log_lines, t0)
            return np.full(4, np.nan)

        plane = res.plane.cpu().numpy().astype(np.float64)
        if not bool(res.plane_ok):
            plane = np.full(4, np.nan)
        wd.save_plane(plane if np.all(np.isfinite(plane)) else None)
        log_lines.append("plane: " + " ".join(f"{v:.6g}" for v in plane))

        if np.all(np.isfinite(plane)):
            # Sea-plane-frame u16 payload quantized and compacted on the
            # device; the host writes exactly the 6n payload bytes.
            plane32 = torch.as_tensor(plane, dtype=torch.float32)
            _Rp, _Tp, Rinv, Tinv = (a.numpy().astype(np.float64) for a in rt_from_plane(plane32))
            q, mins, scales = export_u16(res.points, res.valid, plane32.to(res.points.device))
            save_xyz_quantized(
                wd.path / "mesh_cam.xyzC",
                q.cpu().numpy().astype(np.uint16),
                scales.cpu().numpy().astype(np.float64),
                mins.cpu().numpy().astype(np.float64),
                Rinv, Tinv,
            )
        else:
            valid = res.valid.cpu().numpy()
            pts = res.points.cpu().numpy().astype(np.float64)[valid]
            wd.save_mesh(pts, np.eye(3), np.zeros(3))

        self._write_stereo_log(wd, log_lines, t0)
        return plane

    @staticmethod
    def _write_stereo_log(wd: Workdir, lines, t0) -> None:
        with open(wd.path / "wass_stereo_log.txt", "w") as f:
            for ln in lines:
                f.write(f"[INFO] {ln}\n")
            f.write(f"[INFO] finalize wall time: {time.time()-t0:.3f}s\n")

    def stereo(self, wds: Optional[Sequence[Workdir]] = None) -> List[np.ndarray]:
        """Dense reconstruction of every frame; returns the planes (nan rows
        for failed frames) and writes output/planes.txt."""
        wds = list(wds if wds is not None else self.workdirs())
        if self.cfg.stereo.input_smooth_sigma < 0 and wds:
            # AUTO pre-smoothing, resolved once per sequence from frame 0.
            from wass_tpu_torch.prepare.degradation import resolve_smooth_sigma

            self.cfg.stereo = dataclasses.replace(
                self.cfg.stereo,
                input_smooth_sigma=resolve_smooth_sigma(-1.0, read_gray(wds[0].undistorted_path(0)).astype(np.float32), "dense"),
            )
        planes = self._stereo_loop(wds)
        self._write_sequence_outputs(wds, planes)
        return planes

    def _stereo_loop(self, wds) -> List[np.ndarray]:
        """Frames in order.  A frame's finalize (device-to-host copies, file
        writes) runs on the writer thread while the main thread decodes and
        computes the next frame; one finalize at a time, so at most two
        frames' results are alive.  The c2f fallback is decided inside the
        frame, before its full-resolution pass (the pipeline's default, not
        deferred): a re-run from the writer thread would launch kernels
        from a second thread and blur the per-frame launch counts."""
        import wass_tpu_torch

        device = self._device()
        pipe = DenseStereoPipeline(self.cfg.stereo)
        geom_cache: dict = {}
        planes: List[np.ndarray] = []
        pending = None
        with ThreadPoolExecutor(max_workers=1) as writer:
            for wd in wds:
                img0 = read_gray(wd.undistorted_path(0))  # uint8, cast on the device
                img1 = read_gray(wd.undistorted_path(1))
                K0, K1 = wd.load_intrinsics(0), wd.load_intrinsics(1)
                R, T = wd.load_extrinsics()
                geom, gp = self._frame_geometry(geom_cache, K0, K1, R, T, img0.shape, device)
                b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
                H, W = img0.shape
                b = torch.as_tensor(b_img).to(device).to(torch.float32)
                m = torch.as_tensor(m_img).to(device).to(torch.float32)
                before = wass_tpu_torch.launch_counts()
                base_rect = rectify_on_device(b, geom.H_base, (H, W))
                match_rect = rectify_on_device(m, geom.H_match, (H, W))
                res = pipe(base_rect, match_rect, gp)
                launches = {k: v - before[k] for k, v in wass_tpu_torch.launch_counts().items()}
                if pending is not None:
                    planes.append(pending.result())
                pending = writer.submit(self._finalize_stereo_frame, wd, geom, res, K0, K1, launches, pipe.last_c2f)
            if pending is not None:
                planes.append(pending.result())
        return planes

    def _write_sequence_outputs(self, wds, planes) -> None:
        out = self.outdir / "output"
        out.mkdir(exist_ok=True)
        with open(out / "planes.txt", "w") as f:
            for p in planes:
                if np.all(np.isfinite(p)):
                    f.write(" ".join(f"{v:.18g}" for v in p) + "\n")
        with open(self.outdir / "workspaces.txt", "w") as f:
            for wd in wds:
                f.write(str(wd.path) + "\n")
