"""Sequence-level orchestration: prepare every frame pair, match a subset
of the frames, autocalibrate the rig from the pooled matches, and run the
production dense-stereo loop over every frame workdir.

Counterpart of SequencePipeline in wass_tpu/cli/pipeline.py.  The stereo
loop is the JAX package's _stereo_pipelined: PNGs decode on prefetch
threads (io/prefetch.py) dispatch_depth + 1 frames ahead; the main thread
uploads, rectifies and dispatches each frame's device work without
waiting for the device (c2f's fallback decision is deferred); writer
threads finalize the frames (the c2f fallback resolved and, where it
trips, the frame re-run at full range; plane.txt, mesh_cam.xyzC,
P0cam/P1cam, poses, stereo_config.txt, wass_stereo_log.txt) while later
frames compute; at most dispatch_depth frames are in flight, and a
`[P|cur|tot]` line follows each finalized frame.  With debug_renders (the
default, as in the JAX package) the writers also write the frame's six
debug renders (stereo_input.jpg, disparity_final_scaled.jpg, stereo.jpg,
disparity_coverage.jpg, graph_components.jpg, triangulation_failmap.jpg;
utils/render.py), and the match stage its matches.jpg and
matches_epifilter.jpg.  With an optical-flow config (SequenceConfig.flow,
ENABLE_OPTICAL_FLOW in stereo_config.txt) each writer also runs the flow
stage on the frame's disparity (stereo/flow.py, the CUDA solver of
stereo/flow_kernels.py) and writes flow_coarse.png, flow.png and
mesh_full_flow.ply.  output/planes.txt
collects the planes.  The AUTO smoothing sigma is resolved once from
frame 0.

On a card each writer thread reads its frames on a CUDA stream of its
own, after an event recorded at the end of the frame's dispatch: a read on
the dispatching stream would wait for every frame dispatched since.  The
one host read left on the dispatching thread is the plane refinement's
3x3 eigenproblem (stereo/dense.py:plane_normal_read).  On a card the
dispatching thread replays each frame's rectification and dense device
work from CUDA graphs (stereo/frame_graphs.py: a ring of graph instances a
slot, whose inputs a frame's upload fills); the writer records the
instance's `done` event after its last read of the frame.

With more than one frame slot (more than one card, or a torch.distributed
group of several ranks; parallel/mesh.py), frame i belongs to global slot
i % (the slot count), as in the JAX package's frame-sharded loop, and each
process runs only the frames of its own slots: each local slot dispatches
its frames on its slot's device with a DenseStereoPipeline of its own and
at most dispatch_depth of them in flight, from a thread of its own when
the process has more than one slot.  The prefetch threads and the writers
are shared.  Under a process group each rank writes its own frames' files;
after the drain the planes are gathered, rank 0 writes output/planes.txt
and workspaces.txt, and a barrier ends stereo().

The .xyzC payload crosses the link as u16 rows, 6 bytes a point.

Each stereo() call leaves its spans and counters (instrument.py), summed
per frame, in loop_stats.  The dispatching thread is always inside one of
its top-level spans: loop.start (the AUTO smoothing, the pools), then a
frame's loop.take (its prefetched pair), loop.dispatch
(loop.rig, loop.upload, loop.rectify, the dense frame's dense.frame span
with plane.read, the frame's one counted host read, and loop.submit) and
loop.writer_wait (the oldest frame's writer), and loop.drain.  A writer's
writer.finalize holds writer.device_wait (the first read that waits for
the frame's device work), writer.rerun, writer.fetch (the export and its
reads), writer.write (every file), writer.render and writer.flow; a
prefetch thread's decode is prefetch.decode.  writer.render holds
writer.render.build, .fetch, .encode and .write, and the counters
render_bytes (the uint8 bytes fetched) and render_images (the files).  The
dense frame's inner spans (dense.census, dense.disparity, dense.post,
dense.plane) fire where the frame runs eagerly, and on a card only when a
graph is captured; the counters dense_graph_replays and
dense_graph_captures count the frames replayed and the instances captured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from wass_tpu_torch.calib.autocalibrate import AutocalConfig, autocalibrate_sequence
from wass_tpu_torch.core.geometry import rt_from_plane
from wass_tpu_torch.device import on_cuda, resolve_device, to_device
from wass_tpu_torch.instrument import Recorder, count, current, frame_scope, span
from wass_tpu_torch.io import jpeg
from wass_tpu_torch.io.image import RENDER_QUALITY, encode_jpeg
from wass_tpu_torch.io.ply import save_ply_points
from wass_tpu_torch.io.png import read_gray
from wass_tpu_torch.io.prefetch import Prefetcher
from wass_tpu_torch.io.workdir import Workdir, frame_workdirs
from wass_tpu_torch.io.xyzc import save_xyz_quantized
from wass_tpu_torch.match.pipeline import MatchConfig, match_frame
from wass_tpu_torch.ops import components_kernels
from wass_tpu_torch.parallel.mesh import all_gather_host, local_frame_indices, make_frame_mesh, rank, world_size
from wass_tpu_torch.prepare.prepare import PrepareConfig, prepare_frame
from wass_tpu_torch.stereo import flow_kernels, frame_graphs, sgm_kernels
from wass_tpu_torch.stereo.dense import (
    DenseStereoConfig,
    DenseStereoPipeline,
    build_geom_pack,
    c2f_should_fallback,
    export_u16,
    fetch_u16,
    prepare_frame_geometry,
    rectify_pair,
)
from wass_tpu_torch.stereo.flow import FlowConfig, flow_reconstruct_frame
from wass_tpu_torch.utils import render
from wass_tpu_torch.utils.progress import progress


# loop_stats keys that hold every duration of a span, in the order they end:
# one an image, one a frame, one a rendered frame.
LEGACY_KEYS = {"prefetch.decode": "decode_s", "loop.dispatch": "dispatch_s", "writer.render": "render_s"}


@dataclasses.dataclass
class SequenceConfig:
    prepare: PrepareConfig = dataclasses.field(default_factory=PrepareConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    autocal: AutocalConfig = dataclasses.field(default_factory=AutocalConfig)
    stereo: DenseStereoConfig = dataclasses.field(default_factory=DenseStereoConfig)
    match_subset: int = 50  # frames matched at most (wasscli.py:259)
    seed: int = 0  # the numpy draw of the matched subset
    # "cuda" runs the kernels and needs a card; "cpu" runs the plain
    # versions (tests).  No fallback from one to the other.
    device: str = "cuda"
    # Production-loop knobs (the JAX package's): frames dispatched ahead of
    # the oldest one not yet finalized, and finalizing writer threads.
    dispatch_depth: int = 3
    writer_threads: int = 2
    # The reference's always-on stereo and match debug images
    # (wass_stereo.cpp:854,1001,1017,1910-1926, PovMesh.cpp:982-984,
    # wass_match.cpp:70-95).
    debug_renders: bool = True
    # The optical-flow reconstruction (ENABLE_OPTICAL_FLOW; None: off, as in
    # the reference).
    flow: Optional[FlowConfig] = None


class SequencePipeline:
    def __init__(self, outdir, cfg: Optional[SequenceConfig] = None):
        self.outdir = Path(outdir)
        self.cfg = cfg or SequenceConfig()
        self.outdir.mkdir(parents=True, exist_ok=True)
        # The last stereo() call's spans and counters (instrument.Recorder.
        # stats): a list of seconds (or counts) a frame under each span's
        # name, and under LEGACY_KEYS each PNG decode's, each dispatch's and
        # each frame's debug renders' seconds.
        self.loop_stats: dict = {}

    def _device(self) -> torch.device:
        return resolve_device(self.cfg.device)

    # -- stage 1: prepare --------------------------------------------------
    def prepare(self, frames, K0, d0, K1, d1, ext_R=None, ext_T=None) -> List[Workdir]:
        """frames: iterable of (img0, img1) raw grayscale arrays."""
        device = self._device()
        return [
            prepare_frame(self.outdir / f"{i:06d}_wd", img0, img1, K0, d0, K1, d1, self.cfg.prepare,
                          ext_R, ext_T, device=device)
            for i, (img0, img1) in enumerate(frames)
        ]

    def workdirs(self) -> List[Workdir]:
        return frame_workdirs(self.outdir)

    # -- stage 2: match ----------------------------------------------------
    def match(self, wds: Optional[Sequence[Workdir]] = None) -> int:
        """Match a random subset of at most match_subset frames; each writes
        ext_R/ext_T, matches.txt, matches_epionly.txt,
        matches_unfiltered.txt, matcher_stats.csv and wass_match_log.txt.
        Returns the number of frames matched."""
        wds = list(wds if wds is not None else self.workdirs())
        device = self._device()
        rng = np.random.default_rng(self.cfg.seed)
        if len(wds) > self.cfg.match_subset:
            sel = rng.choice(len(wds), self.cfg.match_subset, replace=False)
            wds = [wds[i] for i in sorted(sel)]
        n_ok = 0
        for wd in wds:
            t0 = time.time()
            img0 = wd.load_undistorted(0)
            img1 = wd.load_undistorted(1)
            res = match_frame(img0, img1, wd.load_intrinsics(0), wd.load_intrinsics(1), self.cfg.match, device)
            with open(wd.path / "wass_match_log.txt", "w") as f:
                if res is None:
                    f.write("[ERROR] match stage failed (no pose recovered)\n")
                else:
                    f.write(f"[INFO] matches: {res.n_matches}\n")
                    f.write(f"[INFO] epipolar error avg/std/min/max: {res.epi_avg:.4f} {res.epi_std:.4f} "
                            f"{res.epi_min:.4f} {res.epi_max:.4f} px\n")
                f.write(f"[INFO] wall time: {time.time() - t0:.3f}s\n")
            if res is None:
                continue
            wd.save_extrinsics(res.R, res.T)
            wd.save_matches("matches.txt", res.uv0_pose, res.uv1_pose)
            wd.save_matches("matches_epionly.txt", res.uv0_epi, res.uv1_epi)
            wd.save_matches("matches_unfiltered.txt", res.uv0_all, res.uv1_all)
            wd.save_matcher_stats(res.n_matches, res.epi_avg, res.epi_std, res.epi_min, res.epi_max)
            if self.cfg.debug_renders:
                try:
                    render.save(wd.path / "matches.jpg", render.render_matches(img0, img1, res.uv0_pose, res.uv1_pose))
                    render.save(wd.path / "matches_epifilter.jpg",
                                render.render_matches(img0, img1, res.uv0_epi, res.uv1_epi))
                except Exception as e:  # debug imagery must never fail the stage
                    with open(wd.path / "wass_match_log.txt", "a") as f:
                        f.write(f"[INFO] debug renders failed: {e}\n")
            n_ok += 1
        return n_ok

    # -- stage 3: autocalibrate -------------------------------------------
    def autocalibrate(self):
        """The pooled reduction over every frame's matches_epionly.txt;
        writes wass_autocalibrate_log.txt, and ext_R/ext_T and H.xml to every
        workdir on success.  Returns the AutocalResult or None."""
        t0 = time.time()
        res = autocalibrate_sequence(self.workdirs(), self.cfg.autocal, self._device())
        with open(self.outdir / "wass_autocalibrate_log.txt", "w") as f:
            if res is None:
                f.write("[ERROR] autocalibrate failed (no pooled matches)\n")
            else:
                f.write(f"[INFO] pooled inliers: {res.n_inliers}\n")
                f.write(f"[INFO] median epipolar error before/after BA: "
                        f"{res.epi_med_before:.6f} / {res.epi_med_after:.6f} px\n")
                f.write(f"[INFO] accepted (improved): {res.improved}\n")
            f.write(f"[INFO] wall time: {time.time() - t0:.3f}s\n")
        return res

    # -- stage 4: dense stereo --------------------------------------------
    def _frame_geometry(self, cache: dict, K0, K1, R, T, shape, device):
        """Geometry + device pack, cached by rig parameters; returns (geometry,
        pack, cache key)."""
        key = (K0.tobytes(), K1.tobytes(), np.asarray(R).tobytes(), np.asarray(T).tobytes(), shape, str(device))
        hit = cache.get(key)
        if hit is None:
            H, W = shape
            geom = prepare_frame_geometry(K0, K1, R, T, (W, H), cam_distance=self.cfg.stereo.cam_distance)
            hit = (geom, build_geom_pack(geom, shape, device), key)
            cache[key] = hit
        return hit

    def _finalize_stereo_frame(self, wd: Workdir, geom, res, K0, K1, extras: dict, whole) -> np.ndarray:
        """Per-frame outputs, on a writer thread; the first host reads of the
        frame's results.  extras: the frame's kernel launches ("launches"),
        the uploaded uint8 base and match images ("imgs") and the rectified
        pair ("rect") for the renders, and, when c2f ran, its deferred
        diagnostics ("c2f"), the pipeline ("pipe") and the geometry pack
        ("gp") for a full-range re-run.  The frame's flow kernels count in
        its launches too.  whole: the writer.finalize span, whose seconds so
        far the log's wall time line gives."""
        c2f = extras.get("c2f")
        pending = c2f is not None and c2f["fallback"] is None
        n_points = None
        with span("writer.device_wait"):
            # The first host read waits for the frame's device work: the
            # deferred c2f scalars, or the point count.
            if pending:
                c2f = {**c2f, "coverage": float(c2f["coverage"]), "offband": float(c2f["offband"])}
            else:
                n_points = int(res.n_points)
        if pending:
            # Deferred c2f fallback: re-run the frame at full range if the
            # guard trips; its launches count for this frame.
            pipe = extras["pipe"]
            rerun = c2f_should_fallback(c2f["coverage"], c2f["offband"], pipe.cfg)
            with span("writer.rerun") if rerun else contextlib.nullcontext():
                res, c2f = pipe.resolve_fallback(res, c2f, *extras["rect"], extras["gp"])
            with span("writer.device_wait"):
                n_points = int(res.n_points)
        log_lines = []
        if c2f is not None:
            log_lines.append(
                f"c2f window coverage: {c2f['coverage']:.4f} "
                f"coherent-offband: {c2f['offband']:.5f} "
                + ("FALLBACK to full-range SGM" if c2f["fallback"] else "windowed")
            )
        P0 = K0 @ np.hstack([np.eye(3), np.zeros((3, 1))])
        P1 = K1 @ np.hstack([geom.R, geom.T.reshape(3, 1)])
        with span("writer.write"):
            wd.save_projection_matrices(P0, P1)
            wd.save_camera_poses(np.eye(3), np.zeros(3), geom.R, geom.T)
            with open(wd.path / "stereo_config.txt", "w") as f:
                for k, v in dataclasses.asdict(self.cfg.stereo).items():
                    f.write(f"{k.upper()}={v}\n")

        log_lines.append(f"triangulated+filtered points: {n_points}")
        # MIN_TRIANGULATED_POINTS gate: mark the frame failed and go on.
        if n_points < self.cfg.stereo.min_triangulated:
            log_lines.append("FRAME FAILED: below MIN_TRIANGULATED_POINTS")
            with span("writer.write"):
                wd.save_plane(None)
                wd.save_mesh(np.zeros((0, 3)), np.eye(3), np.zeros(3))
                self._write_stereo_log(wd, [self._launch_line(extras["launches"])] + log_lines, whole)
            return np.full(4, np.nan)

        with span("writer.fetch"):
            plane = res.plane.cpu().numpy().astype(np.float64)
            if not bool(res.plane_ok):
                plane = np.full(4, np.nan)
            log_lines.append("plane: " + " ".join(f"{v:.6g}" for v in plane))
            finite = bool(np.all(np.isfinite(plane)))
            if finite:
                # Sea-plane-frame u16 payload quantized and compacted on the
                # device; the host fetches exactly the n_points payload rows.
                plane32 = torch.as_tensor(plane, dtype=torch.float32)
                _Rp, _Tp, Rinv, Tinv = (a.numpy().astype(np.float64) for a in rt_from_plane(plane32))
                q, mins, scales = export_u16(res.points, res.valid, plane32.to(res.points.device), n_points)
                quant = fetch_u16(q)
                scales = scales.cpu().numpy().astype(np.float64)
                mins = mins.cpu().numpy().astype(np.float64)
            else:
                valid = res.valid.cpu().numpy()
                pts = res.points.cpu().numpy().astype(np.float64)[valid]
        with span("writer.write"):
            wd.save_plane(plane if finite else None)
            if finite:
                save_xyz_quantized(wd.path / "mesh_cam.xyzC", quant, scales, mins, Rinv, Tinv)
            else:
                wd.save_mesh(pts, np.eye(3), np.zeros(3))

        if self.cfg.debug_renders:
            with span("writer.render"):
                try:
                    self._write_renders(wd, geom, res, extras)
                except Exception as e:  # debug imagery must never fail the stage
                    log_lines.append(f"debug renders failed: {e}")

        if self.cfg.flow is not None:
            # The optical-flow reconstruction (refine_flow,
            # wass_stereo.cpp:1985-1990): a second, flow-based point cloud
            # beside the stereo mesh, and the flow renders.  Outside the
            # renders' handler: a failure fails the frame.
            with span("writer.flow"):
                self._write_flow(wd, geom, res, extras)

        with span("writer.write"):
            self._write_stereo_log(wd, [self._launch_line(extras["launches"])] + log_lines, whole)
        return plane

    def _launch_line(self, launches: dict) -> str:
        names = {**sgm_kernels.LAUNCHES, **components_kernels.LAUNCHES}
        if self.cfg.flow is not None:
            names.update(flow_kernels.LAUNCHES)
        return "kernel launches: " + " ".join(f"{k}={launches.get(k, 0)}" for k in sorted(names))

    def _write_flow(self, wd: Workdir, geom, res, extras: dict):
        """flow_coarse.png, flow.png and mesh_full_flow.ply of a frame from
        its (c2f-resolved) disparity and validity and its uploaded uint8
        base and match images; returns the FlowResult."""
        b8, m8 = extras["imgs"]
        fr = flow_reconstruct_frame(res.disparity, b8.to(torch.float32), m8.to(torch.float32), geom, self.cfg.flow,
                                    min_disp=float(self.cfg.stereo.min_disp), valid_rect=res.valid)
        render.save_png(wd.path / "flow_coarse.png", render.render_flow(fr.coarse_flow, 200.0))
        render.save_png(wd.path / "flow.png", render.render_flow(fr.flow, 200.0))
        pts = fr.points[fr.valid].cpu().numpy()
        grey = b8[fr.valid].cpu().numpy()
        save_ply_points(wd.path / "mesh_full_flow.ply", pts, np.repeat(grey[:, None], 3, axis=1))
        return fr

    @staticmethod
    def _write_renders(wd: Workdir, geom, res, extras: dict) -> None:
        """The frame's debug renders, each phase over all of them in its own
        span.  Built on the frame's device; on a card the JPEG kernel
        (io/jpeg.py) encodes them there and only the JPEG streams come back
        (build, encode: the launches and the wait for the byte counts,
        fetch, write); on the CPU each uint8 image is fetched and OpenCV
        encodes it (build, fetch, encode, write).  Counts the bytes copied
        from the device (render_bytes: the streams on a card, the images on
        the CPU), the images encoded on the card (render_device_images) and
        the files written (render_images)."""
        with span("writer.render.build"):
            images = render.stereo_renders(res.disparity, res.valid, res.fail_reasons, extras["imgs"],
                                           extras["rect"], geom.roi)
        tensors = list(images.values())
        if on_cuda(*tensors):
            with span("writer.render.encode"):
                encoder = jpeg.device_encoder(extras.get("jpeg_encoders", {}), tensors, RENDER_QUALITY)
                sizes = encoder.run(tensors)
            with span("writer.render.fetch"):
                jpegs = dict(zip(images, encoder.fetch(sizes)))
            count("render_bytes", sum(sizes))
            count("render_device_images", len(jpegs))
        else:
            with span("writer.render.fetch"):
                host = {name: render.fetch(img) for name, img in images.items()}
            count("render_bytes", sum(img.nbytes for img in host.values()))
            with span("writer.render.encode"):
                jpegs = {name: encode_jpeg(img) for name, img in host.items()}
            count("render_device_images", 0)
        with span("writer.render.write"):
            for name, data in jpegs.items():
                (wd.path / name).write_bytes(data)
        count("render_images", len(jpegs))

    @staticmethod
    def _write_stereo_log(wd: Workdir, lines, whole) -> None:
        with open(wd.path / "wass_stereo_log.txt", "w") as f:
            for ln in lines:
                f.write(f"[INFO] {ln}\n")
            f.write(f"[INFO] finalize wall time: {whole.elapsed():.3f}s\n")

    def stereo(self, wds: Optional[Sequence[Workdir]] = None, progress_stream=None) -> List[np.ndarray]:
        """Dense reconstruction of every frame; returns the planes (nan rows
        for failed frames) and writes output/planes.txt.  Progress lines go
        to progress_stream (stdout by default)."""
        wds = list(wds if wds is not None else self.workdirs())
        recorder = Recorder(each=LEGACY_KEYS)
        try:
            with frame_scope({}, 0, recorder, dispatching=True):
                with span("loop.start"):
                    if self.cfg.stereo.input_smooth_sigma < 0 and wds:
                        # AUTO pre-smoothing, resolved once per sequence from frame 0.
                        from wass_tpu_torch.prepare.degradation import resolve_smooth_sigma

                        self.cfg.stereo = dataclasses.replace(
                            self.cfg.stereo,
                            input_smooth_sigma=resolve_smooth_sigma(
                                -1.0, read_gray(wds[0].undistorted_path(0)).astype(np.float32), "dense"),
                        )
                    mesh = self._frame_mesh()
                planes = self._stereo_loop(wds, mesh, progress_stream)
                # Under a process group every rank holds every plane (its own
                # from its writers, the others' from the gather); rank 0
                # writes them, and no rank returns before the files are
                # written.
                with span("loop.drain"):
                    if rank() == 0:
                        self._write_sequence_outputs(wds, planes)
                    if world_size() > 1:
                        torch.distributed.barrier()
        finally:
            self.loop_stats = recorder.stats()
        return planes

    def _frame_mesh(self):
        """The frame slots of the stereo loop (parallel/mesh.py)."""
        device = self._device()
        if device.type == "cuda" and torch.device(self.cfg.device).index is None:
            return make_frame_mesh()
        return make_frame_mesh(devices=[device])

    def _writer_finalizer(self, on_card: bool):
        """The writers' finalize: on a card each writer thread reads its
        frames on a CUDA stream of its own for each device, after the
        frame's `ready` event, and keeps its JPEG encoders."""
        writer_local = threading.local()

        def finalize(wd, geom, res, K0, K1, extras):
            index, recorder = extras["frame"]
            with frame_scope(extras["launches"], index, recorder), span("writer.finalize") as whole:
                if not on_card:
                    return self._finalize_stereo_frame(wd, geom, res, K0, K1, extras, whole)
                with span("writer.device_wait"):
                    dev = res.points.device
                    streams = writer_local.__dict__.setdefault("streams", {})
                    stream = streams.get(dev)
                    if stream is None:
                        stream = streams[dev] = torch.cuda.Stream(dev)
                    stream.wait_event(extras["ready"])
                    c2f = extras["c2f"] or {}
                    for t in (*res, *extras["rect"], *extras["imgs"], c2f.get("coverage"), c2f.get("offband")):
                        if isinstance(t, torch.Tensor):
                            t.record_stream(stream)
                # The thread's JPEG encoders, whose buffers its frames reuse.
                extras["jpeg_encoders"] = writer_local.__dict__.setdefault("jpeg_encoders", {})
                with torch.cuda.stream(stream):
                    try:
                        return self._finalize_stereo_frame(wd, geom, res, K0, K1, extras, whole)
                    finally:
                        if "done" in extras:
                            # After the frame's last device read: its graph
                            # instance may take the next frame.
                            extras["done"].record(stream)

        return finalize

    def _stereo_loop(self, wds, mesh, progress_stream=None) -> List[np.ndarray]:
        """The frames of this process's slots of `mesh` (frame i belongs to
        global slot i % len(mesh)).  Returns every frame's plane: this
        process's from its writers, the other ranks' from the gather."""
        scope = current()
        recorder = scope.recorder if scope is not None else None
        with span("loop.start"):
            local = local_frame_indices(mesh)
            n_slots = len(mesh)
            on_card = mesh[local[0]].device.type == "cuda"
            # Deferred c2f fallback: the dispatching threads never wait for
            # the coverage scalars; the writers resolve them.  One pipeline a
            # slot: last_c2f is the state of the latest frame.
            pipes = {s: DenseStereoPipeline(self.cfg.stereo, defer_c2f_fallback=True) for s in local}
            depth = max(1, self.cfg.dispatch_depth)
            geom_cache: dict = {}
            planes: List[np.ndarray] = [None] * len(wds)
            finalize = self._writer_finalizer(on_card)

            def pop_oldest(inflight):
                j, fut = inflight.popleft()
                planes[j] = fut.result()
                progress(j + 1, len(wds), stream=progress_stream)

            prefetcher = Prefetcher(4 * len(local))
            tickets: dict = {}

            def submit(i):
                if 0 <= i < len(wds) and i not in tickets:
                    tickets[i] = (prefetcher.submit(wds[i].undistorted_path(0), i),
                                  prefetcher.submit(wds[i].undistorted_path(1), i))

            writers = ThreadPoolExecutor(max_workers=max(1, self.cfg.writer_threads),
                                         thread_name_prefix="stereo-writer")
            for s in local:
                for k in range(depth + 1):
                    submit(s + k * n_slots)

        def dispatch_slot(slot) -> deque:
            """Slot `slot`'s frames on its device; returns its frames still
            in flight."""
            device, pipe = mesh[slot].device, pipes[slot]
            graphs = frame_graphs.engages(device)
            inflight: deque = deque()
            with torch.cuda.device(device) if on_card else contextlib.nullcontext():
                for i in range(slot, len(wds), n_slots):
                    wd = wds[i]
                    with frame_scope({}, i, recorder, dispatching=True) as launches:
                        with span("loop.take"):
                            ticket0, ticket1 = tickets.pop(i)
                            img0, img1 = prefetcher.take(ticket0), prefetcher.take(ticket1)
                            submit(i + (depth + 1) * n_slots)
                        with span("loop.dispatch", cpu=True):
                            with span("loop.rig"):
                                K0, K1 = wd.load_intrinsics(0), wd.load_intrinsics(1)
                                R, T = wd.load_extrinsics()
                                geom, gp, geom_key = self._frame_geometry(geom_cache, K0, K1, R, T, img0.shape,
                                                                          device)
                                b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
                                H, W = img0.shape
                                extras = {"launches": launches, "frame": (i, recorder), "pipe": pipe}
                                if graphs:
                                    ring = frame_graphs.ring_for(slot, device, (H, W), b_img.dtype, pipe.cfg,
                                                                 geom_key, gp)
                                    inst = ring.instance(frame_graphs.instance_index(i, n_slots, depth))
                                    gp = ring.geom_pack
                                    extras["done"] = inst.done
                            if graphs:
                                with span("loop.upload"):
                                    b8, m8 = inst.upload(b_img, m_img)
                                with span("loop.rectify"):
                                    base_rect, match_rect = inst.rectify(ring)
                                with span("dense.frame"):
                                    c2f = inst.dense(ring, pipe).c2f
                                    res = inst.finish(ring, pipe)
                            else:
                                with span("loop.upload"):
                                    # uint8 upload from pinned memory.
                                    b8, m8 = (to_device(torch.from_numpy(x), device) for x in (b_img, m_img))
                                with span("loop.rectify"):
                                    base_rect, match_rect = rectify_pair(b8, m8, gp, (H, W))
                                res = pipe(base_rect, match_rect, gp)
                                c2f = pipe.last_c2f
                            with span("loop.submit"):
                                extras.update(c2f=c2f, rect=(base_rect, match_rect), imgs=(b8, m8), gp=gp)
                                if on_card:
                                    extras["ready"] = torch.cuda.Event()
                                    extras["ready"].record()
                                inflight.append((i, writers.submit(finalize, wd, geom, res, K0, K1, extras)))
                        # Bound the slot's frames in flight; the oldest one's
                        # writer has usually finished by now.
                        with span("loop.writer_wait"):
                            while len(inflight) > depth:
                                pop_oldest(inflight)
            return inflight

        try:
            if len(local) == 1:
                pending = [dispatch_slot(local[0])]
            else:
                with ThreadPoolExecutor(max_workers=len(local), thread_name_prefix="frame-slot") as slots:
                    pending = list(slots.map(dispatch_slot, local))
            with span("loop.drain"):
                for inflight in pending:
                    while inflight:
                        pop_oldest(inflight)
        finally:
            with span("loop.drain"):
                writers.shutdown(wait=True)
                prefetcher.close()
        if world_size() > 1:
            with span("loop.drain"):
                for part in all_gather_host({i: p for i, p in enumerate(planes) if p is not None}):
                    for i, plane in part.items():
                        planes[i] = plane
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
