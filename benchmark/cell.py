"""One run of one cell: set-up, the measured window, the traced metrics
and the correctness check.

Set-up loads the program's kernel library (built on a checkout's first
run; its seconds are printed apart), traces the traffic's distinct pairs
on the device (consecutive frames of the configuration's sea from a start
the seed draws), writes them once as PNG with the rig's intrinsics and
extrinsics, and links them into frame workdirs (pair i % pairs in frame
i).  It loads the pipeline as the console does
(wass_tpu_torch.cli.main.load_pipeline), applies the traffic's library
settings, and warms it up with one stereo() pass over two cycles of the
pairs: that resolves the AUTO smoothing and the wire probe as a
sequence's first call does.  The window is one stereo() call over a fixed
number of frames, N: the traffic's nominal megapixels a second over the
frame's megapixels, times the seconds asked for, in whole cycles of the
pairs, capped so that the run's files stay under the traffic's disk cap.
N depends on nothing measured, so every run does the same work.  Before
the window the warm-up's files are removed and the dirty pages written
back (os.sync: no cache is dropped), so no writeback of set-up runs in
it.  After the window the program is freed and the plain reference
recomputes a sample of the window's frames drawn from the seed, of both
parities (the loop's two writers, a pool, take alternate frames as a
rule), which the written files are held to (compare.py).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import re
import resource
import shutil
import sys
import time
import types
from pathlib import Path

import cv2
import numpy as np
import torch

import compare
import peaks
import scene
import spec as spec_mod
import trace as trace_mod
from reference import options as ref_options
from reference import pipeline as ref_pipeline
from reference import xyzc
from reference.precision import lower

FORBIDDEN = ("jax", "jaxlib", "flax", "wass_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not load, each
    compared whole (wass_tpu_torch is not wass_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Quiet:
    """A progress stream for stereo() that keeps nothing."""

    def write(self, text: str) -> None:
        pass

    def flush(self) -> None:
        pass


def _xml(name: str, M: np.ndarray) -> str:
    """A float64 matrix as OpenCV FileStorage XML (the workdir format)."""
    rows, cols = M.shape
    data = " ".join(repr(float(v)) for v in M.reshape(-1))
    return (f'<?xml version="1.0"?>\n<opencv_storage>\n<{name} type_id="opencv-matrix">\n  <rows>{rows}</rows>\n'
            f"  <cols>{cols}</cols>\n  <dt>d</dt>\n  <data>\n    {data}</data></{name}>\n</opencv_storage>\n")


def _link(src: Path, dst: Path) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def tree_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def parse_log(path: Path) -> dict:
    """A frame's wass_stereo_log.txt: finalize seconds, the c2f decision
    (None without c2f), kernel launches, and whether the frame failed."""
    out = {"finalize_s": None, "fallback": None, "launches": {}, "failed_gate": False}
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        if "kernel launches:" in line:
            out["launches"] = {k: int(v) for k, v in (kv.split("=") for kv in line.split("kernel launches:")[1].split())}
        elif "c2f window coverage:" in line:
            out["fallback"] = "FALLBACK" in line
        elif "finalize wall time:" in line:
            out["finalize_s"] = float(re.search(r"finalize wall time: ([0-9.]+)s", line).group(1))
        elif "FRAME FAILED" in line:
            out["failed_gate"] = True
    return out


def frame_times(traffic: dict, seed: int) -> list:
    """The acquisition times of the traffic's pairs: consecutive frames at
    acquisition_hz from a start drawn from the seed within the recording.
    Every seed sees the configuration's one sea state, so the work a frame
    asks for is alike from seed to seed; the surfaces differ."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 2])
    t0 = float(rng.uniform(0.0, traffic["recording_s"]))
    return [t0 + k / traffic["acquisition_hz"] for k in range(traffic["pairs"])]


class Inputs:
    """The traffic's pairs of one sea, as 8-bit images and as the workdir
    files the program reads."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, work: Path):
        self.rig = scene.rig_from_config(config)
        self.sea = scene.Sea(config["sea_seed"], self.rig, device, config["wave_amplitude"],
                             config.get("texture_octaves", 7))
        self.times = frame_times(traffic, seed)
        self.pairs = []
        self.files = work / "pairs"
        self.files.mkdir(parents=True)
        for k, t in enumerate(self.times):
            img0, img1, _ = self.sea.pair(t)
            pair = (scene.to_u8(img0), scene.to_u8(img1))
            self.pairs.append(pair)
            for cam, img in enumerate(pair):
                ok, buf = cv2.imencode(".png", img)
                if not ok:
                    raise RuntimeError("OpenCV cannot encode a PNG")
                (self.files / f"p{k:03d}_{cam}.png").write_bytes(buf.tobytes())
        mats = {"intrinsics_00000000.xml": ("intr", self.rig.K0), "intrinsics_00000001.xml": ("intr", self.rig.K1),
                "ext_R.xml": ("ext_R", self.rig.R), "ext_T.xml": ("ext_T", self.rig.T.reshape(3, 1))}
        for fname, (node, M) in mats.items():
            (self.files / fname).write_text(_xml(node, np.asarray(M, np.float64)))
        self.mat_names = list(mats)

    def workdirs(self, seq: Path, prefix: str, n: int) -> list:
        paths = []
        for i in range(n):
            k = i % len(self.pairs)
            wd = seq / f"{prefix}{i:06d}_wd"
            (wd / "undistorted").mkdir(parents=True)
            for cam in (0, 1):
                _link(self.files / f"p{k:03d}_{cam}.png", wd / "undistorted" / f"{cam:08d}.png")
            for fname in self.mat_names:
                _link(self.files / fname, wd / fname)
            paths.append(wd)
        return paths


def window_frames(seconds: float, n_pairs: int, mpx_per_s: float, mpx: float, frame_bytes: float,
                  budget: float) -> tuple:
    """(N, capped): whole cycles of the pairs covering the traffic's nominal
    rate (mpx_per_s over the frame's mpx megapixels) x seconds, at most
    what the disk budget holds (at least one cycle)."""
    n = max(n_pairs, n_pairs * math.ceil(seconds * mpx_per_s / mpx / n_pairs))
    cap = max(n_pairs, n_pairs * int(budget // max(frame_bytes, 1.0) // n_pairs))
    return (cap, True) if n > cap else (n, False)


def compared_frames(rng, n: int, n_pairs: int, k: int) -> list:
    """k window frames of distinct pairs, their parities alternating, each
    in a cycle drawn from rng."""
    by_parity = [list(rng.permutation(np.arange(p, n_pairs, 2))) for p in (0, 1)]
    pairs = [int(by_parity[j % 2].pop()) for j in range(min(k, n_pairs))]
    return sorted(p + n_pairs * int(rng.integers(0, n // n_pairs)) for p in pairs)


def cpu_seconds() -> float:
    """The process's CPU seconds so far, user and system."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(spec: dict, seed: int, seconds: float, trace: bool, work: Path, device="cuda", chips: int = 1,
        t_start=None) -> dict:
    """One run of the cell `spec` (spec.load); returns the result object."""
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.io.workdir import Workdir

    t_run = time.perf_counter()
    t_start = t_run if t_start is None else t_start
    config, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    on_card = torch.device(device).type == "cuda"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    try:
        t_cuda = time.perf_counter()
        if on_card:
            torch.empty(1, device=device)  # the CUDA context
            torch.cuda.synchronize()
        t_lib = time.perf_counter()
        t_cuda = t_lib - t_cuda
        built = False
        if on_card:
            from wass_tpu_torch import _build

            built = not _build.library_path().exists()
            _build.load()
        t_lib = time.perf_counter() - t_lib
        log(f"kernel library: {'built and loaded' if built else 'loaded'} in {t_lib:.3f} s (part of setup_s)")
        inputs = Inputs(config, traffic, seed, device, work)
        seq = work / "seq"
        seq.mkdir()
        (seq / "stereo_config.txt").write_text(ref_options.stereo_config_text(config.get("stereo", {})))
        warm = [Workdir(p) for p in inputs.workdirs(seq, "warmup", traffic["warmup_frames"])]
        t_inputs = time.perf_counter()
        pipe = load_pipeline(seq, device=device)
        for key, value in traffic.get("library", {}).items():
            setattr(pipe.cfg, key, value)
        for key, value in config.get("loop", {}).items():
            if getattr(pipe.cfg, key) != value:
                raise ValueError(f"the configuration runs the loop at {key} = {value}, load_pipeline builds "
                                 f"{getattr(pipe.cfg, key)}")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t_load = time.perf_counter()
        pipe.stereo(warm, progress_stream=Quiet())
        t_warm = time.perf_counter()
        frame_bytes = sum(tree_bytes(w.path) for w in warm) / len(warm)
        budget = traffic["disk_cap_bytes"] - tree_bytes(work)
        n, capped = window_frames(seconds, traffic["pairs"], traffic["window_megapixels_per_s"],
                                  config["width"] * config["height"] / 1e6, frame_bytes, budget)
        wds = [Workdir(p) for p in inputs.workdirs(seq, "", n)]
        for w in warm:
            shutil.rmtree(w.path)
        os.sync()
        log(f"set-up: imports {t_run - t_start:.3f} s, CUDA context {t_cuda:.3f} s, kernel library {t_lib:.3f} s, "
            f"inputs {t_inputs - t_run - t_cuda - t_lib:.3f} s, pipeline loaded {t_load - t_inputs:.3f} s, warm-up "
            f"{t_warm - t_load:.3f} s ({len(warm)} frames), window workdirs and writeback "
            f"{time.perf_counter() - t_warm:.3f} s; {frame_bytes:.0f} bytes a frame; window {n} frames"
            + (" (the disk cap binds)" if capped else ""))
        gc.collect()
        sync(device)

        cpu0 = cpu_seconds()
        t_w0 = time.perf_counter()
        with trace_mod.profiled(trace) as prof:
            with torch.profiler.record_function(trace_mod.WINDOW):
                pipe.stereo(wds, progress_stream=Quiet())
        t_w1 = time.perf_counter()
        window_s = t_w1 - t_w0
        cpu = cpu_seconds() - cpu0
        log(f"host over the window: the process {cpu:.3f} CPU s, {cpu / n:.4f} a frame ({cpu / window_s:.2f} cores); "
            f"torch threads {torch.get_num_threads()}, OpenCV threads {cv2.getNumThreads()}")
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        loop_stats = {k: list(v) for k, v in pipe.loop_stats.items()}
        sigma = pipe.cfg.stereo.input_smooth_sigma
        renders = bool(pipe.cfg.debug_renders)
        del pipe
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        summary = trace_mod.summarize(prof) if trace else None
        del prof

        frames, missing, failed = [], 0, 0
        for wd in wds:
            info = parse_log(wd.path / "wass_stereo_log.txt")
            frames.append(info)
            if not compare.frame_written(wd.path, renders):
                missing += 1
                failed += 1
            elif info["failed_gate"] or not np.all(np.isfinite(compare.read_plane(wd.path / "plane.txt"))):
                failed += 1
        written = tree_bytes(work)
        means = {k: 1e3 * sum(v) / len(v) for k, v in loop_stats.items() if v}
        log("loop: " + ", ".join(f"{k} mean {v:.3f} ms" for k, v in means.items())
            + f"; window {window_s:.3f} s for {n} frames")
        log(f"disk: {written} bytes written (inputs and outputs); disk cap {traffic['disk_cap_bytes']:.0f}, "
            f"the frame cap {'binds' if capped else 'does not bind'}")

        # The correctness check on a sample of the window's frames.
        cfg = ref_options.stereo_config(config.get("stereo", {}))
        ref_options.check_fixed(cfg, config.get("dense_fixed", {}))
        t_sigma = time.perf_counter()
        cfg = dataclasses.replace(cfg, input_smooth_sigma=ref_pipeline.smooth_sigma(cfg, inputs.pairs[0][0]))
        log(f"AUTO smoothing: sigma {cfg.input_smooth_sigma} from the first pair's cam0 image, the degradation "
            f"estimate {time.perf_counter() - t_sigma:.3f} s on the host")
        if cfg.input_smooth_sigma != sigma:
            log(f"note: the program smoothed with sigma {sigma}, the reference with {cfg.input_smooth_sigma}")
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 1])
        chosen = compared_frames(rng, n, traffic["pairs"], traffic["compare_frames"])
        readings, errors, spent = [], [], {"reference": 0.0, "comparison": 0.0, "accuracy": 0.0}
        for i in chosen:
            pk = i % traffic["pairs"]
            img0, img1 = inputs.pairs[pk]
            t = time.perf_counter()
            ref = ref_pipeline.frame(img0, img1, inputs.rig.K0, inputs.rig.K1, inputs.rig.R, inputs.rig.T, cfg, device)
            ref_images = ref_pipeline.renders(ref) if renders else None
            sync(device)
            spent["reference"] += time.perf_counter() - t
            wd = wds[i].path
            if compare.frame_written(wd, renders):
                t = time.perf_counter()
                r = compare.compare_frame(wd, ref, device, ref_images)
                mesh = compare.read_mesh(wd / "mesh_cam.xyzC")
                plane = compare.read_plane(wd / "plane.txt")
                del ref
                spent["comparison"] += time.perf_counter() - t
                if len(mesh) and np.all(np.isfinite(plane)):
                    t = time.perf_counter()
                    _, _, gt = inputs.sea.pair(inputs.times[pk], with_points=True)
                    errors.append(scene.elevation_error(gt, inputs.rig.K0, inputs.rig.baseline, mesh, plane))
                    del gt
                    spent["accuracy"] += time.perf_counter() - t
            else:
                del ref
                r = {"plane_gap": compare.MISSING, "mesh_gap": compare.MISSING, "rows_off": 1.0}
                if renders:
                    r["render_gap"] = 256.0
            readings.append(r)
            if on_card:
                torch.cuda.empty_cache()
        numbers = compare.worst(readings)
        numbers["frames_missing"] = float(missing)
        correct, checks = compare.verdict(numbers, limits)
        log(f"accuracy: trimmed-mean elevation error of the compared frames {chosen}: "
            + ", ".join(repr(e) for e in errors) + " (verify_meshes gate < 0.02, baseline units)")
        log(f"reference: {len(chosen)} frames in {spent['reference']:.3f} s; comparison {spent['comparison']:.3f} s, "
            f"accuracy line {spent['accuracy']:.3f} s")

        ctx = types.SimpleNamespace(frames=frames, loop_stats=loop_stats, trace=summary, n_frames=n,
                                    stereo=cfg, shape=(config["height"], config["width"]),
                                    peaks=peaks.card() if (trace and on_card) else {})
        metrics = {}
        if trace:
            for m in spec["per_layer"]:
                v = spec_mod.metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = {"frames_per_s": n / window_s, "setup_s": t_w0 - t_start}
            for m in spec["end_to_end"]:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        result = {"correct": bool(correct), "attempted": n, "failed": failed, "metrics": metrics,
                  "device": {"platform": "gpu" if on_card else "cpu",
                             "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                             "count": chips, "memory_peak_bytes": int(memory_peak)}}
        if trace:
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_frame(wd: Path, out: dict, images) -> None:
    """A reference frame's files as the program's writers write them:
    plane.txt, mesh_cam.xyzC from its u16 rows, the renders as JPEG."""
    wd.mkdir(parents=True, exist_ok=True)
    xyzc.save_plane(wd / "plane.txt", out["plane"])
    if out["rows"] is not None:
        xyzc.save_xyz_quantized(wd / "mesh_cam.xyzC", out["rows"], out["scales"], out["mins"], out["Rinv"],
                                out["Tinv"])
    for name, img in (images or {}).items():
        (wd / name).write_bytes(ref_pipeline.jpeg_bytes(img))


def control_readings(spec: dict, seed: int, device, frames: int, work: Path) -> list:
    """The control's numbers: the reference computed one precision lower
    (reference/precision.py) put in the program's place, its files written
    as the program's writers write them, and those files compared with the
    reference as a run compares the program's (compare.compare_frame), on
    `frames` pairs of the seed's sea."""
    config, traffic = spec["config"], spec["traffic"]
    rig = scene.rig_from_config(config)
    sea = scene.Sea(config["sea_seed"], rig, device, config["wave_amplitude"], config.get("texture_octaves", 7))
    times = frame_times(traffic, seed)
    cfg = ref_options.stereo_config(config.get("stereo", {}))
    renders = bool(traffic.get("library", {}).get("debug_renders", True))
    out = []
    first = None
    try:
        for k in range(frames):
            img0, img1, _ = sea.pair(times[k % len(times)])
            img0, img1 = scene.to_u8(img0), scene.to_u8(img1)
            if first is None:
                first = img0
                cfg = dataclasses.replace(cfg, input_smooth_sigma=ref_pipeline.smooth_sigma(cfg, first))
            ref = ref_pipeline.frame(img0, img1, rig.K0, rig.K1, rig.R, rig.T, cfg, device)
            ref_images = ref_pipeline.renders(ref) if renders else None
            with lower():
                ctl = ref_pipeline.frame(img0, img1, rig.K0, rig.K1, rig.R, rig.T, cfg, device)
                ctl_images = ref_pipeline.render_images(ctl) if renders else None
            wd = work / f"control{k:03d}"
            write_frame(wd, ctl, ctl_images)
            del ctl
            out.append(compare.compare_frame(wd, ref, device, ref_images))
            shutil.rmtree(wd)
            del ref
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out
