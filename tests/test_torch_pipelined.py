"""The port's production stereo loop (cli/pipeline.py _stereo_loop)
and its host pieces, on the CPU: frame outputs independent of the dispatch
depth and the writer count, progress lines, the deferred c2f fallback,
decode errors, the thread-safe per-frame launch counts, the device-side
modal label, the PNG prefetcher (shared by the loop's slot threads),
and the progress text against the JAX
package's."""

import dataclasses
import io
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from wass_tpu.utils.progress import progress as jax_progress
from wass_tpu_torch.cli.main import load_pipeline
from wass_tpu_torch.io import png
from wass_tpu_torch.io.prefetch import Prefetcher
from wass_tpu_torch.instrument import LaunchCounts, Recorder, frame_scope
from wass_tpu_torch.ops.components import INT32_MAX, _modal_label
from wass_tpu_torch.testing import write_sequence
from wass_tpu_torch.testing.synthetic import make_rig, make_scene
from wass_tpu_torch.utils.progress import progress
from torch_registries import reset_registries  # noqa: F401  (autouse)

N_FRAMES = 4
# c2f at 256x192: windows of 32 disparities over num_disp 96.
CONFIG = "MAX_DISPARITY=96\n"
C2F = {"c2f_window": 32}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """4 frame workdirs of two scenes (one rig)."""
    root = tmp_path_factory.mktemp("pipelined")
    rig = make_rig(width=256, height=192)
    (root / "base").mkdir()
    for k in range(2):
        sc = make_scene(seed=60 + k, width=256, height=192, wave_amplitude=0.25, rig=rig, time=k * 0.3)
        for i, path in enumerate(write_sequence(root / f"scene{k}", sc.img0, sc.img1, rig, 2)):
            shutil.move(path, root / "base" / f"{2 * i + k:06d}_wd")
    (root / "base" / "stereo_config.txt").write_text(CONFIG)
    return root


def _run(base, name, depth=3, writers=2, override=C2F, stream=None):
    seq = base / name
    shutil.copytree(base / "base", seq)
    pipe = load_pipeline(seq, "cpu")
    pipe.cfg = dataclasses.replace(pipe.cfg, dispatch_depth=depth, writer_threads=writers,
                                   stereo=dataclasses.replace(pipe.cfg.stereo, **override))
    planes = pipe.stereo(progress_stream=stream)
    return seq, planes


def _frame_files(seq):
    """Every output file of every frame (the log without its wall time)."""
    out = {"planes.txt": (seq / "output" / "planes.txt").read_bytes()}
    for wd in sorted(seq.glob("*_wd")):
        for f in sorted(wd.iterdir()):
            if f.is_file():
                data = f.read_bytes()
                if f.name == "wass_stereo_log.txt":
                    data = b"\n".join(ln for ln in data.splitlines() if b"wall time" not in ln)
                out[f"{wd.name}/{f.name}"] = data
    return out


@pytest.fixture(scope="module")
def serial(base):
    """The loop at dispatch depth 1 with one writer."""
    stream = io.StringIO()
    seq, planes = _run(base, "serial", depth=1, writers=1, stream=stream)
    return seq, planes, stream.getvalue()


@pytest.mark.parametrize("depth,writers", [(3, 2), (2, 1)])
def test_outputs_independent_of_depth_and_writers(base, serial, depth, writers):
    seq, planes = _run(base, f"d{depth}w{writers}", depth, writers)
    ref = _frame_files(serial[0])
    got = _frame_files(seq)
    assert sorted(got) == sorted(ref) and len(ref) > 4 * 9
    for name in ref:
        assert got[name] == ref[name], name
    np.testing.assert_array_equal(np.array(planes), np.array(serial[1]))


def test_progress_lines_in_order_and_windowed(serial):
    seq, planes, text = serial
    assert text.splitlines() == [f"[P|{i}|{N_FRAMES}]" for i in range(1, N_FRAMES + 1)]
    assert len(planes) == N_FRAMES and all(np.isfinite(p).all() for p in planes)
    for wd in sorted(seq.glob("*_wd")):
        log = (wd / "wass_stereo_log.txt").read_text()
        assert "kernel launches: census=0 census_cost=0 " in log
        assert [ln.split("] ")[1].split()[-1] for ln in log.splitlines() if "c2f window coverage" in ln] == ["windowed"]


def test_returned_planes_are_the_frames_own(serial):
    """stereo() returns, and output/planes.txt holds, each frame's own plane
    (its plane.txt), though one writer reads every frame's export header
    into the same buffer."""
    seq, planes, _ = serial
    wds = sorted(seq.glob("*_wd"))
    rows = np.loadtxt(seq / "output" / "planes.txt")
    assert len(wds) == len(planes) == len(rows) == N_FRAMES
    for i, wd in enumerate(wds):
        own = np.loadtxt(wd / "plane.txt")
        np.testing.assert_array_equal(planes[i], own)
        np.testing.assert_array_equal(rows[i], own)
    assert len({tuple(p) for p in planes}) == 2  # the two scenes


def test_deferred_fallback_equals_full_range(base):
    """A frame whose guard trips (coverage never reaches 1.01) is re-run at
    full range by its writer: byte for byte the c2f_window = 0 frame, and
    its log says FALLBACK."""
    fb, _ = _run(base, "fallback", override={**C2F, "c2f_min_coverage": 1.01})
    full, _ = _run(base, "full", override={"c2f_window": 0})
    a, b = _frame_files(fb), _frame_files(full)
    for name in a:
        if name.endswith(("wass_stereo_log.txt", "stereo_config.txt")):
            continue  # the c2f line, and the config that differs on purpose
        assert a[name] == b[name], name
    for wd in sorted(fb.glob("*_wd")):
        assert "FALLBACK to full-range SGM" in (wd / "wass_stereo_log.txt").read_text()


def test_corrupt_png_raises(base):
    seq = base / "corrupt"
    shutil.copytree(base / "base", seq)
    (seq / "000002_wd" / "undistorted" / "00000001.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)
    pipe = load_pipeline(seq, "cpu")
    with pytest.raises(ValueError, match="00000001.png"):
        pipe.stereo(progress_stream=io.StringIO())


def test_prefetcher_takes_any_order_and_raises_in_take(tmp_path, rng):
    imgs = [rng.integers(0, 256, (5 + i, 7), dtype=np.uint8) for i in range(6)]
    for i, img in enumerate(imgs):
        png.write_gray(tmp_path / f"{i}.png", img)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    good = png.encode_gray(imgs[0])
    (tmp_path / "cut.png").write_bytes(good[:-30] + good[-12:])  # IDAT cut short, IEND kept
    rec = Recorder(each={"prefetch.decode": "decode_s"})
    with frame_scope({}, 0, rec), Prefetcher(3) as pf:
        tickets = [pf.submit(tmp_path / f"{i}.png", frame=i) for i in range(6)]
        bad, cut = pf.submit(tmp_path / "bad.png", frame=6), pf.submit(tmp_path / "cut.png", frame=7)
        for i in (5, 0, 3, 1, 4, 2):
            np.testing.assert_array_equal(pf.take(tickets[i]), imgs[i])
        with pytest.raises(ValueError, match="bad.png"):
            pf.take(bad)
        with pytest.raises(ValueError, match="cut.png: corrupt PNG image data"):
            pf.take(cut)
    stats = rec.stats()
    assert len(stats["decode_s"]) == 8 and len(stats["prefetch.decode"]) == 8 and min(stats["decode_s"]) > 0


def test_prefetcher_under_many_threads(tmp_path, rng):
    """24 threads, more than the cores, submit and take at once with a
    short switch interval: every ticket gives its own image (a ticket lost
    to a race would give another's, or none)."""
    imgs = [rng.integers(0, 256, (4, 3 + i), dtype=np.uint8) for i in range(8)]
    for i, img in enumerate(imgs):
        png.write_gray(tmp_path / f"{i}.png", img)
    wrong, errors = [], []

    def work(k, pf):
        try:
            for n in range(40):
                i = (k + n) % len(imgs)
                if not np.array_equal(pf.take(pf.submit(tmp_path / f"{i}.png", frame=k)), imgs[i]):
                    wrong.append((k, n))
        except Exception as e:  # the test thread reports it
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with Prefetcher(4) as pf:
            threads = [threading.Thread(target=work, args=(k, pf)) for k in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == [] and wrong == []


def _png_with_filters(img, ftypes):
    """PNG bytes of an (H, W) uint8 image, row y filtered with ftypes[y]."""
    import struct
    import zlib

    x = img.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, png._paeth(a, b, c)]
    pred = np.choose(np.broadcast_to(ftypes[:, None], x.shape), preds)
    raw = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    raw[:, 0] = ftypes
    raw[:, 1:] = (x - pred) & 0xFF
    ihdr = struct.pack(">IIBBBBB", x.shape[1], x.shape[0], 8, 0, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (0, 1), (0, 1, 2), (0, 1, 2, 3, 4), "cv2"],
                         ids=["none", "none_sub", "none_sub_up", "all", "cv2"])
def test_png_decode_every_row_filter(rng, kinds):
    """The decoder's three paths (None/Sub rows at once, Up rows one after
    another, Average/Paeth by anti-diagonals) on rows of mixed filters, and
    on OpenCV's adaptively filtered PNG."""
    import cv2

    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    img[5:20, 10:40] = 77  # flat rows, where the predictors differ most
    if kinds == "cv2":
        data = cv2.imencode(".png", img)[1].tobytes()
    else:
        data = _png_with_filters(img, rng.choice(kinds, img.shape[0]).astype(np.uint8))
    np.testing.assert_array_equal(png.decode_gray(data), img)


def test_launch_counts_under_threads():
    """Many threads bump shared counts, each inside its own frame scope,
    with a short switch interval: no update is lost, and each scope holds
    exactly its own thread's launches."""
    counts = LaunchCounts({"a": 0, "b": 0})
    scopes = [{} for _ in range(16)]

    def work(k):
        with frame_scope(scopes[k]):
            for _ in range(500):
                counts.add("a")
                if k % 2:
                    counts.add("b")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts == {"a": 16 * 500, "b": 8 * 500}
    for k, scope in enumerate(scopes):
        assert scope == ({"a": 500, "b": 500} if k % 2 else {"a": 500})
    counts.reset()
    assert counts == {"a": 0, "b": 0}


def _modal_label_by_sort(labels, valid):
    """The earlier host version: sort, run lengths, first longest run."""
    if labels.numel() > (1 << 20):
        labels, valid = labels[::4, ::4], valid[::4, ::4]
    flat = labels[valid]
    if flat.numel() == 0:
        return INT32_MAX
    values, counts = torch.unique_consecutive(torch.sort(flat).values, return_counts=True)
    return int(values[torch.argmax(counts)])


@pytest.mark.parametrize("shape", [(40, 56), (1030, 1024)])
def test_modal_label_matches_sort(rng, shape):
    """Random label maps (labels are linear indices of the grid), ties
    between the two largest components included, and the empty mask."""
    H, W = shape
    n = H * W
    for trial in range(6):
        k = int(rng.integers(1, 6))
        roots = np.sort(rng.choice(n, k, replace=False))
        labels = torch.from_numpy(roots[rng.integers(0, k, shape)].astype(np.int32))
        valid = torch.from_numpy(rng.random(shape) < 0.7)
        if trial == 0:  # a tie: two labels, the same count on the voting grid
            grid = valid[::4, ::4] if n > (1 << 20) else valid
            lab = labels[::4, ::4] if n > (1 << 20) else labels
            flat = torch.zeros(grid.numel(), dtype=torch.int32)
            flat[::2] = int(roots[-1])
            flat[1::2] = int(roots[0])
            lab.copy_(flat.reshape(lab.shape))
            grid.fill_(True)
        assert int(_modal_label(labels, valid)) == _modal_label_by_sort(labels, valid)
    empty = torch.zeros(shape, dtype=torch.bool)
    assert int(_modal_label(labels, empty)) == INT32_MAX == _modal_label_by_sort(labels, empty)


def test_progress_and_timer_text_match_jax():
    a, b = io.StringIO(), io.StringIO()
    for cur, tot in ((1, 4), (4, 4), (0, 100)):
        progress(cur, tot, stream=a)
        jax_progress(cur, tot, stream=b)
    assert a.getvalue() == b.getvalue() == "[P|1|4]\n[P|4|4]\n[P|0|100]\n"
