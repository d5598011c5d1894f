"""The port runs without jax and without any module of the JAX package
(a dense frame, the stereo CLI, the grid console on its meshes, the post
console on that cube, and the match stage through the CLI), and without
h5py, imageio, matplotlib or click, which the GPU host lacks (click: the
port's consoles are argparse); its stdlib PNG codec agrees with imageio
and OpenCV."""

import ast
import io
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import imageio.v3 as iio
import numpy as np
import pytest

from wass_tpu_torch.io import png

ROOT = Path(__file__).resolve().parents[1]

# The JAX package's modules the port may import: none (it keeps its own
# copies of the host modules it needs).
SHARED = ()


def _shared(name: str) -> bool:
    return any(name == s or name.startswith(s + ".") for s in SHARED)


_NOJAX_RUN = r"""
import importlib.abc, sys, tempfile
from pathlib import Path

SHARED = %r

def shared(name):
    return any(name == s or name.startswith(s + ".") for s in SHARED)

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "h5py", "imageio", "matplotlib", "click") or (top == "wass_tpu" and not shared(name)):
            raise ImportError(f"{name} is refused in this process")
        return None

sys.meta_path.insert(0, _Refuse())
import numpy as np
import torch
torch.set_num_threads(2)  # the test workers share the host's cores
import wass_tpu_torch
import wass_tpu_torch.calib.autocalibrate
import wass_tpu_torch.cli.pipeline
import wass_tpu_torch.match.pipeline
import wass_tpu_torch.grid.outliers
from wass_tpu_torch.cli.gridsurface import main as grid_main
from wass_tpu_torch.cli.main import main
from wass_tpu_torch.cli.post import main as post_main
from wass_tpu_torch.grid.netcdf import NetCDFReader, NetCDFWriter
from wass_tpu_torch.grid.setup import GridSetup
from wass_tpu_torch.grid.setup import align_on_sea_plane
from wass_tpu_torch.testing import make_scene, read_frame, write_sequence
from wass_tpu_torch.stereo.dense import DenseStereoConfig, dense_stereo_frame

sc = make_scene(seed=3, width=64, height=48, wave_amplitude=0.2)
rig = sc.rig
res, geom = dense_stereo_frame(sc.img0, sc.img1, rig.K0, rig.K1, rig.R, rig.T,
                               DenseStereoConfig(num_disp=16, plane_ransac_rounds=50), device="cpu")
assert res.points.shape == (48, 64, 3) and int(res.n_points) > 0
with tempfile.TemporaryDirectory() as tmp:
    seq = Path(tmp)
    write_sequence(seq, sc.img0, sc.img1, rig, 1)
    (seq / "stereo_config.txt").write_text("MAX_DISPARITY=16\nPLANE_RANSAC_ROUNDS=50\n")
    assert main(["stereo", str(seq), "--device", "cpu"]) == 0
    plane, mesh, _ = read_frame(seq / "000000_wd")
    assert mesh.shape[1] == 3 and len(mesh) > 0
    ma = align_on_sea_plane(mesh.T, plane) * 2.5
    cx, cy = np.median(ma[:2], axis=1)
    grid = seq / "grid"
    assert grid_main([str(seq), str(grid), "--action", "setup", "--baseline", "2.5", "--area_center",
                      f"{cx},{cy}", "--area_size", "4", "-N", "16", "--device", "cpu"]) == 0
    assert grid_main([str(seq), str(grid), "--action", "grid", "--device", "cpu"]) == 0
    with NetCDFReader(grid / "gridded.nc") as cube:
        assert cube.Z.shape == (1, 16, 16) and np.isfinite(cube.Z[...]).any()
        z0 = np.nan_to_num(cube.Z[0])
    # The post console on a 32-frame cube of that grid (the order-8 filter
    # needs more than 27 frames): the frame scaled a little more each frame.
    st = GridSetup.load_mat(grid / "config.mat")
    nc = grid / "long.nc"
    w = NetCDFWriter(nc, M=16, N=16, count=32)
    w.set_grids(st.XX * 1000.0, st.YY * 1000.0)
    w.set_intrinsics(st.K0, st.K1, np.zeros(5), np.zeros(5), st.P0plane, st.P1plane, st.P0cam[:3], st.P1cam[:3],
                     st.Cam0toGrid, st.Cam1toGrid)
    w.add_meta_attribute("fps", 4.0)
    for i in range(32):
        w.push_Z(z0.T * (1 + 0.1 * i), time=i / 4.0, workdir=i)
    w.close()
    for cmd in (["info"], ["spectrum", "--nperseg", "8", "--rangespan", "2"], ["visibilitymap"], ["filter"]):
        assert post_main([cmd[0], str(nc), *cmd[1:], "--device", "cpu"]) == 0
    with NetCDFReader(nc) as cube:
        assert cube["Z_filtered"].shape == cube["occlusion_cam0"].shape == (32, 16, 16)
with tempfile.TemporaryDirectory() as tmp:
    seq = Path(tmp)
    sc = make_scene(seed=3, width=256, height=192, wave_amplitude=0.25)
    write_sequence(seq, sc.img0, sc.img1, sc.rig, 1)
    (seq / "matcher_config.txt").write_text(
        "NUM_FEATURES_PER_IMAGE=400\nMATCHER_MAX_ROUNDS=4\nFEATURE_HESSIAN_THRESHOLD=3e-5\nFEATURE_MIN_DISTANCE=8\n")
    assert main(["match", str(seq), "--device", "cpu"]) == 0
    n_matches = int((seq / "000000_wd" / "matcher_stats.csv").read_text().splitlines()[1].split(";")[0])
    assert n_matches > 8
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "wass_tpu", "h5py", "imageio", "matplotlib", "click")]
assert all(shared(m) for m in loaded), loaded
print("OK", int(res.n_points), len(mesh), n_matches)
""" % (SHARED,)


def test_port_runs_without_jax():
    """jax, every module of the JAX package, h5py, imageio, matplotlib and
    click are refused at import; a frame, the stereo CLI, the grid console
    (setup and grid), the post console (info, spectrum, visibilitymap,
    filter) and the match CLI still run, and the match, calibration and
    grid modules import."""
    proc = subprocess.run([sys.executable, "-c", _NOJAX_RUN], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1].startswith("OK")


def test_no_jax_import_statements():
    for path in [ROOT / "chip_smoke.py", *sorted((ROOT / "wass_tpu_torch").rglob("*.py"))]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [f"{node.module}.{a.name}" for a in node.names]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "h5py", "imageio", "matplotlib", "click"), f"{path}: imports {name}"
                assert top != "wass_tpu" or _shared(name), f"{path}: imports {name}"


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (48, 64)])
def test_png_roundtrip_against_imageio(rng, tmp_path, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "a.png"
    png.write_gray(path, img)
    np.testing.assert_array_equal(iio.imread(path), img)
    path2 = tmp_path / "b.png"
    iio.imwrite(path2, img)
    np.testing.assert_array_equal(png.read_gray(path2), img)


def _encode_with_filter(img: np.ndarray, ftypes) -> bytes:
    """A grayscale PNG whose row y uses the filter type ftypes[y] (0..4)."""
    H, W = img.shape
    x = img.astype(np.int64)
    rows = []
    for y, ftype in enumerate(ftypes):
        prev = x[y - 1] if y else np.zeros(W, np.int64)
        out = np.zeros(W, np.int64)
        for i in range(W):
            a = x[y, i - 1] if i else 0
            b = prev[i]
            c = prev[i - 1] if i else 0
            pred = [0, a, b, (a + b) >> 1, png._paeth(a, b, c)][ftype]
            out[i] = (x[y, i] - pred) & 0xFF
        rows.append(bytes([ftype]) + out.astype(np.uint8).tobytes())

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, None])
def test_png_decodes_every_filter(rng, ftype):
    """One filter type on every row, or (None) a random type per row."""
    img = rng.integers(0, 256, size=(9, 17), dtype=np.uint8)
    ftypes = rng.integers(0, 5, size=9) if ftype is None else [ftype] * 9
    data = _encode_with_filter(img, ftypes)
    np.testing.assert_array_equal(png.decode_gray(data), img)
    np.testing.assert_array_equal(iio.imread(io.BytesIO(data)), img)


def test_png_decodes_opencv_adaptive_filters():
    yy, xx = np.mgrid[0:60, 0:90]
    img = (127 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.uint8)
    ok, data = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(png.decode_gray(data.tobytes()), img)


def test_png_rejects_colour(rng):
    rgb = rng.integers(0, 256, size=(4, 5, 3), dtype=np.uint8)
    buf = io.BytesIO()
    iio.imwrite(buf, rgb, extension=".png")
    with pytest.raises(ValueError, match="colour type 2"):
        png.decode_gray(buf.getvalue())
