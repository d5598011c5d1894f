"""Build and bind the port's CUDA kernels.

All `csrc/*.cu` files are compiled by `nvcc`, one process per source, all
started together, and linked into one shared library with a plain C
interface, keyed by a hash of the sources and flags, at first use, and
loaded with `ctypes` (no PyTorch headers, so a build takes seconds).
The library lands in `wass_tpu_torch/_build/`.  Every C entry point returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.

There is no fallback: a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math: the WTA subpixel division must be IEEE-rounded to
# match the plain version bit for bit.  ptxas reports each kernel's
# registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib = None
_c = ctypes
_PTR = _c.c_void_p
_INT = _c.c_int
# name -> argtypes of each C entry point (all return int: a cudaError_t).
_SIGNATURES = {
    "wass_census_cost": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR],
    "wass_census_cost_windowed": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    "wass_sgm_wta_fused": [_PTR, _PTR, _PTR] + [_INT] * 8 + [_PTR],
    "wass_sgm_wta_fused_windowed": [_PTR] * 4 + [_INT] * 7 + [_PTR],
    "wass_sgm_aggregate": [_PTR] * 2 + [_INT] * 6 + [_PTR],
    "wass_sgm_aggregate_windowed": [_PTR] * 3 + [_INT] * 6 + [_PTR],
    "wass_sgm_pair_img": [_PTR] * 3 + [_INT] * 5 + [_PTR],
    "wass_sgm_walk": [_PTR] * 6 + [_INT] * 9 + [_PTR],
    "wass_sgm_lane_width": [_INT],
    "wass_label_propagate": [_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR],
    "wass_iidyn": [_PTR] * 6 + [_INT, _c.c_float, _INT, _PTR],
    "wass_visibility_march": [_PTR] * 4 + [_INT] * 4 + [_PTR],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwass_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the kernels if the hashed library is missing.

    Returns (library path, compiler output); the output is empty when the
    library was already built."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(work / f"{src.stem}.o")]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for cmd, proc in jobs:
            text = proc.communicate()[0]
            logs.append(text)
            if proc.returncode != 0:
                for _, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        tmp = work / "lib.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{src.stem}.o") for src in sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout + proc.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, "".join(logs)


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _INT
            lib.wass_cuda_error_string.argtypes = [_INT]
            lib.wass_cuda_error_string.restype = _c.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().wass_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
