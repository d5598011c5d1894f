"""Device selection and numeric settings for the port.

The plain PyTorch versions of the kernels serve CPU tensors only (the
tests); the main path on a card needs CUDA and never falls back to the
CPU.  TF32 is off for matmuls and convolutions: the plane fit asks for
full float32 products (wass_tpu/stereo/plane.py, HIGHEST precision).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device to run on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("wass_tpu_torch needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", index)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors all lie on one CUDA device, False when they
    all lie on the CPU; raises on any other mix.  Kernel wrappers launch
    their kernel on True and run the plain version on False."""
    devices = {t.device for t in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got {sorted(map(str, devices))}")
