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


def resolve_device(name) -> torch.device:
    """The device an entry point runs on: "cuda" (the default of the
    entry points) needs a card and raises without one; "cpu" is asked
    for explicitly (the tests)."""
    device = torch.device(name)
    if device.type == "cuda":
        return require_cuda(device.index or 0)
    return device


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


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the device: on CUDA a
    copy from pinned memory, enqueued on the current stream (a copy from
    pageable memory synchronizes the stream first)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
