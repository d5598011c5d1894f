"""Temporal and spatial filtering of gridded elevation cubes.

Counterpart of wass_tpu/post/filters.py (the wasspost `filter`,
`filter_fast` and `spatial_lowpass` commands, wasspost.py:149-371):

* temporal_butterworth: zero-phase Butterworth (scipy sosfiltfilt) along
  the time axis, on the host in float64 as in the JAX package;
* spatial_butterworth_lowpass: the radial frequency-domain 2D Butterworth
  (Spatial2DButterworth, spectra.py:176-202) on every frame, float32 FFTs
  on the device;
* zero_mean: the per-point temporal zero-mean.
"""

from __future__ import annotations

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device


def temporal_butterworth(data: np.ndarray, fps: float, cutoff_hz: float = 1.0, order: int = 8,
                         kind: str = "lowpass") -> np.ndarray:
    """Zero-phase temporal Butterworth over a (T, H, W) cube (NaN-safe:
    NaNs are mean-filled before filtering and restored after)."""
    from scipy import signal

    T = data.shape[0]
    flat = np.asarray(data, np.float64).reshape(T, -1)
    nanmask = np.isnan(flat)
    colmean = np.nan_to_num(np.nanmean(np.where(nanmask, np.nan, flat), axis=0))
    filled = np.where(nanmask, colmean[None, :], flat)
    sos = signal.butter(order, cutoff_hz, btype="low" if kind == "lowpass" else "high", fs=fps, output="sos")
    out = signal.sosfiltfilt(sos, filled, axis=0)
    out = np.where(nanmask, np.nan, out)
    return out.reshape(data.shape)


def spatial_butterworth_kernel(H: int, W: int, du: float, cutoff: float, order: int = 4) -> np.ndarray:
    fx = np.fft.fftshift(np.fft.fftfreq(W, d=du))
    fy = np.fft.fftshift(np.fft.fftfreq(H, d=du))
    FX, FY = np.meshgrid(fx, fy)
    R = np.sqrt(FX**2 + FY**2)
    return 1.0 / np.sqrt(1.0 + (R / cutoff) ** (2 * order))


def spatial_butterworth_lowpass(frames: np.ndarray, du: float, cutoff: float, order: int = 4,
                                device="cuda") -> np.ndarray:
    """The 2D radial Butterworth on (T, H, W) or (H, W) data; NaN cells
    are filtered as zeros and stay NaN."""
    dev = resolve_device(device)
    single = frames.ndim == 2
    cube = frames[None] if single else frames
    T, H, W = cube.shape
    filt = torch.as_tensor(np.fft.ifftshift(spatial_butterworth_kernel(H, W, du, cutoff, order)).astype(np.float32),
                           device=dev)
    x = torch.as_tensor(np.nan_to_num(cube).astype(np.float32), device=dev)
    out = torch.fft.ifft2(torch.fft.fft2(x) * filt[None]).real.cpu().numpy()
    out = np.where(np.isnan(cube), np.nan, out)
    return out[0] if single else out


def zero_mean(data: np.ndarray) -> np.ndarray:
    """Per-point temporal zero-mean (wasspost `zeromean`, wasspost.py:965-1005)."""
    return data - np.nanmean(data, axis=0, keepdims=True)
