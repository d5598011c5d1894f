"""Wave spectra: the Welch frequency spectrum, its integral parameters, and
the 3D wavenumber-frequency spectrum.

Counterpart of wass_tpu/post/spectra.py (after the reference's
postproc/wasspost/spectra.py:9-171 and wasspost.py:415-433).  The FFTs
run in float32 on the device with torch.fft, as the JAX package's jnp.fft
runs them in float32 (x64 off: jnp.asarray of float64 data is float32);
the segment loop, the patch read and the float64 accumulation of the 3D
Welch sum stay on the host.  `data` may be a dataset of the port's HDF5
reader: only the patch (or one Welch segment) is read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device


def _hann(n: int) -> np.ndarray:
    """scipy.signal.windows.hann (symmetric), as the reference."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))


def compute_spectrum(data, dt: float, nperseg: int = 512, rangespan: int = 5, scale: float = 1.0, device="cuda"):
    """Averaged Welch PSD over the central (2*rangespan+1)^2 grid points.

    data: (T, H, W) elevation cube (NaN allowed; series are mean-filled).
    Returns (f, S, center_timeseries): one-sided density (Hann window, 50%
    overlap), the centre series counted twice as in the reference.
    """
    dev = resolve_device(device)
    T, H, W = data.shape
    ci, cj = H // 2, W // 2
    series = np.asarray(data[:, ci - rangespan:ci + rangespan + 1, cj - rangespan:cj + rangespan + 1],
                        np.float64) * scale
    series = series.reshape(T, -1)
    series = np.where(np.isnan(series), np.nanmean(series, axis=0, keepdims=True), series)
    series = series - series.mean(axis=0, keepdims=True)

    nperseg = min(nperseg, T)
    noverlap = nperseg // 2
    step = nperseg - noverlap
    nseg = max((T - noverlap) // step, 1)
    win = _hann(nperseg)
    wnorm = (win**2).sum()

    segs = np.stack([series[k * step:k * step + nperseg] for k in range(nseg)], axis=0)  # (nseg, nperseg, M)
    segs = segs - segs.mean(axis=1, keepdims=True)
    segs = segs * win[None, :, None]
    F = torch.fft.rfft(torch.as_tensor(segs.astype(np.float32), device=dev), dim=1)
    psd = F.abs() ** 2 * (dt / wnorm)
    nf = psd.shape[1]
    fac = torch.ones(nf, device=dev)  # one-sided: every bin but DC (and Nyquist) doubled
    fac[1:] = 2.0
    if nperseg % 2 == 0:
        fac[-1] = 1.0
    psd = psd * fac[None, :, None]
    S_all = psd.mean(dim=0)  # (nf, M)
    center_idx = series.shape[1] // 2
    S = (S_all.sum(dim=1) + S_all[:, center_idx]) / (series.shape[1] + 1)
    f = np.fft.rfftfreq(nperseg, d=dt)
    return f, S.cpu().numpy(), series[:, center_idx]


class SpectrumStats(NamedTuple):
    hm0: float
    tm01: float
    fp: float
    tp: float


def spectrum_stats(f: np.ndarray, S: np.ndarray) -> SpectrumStats:
    """Hm0 = 4 sqrt(m0), Tm01 = m0 / m1, the peak of S (wasspost.py:415-433)."""
    df = f[1] - f[0]
    m0 = float(np.sum(S) * df)
    m1 = float(np.sum(f * S) * df)
    fp = float(f[int(np.argmax(S))])
    return SpectrumStats(
        hm0=4.0 * np.sqrt(m0),
        tm01=m0 / m1 if m1 > 0 else np.inf,
        fp=fp,
        tp=1.0 / fp if fp > 0 else np.inf,
    )


def compute_3d_spectrum(data, du: float, dt: float, segments: int = 10, datascale: float = 1.0, device="cuda"):
    """3D wavenumber-frequency Welch spectrum (spectra.py:53-171): Hann
    windows in t, x and y, 50% overlapping time segments, the window power
    corrected.  Returns (S_welch (Nt, Nx, Ny) float64, KX, KY, f)."""
    dev = resolve_device(device)
    N = data.shape[1] * 2 // 3
    T = data.shape[0]
    Nt = int(T / segments)
    if Nt % 2 > 0:
        Nt += 1
    seg_shift = Nt // 2

    mr = data.shape[1] // 2
    mc = data.shape[2] // 2
    r_start, r_end = max(mr - N // 2 - 20, 0), mr + N // 2 - 20 + 1
    c_start, c_end = max(mc - N // 2, 0), mc + N // 2 + 1
    Nx = r_end - r_start
    Ny = c_end - c_start

    kx_max = (2.0 * np.pi / du) / 2.0
    f_max = (1.0 / dt) / 2.0
    dkx = 2.0 * np.pi / (du * np.floor(Nx / 2.0) * 2.0)
    dky = 2.0 * np.pi / (du * np.floor(Ny / 2.0) * 2.0)
    df = 1.0 / (dt * np.floor(Nt / 2.0) * 2.0)

    kx = np.arange(-kx_max, kx_max + dkx, dkx)[:Nx]
    ky = np.arange(-kx_max, kx_max + dky, dky)[:Ny]
    f = np.arange(-f_max, f_max, df)[:Nt]
    KX, KY = np.meshgrid(kx, ky, indexing="ij")  # rows kx, columns ky, as S's spatial axes

    hx, hy, ht = _hann(Nx), _hann(Ny), _hann(Nt)
    win3d = ht[:, None, None] * (hx[:, None] * hy[None, :])[None, :, :]
    wc = (1.0 / np.mean(hx**2)) * (1.0 / np.mean(hy**2)) * (1.0 / np.mean(ht**2))

    S_welch = np.zeros((Nt, Nx, Ny))
    n = 0
    for ii in range(segments * 2):
        t0 = ii * seg_shift
        if t0 + Nt > T:
            break
        cube = np.asarray(data[t0:t0 + Nt, r_start:r_end, c_start:c_end], np.float64) * datascale
        cube = np.where(np.isnan(cube), np.nanmean(cube, axis=0, keepdims=True), cube)
        w = (cube - cube.mean()) * win3d
        S = torch.fft.fftshift(torch.fft.fftn(torch.as_tensor(w.astype(np.float32), device=dev), norm="ortho"))
        S = S / (Nt * Nx * Ny)
        S = S.abs() ** 2 / (dkx * dky * df) * wc
        S_welch += S.cpu().numpy()
        n += 1
    if n:
        S_welch /= n
    return S_welch, KX, KY, f
