"""Surface-infill interpolators for gridded elevations, on torch tensors.

Counterpart of wass_tpu/grid/interpolators.py, the reference's two
inpainting schemes:

* DCT: inverse-problem inpainting — fit an nfreqs x nfreqs block of DCT
  coefficients so that the reconstruction matches the observed cells,
  L1-regularized, with Rprop (DCTInterpolator,
  gridding/wassgridsurface/DCTInterpolator.py:27-121);
* IDW: iterated inverse-distance-weighted convolution infill with a
  morphological-close validity mask (IDWInterpolator.py:23-58).

Both take a Z grid with NaN holes on any device and return (filled, mask)
on that device.  The DCT fit's two products are plain matmuls with the
zero block of the coefficient grid cut out (the same sums less their
zero terms); its gradient is written out.  TF32 stays off (device.py), so
the products are full float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-III matrix matching scipy.fft.dct(np.eye(n), type=3,
    norm='ortho') as used by the reference."""
    from scipy.fft import dct

    return dct(np.eye(n), type=3, norm="ortho")


def dct_x0(nfreqs: int, seed: int, device) -> torch.Tensor:
    """The fit's initial coefficients when none are given: uniform [0, 1)
    from a torch.Generator seeded with `seed` on `device` (the JAX package
    draws jax.random.uniform(PRNGKey(seed)), which torch cannot
    reproduce)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand((nfreqs, nfreqs), generator=gen, device=device, dtype=torch.float32)


def dct_fit(I: torch.Tensor, mask: torch.Tensor, Dc_h: torch.Tensor, Dc_w: torch.Tensor, x0: torch.Tensor,
            max_iters: int, alpha: float, lr: float) -> torch.Tensor:
    """The Rprop loop of _dct_optimize (wass_tpu/grid/interpolators.py:35-70):
    the reconstruction from the final coefficients."""
    nf = x0.shape[0]
    A = Dc_h[:nf].T.contiguous()  # (H, nf): Dc_h.T @ full keeps full's nonzero rows
    B = Dc_w[:nf].contiguous()  # (nf, W)
    # d(data)/d(Irec) = 2 (Irec - I) mask / msum
    w2 = mask * (2.0 / torch.clamp_min(mask.sum(), 1.0))
    x = x0.clone()
    step = torch.full_like(x, lr)
    gprev = torch.zeros_like(x)
    for _ in range(max_iters):
        R = (A @ x @ B - I) * w2
        g = A.T @ R @ B.T + alpha * torch.sign(x)
        agree = torch.sign(g) * torch.sign(gprev)
        step = torch.where(agree > 0, torch.clamp_max(step * 1.2, 50.0), step)
        step = torch.where(agree < 0, torch.clamp_min(step * 0.5, 1e-6), step)
        g = torch.where(agree < 0, 0.0, g)
        x = x - torch.sign(g) * step
        gprev = g
    return A @ x @ B


def dct_loss(Irec: torch.Tensor, I: torch.Tensor, mask: torch.Tensor, x: torch.Tensor, alpha: float) -> float:
    """The fit's objective at coefficients x, in float64 (the tests compare
    the two packages' final losses)."""
    Irec, I, mask, x = (t.double() for t in (Irec, I, mask, x))
    return float(((Irec - I) ** 2 * mask).sum() / torch.clamp_min(mask.sum(), 1.0) + alpha * x.abs().sum())


def dct_interpolate(
    Z: torch.Tensor,
    nfreqs: int = 150,
    max_iters: int = 500,
    alpha: float = 8e-7,
    lr: float = 5.0,
    seed: int = 0,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill NaN holes of Z with the truncated-DCT optimization; x0, the
    initial (nfreqs', nfreqs') coefficients, defaults to dct_x0(seed)."""
    H, W = Z.shape
    nfreqs = min(nfreqs, H, W)
    valid = ~torch.isnan(Z)
    mask = valid.float()
    I = torch.nan_to_num(Z.float(), nan=0.0)
    Dc_h = torch.as_tensor(_dct_matrix(H), dtype=torch.float32).to(Z.device)
    Dc_w = torch.as_tensor(_dct_matrix(W), dtype=torch.float32).to(Z.device)
    if x0 is None:
        x0 = dct_x0(nfreqs, seed, Z.device)
    out = dct_fit(I, mask, Dc_h, Dc_w, x0.to(Z.device, torch.float32), max_iters, alpha, lr)
    return out, torch.ones_like(mask)


def _conv2_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """convolve2d(x, k, mode="same") for an odd square k (a flipped
    correlation, zero padding)."""
    r = k.shape[0] // 2
    return F.conv2d(x[None, None], torch.flip(k, (0, 1))[None, None], padding=r)[0, 0]


def idw_interpolate(Z: torch.Tensor, ksize: int = 5, exp: float = 2.4, reps: int = 3):
    """The IDW infill of _idw_device (wass_tpu/grid/interpolators.py:99-135):
    (filled with NaN outside the closed mask, closed mask)."""
    dev = Z.device
    valid = ~torch.isnan(Z)
    I = torch.nan_to_num(Z.float(), nan=0.0)
    kd = torch.arange(ksize, dtype=torch.float32, device=dev) - ksize // 2
    kx = kd.expand(ksize, ksize)
    ky = kx.T
    dist = torch.sqrt(kx**2 + ky**2)
    K = torch.where(dist > 0, 1.0 / torch.pow(torch.clamp_min(dist, 1e-9), exp), 0.0)

    mask = valid.float()
    Iinit = I * mask
    cur = Iinit
    m = mask
    for _ in range(reps):
        I2 = _conv2_same(cur, K)
        m2 = _conv2_same(m, K)
        I2 = I2 / (m2 + 1e-9)
        m = torch.sign(m2)
        cur = mask * Iinit + (1 - mask) * I2

    # Morphological close of the validity mask (reps iterations).
    ones = torch.ones((ksize, ksize), dtype=torch.float32, device=dev)
    d = valid.float()
    for _ in range(reps):
        d = torch.sign(_conv2_same(d, ones))
    for _ in range(reps):
        d = 1.0 - torch.sign(_conv2_same(1.0 - d, ones))
    return torch.where(d == 0, torch.nan, cur), d
