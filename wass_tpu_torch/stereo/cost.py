"""Census transform and the plain census cost volume.

Counterpart of wass_tpu/stereo/cost.py.  Census words are int32 tensors
holding the bits of the reference's uint32 words (torch has no uint32
shift on the CPU and no popcount), and the popcount is a SWAR reduction
in int64.  `census_cost_volume` here is the plain version of kernel K1
(stereo/sgm_kernels.py, csrc/census_cost.cu); the main path calls the
kernel wrapper, which uses this function for CPU tensors only.

Disparity convention (as the reference): base(y, x) matches
match(y, x - d) for d in [min_disp, min_disp + num_disp).
"""

from __future__ import annotations

from typing import Tuple

import torch

AUTO_SIGMA = 0.8  # clean-input baseline the AUTO sentinel stands for here


def _gauss_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _edge_pad_rows(img: torch.Tensor, r: int) -> torch.Tensor:
    return torch.cat([img[:1].expand(r, -1), img, img[-1:].expand(r, -1)], 0)


def _pairwise_sum(terms: list) -> torch.Tensor:
    """((t0 + t1) + (t2 + t3)) + ...: the order in which the reference's
    CPU convolution sums the 5 taps of the sigma = 0.8 kernel, so the two
    blurs agree bit for bit there (other sizes agree to float32 rounding)."""
    while len(terms) > 1:
        pairs = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        terms = pairs + terms[len(pairs) * 2 :]
    return terms[0]


def gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian with edge padding, radius int(3 sigma + 0.5)
    (wass_tpu/match/features.py:_gauss_blur)."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gauss_kernel1d(sigma, radius, img.device)
    H, W = img.shape
    p = _edge_pad_rows(img, radius)
    v = _pairwise_sum([k[t] * p[t : t + H] for t in range(2 * radius + 1)])
    p = _edge_pad_rows(v.T, radius).T
    return _pairwise_sum([k[t] * p[:, t : t + W] for t in range(2 * radius + 1)])


def census_transform(
    img: torch.Tensor, win: Tuple[int, int] = (7, 9), smooth_sigma: float = 0.0
) -> torch.Tensor:
    """Census transform with a win=(wy, wx) window: (H, W) float ->
    (H, W, n_words) int32, n_words = ceil((wy*wx - 1) / 32).

    Bit i of word w is set where the neighbour (zero-padded at the border)
    is below the centre.  A negative smooth_sigma is the AUTO sentinel and
    means 0.8 at this level; a positive one blurs the image first."""
    if smooth_sigma is not None and smooth_sigma < 0:
        smooth_sigma = AUTO_SIGMA
    if smooth_sigma and smooth_sigma > 0:
        img = gauss_blur(img, smooth_sigma)
    wy, wx = win
    if wy % 2 != 1 or wx % 2 != 1:
        raise ValueError(f"census window must be odd, got {win}")
    ry, rx = wy // 2, wx // 2
    H, W = img.shape
    p = torch.nn.functional.pad(img, (rx, rx, ry, ry))
    bits = [
        p[dy : dy + H, dx : dx + W] < img
        for dy in range(wy)
        for dx in range(wx)
        if not (dy == ry and dx == rx)
    ]
    words = []
    for w in range((len(bits) + 31) // 32):
        acc = torch.zeros((H, W), dtype=torch.int64, device=img.device)
        for i, b in enumerate(bits[w * 32 : (w + 1) * 32]):
            acc |= b.to(torch.int64) << i
        words.append(torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32))
    return torch.stack(words, dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as uint32), in int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Summed popcount over the census words, as uint8."""
    return popcount32(a ^ b).sum(-1).to(torch.uint8)


def census_cost_volume(
    census_base: torch.Tensor,
    census_match: torch.Tensor,
    num_disp: int,
    min_disp: int = 0,
) -> torch.Tensor:
    """Plain (H, W, D) uint8 cost volume:
    cost[y, x, j] = hamming(base[y, x], match[y, x - (min_disp + j)]),
    and the census bit width (32 * n_words, at most 255) where x - d < 0."""
    if min_disp < 0:
        raise ValueError(f"min_disp must be >= 0, got {min_disp}")
    H, W, nw = census_base.shape
    max_cost = min(32 * nw, 255)
    out = torch.full((H, W, num_disp), max_cost, dtype=torch.uint8, device=census_base.device)
    for j in range(num_disp):
        d = min_disp + j
        if d < W:
            out[:, d:, j] = hamming(census_base[:, d:], census_match[:, : W - d])
    return out
