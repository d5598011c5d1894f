"""Matplotlib's figures drawn with OpenCV on a uint8 canvas.

The GPU host has no matplotlib, so the port draws its diagnostic plots
(area_grid.png, gridded.png, <cube>.spectrum.png) with cv2's lines,
rectangles and Hershey text, at the JAX package's figure size x dpi and
with matplotlib's default subplot box, margins, colour limits and
viridis.  The pixels differ from matplotlib's (fonts, antialiasing,
tick choice); the data-to-pixel mapping of each axes is exact and kept on
the Axes, so that a pixel maps back to the data it shows.  Everything is
drawn on the host from numpy arrays: the bytes do not depend on where
the arrays were computed.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np

from wass_tpu_torch.io import png

# matplotlib's viridis, its 256 entries rounded to uint8 R, G, B.
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164471365481467481668481769"
    "48186a481a6c481b6d481c6e481d6f481f70482071482173482374482475482576482677482878482979472a7a472c7a"
    "472d7b472e7c472f7d46307e46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a3d4e8a3c4f8a3c508b3b518b"
    "3b528b3a538b3a548c39558c39568c38588c38598c375a8c375b8d365c8d365d8d355e8d355f8d34608d34618d33628d"
    "33638d32648e32658e31668e31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e277e8e277f8e27808e26818e"
    "26828e26828e25838e25848e25858e24868e24878e23888e23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d"
    "21918c20928c20928c20938c1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad8127ad81"
    "28ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b67935b77937b87838b9773aba763bbb753dbc74"
    "3fbc7340bd7242be7144bf7046c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d1537ad1517cd2507fd34e81d34d"
    "84d44b86d54989d5488bd6468ed64590d74393d74195d84098d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32"
    "addc30b0dd2fb2dd2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61ef6e620f8e621fbe723fde725"
), np.uint8).reshape(256, 3)

BLACK, WHITE, RED = (0, 0, 0), (255, 255, 255), (255, 0, 0)
GRID = (231, 231, 231)  # matplotlib's grid colour #b0b0b0 at alpha 0.3 on white
FONT = cv2.FONT_HERSHEY_SIMPLEX
# matplotlib's defaults: the subplot box (left, right, bottom, top), the
# data margins, the colorbar's fraction, pad and aspect, the font size.
SUBPLOT = (0.125, 0.9, 0.11, 0.88)
MARGIN = 0.05
CBAR_FRACTION, CBAR_PAD, CBAR_ASPECT = 0.15, 0.05, 20.0
FONT_PT = 10.0


def colormap(values: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """(..., 3) uint8 viridis colours of values over [vmin, vmax] as
    matplotlib maps them (x * 256, floored, the ends clipped); NaN white."""
    v = np.asarray(values, np.float64)
    x = (v - vmin) / (vmax - vmin) if vmax > vmin else np.zeros_like(v)
    idx = np.clip(np.floor(np.nan_to_num(x, nan=0.0) * 256), 0, 255).astype(np.intp)
    out = VIRIDIS[idx]
    out[np.isnan(v)] = WHITE
    return out


def nice_ticks(lo: float, hi: float, max_ticks: int = 9) -> np.ndarray:
    """Ticks at multiples of 1, 2, 2.5 or 5 x 10^k inside [lo, hi], at most
    max_ticks of them (matplotlib's MaxNLocator steps)."""
    if not hi > lo:
        return np.array([lo])
    raw = (hi - lo) / max(max_ticks - 1, 1)
    base = 10.0 ** math.floor(math.log10(raw))
    step = next(s * base for s in (1, 2, 2.5, 5, 10) if s * base >= raw)
    first = math.ceil(lo / step - 1e-9)
    ticks = (first + np.arange(int(math.floor(hi / step + 1e-9)) - first + 1)) * step
    return np.round(ticks, 12)


def _label(v: float) -> str:
    s = f"{v:.6g}"
    return "0" if s in ("-0", "0") else s


class Figure:
    """A white canvas of width_in x height_in inches at dpi."""

    def __init__(self, width_in: float, height_in: float, dpi: float):
        self.dpi = dpi
        self.image = np.full((int(round(height_in * dpi)), int(round(width_in * dpi)), 3), 255, np.uint8)

    @property
    def size(self) -> Tuple[int, int]:
        return self.image.shape[1], self.image.shape[0]

    def px(self, points: float) -> float:
        return points * self.dpi / 72.0

    def thickness(self, width_pt: float) -> int:
        """cv2's thickness for a line width_pt wide: thickness t draws
        2 t - 1 pixels (t > 1) or one."""
        w = self.px(width_pt)
        return 1 if w < 1.75 else int(round((w + 1) / 2))

    def subplot_box(self) -> Tuple[float, float, float, float]:
        """(left, top, right, bottom) pixels of matplotlib's one subplot."""
        W, H = self.size
        left, right, bottom, top = SUBPLOT
        return left * W, (1 - top) * H, right * W, (1 - bottom) * H

    def text(self, s: str, x: float, y: float, size_pt: float = FONT_PT, color=BLACK, ha: str = "center",
             va: str = "center", rotate: bool = False) -> None:
        """s at (x, y) aligned by ha (left, center, right) and va (top,
        center, bottom); rotate: upwards, as a y-axis label."""
        scale = self.px(size_pt) / 24.0
        thick = max(1, int(round(scale * 1.6)))
        (w, h), base = cv2.getTextSize(s, FONT, scale, thick)
        if rotate:
            tile = np.full((h + base + 2, w + 2, 3), 255, np.uint8)
            cv2.putText(tile, s, (1, h + 1), FONT, scale, color, thick, cv2.LINE_AA)
            tile = np.ascontiguousarray(np.rot90(tile))
            th, tw = tile.shape[:2]
            x0 = int(round(x - {"left": 0, "center": tw / 2, "right": tw}[ha]))
            y0 = int(round(y - {"top": 0, "center": th / 2, "bottom": th}[va]))
            self._paste(tile, x0, y0)
            return
        x0 = x - {"left": 0, "center": w / 2, "right": w}[ha]
        y0 = y + {"top": h, "center": h / 2, "bottom": 0}[va]
        cv2.putText(self.image, s, (int(round(x0)), int(round(y0))), FONT, scale, color, thick, cv2.LINE_AA)

    def _paste(self, tile: np.ndarray, x0: int, y0: int) -> None:
        H, W = self.image.shape[:2]
        ys, xs = slice(max(y0, 0), min(y0 + tile.shape[0], H)), slice(max(x0, 0), min(x0 + tile.shape[1], W))
        sub = tile[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
        dst = self.image[ys, xs]
        np.minimum(dst, sub, out=dst)  # dark text over the canvas

    def save(self, path) -> None:
        Path(path).write_bytes(png.encode_rgb(self.image))


class Axes:
    """A data rectangle drawn into a pixel box (left, top, right, bottom):
    x and y each linear or log10, y growing upwards unless yinvert."""

    def __init__(self, fig: Figure, box, xlim, ylim, xlog: bool = False, ylog: bool = False,
                 yinvert: bool = False):
        self.fig, self.box = fig, tuple(float(b) for b in box)
        self.xlog, self.ylog, self.yinvert = xlog, ylog, yinvert
        self.xlim, self.ylim = tuple(xlim), tuple(ylim)

    def _t(self, v, log: bool):
        v = np.asarray(v, np.float64)
        return np.log10(v) if log else v

    def _fx(self, x):
        a, b = (self._t(v, self.xlog) for v in self.xlim)
        return (self._t(x, self.xlog) - a) / (b - a)

    def _fy(self, y):
        a, b = (self._t(v, self.ylog) for v in self.ylim)
        f = (self._t(y, self.ylog) - a) / (b - a)
        return f if self.yinvert else 1.0 - f

    def px(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """Pixel coordinates (column, row; continuous, pixel centres at +0.5)."""
        l, t, r, b = self.box
        return l + self._fx(x) * (r - l), t + self._fy(y) * (b - t)

    def data(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        """The inverse of px."""
        l, t, r, b = self.box
        fx = (np.asarray(u, np.float64) - l) / (r - l)
        fy = (np.asarray(v, np.float64) - t) / (b - t)
        fy = fy if self.yinvert else 1.0 - fy
        out = []
        for f, lim, log in ((fx, self.xlim, self.xlog), (fy, self.ylim, self.ylog)):
            a, b2 = (self._t(v, log) for v in lim)
            w = a + f * (b2 - a)
            out.append(10.0 ** w if log else w)
        return out[0], out[1]

    def _ipx(self, x, y) -> np.ndarray:
        u, v = self.px(x, y)
        return np.stack([np.floor(u), np.floor(v)], -1).astype(np.int32)

    def _clip(self):
        l, t, r, b = self.box
        return int(math.floor(l)), int(math.floor(t)), int(math.ceil(r)), int(math.ceil(b))

    def line(self, x, y, color=BLACK, width_pt: float = 1.5, dash: Optional[Tuple[float, float]] = None) -> None:
        """A polyline through the points (x, y), clipped to the box; dash
        (on, off) in multiples of the line width, as matplotlib's "--"."""
        pts = self._ipx(x, y)
        thick = self.fig.thickness(width_pt)
        l, t, r, b = self._clip()
        layer = self.fig.image[t:b, l:r]
        pts = pts - np.array([l, t], np.int32)
        if dash is None:
            cv2.polylines(layer, [pts.reshape(-1, 1, 2)], False, color, thick, cv2.LINE_8)
            return
        on, off = (max(1.0, self.fig.px(d * width_pt)) for d in dash)
        for p, q in zip(pts[:-1].astype(np.float64), pts[1:].astype(np.float64)):
            n = np.hypot(*(q - p))
            s = 0.0
            while s < n:
                e = min(s + on, n)
                a, c = p + (q - p) * s / n, p + (q - p) * e / n
                cv2.line(layer, tuple(int(round(z)) for z in a), tuple(int(round(z)) for z in c), color, thick,
                         cv2.LINE_8)
                s = e + off

    def scatter(self, x, y, colors: np.ndarray, size_px: int = 2) -> None:
        """Square markers of size_px at (x, y), in the given order: where
        markers share a pixel the later one wins, as in matplotlib."""
        pts = self._ipx(x, y)
        l, t, r, b = self._clip()
        cells = []
        for du in range(size_px):
            for dv in range(size_px):
                cells.append(pts + np.array([du - size_px // 2, dv - size_px // 2], np.int32))
        cells = np.stack(cells, 1).reshape(-1, 2)  # point-major: a later point's cells come later
        col = np.repeat(np.asarray(colors, np.uint8), size_px * size_px, axis=0)
        inside = (cells[:, 0] >= l) & (cells[:, 0] < r) & (cells[:, 1] >= t) & (cells[:, 1] < b)
        cells, col = cells[inside], col[inside]
        W = self.fig.image.shape[1]
        key = cells[:, 1].astype(np.int64) * W + cells[:, 0]
        _, first = np.unique(key[::-1], return_index=True)  # the last occurrence of each pixel
        last = len(key) - 1 - first
        self.fig.image[cells[last, 1], cells[last, 0]] = col[last]

    def image(self, rgb: np.ndarray) -> None:
        """An (h, w, 3) image filling the box, nearest-neighbour (imshow's
        upsampling), row 0 at the top."""
        l, t, r, b = self._clip()
        h, w = rgb.shape[:2]
        u = (np.arange(l, r) + 0.5 - self.box[0]) / (self.box[2] - self.box[0]) * w
        v = (np.arange(t, b) + 0.5 - self.box[1]) / (self.box[3] - self.box[1]) * h
        iu, iv = np.clip(np.floor(u).astype(np.intp), 0, w - 1), np.clip(np.floor(v).astype(np.intp), 0, h - 1)
        self.fig.image[t:b, l:r] = rgb[iv[:, None], iu[None, :]]

    def _ticks(self, lim, log: bool):
        lo, hi = sorted(lim)
        if not log:
            t = nice_ticks(lo, hi)
            return t, [], [_label(v) for v in t]
        k0, k1 = math.floor(math.log10(lo)), math.ceil(math.log10(hi))
        major = [10.0 ** k for k in range(k0, k1 + 1) if lo <= 10.0 ** k <= hi]
        minor = [m * 10.0 ** k for k in range(k0, k1 + 1) for m in range(2, 10) if lo <= m * 10.0 ** k <= hi]
        return np.array(major), minor, [f"10^{k}" for k in range(k0, k1 + 1) if lo <= 10.0 ** k <= hi]

    def grid(self, minor: bool = False) -> None:
        """Grid lines at the major ticks (and minor ones), under the data."""
        l, t, r, b = self._clip()
        xt, xm, _ = self._ticks(self.xlim, self.xlog)
        yt, ym, _ = self._ticks(self.ylim, self.ylog)
        for v in list(xt) + (xm if minor else []):
            u = int(math.floor(self.px(v, self.ylim[0])[0]))
            cv2.line(self.fig.image, (u, t), (u, b - 1), GRID, 1, cv2.LINE_8)
        for v in list(yt) + (ym if minor else []):
            w = int(math.floor(self.px(self.xlim[0], v)[1]))
            cv2.line(self.fig.image, (l, w), (r - 1, w), GRID, 1, cv2.LINE_8)

    def decorate(self, title: str = "", xlabel: str = "", ylabel: str = "") -> None:
        """The frame, ticks and their labels, axis labels and title."""
        fig = self.fig
        l, t, r, b = self._clip()
        major, minor = max(2, int(round(fig.px(3.5)))), max(1, int(round(fig.px(2))))
        cv2.rectangle(fig.image, (l, t), (r - 1, b - 1), BLACK, max(1, int(round(fig.px(0.8)))), cv2.LINE_8)
        xt, xm, xl = self._ticks(self.xlim, self.xlog)
        for v, s in zip(xt, xl):
            u = int(math.floor(self.px(v, self.ylim[0])[0]))
            cv2.line(fig.image, (u, b - 1), (u, b - 1 + major), BLACK, 1, cv2.LINE_8)
            self._tick_label(s, u, b + major + fig.px(3.5), "center", "top")
        for v in xm:
            u = int(math.floor(self.px(v, self.ylim[0])[0]))
            cv2.line(fig.image, (u, b - 1), (u, b - 1 + minor), BLACK, 1, cv2.LINE_8)
        yt, ym, yl = self._ticks(self.ylim, self.ylog)
        widest = 0
        for v, s in zip(yt, yl):
            w = int(math.floor(self.px(self.xlim[0], v)[1]))
            cv2.line(fig.image, (l - major, w), (l, w), BLACK, 1, cv2.LINE_8)
            widest = max(widest, self._tick_label(s, l - major - fig.px(3.5), w, "right", "center"))
        for v in ym:
            w = int(math.floor(self.px(self.xlim[0], v)[1]))
            cv2.line(fig.image, (l - minor, w), (l, w), BLACK, 1, cv2.LINE_8)
        if xlabel:
            fig.text(xlabel, (l + r) / 2, b + major + fig.px(3.5 + FONT_PT + 6), ha="center", va="top")
        if ylabel:
            fig.text(ylabel, l - major - fig.px(3.5 + 6) - widest, (t + b) / 2, ha="right", rotate=True)
        if title:
            fig.text(title, (l + r) / 2, t - fig.px(6), size_pt=1.2 * FONT_PT, ha="center", va="bottom")

    def _tick_label(self, s: str, x: float, y: float, ha: str, va: str) -> int:
        """A tick label (10^k with a raised exponent); its width in pixels."""
        fig = self.fig
        if s.startswith("10^"):
            base, exp = "10", s[3:]
            scale = fig.px(FONT_PT) / 24.0
            wb = cv2.getTextSize(base, FONT, scale, 1)[0][0]
            we = cv2.getTextSize(exp, FONT, 0.7 * scale, 1)[0][0]
            x0 = x - {"left": 0, "center": (wb + we) / 2, "right": wb + we}[ha]
            fig.text(base, x0, y, ha="left", va=va)
            fig.text(exp, x0 + wb + 1, y - fig.px(FONT_PT) * 0.45, size_pt=0.7 * FONT_PT, ha="left", va=va)
            return wb + we
        fig.text(s, x, y, ha=ha, va=va)
        return cv2.getTextSize(s, FONT, fig.px(FONT_PT) / 24.0, 1)[0][0]


def data_limits(lo: float, hi: float, log: bool = False) -> Tuple[float, float]:
    """matplotlib's autoscaled limits: the data range widened by 5% a side
    (in log10 for a log axis)."""
    if log:
        a, b = math.log10(lo), math.log10(hi)
        d = (b - a) * MARGIN or 0.5
        return 10.0 ** (a - d), 10.0 ** (b + d)
    d = (hi - lo) * MARGIN or 0.5
    return lo - d, hi + d


def split_colorbar(box) -> Tuple[tuple, tuple]:
    """The parent's box and the colorbar's, as matplotlib's colorbar takes
    15% of the parent's width with a 5% pad, the bar 20 times as tall as
    wide."""
    l, t, r, b = box
    w = r - l
    parent = (l, t, l + w * (1 - CBAR_FRACTION - CBAR_PAD), b)
    bar_l = l + w * (1 - CBAR_FRACTION)
    bar_w = min(w * CBAR_FRACTION, (b - t) / CBAR_ASPECT)
    return parent, (bar_l, t, bar_l + bar_w, b)


def colorbar(fig: Figure, box, vmin: float, vmax: float) -> Axes:
    """A vertical viridis colorbar over [vmin, vmax] with ticks on its right."""
    ax = Axes(fig, box, (0.0, 1.0), (vmin, vmax))
    l, t, r, b = ax._clip()
    levels = np.linspace(vmax, vmin, b - t) if vmax > vmin else np.full(b - t, vmin)
    strip = colormap(levels, vmin, vmax)
    fig.image[t:b, l:r] = strip[:, None, :]
    cv2.rectangle(fig.image, (l, t), (r - 1, b - 1), BLACK, 1, cv2.LINE_8)
    major = max(2, int(round(fig.px(3.5))))
    for v in nice_ticks(min(vmin, vmax), max(vmin, vmax)):
        w = int(math.floor(ax.px(0.0, v)[1]))
        cv2.line(fig.image, (r - 1, w), (r - 1 + major, w), BLACK, 1, cv2.LINE_8)
        fig.text(_label(v), r + major + fig.px(3.5), w, ha="left", va="center")
    return ax


def equal_limits(box, xlim: Sequence[float], ylim: Sequence[float]) -> Tuple[tuple, tuple]:
    """axis("equal") with adjustable datalim: the limits widened about
    their centres so that one data unit spans as many pixels on x as on y."""
    l, t, r, b = box
    sx = (xlim[1] - xlim[0]) / (r - l)
    sy = (ylim[1] - ylim[0]) / (b - t)
    s = max(sx, sy)
    cx, cy = (xlim[0] + xlim[1]) / 2, (ylim[0] + ylim[1]) / 2
    hx, hy = s * (r - l) / 2, s * (b - t) / 2
    return (cx - hx, cx + hx), (cy - hy, cy + hy)


def fit_aspect(box, h: int, w: int) -> tuple:
    """The box shrunk about its centre to an (h, w) image's aspect (imshow's
    equal aspect, adjustable box)."""
    l, t, r, b = box
    s = min((r - l) / w, (b - t) / h)
    cx, cy = (l + r) / 2, (t + b) / 2
    return cx - s * w / 2, cy - s * h / 2, cx + s * w / 2, cy + s * h / 2
