"""The spectrum plot (the JAX package's wass_tpu/post/plotting.py, after
wasspost/plotting.py:4-29), drawn with OpenCV (utils/plotting.py): the
same file, data, title and marks as matplotlib's loglog figure, not the
same pixels."""

from __future__ import annotations

import numpy as np

from wass_tpu_torch.utils.plotting import BLACK, RED, Axes, Figure, data_limits

FIGSIZE, DPI = (10, 6), 120  # the JAX figure's inches and savefig dpi


def spectrum_figure(f: np.ndarray, S: np.ndarray, title: str = "Wave spectrum") -> Axes:
    """loglog S(f) over f > 0 and S > 0 (black), the peak's red dashed
    vertical with its "fp = ... Hz" label, axis labels, the title and a
    grid over the decades."""
    f, S = np.asarray(f, np.float64), np.asarray(S, np.float64)
    m = (f > 0) & (S > 0)
    fm, Sm = f[m], S[m]
    ip = int(np.argmax(Sm))
    fp = fm[ip]
    fig = Figure(*FIGSIZE, DPI)
    ax = Axes(fig, fig.subplot_box(), data_limits(fm.min(), fm.max(), log=True),
              data_limits(Sm.min(), Sm.max(), log=True), xlog=True, ylog=True)
    ax.grid(minor=True)
    ax.line(fm, Sm, BLACK, 1.2)
    ax.line([fp, fp], ax.ylim, RED, 0.8, dash=(3.7, 1.6))
    u, v = ax.px(fp, Sm[ip])
    fig.text(f"fp = {fp:.3f} Hz", u + fig.px(8), v + fig.px(4), ha="left", va="center")
    ax.decorate(title, "frequency (Hz)", "S(f)  (m^2/Hz)")
    return ax


def plot_spectrum(f: np.ndarray, S: np.ndarray, out_path, title: str = "Wave spectrum") -> Axes:
    """spectrum_figure saved as PNG to out_path; returns its axes."""
    ax = spectrum_figure(f, S, title)
    ax.fig.save(out_path)
    return ax
