"""Matrix IO in the reference's on-disk formats.

The workdir contract stores matrices as OpenCV FileStorage XML
(WASS::load_matrix, src/include/utils.hpp:32-66) and as
scientific-notation whitespace text (save_matrix_txt, utils.hpp:69-92).
We write/read both formats with a pure-Python XML codec (no cv2 dependency
on the IO path) that is byte-compatible with cv::FileStorage's XML schema,
so reference tools and Matlab loaders interoperate.

The port's own copy of the JAX package's wass_tpu/io/matrices.py, with the same
behaviour (the port imports nothing of the JAX package); file
references are to the WASS reference sources.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

_DTYPES = {"d": np.float64, "f": np.float32, "i": np.int32, "u": np.uint8, "s": np.int16}
_DTYPE_CODES = {np.dtype(np.float64): "d", np.dtype(np.float32): "f", np.dtype(np.int32): "i"}


def load_matrix(path) -> np.ndarray:
    """Load an OpenCV FileStorage XML matrix (first top-level node)."""
    path = Path(path)
    tree = ET.parse(path)
    root = tree.getroot()  # <opencv_storage>
    node = None
    for child in root:
        node = child
        break
    if node is None:
        raise ValueError(f"{path}: no matrix node found")
    rows = int(node.findtext("rows"))
    cols = int(node.findtext("cols"))
    dt = node.findtext("dt").strip()
    data_text = node.findtext("data")
    vals = [float(tok) for tok in data_text.split()]
    dtype = _DTYPES.get(dt[0], np.float64)
    return np.asarray(vals, dtype=dtype).reshape(rows, cols)


def save_matrix_xml(path, name: str, M: np.ndarray) -> None:
    """Write a matrix as cv::FileStorage XML (matching the writer used at
    src/wass_match/wass_match.cpp:347-353)."""
    M = np.asarray(M)
    code = _DTYPE_CODES.get(M.dtype, "d")
    if code == "d":
        M = M.astype(np.float64)

    def fmt(v):
        if code in ("d", "f"):
            return repr(float(v))
        return str(int(v))

    rows, cols = M.shape
    data = " ".join(fmt(v) for v in M.reshape(-1))
    body = (
        '<?xml version="1.0"?>\n'
        "<opencv_storage>\n"
        f'<{name} type_id="opencv-matrix">\n'
        f"  <rows>{rows}</rows>\n"
        f"  <cols>{cols}</cols>\n"
        f"  <dt>{code}</dt>\n"
        f"  <data>\n    {data}</data></{name}>\n"
        "</opencv_storage>\n"
    )
    with open(path, "w") as f:
        f.write(body)


def save_matrix_txt(path, M: np.ndarray) -> None:
    """Scientific-notation text matrix (utils.hpp:69-92): space-separated
    columns, newline-separated rows, 16 significant digits."""
    M = np.asarray(M, dtype=np.float64)
    with open(path, "w") as f:
        for i, row in enumerate(M):
            f.write(" ".join(f"{v:.16e}" for v in row))
            if i != M.shape[0] - 1:
                f.write("\n")


def load_matrix_txt(path) -> np.ndarray:
    return np.atleast_2d(np.loadtxt(path, dtype=np.float64))
