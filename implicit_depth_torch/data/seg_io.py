"""Indexed-PNG segmentation IO (the port's copy of
``implicit_depth_tpu/data/seg_io.py``, on ``data/png.py`` instead of
Pillow).

Parity: src/utils/seg_utils.py — ``imread_indexed`` (palette PNG -> raw index
matrix) and ``imwrite_indexed`` (write with palette), plus the index-matrix
builder.
"""

from __future__ import annotations

import numpy as np

from implicit_depth_torch.data.png import read_png_pillow, write_png


def build_matrix_of_indices(height: int, width: int) -> np.ndarray:
    """(H, W, 2): [..., 0] y coords, [..., 1] x coords."""
    return np.indices((height, width), dtype=np.float32).transpose(1, 2, 0)


def imread_indexed(path: str) -> np.ndarray:
    """The image as ``np.array(Image.open(path))``: a palette image's
    indices, a grey image's values (``png.read_png_pillow``)."""
    return read_png_pillow(path)


# The DAVIS palette used by ClearGrasp masks (first entries; rest generated).
def _default_palette() -> np.ndarray:
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        r = g = b = 0
        cid, shift = i, 7
        while cid:
            r |= (cid & 1) << shift
            g |= ((cid >> 1) & 1) << shift
            b |= ((cid >> 2) & 1) << shift
            cid >>= 3
            shift -= 1
        pal[i] = (r, g, b)
    return pal


def imwrite_indexed(path: str, array: np.ndarray,
                    palette: np.ndarray | None = None) -> None:
    if array.ndim != 2:
        raise ValueError("indexed PNG requires a 2-D label array")
    pal = palette if palette is not None else _default_palette()
    write_png(path, np.asarray(array).astype(np.uint8), palette=pal)
