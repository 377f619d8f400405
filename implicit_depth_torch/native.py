"""ctypes bindings for the native host runtime (native/libidt_native.so;
the port's copy of ``implicit_depth_tpu/native.py``, over the same C
sources in ``native/``).

Builds lazily on first use if the .so is missing (g++ is in the image);
callers always have a pure-python fallback, so failures degrade gracefully.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
_SO_PATH = osp.join(_ROOT, "native", "libidt_native.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not osp.exists(_SO_PATH):
        build = osp.join(_ROOT, "native", "build.sh")
        if osp.exists(build):
            try:
                subprocess.run(["sh", build], capture_output=True, check=True,
                               timeout=120)
            except Exception:
                return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.idt_exr_unzip.restype = ctypes.c_int
    lib.idt_exr_unzip.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                  ctypes.c_void_p, ctypes.c_long]
    lib.idt_exr_unrle.restype = ctypes.c_long
    lib.idt_exr_unrle.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                  ctypes.c_void_p, ctypes.c_long]
    lib.idt_connected_components.restype = ctypes.c_int
    lib.idt_connected_components.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def exr_unzip(data: bytes, out_len: int) -> Optional[np.ndarray]:
    """Inflate + un-predictor + de-interleave an EXR ZIP chunk."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(out_len, np.uint8)
    rc = lib.idt_exr_unzip(data, len(data), out.ctypes.data, out_len)
    return out if rc == 0 else None


def exr_unrle(data: bytes, out_len: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(out_len, np.uint8)
    n = lib.idt_exr_unrle(data, len(data), out.ctypes.data, out_len)
    return out[:n] if n >= 0 else None


def connected_components(mask: np.ndarray) -> Optional[np.ndarray]:
    """4-connected labeling of mask != 0 -> int32 labels (0 background)."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = m.shape
    labels = np.empty((h, w), np.int32)
    lib.idt_connected_components(m.ctypes.data, h, w, labels.ctypes.data)
    return labels
