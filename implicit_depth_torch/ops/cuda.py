"""Build and load the hand-written CUDA kernels of ``implicit_depth_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/idt_torch_kernels/<hash>/`` at the root of the checkout (the hash
covers every source and the flags, so an edit rebuilds). All sources build
in parallel: one ``nvcc`` process each, started together, each into a
file of its own process that is then renamed into place, so that the
ranks of a data-parallel run that build at once each load a whole
library. Libraries are loaded with ``ctypes``; every C entry point takes
raw device pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import time: the package imports on machines with no
CUDA toolkit (the CPU tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "idt_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
build_seconds: float = 0.0       # wall time of the last build (0 when cached)
build_log: str = ""              # nvcc's output of the last build (-Xptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that has no library yet; returns the
    build directory. One nvcc per source, all running at once."""
    global build_seconds, build_log
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [p for p in sorted(CSRC.glob("*.cu"))
            if not (out_dir / f"lib{p.stem}.so").exists()]
    if not todo:
        build_seconds = 0.0
        return out_dir
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
        else:
            tmp.replace(out_dir / f"lib{src.stem}.so")
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def bind(name: str, fn: str, *argtypes):
    """``lib.fn`` of ``csrc/<name>.cu`` with the given ctypes argtypes, then
    the stream (void*); returns int (a cudaError_t)."""
    key = f"{name}:{fn}"
    f = _fns.get(key)
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = [*argtypes, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns[key] = f
    return f


def ptr_array(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (``void* const*``; a
    ``None`` entry is a null pointer). The kernels index every operand as a
    dense row-major array."""
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"kernel operand of shape {tuple(t.shape)} is "
                             "not contiguous")
    return (ctypes.c_void_p * len(tensors))(*(ptr(t) for t in tensors))


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {status}")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


PTR, I64, F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
