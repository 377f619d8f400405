"""Build and load the hand-written CUDA kernels of ``implicit_depth_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (a source of ``PER_WIDTH`` once per
decoder width, ``-DIDT_GF=<g>``, into ``lib<name>_g<g>.so``), at first use,
into
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
# imnet_gf of the decoders the decode kernels are compiled for (layers
# 4g -> 2g -> g -> 1; csrc/decode_common.cuh with_width)
DECODER_GF = (8, 16, 32, 64, 128)
# sources built once per width, in parallel: all of K3's instances in one
# translation unit took 73 s of nvcc on the H100's host
PER_WIDTH = ("ray_decode_bwd",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
build_seconds: float = 0.0       # wall time of the last build (0 when cached)
# nvcc's output of the last build (-Xptxas -v), each library's under
# "== <source> [-DIDT_GF=<g>]"
build_log: str = ""
# seconds from the start of the last build to each library
source_seconds: Dict[str, float] = {}


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
    build directory. One nvcc per library, all running at once."""
    global build_seconds, build_log, source_seconds
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = []  # (source, library, flags)
    for src in sorted(CSRC.glob("*.cu")):
        if src.stem in PER_WIDTH:
            targets += [(src, f"{src.stem}_g{g}", [f"-DIDT_GF={g}"])
                        for g in DECODER_GF]
        else:
            targets.append((src, src.stem, []))
    todo = [t for t in targets if not (out_dir / f"lib{t[1]}.so").exists()]
    if not todo:
        build_seconds = 0.0
        return out_dir
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, lib, flags in todo:
        tmp = out_dir / f"lib{lib}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs.append((lib, " ".join([src.name, *flags]), tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outs = {}

    def wait(lib, proc):  # one thread a process, so each finish is timed
        outs[lib] = proc.communicate()[0]
        source_seconds[lib] = time.perf_counter() - t0

    source_seconds = {}
    waiters = [threading.Thread(target=wait, args=(lib, proc))
               for lib, _, _, proc in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = [], []
    for lib, label, tmp, proc in procs:
        logs.append(f"== {label}\n{outs[lib]}")
        if proc.returncode != 0:
            failed.append(lib)
        else:
            tmp.replace(out_dir / f"lib{lib}.so")
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use); of a
    ``PER_WIDTH`` source, ``name`` is ``<stem>_g<g>``."""
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
