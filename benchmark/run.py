"""Runs one cell of the benchmark of ``implicit_depth_torch`` once, from
the root of a checkout::

    python3 benchmark/run.py --workload serve.refine.b8 --seed 7 \
        --seconds 30 --trace 0

Every build and kernel cache is kept at a fixed path inside the checkout,
under ``build/`` (the program's nvcc libraries go to
``build/idt_torch_kernels/``), so that only a checkout's first run builds.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "build", "bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["OMP_NUM_THREADS"] = "2"  # as harness/main.py's HOST_THREADS
sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T0))
