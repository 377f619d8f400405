"""ray_decode_roofline.train: the stage-1 per-ray decode's forward and
backward least time at the steps' shapes (``harness/counts.py``) over the
device time of the kernels that did them in the traced stretch: K2 (the
forward with its saves) and K3 (Pass A, Pass B and its reductions)."""

from benchmark.harness import counts
from benchmark.harness.trace import device_seconds

KERNELS = (r"\(anonymous namespace\)::ray_decode_tc<1,",
           r"\(anonymous namespace\)::ray_decode_kernel<[^,]+, \d+, 1,",
           r"\(anonymous namespace\)::pass_a_kernel<",
           r"\(anonymous namespace\)::pass_b_kernel<",
           r"\(anonymous namespace\)::reduce_kernel")


def read(run):
    secs, n = device_seconds(run.summary, KERNELS)
    if not n:
        return None
    cfg = run.cell.config
    least = counts.least_seconds(
        *counts.decode(cfg, *run.driver.decode_images_rays(), backward=True),
        cfg["tpu"]["compute_dtype"])
    return 100.0 * least * run.driver.traced_iters / secs
