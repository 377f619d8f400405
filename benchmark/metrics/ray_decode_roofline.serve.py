"""ray_decode_roofline.serve: the stage-1 per-ray decode's least time at
the calls' shapes (``harness/counts.py``) over the device time of the
kernels that did it in the traced stretch: K1 (the forward decode)."""

from benchmark.harness import counts
from benchmark.harness.trace import device_seconds

KERNELS = (r"\(anonymous namespace\)::ray_decode_tc<0,",
           r"\(anonymous namespace\)::ray_decode_kernel<[^,]+, \d+, 0,")


def read(run):
    secs, n = device_seconds(run.summary, KERNELS)
    if not n:
        return None
    cfg = run.cell.config
    least = counts.least_seconds(*counts.decode(cfg, *run.driver.decode_images_rays()),
                                 cfg["tpu"]["compute_dtype"])
    return 100.0 * least * run.driver.traced_iters / secs
