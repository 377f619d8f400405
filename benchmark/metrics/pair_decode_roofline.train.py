"""pair_decode_roofline.train: K6's least time over the rows it decodes in
a training step (the traffic pool's valid pairs at a budget of every slot,
``harness/pair_counts.py``) over its device time in the traced stretch."""

from benchmark.harness import counts, pair_counts
from benchmark.harness.trace import device_seconds

KERNELS = (r"pair_decode_tc<", r"pair_decode_f32<")


def read(run):
    secs, n = device_seconds(run.summary, KERNELS)
    if not n:
        return None
    d, cfg = run.driver, run.cell.config
    images, rays = d.decode_images_rays()
    k = cfg["tpu"]["max_pairs_per_ray"]
    least = counts.least_seconds(*pair_counts.k6(
        cfg, images, rays, images * rays * k, pair_counts.valid_pairs(d)),
        cfg["tpu"]["compute_dtype"])
    return 100.0 * least * d.traced_iters / secs
