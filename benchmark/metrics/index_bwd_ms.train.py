"""index_bwd_ms.train: device ms a training step of PyTorch's indexing
backward and ``index_put_`` kernels (the gathers' gradients), in the
traced stretch."""

from benchmark.harness.trace import device_seconds

KERNELS = (r"indexing_backward_kernel", r"index_put")


def read(run):
    secs, n = device_seconds(run.summary, KERNELS)
    return 1e3 * secs / run.driver.traced_iters if n else None
