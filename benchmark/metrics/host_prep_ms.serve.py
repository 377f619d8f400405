"""host_prep_ms.serve: the mean host-clock time of the served calls' host
preparation (``DepthCompleter.device_batch``: each frame's preparation,
the batch's pinned copies to the card and its point clouds), over every
call of the window, from the benchmark's span around it."""

NAME = "device_batch"


def read(run):
    d = [t1 - t0 for n, t0, t1 in run.spans if n == NAME]
    return 1e3 * sum(d) / len(d) if d else None
