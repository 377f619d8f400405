"""sync_wait_ms.train: the mean host-clock ms a training step waits for
the card inside the step (the program's ``sync.*`` spans under
``train.step``, each operation that makes the host wait counted once),
over the steps of the traced stretch. None where the program keeps no
spans."""

STEP, PREFIX = "train.step", "sync."


def read(run):
    try:
        from implicit_depth_torch.utils.profiling import spans
    except ImportError:
        return None
    # the traced stretch's records: set-up's profiled step came before the
    # window, whose spans are on the same clock
    after = max((t1 for _, _, t1 in run.spans), default=0.0) * 1e9
    recs = [r for r in spans() if r.start_ns > after]
    by_id = {r.id: r for r in recs}

    def in_step(r):
        up = by_id.get(r.parent)
        while up is not None:
            if up.name == STEP:
                return True
            if up.name.startswith(PREFIX):  # inside another wait
                return False
            up = by_id.get(up.parent)
        return False

    d = [r.end_ns - r.start_ns for r in recs
         if r.name.startswith(PREFIX) and in_step(r)]
    return 1e-6 * sum(d) / run.driver.traced_iters if d else None
