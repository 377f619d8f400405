"""geometry_ms.serve: the mean host-clock ms a served call spends in the
geometry stage (the program's ``lidf.prepare_inputs`` span: the
valid-point draw, the voxel grid, the ray/grid walk), less the waits for
the card inside it (its ``sync.*`` spans, which ``sync_wait_ms.serve``
counts), over the calls of the traced stretch. None where the program
keeps no spans."""

NAME, WAIT = "lidf.prepare_inputs", "sync."


def read(run):
    try:
        from implicit_depth_torch.utils.profiling import spans
    except ImportError:
        return None
    # the traced stretch's records: set-up's profiled call came before the
    # window, whose spans are on the same clock
    after = max((t1 for _, _, t1 in run.spans), default=0.0) * 1e9
    recs = [r for r in spans() if r.start_ns > after]
    by_id = {r.id: r for r in recs}
    waits = {}  # id of a NAME span -> the outermost waits inside it
    for r in recs:
        up = by_id.get(r.parent) if r.name.startswith(WAIT) else None
        while up is not None and not up.name.startswith(WAIT):
            if up.name == NAME:
                waits.setdefault(up.id, []).append((r.start_ns, r.end_ns))
                break
            up = by_id.get(up.parent)
    d = []
    for r in recs:
        if r.name != NAME:
            continue
        own, reach = r.end_ns - r.start_ns, r.start_ns
        for s, e in sorted(waits.get(r.id, ())):  # their union, once
            own -= max(0, e - max(s, reach))
            reach = max(reach, e)
        d.append(own)
    return 1e-6 * sum(d) / run.driver.traced_iters if d else None
