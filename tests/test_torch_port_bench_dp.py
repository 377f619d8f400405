"""The benchmark's data-parallel driver (``benchmark/drivers/train_dp.py``)
on the CPU, in a cell added to a tiny copy of the benchmark
(``train.lidf.b32``'s steps and limits on N ranks): two and four gloo ranks
run a window and its check against the reference at the global batch, with
the program's all-reduce span and counters; ranks that leave the gradients
unexchanged fail the check; a rank that dies ends the run with another
code than 0 within its limit, and leaves no process behind; without a
group the span and the counters stay still."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from implicit_depth_torch.models import resnet
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "train.lidf.b32.dp"
BASE = "train.lidf.b32"  # the one-card cell whose steps and limits it takes
# the metrics of the one-card training cells that read rank 0's process
METRICS = ("train_samples_per_s", "dispatch_ms.train", "device_idle.train",
           "backward_ms.train", "sync_wait_ms.train")
LIMIT_S = 60.0  # a run with a dead rank ends within this


@pytest.fixture(scope="module")
def tiny_roots(tmp_path_factory):
    """ranks -> the benchmark at its tests' tiny size (a batch of 4), with
    the cell on that many ranks added to it."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmark.harness import spec
        conftest = spec.load_module(ROOT / "benchmark" / "tests"
                                    / "conftest.py", "bench_tests_conftest")
    finally:
        sys.path.remove(str(ROOT))
    roots = {}

    def make(ranks):
        if ranks not in roots:
            root = conftest.make_tiny_root(
                tmp_path_factory.mktemp(f"dp{ranks}") / "root")
            data = root / "benchmark" / "workloads"
            work = json.loads((data / f"{BASE}.json").read_text())
            (data / f"{CELL}.json").write_text(
                json.dumps({**work, "driver": "train_dp"}))
            bench = json.loads((root / "BENCHMARK.json").read_text())
            base = next(w for w in bench["workloads"] if w["name"] == BASE)
            bench["workloads"].append({**base, "name": CELL, "chips": ranks})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if m["name"] in METRICS:
                    m["workloads"].append(CELL)
            (root / "BENCHMARK.json").write_text(json.dumps(bench))
            roots[ranks] = root
        return roots[ranks]

    return make


RUN = """
import contextlib, io, json, pathlib, sys
sys.path.insert(0, {repo!r})
from benchmark.harness.main import main
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = main(["--workload", {cell!r}, "--seed", "3000000019", "--seconds",
               {seconds!r}, "--trace", {trace!r}],
              root=pathlib.Path({root!r}), device="cpu")
from implicit_depth_torch.models import resnet
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.utils import profiling
recs = profiling.spans()
by_id = {{r.id: r for r in recs}}
spans = [(r.name, by_id[r.parent].name if r.parent in by_id else None)
         for r in recs if r.name == "parallel.all_reduce_grads"]
print(json.dumps({{"rc": rc, "line": out.getvalue().strip().splitlines()[-1],
                  "counters": [mesh.all_reduce_grads.calls,
                               mesh.all_reduce_sum.calls,
                               resnet._global_moments.calls],
                  "spans": spans}}))
"""


def _harness(root, seconds, trace=0, path=()):
    """The harness's process on ``root``'s cell; ``path``: directories put
    first on every rank's PYTHONPATH."""
    code = RUN.format(repo=str(ROOT), cell=CELL, seconds=str(seconds),
                      trace=str(trace), root=str(root))
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    if path:
        env["PYTHONPATH"] = os.pathsep.join(
            [*map(str, path), str(ROOT), env.get("PYTHONPATH", "")])
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _ranks(parent=None):
    """{pid: rank} of the driver's rank processes alive (of ``parent``)."""
    found = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            argv = (d / "cmdline").read_bytes().split(b"\0")
            stat = (d / "stat").read_text()
        except OSError:
            continue
        if b"benchmark.drivers.train_dp" not in argv:
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if state == "Z" or (parent is not None and int(ppid) != parent):
            continue
        found[int(d.name)] = int(argv[argv.index(b"--rank") + 1])
    return found


@pytest.mark.parametrize("ranks", [2, 4])
def test_the_ranks_run_a_window_and_its_check(tiny_roots, ranks):
    """Rank 0 in the harness's process, the others its children: one
    result line, ``correct`` against the reference at the global batch;
    the gradients' all-reduce once a step, in its span under
    ``train.backward``; the BatchNorm moments and the loss counts
    all-reduced; no rank left."""
    p = _harness(tiny_roots(ranks), 1.0, trace=1)
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    line = json.loads(got["line"])
    assert got["rc"] == 0
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"dispatch_ms.train", "backward_ms.train"} <= set(line["metrics"])
    steps = 3 + 3 + 1 + line["attempted"] + 3  # checked, warm, set-up's
    # profiled step, the window, the traced stretch
    grads, sums, moments = got["counters"]
    assert grads == steps
    assert sums > steps and moments > 0
    assert got["spans"] and all(parent == "train.backward"
                                for _, parent in got["spans"])
    assert _ranks(p.pid) == {}


# every rank's gradients left as its own block's: the exchange between the
# cards left out, planted in each rank's process as it starts
UNEXCHANGED = """
from implicit_depth_torch.parallel import mesh


def all_reduce_grads(params):
    pass


all_reduce_grads.calls = 0
mesh.all_reduce_grads = all_reduce_grads
"""


def test_unexchanged_gradients_fail_the_check(tiny_roots, tmp_path):
    """With no gradient all-reduce on any rank (the BatchNorm moments and
    the loss counts still exchanged), rank 0's first gradient is its own
    block's, and the check refuses the run by it."""
    (tmp_path / "sitecustomize.py").write_text(UNEXCHANGED)
    p = _harness(tiny_roots(2), 0.5, path=[tmp_path])
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    line = json.loads(got["line"])
    assert got["counters"][0] == 0  # no gradient all-reduce ran
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["grad_norm_gap_median"]["value"] \
        > checks["grad_norm_gap_median"]["limit"], checks
    assert _ranks(p.pid) == {}


@pytest.mark.parametrize("killed", [1, 0])
def test_a_killed_rank_ends_the_run(tiny_roots, killed):
    """Rank 1 killed: rank 0 ends the run with another code than 0 well
    inside the limit (not at the collectives' time-out), and no rank is
    left; rank 0 killed: rank 1 exits on its own within the limit."""
    p = _harness(tiny_roots(2), 300.0)
    try:
        t0 = time.monotonic()
        while not _ranks(p.pid) and time.monotonic() - t0 < 120:
            assert p.poll() is None, p.communicate()[1][-3000:]
            time.sleep(0.2)
        ranks = _ranks(p.pid)
        assert list(ranks.values()) == [1]
        time.sleep(5.0)  # into the run
        rank1 = next(iter(ranks))
        os.kill(rank1 if killed else p.pid, signal.SIGKILL)
        t_kill = time.monotonic()
        if killed:
            p.communicate(timeout=LIMIT_S + 30)
            assert p.returncode not in (0, None)
        else:
            p.wait(timeout=30)
        while rank1 in _ranks() and time.monotonic() - t_kill < LIMIT_S:
            time.sleep(0.2)
        assert time.monotonic() - t_kill < LIMIT_S
        assert rank1 not in _ranks()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        for pid in _ranks(p.pid):
            os.kill(pid, signal.SIGKILL)


def test_without_a_group_the_all_reduces_stay_still():
    """No group: the gradients, the loss counts and the BatchNorm moments
    are not reduced, and neither the span nor the counters move."""
    assert not torch.distributed.is_initialized()
    lin = torch.nn.Linear(3, 2)
    lin(torch.ones(4, 3)).sum().backward()
    before = (mesh.all_reduce_grads.calls, mesh.all_reduce_sum.calls,
              resnet._global_moments.calls)
    grad = lin.weight.grad.clone()
    profiling.enable()
    try:
        since = max((r.id for r in profiling.spans()), default=0)
        mesh.all_reduce_grads(lin.parameters())
        t = torch.ones(3)
        assert mesh.all_reduce_sum(t) is t
        resnet._global_moments(torch.ones(2, 3, 4, 4))
    finally:
        profiling.disable()
    assert torch.equal(lin.weight.grad, grad)
    assert [r.name for r in profiling.spans() if r.id > since] == []
    assert (mesh.all_reduce_grads.calls, mesh.all_reduce_sum.calls,
            resnet._global_moments.calls) == before
