"""Driver ``train_dp``: the ``train`` driver's closed-loop stage-1 steps
(``benchmark/drivers/train.py``, imported and reused) under data
parallelism, one process a rank, one card a rank, as the program trains
under ``torchrun``: each rank joins the group through
``parallel/mesh.py::init_from_env``, steps on its data block of the global
batch (``mesh.shard``), takes the BatchNorm moments and the loss counts
over the ranks and all-reduces the gradients once a step.

The harness's own process is rank 0, on the cell's first card (``cuda:0``)
or on the CPU; set-up starts ranks 1 to N-1 (N the cell's ``chips``) as
processes of this file on cards 1 to N-1 (on the CPU: gloo), with the
variables ``init_from_env`` reads. So the program's spans, the window's
spans and the trace are rank 0's, in the harness's process. Every rank
builds the same weights and the same pool from the seed and takes the same
draws from one seeded generator; rank 0 decides when the window ends, and
every other rank waits, before each window step, for rank 0's word on it
(a key of the group's rendezvous store, ``mesh.store``, which rank 0
serves), so that every rank stops on the same step.

The check is ``train``'s at the global batch: rank 0's checked steps, the
first gradient and the change as rank 0 holds them after the all-reduce,
each step's loss summed over the ranks, against the plain reference's
steps at the whole batch, after the group has been left.

A rank that dies ends the run: rank 0 watches the other ranks and, when
one fails before the group has been left, stops them all and exits with
1; a rank whose parent is gone exits with 1. A collective that waits on a
lost rank gives up after :data:`TIMEOUT_S`. No rank outlives the run.
"""

from __future__ import annotations

import argparse
import atexit
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

import benchmark
from benchmark.drivers import train

TIMEOUT_S = 45.0  # a collective that waits longer on a lost rank raises
POLL_S = 0.5      # how often a rank looks for a lost rank or parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _go_key(i: int) -> str:
    return f"bench_go/{i}"


class Driver(train.Driver):
    def __init__(self, cell, seed: int, device, trace: bool = False,
                 rank: int = 0, port=None):
        super().__init__(cell, seed, device, trace)
        if self.stage != "lidf":
            raise ValueError("train_dp runs stage-1 steps (stage 'lidf')")
        self.world = int(cell.entry["chips"])
        self.rank = rank
        if self.batch % self.world:
            raise ValueError(f"batch {self.batch} over {self.world} ranks")
        self.port = port
        self.procs = []
        self.done = False
        if device.type == "cuda":
            self.dev = torch.device("cuda", rank)

    # -- the ranks -------------------------------------------------------------
    def _env(self, rank: int):
        return {"RANK": str(rank), "WORLD_SIZE": str(self.world),
                "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(self.world),
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(self.port)}

    def _start_ranks(self):
        if self.dev.type == "cuda":
            from implicit_depth_torch.ops import cuda
            cuda.build_all()  # once, before the ranks load the libraries
        self.port = _free_port()
        # the ranks import the benchmark and the program from where this
        # process does; the cell's files come from the cell's root
        path = os.pathsep.join([str(Path(benchmark.__file__).parents[1]),
                                os.environ.get("PYTHONPATH", "")])
        for r in range(1, self.world):
            cmd = [sys.executable, "-m", "benchmark.drivers.train_dp",
                   "--rank", str(r), "--workload", self.cell.name,
                   "--seed", str(self.seed), "--trace", str(int(self.trace)),
                   "--root", str(self.cell.root), "--device", self.dev.type,
                   "--port", str(self.port), "--parent", str(os.getpid())]
            self.procs.append(subprocess.Popen(
                cmd, env={**os.environ, **self._env(r), "PYTHONPATH": path},
                stdout=subprocess.DEVNULL))
        atexit.register(self._stop_ranks)
        threading.Thread(target=self._watch_ranks, daemon=True).start()

    def _watch_ranks(self):
        """Rank 0: a rank that fails (exits with another code than 0, which
        it gives only once it has left the group) ends the run."""
        while not self.done:
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0) and not self.done:
                    print(f"benchmark: rank {r} of {self.world} exited with "
                          f"{p.returncode} during the run", file=sys.stderr,
                          flush=True)
                    self._stop_ranks()
                    os._exit(1)
            time.sleep(POLL_S)

    def _stop_ranks(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _join(self):
        from implicit_depth_torch.parallel import mesh
        env = self._env(self.rank)
        self.saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        mesh.init_from_env(device=str(self.dev), timeout_s=TIMEOUT_S)
        mesh.use_layout(self.batch)
        lo = self.rank * self.batch // self.world
        self.rows = slice(lo, lo + self.batch // self.world)
        self.store = mesh.store()

    # -- set-up ----------------------------------------------------------------
    def setup(self):
        if self.rank == 0:
            self._start_ranks()
        self._join()
        super().setup()

    def _step(self):
        """``train``'s step on this rank's block of the pool's batch."""
        hb = self.pool[self.i % len(self.pool)]
        self.i += 1
        sp = self.spans.span if self.spans else train._no_span
        with sp("to_device"):
            db = self._to_device({k: v[self.rows] for k, v in hb.items()},
                                 self.dev)
        with sp("step_call"):
            losses = self.step_fn(self.state, db, self.gen, self.epoch)
        if self.i <= int(self.w["checked_steps"]):
            # the checked steps' losses: the global batch's, every rank's
            # share summed
            from implicit_depth_torch.parallel import mesh
            losses = {**losses,
                      "loss_net": mesh.all_reduce_sum(losses["loss_net"])}
        return losses

    # -- the window ------------------------------------------------------------
    def window(self, seconds: float):
        """Rank 0's window, with its word on each step to the other ranks
        (1: take it; 0: the window is over)."""
        n, pending = 0, None
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end or n == 0:
            self.store.set(_go_key(n), "1")
            losses = self._step()
            if pending is not None:
                self._read(pending)
            pending, n = losses, n + 1
        self.store.set(_go_key(n), "0")
        self._read(pending)
        self.window_s = time.perf_counter() - t0
        self.steps = self.attempted = n
        self.window_spans = list(self.spans.records) if self.spans else []

    def follow(self):
        """A rank other than 0: the window's steps as rank 0 calls them,
        then the traced stretch's."""
        n, pending = 0, None
        while self.store.get(_go_key(n)) == b"1":
            losses = self._step()
            if pending is not None:
                self._read(pending)
            pending, n = losses, n + 1
        self._read(pending)
        pending = None
        for _ in range(int(self.w["trace_steps"]) if self.trace else 0):
            losses = self._step()
            if pending is not None:
                self._read(pending)
            pending = losses
        if pending is not None:
            self._read(pending)

    # -- the check -------------------------------------------------------------
    def release(self):
        """Every rank leaves the group (rank 0 once the others are done
        with it); then ``train``'s release."""
        from implicit_depth_torch.parallel import mesh
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        mesh.shutdown(clean=True)
        self.done = True
        for k, v in self.saved_env.items():  # no group left to join
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        super().release()


def _rank_main(argv=None) -> int:
    """One rank other than 0, started by rank 0's set-up."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--parent", type=int, required=True)  # rank 0's pid
    a = ap.parse_args(argv)

    def watch_parent():
        while True:
            if os.getppid() != a.parent:  # gone, even before this started
                print(f"benchmark: rank {a.rank}: rank 0 is gone",
                      file=sys.stderr, flush=True)
                os._exit(1)
            time.sleep(POLL_S)

    threading.Thread(target=watch_parent, daemon=True).start()
    import gc

    from benchmark.harness import spec
    from benchmark.harness.main import HOST_THREADS
    torch.set_num_threads(HOST_THREADS)
    cell = spec.load_cell(a.workload, Path(a.root))
    drv = Driver(cell, a.seed, torch.device(a.device), trace=bool(a.trace),
                 rank=a.rank, port=a.port)
    drv.setup()
    gc.freeze()
    drv.follow()
    drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
