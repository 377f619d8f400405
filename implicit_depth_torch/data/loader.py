"""Batched, sharded, prefetching host-side data loader (the port's copy of
``implicit_depth_tpu/data/loader.py``).

Deterministic per-epoch shuffling (``default_rng(seed + epoch)``), per-host
index slices (``host_id`` / ``num_hosts``: every host sees the same number
of batches, each host a block of every global batch), and a worker pool
that loads the samples of each batch while the trainer runs the previous
one. Two worker types (``worker_type``):
  * ``thread``  — low overhead; right for light decode (procedural synthetic,
    pre-resized data). The full-resolution ClearGrasp path is numpy-heavy
    and holds the GIL.
  * ``process`` — a forkserver pool; the dataset object is shipped once per
    worker (initializer), samples come back pickled.
Batches are dicts of stacked numpy arrays (``collate``) plus the list of
``item_path``s.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

_WORKER_DS = None


def _proc_init(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _proc_fetch(idx: int, epoch: int):
    return _WORKER_DS.__getitem__(idx, epoch)

_STACK_KEYS = ("rgb", "depth", "depth_corrupt", "xyz", "xyz_corrupt",
               "corrupt_mask", "valid_mask", "fx", "fy", "cx", "cy")


def collate(samples) -> Dict[str, np.ndarray]:
    batch = {k: np.stack([s[k] for s in samples]) for k in _STACK_KEYS}
    if "pred_mask" in samples[0]:  # optional: mask_type='pred' eval
        batch["pred_mask"] = np.stack([s["pred_mask"] for s in samples])
    batch["item_path"] = [s["item_path"] for s in samples]
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, num_workers: int = 4,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 2,
                 worker_type: str = "thread"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.worker_type = worker_type
        self._pool = None  # persistent process pool (created lazily)

    def _get_pool(self):
        if self.worker_type == "process":
            if self._pool is None:
                import multiprocessing as mp
                self._pool = ProcessPoolExecutor(
                    self.num_workers,
                    mp_context=mp.get_context("forkserver"),
                    initializer=_proc_init, initargs=(self.dataset,))
            return self._pool, _proc_fetch
        return None, None

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """Per-host index slice for one epoch.

        DistributedSampler semantics (train_lidf.py:162-175): every host sees
        the same number of batches, coverage is every-sample-once with
        wrap-around padding. One deliberate divergence: hosts take BLOCK
        slices of each global-batch window (host h owns rows
        [h·B_local, (h+1)·B_local) of every global batch) rather than
        torch's `rank::world` interleave, so that the global batch (the
        hosts' batches in host order) is the same for every number of hosts,
        and so are the position-keyed ray draws.
        """
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(n)
        # pad so every host sees the same number of batches (wrap around
        # rather than drop)
        per_host = -(-n // self.num_hosts)
        if self.drop_last:
            per_host = (per_host // self.batch_size) * self.batch_size
        total = per_host * self.num_hosts
        if total > n:
            idx = np.concatenate([idx, idx[: total - n]])
        else:
            idx = idx[:total]
        g = self.batch_size * self.num_hosts
        full = (total // g) * g
        head = idx[:full].reshape(-1, self.num_hosts, self.batch_size)[
            :, self.host_id, :].reshape(-1)
        # ragged tail (non-drop_last only): fall back to an interleave
        tail = idx[full:][self.host_id::self.num_hosts]
        return np.concatenate([head, tail])

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches, loading samples in a thread pool with prefetch."""
        indices = self._epoch_indices(epoch)
        n_batches = self.steps_per_epoch()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        proc_pool, proc_fetch = self._get_pool()

        def run_batches(pool, fetch):
            for b in range(n_batches):
                if stop.is_set():
                    return False
                chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
                futs = [pool.submit(fetch, int(i), epoch) for i in chunk]
                try:
                    out_q.put(collate([f.result() for f in futs]))
                except Exception as e:  # surface loader errors to consumer
                    out_q.put(e)
                    return False
            return True

        def producer():
            if proc_pool is not None:
                if run_batches(proc_pool, proc_fetch):
                    out_q.put(None)
                return
            with ThreadPoolExecutor(self.num_workers) as pool:
                ok = run_batches(pool,
                                 lambda i, e: self.dataset.__getitem__(i, e))
            if ok:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
