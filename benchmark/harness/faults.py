"""Faults planted under a cell's timed path, for the check that each one
turns ``correct`` false (``tests/test_port_bench_faults.py``) and for the
upper readings of the limits (``calibrate.py``):

- ``frozen``: a training step that leaves its state unchanged (the
  optimizer's update skipped);
- ``half_batch``: a training step that leaves out half of its batch, its
  mean taken over the rest;
- ``altered``: a served call whose first frame's answer is altered where
  it is produced (its predicted depth moved by 5 cm).

Planted by wrapping the program's objects once set-up has built them and
before the first call or step runs."""

from __future__ import annotations

import torch

FAULTS = ("frozen", "half_batch", "altered")


def plant(driver, name: str):
    if name not in FAULTS:
        raise ValueError(f"fault {name!r}: one of {FAULTS}")
    driver.fault = globals()["_" + name]


def _frozen(d):
    d.state.apply_gradients = lambda: None


def _half_batch(d):
    inner = d.step_fn

    def step(state, batch, gen, epoch):
        n = next(iter(batch.values())).shape[0] // 2
        return inner(state, {k: v[:n] for k, v in batch.items()}, gen, epoch)

    d.step_fn = step


def _altered(d):
    inner = d.dc.forward

    def forward(batch, seed=0, valid_idx=None):
        _, pred_z = inner(batch, seed, valid_idx)
        pred_z = pred_z.clone()
        pred_z[0] += 0.05
        depth = batch["depth_corrupt"]
        return torch.where(depth == 0, pred_z, depth), pred_z

    d.dc.forward = forward
