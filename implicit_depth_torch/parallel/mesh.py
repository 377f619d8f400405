"""The data-parallel runtime: one process per rank, a process group over
them (counterpart of ``implicit_depth_tpu/parallel/mesh.py``).

The JAX package trains as one SPMD program over the processes of a
``data`` mesh axis: ``training.batch_size`` is the global batch, each host
loads its block of it, GSPMD takes the BatchNorm statistics, the loss
normalisers and the hard-negative top-k over the global batch and inserts
the gradient ``psum``. Here each rank runs its own steps on its block and
the global reductions are explicit:

* BatchNorm statistics: ``models/resnet.py::_bn_f32`` all-reduces
  (Σx, Σx²) in training;
* loss normalisers: each rank's loss is its share of the global loss, its
  local numerator over the all-reduced count (``models/lidf.py``);
* hard negatives: ``parallel/hardneg.py::sharded_hard_neg_mean``;
* gradients: :func:`all_reduce_grads`, one SUM all-reduce of the flattened
  gradients in parameter order, between ``backward()`` and the update;
* random draws: every rank draws the global batch's tensors from the same
  generator and keeps its rows (:func:`shard`), so that its generator
  stays equal to every other rank's and to a 1-rank run's.

The group comes from torchrun's variables (:func:`init_from_env`); without
one, every function here is a no-op, and a 1-process run is the same bits
as before this module existed. The rank-aware BatchNorm, loss and draws
run when the group holds more than one rank; the gradient all-reduce, the
barriers and the broadcasts run in any group (a 1-rank group's sum is its
own value). The mesh's ``rays`` axis (one step's rays split across cards)
is not ported.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600.0  # a collective that waits longer on a lost rank raises


def init_from_env(device: Optional[str] = None,
                  backend: Optional[str] = None,
                  timeout_s: float = TIMEOUT_S) -> str:
    """Joins the process group that torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` describe (set by
    hand, they do the same) and returns the device this rank runs on:
    ``device`` when given, else ``cuda:LOCAL_RANK``. Without
    ``WORLD_SIZE`` there is no group, and the device is ``device`` or
    ``cuda``.

    ``backend`` defaults to NCCL on a CUDA device and gloo on the CPU; gloo
    also runs on CUDA tensors, and is the backend that puts several ranks
    on one card. NCCL refuses that, so two NCCL ranks on one card raise
    here, as does a ``LOCAL_RANK`` past the cards this process sees. Every
    collective gives up after ``timeout_s``."""
    if "WORLD_SIZE" not in os.environ:
        return device or "cuda"
    dev = torch.device(device) if device else local_device()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"dist backend {backend!r}: one of {BACKENDS}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but no CUDA device "
                               "is available")
        index = local_device().index if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {os.environ['RANK']} maps to cuda:{index}, but this "
                f"process sees {torch.cuda.device_count()} card(s); to run "
                "several ranks on one card pass --device cuda:0 "
                "--dist_backend gloo")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dist.is_initialized():
        return str(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank_, world_ = next(dist.rendezvous("env://", timeout=timeout))
    store.set_timeout(timeout)
    kw = {}
    if backend == "nccl":
        _refuse_shared_cards(store, rank_, world_, dev)
        kw["device_id"] = dev  # binds the communicator to this card
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            rank=rank_, world_size=world_, timeout=timeout,
                            **kw)
    return str(dev)


def _refuse_shared_cards(store, rank_: int, world_: int,
                         dev: torch.device) -> None:
    """Raises when another NCCL rank of this group runs on the same card
    (host name and card UUID, exchanged through the rendezvous store)."""
    me = f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"
    store.set(f"idt_card/{rank_}", me)
    for other in range(world_):
        if other != rank_ and store.get(f"idt_card/{other}").decode() == me:
            raise RuntimeError(
                f"ranks {min(rank_, other)} and {max(rank_, other)} both run "
                f"on card {me} under NCCL, which refuses two ranks on one "
                "card; use --dist_backend gloo to share a card")


def shutdown() -> None:
    """Leaves the process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def shard() -> Tuple[int, int]:
    """(rank, world): which block of the global batch this rank holds."""
    return rank(), world()


def local_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (torchrun's local rank; ``RANK`` when it is not
    set, 0 without either)."""
    return torch.device("cuda", int(os.environ.get(
        "LOCAL_RANK", os.environ.get("RANK", 0))))


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its copy on this rank's card where the backend is NCCL
    (which takes CUDA tensors only) and ``t`` a CPU tensor: a generator's
    state, an optimizer's step count, a host-side flag."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _broadcast_(t: torch.Tensor) -> torch.Tensor:
    """``t`` overwritten in place by rank 0's value."""
    buf = _on_backend(t)
    dist.broadcast(buf, 0)
    if buf is not t:
        t.copy_(buf)
    return t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor on ``t``'s device; no
    gradient); ``t`` itself without a group."""
    if not dist.is_initialized():
        return t
    out = _on_backend(t.detach()).clone()
    dist.all_reduce(out)
    return out.to(t.device)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's ``t`` in rank order (no gradient)."""
    src = t.detach().contiguous()
    if not dist.is_initialized():
        return src[None]
    parts = [torch.empty_like(src) for _ in range(world())]
    dist.all_gather(parts, src)
    return torch.stack(parts)


def replicate_state(*modules: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None) -> None:
    """Rank 0's parameters and buffers of ``modules``, optimizer state and
    generator state, broadcast to every rank (the counterpart of
    ``replicate``). Every rank must hold the same structure: the same
    modules, and an optimizer state with the same entries (restored from
    the same checkpoint, or empty)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for m in modules:
            for t in m.state_dict().values():
                _broadcast_(t)
        if optimizer is not None:
            for group in optimizer.param_groups:
                for p in group["params"]:
                    for k in sorted(optimizer.state.get(p, {})):
                        v = optimizer.state[p][k]
                        if torch.is_tensor(v):
                            _broadcast_(v)
    if generator is not None:
        generator.set_state(_broadcast_(generator.get_state()))


def all_reduce_grads(params: Iterable[nn.Parameter]) -> None:
    """Each parameter's ``.grad`` replaced by its sum over the ranks: the
    gradients flattened in parameter order into one buffer, one SUM
    all-reduce, unflattened (the fixed order keeps a run's bits the same
    from run to run). A parameter without a gradient keeps none; the set of
    those is the same on every rank (the graph's structure does not depend
    on the data)."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
