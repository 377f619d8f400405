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

The ranks form JAX's ``("data", "rays")`` mesh (:func:`layout`, the rule of
the JAX trainer, ``implicit_depth_tpu/train/trainer.py:77-93``): a train
step's global batch is split into ``data`` blocks of images, and each
image's rays into ``rays`` blocks (:func:`ray_block`), so that ranks
beyond the batch size still share the work. The ranks of one data block
(a *rays group*, within one host) hold the same images and compute their
trunk alike; each decodes its block of rays, and the image-level loss
terms gather the predictions along the group (:class:`Split`). Eval
frames split their rays over every rank (JAX's ``ray_axis=("data",
"rays")``). The BatchNorm moments reduce over the rank's *data group*
(the ranks of its ray index: one copy of each image, see
``models/resnet.py``); the loss counts, the hard-negative top-k and the
gradients over every rank.

The group comes from torchrun's variables (:func:`init_from_env`); without
one, every function here is a no-op, and a 1-process run is the same bits
as before this module existed. The rank-aware BatchNorm, loss and draws
run when the group holds more than one rank; the gradient all-reduce, the
barriers and the broadcasts run in any group (a 1-rank group's sum is its
own value). Until :func:`use_layout` is called the layout is ``data`` =
world, ``rays`` = 1: every rank a block of the batch.

Tracing (``utils/profiling.py``): the span ``parallel.all_reduce_grads``
around the gradients' all-reduce, and the counters
``all_reduce_grads.calls`` and ``all_reduce_sum.calls`` (the loss counts;
the BatchNorm moments' all-reduces are counted in
``models/resnet.py::_global_moments.calls``), all of which only a group
moves.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
from typing import Any, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from implicit_depth_torch.utils import profiling

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
    global _STORE
    store, rank_, world_ = next(dist.rendezvous("env://", timeout=timeout))
    store.set_timeout(timeout)
    _STORE = store
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


def store():
    """The rendezvous store of :func:`init_from_env`'s group (rank 0
    serves it), for keys of the caller's own; None outside such a group."""
    return _STORE


def shutdown(clean: bool = True) -> None:
    """Leaves the process group, when there is one, and forgets the
    layout. ``clean`` (every rank got here without an error): a barrier
    first, so that no rank tears its group down while another still has a
    collective in flight, and the rank that serves the rendezvous store
    (rank 0) waits, after leaving, until every other rank has left, so that
    none of them loses the store in the middle of its own teardown. After
    an error the group is torn down at once: the other ranks may never
    reach the barrier."""
    global _LAYOUT, _RAYS_GROUP, _DATA_GROUP, _STORE
    _LAYOUT, _RAYS_GROUP, _DATA_GROUP = None, None, None
    store, _STORE = _STORE, None
    if not dist.is_initialized():
        return
    rank_, world_ = dist.get_rank(), dist.get_world_size()
    if clean:
        dist.barrier()
    dist.destroy_process_group()
    if clean and store is not None and world_ > 1:
        if rank_:
            store.set(f"idt_left/{rank_}", "1")
        else:
            store.wait([f"idt_left/{r}" for r in range(1, world_)])


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def shard() -> Tuple[int, int]:
    """(data index, data): which block of the global batch this rank holds
    (every rank of a rays group the same one)."""
    lay = current()
    return lay.data_index, lay.data


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
    all_reduce_sum.calls += 1
    out = _on_backend(t.detach()).clone()
    dist.all_reduce(out)
    return out.to(t.device)


all_reduce_sum.calls = 0


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
    all_reduce_grads.calls += 1
    with profiling.span("parallel.all_reduce_grads"):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


all_reduce_grads.calls = 0


# -- the ("data", "rays") layout ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """The ranks as JAX's ``("data", "rays")`` mesh: ``data`` blocks of the
    global batch, each image's rays split over ``rays`` ranks; this rank at
    (``data_index``, ``ray_index``), ``coords[r]`` rank r's."""

    data: int
    rays: int
    data_index: int
    ray_index: int
    coords: Tuple[Tuple[int, int], ...]


def layout(batch_size: int, world_size: Optional[int] = None,
           local_world_size: Optional[int] = None,
           rank_: Optional[int] = None) -> Layout:
    """The layout of ``world_size`` ranks, ``local_world_size`` a host, for
    a global batch of ``batch_size`` (defaults: the group's world and rank,
    torchrun's ``LOCAL_WORLD_SIZE``, else one host). The JAX trainer's rule
    (``implicit_depth_tpu/train/trainer.py:77-93``): per host the batch
    ``batch_size // hosts``, ``data_local = gcd(per-host batch, local)``,
    ``rays = local // data_local``, ``data = data_local · hosts``; ranks
    are hosts-major, so that a rays group never crosses a host, and local
    rank ``lr`` of host ``h`` sits at data index ``h·data_local + lr //
    rays``, ray index ``lr % rays`` (``make_mesh``'s device order,
    ``implicit_depth_tpu/parallel/mesh.py:63-69``). Raises a ValueError
    for a layout JAX would refuse: uneven ranks a host, or a batch that is
    not a multiple of the host count."""
    world_size = world() if world_size is None else int(world_size)
    rank_ = rank() if rank_ is None else int(rank_)
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    local = int(local_world_size)
    if local < 1 or world_size % local:
        raise ValueError(f"{world_size} ranks do not make hosts of "
                         f"{local} ranks each (LOCAL_WORLD_SIZE)")
    hosts = world_size // local
    if batch_size < 1 or batch_size % hosts:
        raise ValueError(f"training.batch_size {batch_size} must be a "
                         f"multiple of the host count {hosts} ({world_size} "
                         f"ranks, {local} a host): the data axis is split "
                         "hosts-major and the rays stay within a host")
    data_local = math.gcd(batch_size // hosts, local)
    rays = local // data_local
    coords = tuple((h * data_local + lr // rays, lr % rays)
                   for h in range(hosts) for lr in range(local))
    return Layout(data_local * hosts, rays, *coords[rank_], coords)


_LAYOUT: Optional[Layout] = None
_RAYS_GROUP = None  # this rank's rays group (None: the default group)
_DATA_GROUP = None  # this rank's data group (None: the default group)
_STORE = None  # the rendezvous store of init_from_env's group


def _axis_groups(lay: Layout, axis: int):
    """The process group of this rank along ``axis`` of the layout (0: its
    data group, the ranks of its ray index; 1: its rays group), made for
    every index of the other axis in turn; None where the axis spans every
    rank (the default group) or this rank alone."""
    size, other = ((lay.data, lay.rays) if axis == 0
                   else (lay.rays, lay.data))
    if not dist.is_initialized() or size in (1, size * other):
        return None
    mine = (lay.ray_index, lay.data_index)[axis]
    group = None
    for i in range(other):
        g = dist.new_group([r for r, c in enumerate(lay.coords)
                            if c[1 - axis] == i])
        if i == mine:
            group = g
    return group


def use_layout(batch_size: int) -> Layout:
    """Sets this process's layout for a global batch of ``batch_size``
    (:func:`layout`) and makes the process groups of its rays groups and
    data groups: every rank must call it, with the same batch size, in the
    same order as its other collectives (``torch.distributed.new_group``
    is one). Returns the layout."""
    global _LAYOUT, _RAYS_GROUP, _DATA_GROUP
    lay = layout(batch_size)
    if lay == _LAYOUT:
        return lay
    _RAYS_GROUP = _axis_groups(lay, 1)
    _DATA_GROUP = _axis_groups(lay, 0)
    _LAYOUT = lay
    return lay


def data_group():
    """The process group of this rank's data axis: the ranks of its ray
    index, which hold one copy of each image of the global batch (None:
    the default group, or this rank alone when ``data`` is 1)."""
    return _DATA_GROUP


def current() -> Layout:
    """The layout :func:`use_layout` set; before that every rank a block of
    the batch (``data`` = world, ``rays`` = 1)."""
    if _LAYOUT is not None:
        return _LAYOUT
    w = world()
    return Layout(w, 1, rank(), 0, tuple((r, 0) for r in range(w)))


def ray_block(n: int, blocks: int, block: int) -> Tuple[int, int]:
    """[start, stop) of block ``block`` of ``n`` rays split into ``blocks``
    contiguous blocks: ``block·n // blocks`` on, the sizes differing by at
    most one where ``blocks`` does not divide ``n`` (no slot is padded).
    Raises when a block would be empty."""
    if n < blocks:
        raise ValueError(f"{n} rays split over {blocks} ranks: a rank's "
                         "block of rays would be empty")
    return block * n // blocks, (block + 1) * n // blocks


@dataclasses.dataclass(frozen=True)
class Split:
    """Where a rank's (b, r, ...) ray tensors lie in the global batch's
    (B, R, ...): rows [row·b, (row + 1)·b), of which there are ``rows``
    blocks, and block ``block`` of the ``blocks`` blocks of each row's
    ``n`` rays; ``group`` is the process group of the ranks that hold the
    row's blocks, in block order (None: the default group)."""

    row: int
    rows: int
    block: int
    blocks: int
    n: int
    group: Any = None

    def bounds(self) -> Tuple[int, int]:
        return ray_block(self.n, self.blocks, self.block)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(b, n, ...): every block of ``x`` (b, r, ...) along the rays, in
        block order; its gradient is the sum of the ranks' incoming
        gradients, this rank's block of it (:class:`_GatherRays`)."""
        if self.blocks == 1:
            return x
        return _GatherRays.apply(x, self)


def train_split(n: int) -> Split:
    """A train step's split of its images' ``n`` rays under the layout: the
    rank's data block, its block of rays in its rays group."""
    lay = current()
    return Split(lay.data_index, lay.data, lay.ray_index, lay.rays, n,
                 _RAYS_GROUP)


def eval_split(n: int) -> Split:
    """An eval step's split: every rank holds the same frames, and their
    ``n`` rays are split over all ranks (JAX's ``ray_axis=("data",
    "rays")``)."""
    return Split(0, 1, rank(), world(), n, None)


def _gather_rays(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The blocks of ``split`` joined along dim 1 (each padded to the
    largest for the all-gather, the padding cut)."""
    sizes = [ray_block(split.n, split.blocks, i) for i in range(split.blocks)]
    width = max(e - s for s, e in sizes)
    src = x.detach()
    if src.dtype == torch.bool:  # gathered as bytes
        src = src.to(torch.uint8)
    src = _on_backend(src)
    pad = width - src.shape[1]
    if pad:
        src = torch.cat([src, src.new_zeros((src.shape[0], pad,
                                             *src.shape[2:]))], 1)
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(split.blocks)]
    dist.all_gather(parts, src, group=split.group)
    out = torch.cat([p[:, :e - s] for p, (s, e) in zip(parts, sizes)], 1)
    return out.to(device=x.device, dtype=x.dtype)


class _GatherRays(torch.autograd.Function):
    """:meth:`Split.gather` with a gradient: the incoming gradients of the
    gathered tensor summed over the ranks of the split (one all-reduce, the
    same sum on every rank), this rank's block of the sum."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _gather_rays(x, split)

    @staticmethod
    def backward(ctx, g):
        split = ctx.split
        buf = _on_backend(g.contiguous()).clone()
        dist.all_reduce(buf, group=split.group)
        s, e = split.bounds()
        return buf[:, s:e].to(g.device).contiguous(), None
