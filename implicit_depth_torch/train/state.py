"""Train state, optimizer factory and LR schedule (counterpart of
``implicit_depth_tpu/train/state.py``).

The optimizers take optax's hyper-parameters: adam and adamw (b1 0.9,
b2 0.999, eps 1e-8; adamw's decay is decoupled, ``weight_decay`` as given),
rmsprop (decay 0.9, the update g / sqrt(nu + 1e-8), eps inside the root as
optax puts it), plain sgd and lbfgs (:class:`LBFGS`, optax's
``lbfgs(lr, linesearch=None)``). The learning rate follows ``step_lr``
evaluated on the count of updates made so far, as optax evaluates a
schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Union

import torch
from torch import nn

Schedule = Callable[[int], float]


def step_lr(base_lr: float, steps_per_epoch: int, nepoch_decay: int,
            gamma: float) -> Schedule:
    """StepLR: lr · gamma^floor(epoch / nepoch_decay), stepped per epoch;
    ``count`` is the number of updates made before this one."""
    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // max(nepoch_decay, 1))
    return schedule


class _RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: nu = d·nu + (1-d)·g², p -= lr · g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "nu" not in st:
                    st["nu"] = torch.zeros_like(p)
                nu = st["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.sub_(group["lr"] * p.grad * torch.rsqrt(nu + group["eps"]))


class LBFGS(torch.optim.Optimizer):
    """optax 0.2.6's ``lbfgs(lr, linesearch=None)``: ``scale_by_lbfgs``
    (``memory`` 10, ``scale_init_precond``) and then the learning rate, p
    -= lr · P·g. Not ``torch.optim.LBFGS``, which needs a closure, searches
    a line and keeps another recursion.

    The parameters (f32) are one vector, as optax's ``tree.vdot`` sums over
    every leaf. Each step writes the last step's pair (δw = w - w_prev, δg
    = g - g_prev, ρ = 1/⟨δg, δw⟩, 0 where that is 0) into the ring at count
    - 1, scales the identity by ⟨δg, δw⟩ / ‖δg‖² (1 where ‖δg‖ is 0;
    min(1, 1/‖g‖) at count 0) and runs the two-loop recursion from the
    newest pair. The state (count, the last parameters and gradient, the
    ring of m pairs and ρ: 2·m + 2 vectors) lives in the first parameter's
    entry of ``self.state``, so ``state_dict`` carries it: a resumed run
    takes the uninterrupted run's steps bit for bit. Under a process group
    the gradients are summed before the step (``mesh.all_reduce_grads``),
    so every rank holds the same state."""

    def __init__(self, params, lr: float, memory: int = 10):
        super().__init__(params, {"lr": lr})
        self.memory = memory
        ps = self._params()
        n = sum(p.numel() for p in ps)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=ps[0].device)

        # "step": the count of updates (kept as it is by load_state_dict)
        self.state[ps[0]].update(step=0, params=zeros(n), updates=zeros(n),
                                 diff_params=zeros(memory, n),
                                 diff_updates=zeros(memory, n),
                                 weights=zeros(memory))

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        ps = self._params()
        st, m = self.state[ps[0]], self.memory
        w = torch.cat([p.reshape(-1) for p in ps])
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                       .reshape(-1) for p in ps])
        count = st["step"]
        dws, dus, rho = st["diff_params"], st["diff_updates"], st["weights"]
        prev = (count - 1) % m
        if count > 0:
            dw, du = w - st["params"], g - st["updates"]
            vd = torch.dot(du, dw)
            dws[prev], dus[prev] = dw, du
            rho[prev] = torch.where(vd == 0, torch.zeros_like(vd), 1.0 / vd)
            den = torch.dot(du, du)
            gamma = torch.where(den > 0, vd / den, torch.ones_like(den))
        else:
            dws[prev], dus[prev], rho[prev] = 0.0, 0.0, 0.0
            gamma = (1.0 / torch.linalg.vector_norm(g)).clamp(max=1.0)
        order = [(count % m + i) % m for i in range(m)]
        q, alphas = g.clone(), {}
        for i in reversed(order):
            alphas[i] = rho[i] * torch.dot(dws[i], q)
            q.sub_(dus[i] * alphas[i])
        q.mul_(gamma)
        for i in order:
            beta = rho[i] * torch.dot(dus[i], q)
            q.add_(dws[i] * (alphas[i] - beta))
        st["params"].copy_(w)
        st["updates"].copy_(g)
        st["step"] = count + 1
        q.mul_(-self.param_groups[0]["lr"])
        offset = 0
        for p in ps:
            p.add_(q[offset:offset + p.numel()].view_as(p))
            offset += p.numel()


def make_optimizer(name: str, params: Iterable[nn.Parameter],
                   lr: Union[float, Schedule],
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params``; a schedule ``lr`` is applied
    by :meth:`TrainState.apply_gradients` before each update."""
    lr0 = lr(0) if callable(lr) else lr
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "rmsprop":
        return _RMSprop(params, lr=lr0)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr0)
    if name == "lbfgs":
        return LBFGS(params, lr=lr0)
    raise ValueError(f"unsupported optimizer {name!r}")


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, the
    learning-rate schedule and the count of updates made. The stage-2 state
    holds the refine model, whose parameters are all it trains: it has no
    batch statistics, and the frozen stage 1 stays outside the state."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr: Union[float, Schedule]
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, cfg_training,
               steps_per_epoch: int) -> "TrainState":
        """Optimizer + StepLR from a ``training`` config section, over the
        parameters of ``model`` that ask for a gradient."""
        sched = step_lr(cfg_training.lr, steps_per_epoch,
                        cfg_training.nepoch_decay, cfg_training.decay_gamma)
        opt = make_optimizer(cfg_training.optimizer_name,
                             [p for p in model.parameters() if p.requires_grad],
                             sched)
        return cls(model=model, optimizer=opt, lr=sched)

    def apply_gradients(self) -> None:
        """One update from the gradients in ``.grad``, at the learning rate
        of the current count; then the count moves on."""
        lr = self.lr(self.step) if callable(self.lr) else self.lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
