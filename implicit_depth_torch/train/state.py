"""Train state, optimizer factory and LR schedule (counterpart of
``implicit_depth_tpu/train/state.py``).

The optimizers take optax's hyper-parameters: adam and adamw (b1 0.9,
b2 0.999, eps 1e-8; adamw's decay is decoupled, ``weight_decay`` as given),
rmsprop (decay 0.9, the update g / sqrt(nu + 1e-8), eps inside the root as
optax puts it) and plain sgd. The learning rate follows ``step_lr``
evaluated on the count of updates made so far, as optax evaluates a
schedule. ``lbfgs`` (optax's ``lbfgs(linesearch=None)``) has no PyTorch twin
and raises.
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
        raise NotImplementedError("lbfgs: optax.lbfgs(linesearch=None) has no "
                                  "PyTorch counterpart in the port")
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
