"""Train state and optimizer. Port of fast3dhpe_tpu/train/state.py
(:19-89): the state holds the model (parameters and BN running
statistics), the optimizer, the LR schedule and the count of updates.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch
from torch import nn


def multistep_lr(base_lr: float, lr_steps, lr_factor: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR on optimizer steps: update k (counting from 0) runs at
    base_lr * lr_factor^(number of boundaries e * steps_per_epoch <= k),
    as optax.piecewise_constant_schedule counts."""
    boundaries = sorted(int(e) * steps_per_epoch for e in lr_steps)

    def schedule(count: int) -> float:
        return base_lr * lr_factor ** sum(count >= b for b in boundaries)

    return schedule


def make_optimizer(cfg, steps_per_epoch: int, params: Iterable):
    """Adam(0.9, 0.999, eps=1e-8) with the config's MultiStepLR schedule,
    as optax.adam(multistep_lr(...)). torch's Adam adds eps outside the
    square root of the bias-corrected second moment, as optax does with
    eps_root = 0. Returns (optimizer, schedule)."""
    schedule = multistep_lr(cfg.TRAIN.LR, cfg.TRAIN.LR_STEP,
                            cfg.TRAIN.LR_FACTOR, steps_per_epoch)
    opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, schedule


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over the concatenation of all gradients, on the device."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


@torch.no_grad()
def clip_grads_by_norm(grads: List[torch.Tensor], max_norm: float,
                       enable: bool) -> torch.Tensor:
    """Scale the gradients in place by max_norm / (norm + 1e-6) when
    `enable` is set and norm > max_norm, as the JAX package does
    (torch.nn.utils.clip_grad_norm_ would also scale, by a factor just
    below 1, at norm == max_norm). Returns the norm before clipping."""
    norm = global_grad_norm(grads)
    if enable:
        factor = torch.where(norm > max_norm, max_norm / (norm + 1e-6), 1.0)
        for g in grads:
            g.mul_(factor)
    return norm


class TrainState:
    """A model, its optimizer and LR schedule, and the number of updates
    taken (`step`)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0

    @classmethod
    def create(cls, model: nn.Module, cfg,
               steps_per_epoch: int) -> "TrainState":
        opt, schedule = make_optimizer(cfg, steps_per_epoch,
                                       model.parameters())
        return cls(model, opt, schedule)

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.model.parameters() if p.grad is not None]

    def apply_gradients(self):
        """One optimizer update from the parameters' .grad, at the LR the
        schedule gives this update's index."""
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.step += 1
