"""Train state and optimizer. Port of fast3dhpe_tpu/train/state.py
(:19-89): the state holds the model (parameters and BN running
statistics), the optimizer, the LR schedule and the count of updates.

On CUDA the optimizer is Adam with `capturable=True` and its LR a device
tensor that the schedule writes in place, so that a CUDA graph of the
train step (train/graphs.py) replays every update at the LR of its own
index: a graph would keep a Python-float LR of the step it captured. The
eager steps on CUDA use the same optimizer, so an eager and a graphed
epoch are bit-equal. The CPU keeps Adam with a float LR. Both forms write
the same checkpoint (`optimizer_state_dict`: a float LR, `capturable`
off, Adam's step counts on the host), and each loads the other's
(`load_optimizer_state_dict`).
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
    eps_root = 0. On CUDA parameters it is capturable, its LR a device
    tensor (module docstring). `params` may be parameter groups, each
    with an "lr_scale": the group then runs at the schedule's LR times its
    scale (the volumetric model's, models/volumetric.py param_groups).
    Returns (optimizer, schedule)."""
    schedule = multistep_lr(cfg.TRAIN.LR, cfg.TRAIN.LR_STEP,
                            cfg.TRAIN.LR_FACTOR, steps_per_epoch)
    params = list(params)
    groups = bool(params) and isinstance(params[0], dict)
    first = params[0]["params"][0] if groups else (params or [None])[0]
    dev = first.device if first is not None else torch.device("cpu")
    cuda = dev.type == "cuda"

    def lr(scale=1.0):
        v = schedule(0) * scale
        return (torch.tensor(v, dtype=torch.float32, device=dev) if cuda
                else v)

    if groups:
        params = [dict(g, lr=lr(g.get("lr_scale", 1.0))) for g in params]
    opt = torch.optim.Adam(params, lr=lr(), betas=(0.9, 0.999), eps=1e-8,
                           **({"capturable": True} if cuda else {}))
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


# param_group keys that belong to the optimizer's form, not to the run
_FORM_KEYS = ("lr", "capturable", "foreach", "fused", "differentiable")


class TrainState:
    """A model, its optimizer and LR schedule, and the number of updates
    taken (`step`). `version` counts loads of optimizer state: a CUDA
    graph of a step holds the optimizer's tensors, so graphs.py captures
    anew after one."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0
        self.version = 0
        self._lr = None         # the LR last written, a Python float

    @classmethod
    def create(cls, model: nn.Module, cfg,
               steps_per_epoch: int) -> "TrainState":
        params = (model.param_groups() if hasattr(model, "param_groups")
                  else model.parameters())
        opt, schedule = make_optimizer(cfg, steps_per_epoch, params)
        return cls(model, opt, schedule)

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.model.parameters() if p.grad is not None]

    def set_lr(self):
        """Write the LR the schedule gives update `step` into the
        optimizer: a float, or in place into a device LR (one launch, only
        when the value changes). A graphed step calls this on the host
        before its replay."""
        if self.schedule is None:
            return
        lr = self.schedule(self.step)
        if lr == self._lr:
            return
        for group in self.optimizer.param_groups:
            v = lr * group.get("lr_scale", 1.0)
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(v)
            else:
                group["lr"] = v
        self._lr = lr

    def apply_gradients(self):
        """One optimizer update from the parameters' .grad, at the LR the
        schedule gives this update's index."""
        self.set_lr()
        self.optimizer.step()
        self.step += 1

    def optimizer_state_dict(self):
        """The optimizer's state_dict in the plain form that every device
        writes and loads: float LRs (the last one written), `capturable`
        off and Adam's step counts as host tensors. Tensors are the
        optimizer's own, not copies (the checkpoint writers copy)."""
        sd = self.optimizer.state_dict()
        if not any(g.get("capturable") for g in sd["param_groups"]):
            return sd
        groups = []
        for g in sd["param_groups"]:
            lr = g["lr"]
            if isinstance(lr, torch.Tensor):
                lr = (self._lr * g.get("lr_scale", 1.0)
                      if self._lr is not None else float(lr))
            groups.append(dict(g, lr=lr, capturable=False))
        state = {i: {k: (v.detach().to("cpu", copy=True) if k == "step"
                         else v) for k, v in s.items()}
                 for i, s in sd["state"].items()}
        return {"state": state, "param_groups": groups}

    def load_optimizer_state_dict(self, sd):
        """Load either form of optimizer state (optimizer_state_dict) into
        this state's optimizer, which keeps its own form: its LR tensor
        (the object a graph captured; it takes the loaded value), its
        `capturable` and implementation flags."""
        own = self.optimizer.param_groups
        lrs = [g["lr"] for g in own]
        groups = [dict(saved, **{k: g[k] for k in _FORM_KEYS if k in g})
                  for saved, g in zip(sd["param_groups"], own)]
        loaded = [saved["lr"] for saved in sd["param_groups"]]
        self.optimizer.load_state_dict(dict(sd, param_groups=groups))
        for g, lr, value in zip(self.optimizer.param_groups, lrs, loaded):
            if isinstance(lr, torch.Tensor):
                lr.fill_(float(value))
                g["lr"] = lr
            else:
                g["lr"] = float(value)
        if loaded:
            self._lr = float(loaded[0]) / own[0].get("lr_scale", 1.0)
        self.version += 1
