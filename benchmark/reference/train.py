"""Plain references of the training steps: CDRNet's stereo loss (2D
smooth MSE on both views plus 4 x the root-relative 3D term) with the
gradient clipped to a global norm of 100 (after the warm-up, in the
3D phase), PoseResNet's 2D heatmap MSE,
and Adam (0.9, 0.999, eps 1e-8 outside the square root, bias-corrected).
"""

from __future__ import annotations

import torch

from . import model as ref

SMOOTH_THRESHOLD = 400.0
LOSS_3D_WEIGHT = 4.0


def smooth_mse(pred, target, weight):
    """Squared errors of weight * pred against weight * target, those above
    400 compressed to (d^2)^0.1 * 400^0.9, averaged over every entry."""
    w = weight.reshape(*weight.shape, *([1] * (pred.dim() - weight.dim())))
    d = (pred * w - target * w).square()
    big = d.clamp_min(1e-30) ** 0.1 * SMOOTH_THRESHOLD ** 0.9
    return torch.where(d > SMOOTH_THRESHOLD, big, d).mean()


def cdr_loss_parts(pred_2d, pred_3d, batch, scale_3d=0.1, base_joint=1):
    """pred_2d (B, 2, J, 2), pred_3d (B, J, 3) against the batch's
    targets -> (the 2D term of both views, the 3D term): in the 3D term
    every joint but the base one is taken relative to the base joint (the
    base joint keeps its absolute position), clamped to 1e6 mm and scaled
    by 0.1."""
    w = batch["target_weight"]
    t2d, t3d = batch["target_2d"], batch["target_3d"]
    loss_2d = smooth_mse(pred_2d[:, 0], t2d[:, 0], w) \
        + smooth_mse(pred_2d[:, 1], t2d[:, 1], w)
    J = pred_3d.shape[1]
    other = (torch.arange(J, device=pred_3d.device) != base_joint)[None, :,
                                                                   None]
    rel_p = torch.where(other, pred_3d - pred_3d[:, base_joint:base_joint + 1],
                        pred_3d)
    rel_t = torch.where(other, t3d - t3d[:, base_joint:base_joint + 1], t3d)
    loss_3d = smooth_mse(rel_p.clamp(-1e6, 1e6) * scale_3d, rel_t * scale_3d,
                         w)
    return loss_2d, loss_3d


def cdr_loss(pred_2d, pred_3d, batch, use_3d=True,
             loss_3d_weight=LOSS_3D_WEIGHT,
             scale_3d=0.1, base_joint=1):
    """The 2D term, plus (after the warm-up, use_3d) loss_3d_weight times
    the 3D term (cdr_loss_parts)."""
    loss_2d, loss_3d = cdr_loss_parts(pred_2d, pred_3d, batch, scale_3d,
                                      base_joint)
    return loss_2d + loss_3d_weight * loss_3d if use_3d else loss_2d


def heatmap_mse(pred, target, weight):
    """0.5 x the mean squared error of weight * heatmaps."""
    w = weight[..., None, None]
    return 0.5 * (pred * w - target * w).square().mean()


class Adam:
    """Adam over a list of leaves, in fp32."""

    def __init__(self, leaves, lr, betas=(0.9, 0.999), eps=1e-8):
        self.leaves, self.lr, self.betas, self.eps = leaves, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def clip_global(grads, max_norm):
    """Scale the gradients by max_norm / (norm + 1e-6) where their global
    norm exceeds max_norm."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if norm > max_norm:
        grads = [g * (max_norm / (norm + 1e-6)) for g in grads]
    return grads


class Trainer:
    """The reference's training state: `params` (leaves, in the order of
    the names), `buffers` (BN running statistics) and Adam. grads(batch)
    returns the loss and the gradients that Adam would be given (clipped
    where the step clips); step(batch) takes the step too. `loss_2d`
    holds the last loss's 2D term (the whole loss of a 2D model)."""

    def __init__(self, state_dict, names, lr, depth, kind, clip=None,
                 use_3d=True):
        self.names = names
        self.params = {k: state_dict[k].detach().clone().float()
                       .requires_grad_(True) for k in names}
        self.buffers = {k: v.detach().clone() for k, v in state_dict.items()
                        if k not in self.params}
        self.leaves = [self.params[k] for k in names]
        self.adam = Adam(self.leaves, lr)
        self.depth, self.kind, self.use_3d = depth, kind, use_3d
        self.clip = clip if use_3d else None

    def loss(self, batch):
        ops = ref.Ops(self.params, self.buffers, train=True)
        if self.kind == "cdr":
            pred_2d, pred_3d, _ = ref.cdrnet(ops, batch["images"],
                                             batch["proj"], self.depth)
            loss_2d, loss_3d = cdr_loss_parts(pred_2d, pred_3d, batch)
            self.loss_2d = loss_2d.detach()
            return (loss_2d + LOSS_3D_WEIGHT * loss_3d if self.use_3d
                    else loss_2d)
        hm = ref.poseresnet(ops, batch["images"], self.depth)
        loss = heatmap_mse(hm, batch["target"], batch["target_weight"])
        self.loss_2d = loss.detach()
        return loss

    def grads(self, batch):
        loss = self.loss(batch)
        grads = torch.autograd.grad(loss, self.leaves)
        if self.clip is not None:
            grads = clip_global(grads, self.clip)
        return loss.detach(), [g.detach() for g in grads]

    def step(self, batch):
        loss, grads = self.grads(batch)
        self.adam.step(grads)
        return loss, grads
