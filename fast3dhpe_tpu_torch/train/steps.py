"""Train and eval steps and epochs for CDRNet and PoseResNet. Port of
fast3dhpe_tpu/train/steps.py (:37-330, :537-571).

Each step factory returns a step that takes a TrainState (train/state.py)
and a batch dict. The batch goes to the model's device; nothing falls
back to the CPU. A step returns its metrics as device tensors and syncs
nothing: the caller fetches them when it needs them.

Padded final batches carry `batch["row_valid"]`, a (B,) 0/1 mask. The
steps keep padded rows out of the loss (renormalised to the valid rows),
out of every metric, and out of the train-mode BN batch statistics.

An epoch function runs S batches from a device frame cache
(data/device_cache.py): each batch is preprocessed on the device
(data/device_pipeline.py), then stepped. It is a Python loop where the
JAX package has one lax.scan; the per-step metrics are summed on the
device, with no host sync inside the loop.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..data.device_pipeline import (preprocess_mono_batch_cached,
                                    preprocess_stereo_batch_cached)
from ..models.metrics import pck_counts, pck_from_counts, per_sample_mpjpe
from .state import TrainState, clip_grads_by_norm, global_grad_norm


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _masked_count(mask, batch_size, device):
    if mask is None:
        return torch.tensor(float(batch_size), device=device)
    return mask.float().sum()


def _cdr_loss(model, loss_fn, batch, use_3d: bool, loss_3d_weight,
              scale_3d, base_joint, num_joints, train: bool):
    """The CDR loss: 2D only during warmup, 2D + loss_3d_weight * 3D after
    (steps.py:162-220).

    In training, the root-relative alignment subtracts the base joint from
    every OTHER joint; the base joint keeps its absolute coordinates. Eval
    skips the alignment, as the reference's eval loop does. The 3D term
    joins the loss under a Python `if`, so during warmup it adds nothing to
    the graph's gradient; loss_3d is still computed and reported.
    """
    mask = batch.get("row_valid")
    if train:
        pred_2d, pred_3d = model(batch["image"], batch["proj"],
                                 row_valid=mask)
    else:
        pred_2d, pred_3d = model(batch["image"], batch["proj"])
    target_3d = batch["target_3d"]
    w = batch["target_weight"]

    if train:
        not_base = (torch.arange(num_joints, device=pred_3d.device)
                    != base_joint)[None, :, None]
        root_p = pred_3d[:, base_joint:base_joint + 1]
        root_t = target_3d[:, base_joint:base_joint + 1]
        pred_3d_rel = torch.where(not_base, pred_3d - root_p, pred_3d)
        target_3d_rel = torch.where(not_base, target_3d - root_t, target_3d)
    else:
        pred_3d_rel, target_3d_rel = pred_3d, target_3d

    t2d = batch["target_2d"]
    loss_2d = (loss_fn(pred_2d[:, 0], t2d[:, 0], w, sample_mask=mask)
               + loss_fn(pred_2d[:, 1], t2d[:, 1], w, sample_mask=mask))
    # +-1e6 mm bounds a degenerate triangulation (steps.py:206-213)
    pred_3d_loss = pred_3d_rel.clamp(-1e6, 1e6)
    loss_3d = loss_fn(pred_3d_loss * scale_3d, target_3d_rel * scale_3d, w,
                      sample_mask=mask)
    loss = loss_2d + loss_3d_weight * loss_3d if use_3d else loss_2d
    return loss, {"pred_2d": pred_2d, "pred_3d": pred_3d,
                  "loss_2d": loss_2d, "loss_3d": loss_3d}


def make_train_step_cdr(loss_fn, loss_3d_weight: float = 4.0,
                        scale_3d: float = 0.1, base_joint: int = 1,
                        num_joints: int = 19,
                        clip_norm: float = 100.0) -> Callable:
    """CDR train step: train_step(state, batch, use_3d) -> metrics.

    batch: {"image": (B, V, H, W, 3) normalised, "proj": (B, V, 3, 4),
            "target_3d": (B, J, 3), "target_2d": (B, V, J, 2),
            "target_weight": (B, J), optional "row_valid": (B,)}
    use_3d: a Python bool, False during the warmup epochs. The gradients
    are clipped to clip_norm only when it is set. metrics: loss, loss_2d,
    loss_3d and grad_norm (before clipping), detached device scalars.
    """

    def train_step(state: TrainState, batch, use_3d: bool):
        model = state.model
        model.train()
        batch = _on_device(batch, _device_of(model))
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = _cdr_loss(model, loss_fn, batch, use_3d, loss_3d_weight,
                              scale_3d, base_joint, num_joints, train=True)
        loss.backward()
        grad_norm = clip_grads_by_norm(state.grads(), clip_norm, use_3d)
        state.apply_gradients()
        return {"loss": loss.detach(), "loss_2d": aux["loss_2d"].detach(),
                "loss_3d": aux["loss_3d"].detach(), "grad_norm": grad_norm}

    return train_step


def make_eval_step_cdr(loss_fn, loss_3d_weight: float = 4.0,
                       scale_3d: float = 0.1, base_joint: int = 1,
                       num_joints: int = 19) -> Callable:
    """CDR eval step in eval mode: eval_step(state, batch, use_3d) ->
    batch-mean loss / mpjpe_2d / mpjpe_3d, and the masked per-sample sums
    loss_sum / e2_sum / e3_sum / n that accumulate into per-frame epoch
    metrics."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, use_3d: bool):
        model = state.model
        model.eval()
        batch = _on_device(batch, _device_of(model))
        mask = batch.get("row_valid")
        loss, aux = _cdr_loss(model, loss_fn, batch, use_3d, loss_3d_weight,
                              scale_3d, base_joint, num_joints, train=False)
        t2d = batch["target_2d"]
        e2_s, e3_s = per_sample_mpjpe(aux["pred_2d"], aux["pred_3d"],
                                      batch["target_3d"], t2d[:, 0],
                                      t2d[:, 1], batch["target_weight"])
        if mask is not None:
            m = mask.float()
            e2_s, e3_s = e2_s * m, e3_s * m
        n = _masked_count(mask, e2_s.shape[0], e2_s.device)
        e2_sum, e3_sum = e2_s.sum(), e3_s.sum()
        denom = n.clamp_min(1.0)
        return {"loss": loss, "mpjpe_2d": e2_sum / denom,
                "mpjpe_3d": e3_sum / denom, "loss_sum": loss * n,
                "e2_sum": e2_sum, "e3_sum": e3_sum, "n": n}

    return eval_step


def make_train_step_2d(loss_fn) -> Callable:
    """PoseResNet train step (steps.py:48-77): train_step(state, batch) ->
    loss, acc (PCK) and grad_norm.

    batch: {"image": (B, H, W, 3), "target": (B, h, w, J),
            "target_weight": (B, J), optional "row_valid": (B,)}
    """

    def train_step(state: TrainState, batch):
        model = state.model
        model.train()
        batch = _on_device(batch, _device_of(model))
        mask = batch.get("row_valid")
        state.optimizer.zero_grad(set_to_none=True)
        out = model(batch["image"], row_valid=mask)
        loss = loss_fn(out, batch["target"], batch["target_weight"],
                       sample_mask=mask)
        loss.backward()
        grad_norm = global_grad_norm(state.grads())
        state.apply_gradients()
        hits, cnt, _ = pck_counts(out.detach(), batch["target"],
                                  row_mask=mask)
        acc, _ = pck_from_counts(hits, cnt)
        return {"loss": loss.detach(), "acc": acc, "grad_norm": grad_norm}

    return train_step


def make_eval_step_2d(loss_fn) -> Callable:
    """PoseResNet eval step (steps.py:80-100): batch-mean loss and acc, and
    the accumulatable loss_sum / hits / cnt / n."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model
        model.eval()
        batch = _on_device(batch, _device_of(model))
        mask = batch.get("row_valid")
        out = model(batch["image"])
        loss = loss_fn(out, batch["target"], batch["target_weight"],
                       sample_mask=mask)
        hits, cnt, _ = pck_counts(out, batch["target"], row_mask=mask)
        acc, _ = pck_from_counts(hits, cnt)
        n = _masked_count(mask, out.shape[0], out.device)
        return {"loss": loss, "acc": acc, "loss_sum": loss * n,
                "hits": hits, "cnt": cnt, "n": n}

    return eval_step


def _stacked_on_device(state, frames, xs) -> Dict[str, torch.Tensor]:
    """An epoch's stacked (S, B, ...) metadata on the frames' device,
    copied once an epoch, not once a step. The frames must lie on the
    model's device: the pipeline runs where they lie, never quietly on
    another device."""
    if frames.device != _device_of(state.model):
        raise ValueError(f"the frame cache is on {frames.device}, the model "
                         f"on {_device_of(state.model)}")
    return {k: torch.as_tensor(v).to(frames.device) for k, v in xs.items()}


def _accumulate(sums, metrics, keys=None):
    for k in keys or metrics:
        sums[k] = sums[k] + metrics[k] if k in sums else metrics[k]
    return sums


def step_generator(device, epoch_seed: int, step: int) -> torch.Generator:
    """The occlusion generator of one step of an epoch: seeded from (the
    epoch's seed, the step index), as the JAX epoch folds the step index
    into the epoch's key, so an epoch is reproducible from its seed."""
    seed = np.random.SeedSequence((epoch_seed, step)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def make_train_epoch_cdr(loss_fn, image_size, occlusion=None,
                         **step_kwargs) -> Callable:
    """CDR training over an epoch of cached batches (steps.py:255-299).

    epoch(state, frames, xs, epoch_seed, use_3d) -> summed metrics
      frames: the (N, H0, W0, 3) uint8 cache on the model's device;
      xs: dict of (S, B, ...) arrays, as Stereo3DLoader.stacked_epoch
        stacks them: idx_l, idx_r (S, B), trans (S, B, 2, 3), P_l, P_r
        (S, B, 4, 4), pose_3d (S, B, J, 3), joints_vis (S, B, J),
        row_valid (S, B);
      returns the per-step metrics (loss, loss_2d, loss_3d, grad_norm)
      summed over the S steps, device tensors (divide by S for means).
    The state is updated in place.
    """
    step = make_train_step_cdr(loss_fn, **step_kwargs)
    image_size = tuple(image_size)

    def epoch(state: TrainState, frames, xs, epoch_seed: int, use_3d: bool):
        xs = _stacked_on_device(state, frames, xs)
        sums = {}
        for i in range(xs["idx_l"].shape[0]):
            batch = preprocess_stereo_batch_cached(
                step_generator(frames.device, epoch_seed, i), frames,
                xs["idx_l"][i], xs["idx_r"][i], xs["trans"][i],
                xs["P_l"][i], xs["P_r"][i], xs["pose_3d"][i],
                xs["joints_vis"][i], image_size=image_size,
                occlusion=occlusion, train=True)
            batch["row_valid"] = xs["row_valid"][i]
            _accumulate(sums, step(state, batch, use_3d))
        return sums

    return epoch


def make_eval_epoch_cdr(loss_fn, image_size, **step_kwargs) -> Callable:
    """CDR evaluation over an epoch of cached batches (steps.py:302-330):
    epoch(state, frames, xs, use_3d) -> loss_sum, e2_sum, e3_sum and n
    summed over the S batches, no augmentation."""
    step = make_eval_step_cdr(loss_fn, **step_kwargs)
    image_size = tuple(image_size)

    def epoch(state: TrainState, frames, xs, use_3d: bool):
        xs = _stacked_on_device(state, frames, xs)
        sums = {}
        for i in range(xs["idx_l"].shape[0]):
            batch = preprocess_stereo_batch_cached(
                None, frames, xs["idx_l"][i], xs["idx_r"][i],
                xs["trans"][i], xs["P_l"][i], xs["P_r"][i],
                xs["pose_3d"][i], xs["joints_vis"][i],
                image_size=image_size, occlusion=None, train=False)
            batch["row_valid"] = xs["row_valid"][i]
            _accumulate(sums, step(state, batch, use_3d),
                        ("loss_sum", "e2_sum", "e3_sum", "n"))
        return sums

    return epoch


def _mono_batch(frames, xs, i, image_size, heatmap_size, sigma):
    batch = preprocess_mono_batch_cached(
        frames, xs["idx"][i], xs["flip"][i], xs["trans"][i],
        xs["joints"][i], xs["vis"][i], image_size=image_size,
        heatmap_size=heatmap_size, sigma=sigma)
    batch["row_valid"] = xs["row_valid"][i]
    return batch


def make_train_epoch_2d(loss_fn, image_size, heatmap_size,
                        sigma: int = 3) -> Callable:
    """PoseResNet training over an epoch of cached batches
    (steps.py:103-131): epoch(state, frames, xs) -> summed loss, acc and
    grad_norm. xs as Mono2DLoader.stacked_epoch stacks them: idx (S, B),
    flip (S, B) bool, trans (S, B, 2, 3), joints (S, B, J, 2), vis
    (S, B, J), row_valid (S, B). The state is updated in place."""
    step = make_train_step_2d(loss_fn)
    image_size, heatmap_size = tuple(image_size), tuple(heatmap_size)

    def epoch(state: TrainState, frames, xs):
        xs = _stacked_on_device(state, frames, xs)
        sums = {}
        for i in range(xs["idx"].shape[0]):
            _accumulate(sums, step(state, _mono_batch(
                frames, xs, i, image_size, heatmap_size, sigma)))
        return sums

    return epoch


def make_eval_epoch_2d(loss_fn, image_size, heatmap_size,
                       sigma: int = 3) -> Callable:
    """PoseResNet evaluation over an epoch of cached batches
    (steps.py:134-159): epoch(state, frames, xs) -> loss_sum, hits, cnt
    and n summed over the S batches."""
    step = make_eval_step_2d(loss_fn)
    image_size, heatmap_size = tuple(image_size), tuple(heatmap_size)

    def epoch(state: TrainState, frames, xs):
        xs = _stacked_on_device(state, frames, xs)
        sums = {}
        for i in range(xs["idx"].shape[0]):
            _accumulate(sums, step(state, _mono_batch(
                frames, xs, i, image_size, heatmap_size, sigma)),
                ("loss_sum", "hits", "cnt", "n"))
        return sums

    return epoch
