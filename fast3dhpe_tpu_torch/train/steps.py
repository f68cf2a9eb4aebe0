"""Train and eval steps and epochs for CDRNet and PoseResNet. Port of
fast3dhpe_tpu/train/steps.py (:37-571). Beside them, the volumetric
model's (models/volumetric.py; the JAX package has none): its loss (L1
on the 3D joints plus the volumetric cross-entropy), steps and stacked
epochs, taking CDRNet's calls, so that the stereo epochs, segments
(make_segment_stereo) and train/loop_cdr.py run either model.

Each step factory returns a step that takes a TrainState (train/state.py)
and a batch dict. The batch goes to the model's device; nothing falls
back to the CPU. A step returns its metrics as device tensors and syncs
nothing: the caller fetches them when it needs them.

Padded final batches carry `batch["row_valid"]`, a (B,) 0/1 mask. The
steps keep padded rows out of the loss (renormalised to the valid rows),
out of every metric, and out of the train-mode BN batch statistics.

Data parallelism (`mesh=`, parallel/mesh.py): each rank steps on its local
rows of the global batch, with a model that `replicate` gave the process
group. A step then computes what the JAX package's global-batch step
computes under a mesh: one all_reduce of the row counts first (the BN
fallback, the loss normaliser and the metrics' denominators), the BN
statistics of the global batch, the loss as this rank's share of the
global loss, the gradients summed over the ranks (one packed all_reduce,
before the clip, so grad_norm and Adam's moves are the global ones on every
rank) and the reported losses and metrics of the global batch. This
explicit reduction takes the place of DistributedDataParallel, which would
average the ranks' gradients of their local losses (parallel/mesh.py says
why that is not the JAX step). Without a mesh the arithmetic is the
single-process one, operation for operation.

A (D, M) mesh with M > 1: every reduction runs over the data group
(`mesh.group`), so the M model ranks of a data group compute the same
step and nothing is counted M times. With a model that replicate made
spatial (parallel/spatial.py), the eval steps take this model rank's rows
of the images (shard_batch_spatial); the 2D eval step gathers its
heatmaps over the model group when the forward returned the rank's rows
(heatmap_split), then computes its loss and PCK as without a split. The
training loops replicate with spatial=False and train whole images on
every model rank; training on split images raises NotImplementedError,
as not applicable (parallel/spatial.py spatial_of).

An epoch function runs S batches from a device frame cache
(data/device_cache.py): each batch is preprocessed on the device
(data/device_pipeline.py), then stepped. Where the JAX package runs the
epoch as one lax.scan, the port replays a CUDA graph of the whole step,
preprocessing included, once a batch (train/graphs.py); on the CPU the
steps run eagerly. The per-step metrics are summed on the device, with
no host sync inside the loop. A segment (make_segment_stereo /
make_segment_2d) runs E epochs of train and eval with the best state
selected on the device, as the JAX package's one-dispatch segment does.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..data.device_pipeline import (preprocess_mono_batch_cached,
                                    preprocess_stereo_batch_cached)
from ..models.metrics import pck_counts, pck_from_counts, per_sample_mpjpe
from ..parallel.mesh import all_reduce, row_counts
from ..parallel.spatial import gather_height, heatmap_split
from .graphs import StepGraphs
from .state import TrainState, clip_grads_by_norm, global_grad_norm


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _masked_count(mask, batch_size, device):
    if mask is None:
        # a fill, not a tensor from host data: a CUDA graph captures it
        return torch.full((), float(batch_size), dtype=torch.float32,
                          device=device)
    return mask.float().sum()


def _sync_grads(mesh, state: TrainState) -> None:
    """The gradients summed over the ranks (nothing without a mesh)."""
    if mesh is not None:
        grads = state.grads()
        for g, total in zip(grads, all_reduce(mesh.group, grads,
                                              "gradients")):
            g.copy_(total)


def _global(mesh, values):
    """The sums over the ranks of detached device scalars or vectors, one
    all_reduce (the values themselves without a mesh)."""
    if mesh is None:
        return values
    return all_reduce(mesh.group, [v.detach() for v in values], "metrics")


def _cdr_loss(model, loss_fn, batch, use_3d: bool, loss_3d_weight,
              scale_3d, base_joint, num_joints, train: bool, rows=None):
    """The CDR loss: 2D only during warmup, 2D + loss_3d_weight * 3D after
    (steps.py:162-220).

    In training, the root-relative alignment subtracts the base joint from
    every OTHER joint; the base joint keeps its absolute coordinates. Eval
    skips the alignment, as the reference's eval loop does. The 3D term
    joins the loss under a Python `if`, so during warmup it adds nothing to
    the graph's gradient; loss_3d is still computed and reported. rows:
    the global row counts under a mesh; the losses are then this rank's
    shares.
    """
    mask = batch.get("row_valid")
    if train:
        pred_2d, pred_3d = model(batch["image"], batch["proj"],
                                 row_valid=mask,
                                 valid_rows=None if rows is None else rows[0])
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
    loss_2d = (loss_fn(pred_2d[:, 0], t2d[:, 0], w, sample_mask=mask,
                       rows=rows)
               + loss_fn(pred_2d[:, 1], t2d[:, 1], w, sample_mask=mask,
                         rows=rows))
    # +-1e6 mm bounds a degenerate triangulation (steps.py:206-213)
    pred_3d_loss = pred_3d_rel.clamp(-1e6, 1e6)
    loss_3d = loss_fn(pred_3d_loss * scale_3d, target_3d_rel * scale_3d, w,
                      sample_mask=mask, rows=rows)
    loss = loss_2d + loss_3d_weight * loss_3d if use_3d else loss_2d
    return loss, {"pred_2d": pred_2d, "pred_3d": pred_3d,
                  "loss_2d": loss_2d, "loss_3d": loss_3d}


def _train_core_cdr(loss_fn, loss_3d_weight: float = 4.0,
                    scale_3d: float = 0.1, base_joint: int = 1,
                    num_joints: int = 19, clip_norm: float = 100.0,
                    mesh=None) -> Callable:
    """core(state, batch, use_3d, update) -> metrics: the CDR train step
    with the optimizer update as `update()` (TrainState.apply_gradients
    eagerly; inside a CUDA graph the optimizer's step alone, graphs.py)."""

    def core(state: TrainState, batch, use_3d: bool, update):
        model = state.model
        model.train()
        dev = _device_of(model)
        batch = _on_device(batch, dev)
        rows = row_counts(mesh, batch.get("row_valid"),
                          batch["image"].shape[0], dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = _cdr_loss(model, loss_fn, batch, use_3d, loss_3d_weight,
                              scale_3d, base_joint, num_joints, train=True,
                              rows=rows)
        loss.backward()
        _sync_grads(mesh, state)
        grad_norm = clip_grads_by_norm(state.grads(), clip_norm, use_3d)
        update()
        loss, loss_2d, loss_3d = _global(
            mesh, [loss.detach(), aux["loss_2d"].detach(),
                   aux["loss_3d"].detach()])
        return {"loss": loss, "loss_2d": loss_2d, "loss_3d": loss_3d,
                "grad_norm": grad_norm}

    return core


def make_train_step_cdr(loss_fn, loss_3d_weight: float = 4.0,
                        scale_3d: float = 0.1, base_joint: int = 1,
                        num_joints: int = 19,
                        clip_norm: float = 100.0, mesh=None) -> Callable:
    """CDR train step: train_step(state, batch, use_3d) -> metrics.

    batch: {"image": (B, V, H, W, 3) normalised, "proj": (B, V, 3, 4),
            "target_3d": (B, J, 3), "target_2d": (B, V, J, 2),
            "target_weight": (B, J), optional "row_valid": (B,)}
    use_3d: a Python bool, False during the warmup epochs. The gradients
    are clipped to clip_norm only when it is set. metrics: loss, loss_2d,
    loss_3d and grad_norm (before clipping), detached device scalars, of
    the global batch under a mesh.
    """
    core = _train_core_cdr(loss_fn, loss_3d_weight, scale_3d, base_joint,
                           num_joints, clip_norm, mesh)

    def train_step(state: TrainState, batch, use_3d: bool):
        return core(state, batch, use_3d, state.apply_gradients)

    return train_step


def make_eval_step_cdr(loss_fn, loss_3d_weight: float = 4.0,
                       scale_3d: float = 0.1, base_joint: int = 1,
                       num_joints: int = 19, mesh=None) -> Callable:
    """CDR eval step in eval mode: eval_step(state, batch, use_3d) ->
    batch-mean loss / mpjpe_2d / mpjpe_3d, and the masked per-sample sums
    loss_sum / e2_sum / e3_sum / n that accumulate into per-frame epoch
    metrics; those of the global batch under a mesh (on a spatial mesh
    the images are this model rank's rows, and the sums reduce over the
    data group)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, use_3d: bool):
        model = state.model
        model.eval()
        dev = _device_of(model)
        batch = _on_device(batch, dev)
        mask = batch.get("row_valid")
        rows = row_counts(mesh, mask, batch["image"].shape[0], dev)
        loss, aux = _cdr_loss(model, loss_fn, batch, use_3d, loss_3d_weight,
                              scale_3d, base_joint, num_joints, train=False,
                              rows=rows)
        t2d = batch["target_2d"]
        e2_s, e3_s = per_sample_mpjpe(aux["pred_2d"], aux["pred_3d"],
                                      batch["target_3d"], t2d[:, 0],
                                      t2d[:, 1], batch["target_weight"])
        if mask is not None:
            m = mask.float()
            e2_s, e3_s = e2_s * m, e3_s * m
        e2_sum, e3_sum = e2_s.sum(), e3_s.sum()
        if mesh is None:
            n = _masked_count(mask, e2_s.shape[0], e2_s.device)
        else:
            n = rows[0]
            loss, e2_sum, e3_sum = _global(mesh, [loss, e2_sum, e3_sum])
        denom = n.clamp_min(1.0)
        return {"loss": loss, "mpjpe_2d": e2_sum / denom,
                "mpjpe_3d": e3_sum / denom, "loss_sum": loss * n,
                "e2_sum": e2_sum, "e3_sum": e3_sum, "n": n}

    return eval_step


def _vol_loss(model, batch, theta, scale_3d: float, base_joint: int,
              train: bool, rows=None, mesh=None):
    """The volumetric model's loss, as the public recipe computes it: the
    L1 of the 3D joints scaled by scale_3d, summed over the valid (joint,
    coordinate) entries over 3 x max(1, valid joints), plus CE_WEIGHT
    (models/volumetric.py) x the volumetric cross-entropy: -log(p + 1e-6)
    of the softmax volume p at the voxel nearest each valid joint, over
    the joints of the valid rows. The cuboid is centred on the
    ground-truth base joint and turned by theta (B,). Under a mesh the
    loss is this rank's share of the global batch's (rows: the global row
    counts), so that the ranks' shares sum to it."""
    # imported here, so that the CDRNet and 2D steps do not load them
    from ..geometry.volume import nearest_voxel
    from ..models.volumetric import CE_WEIGHT
    mask = batch.get("row_valid")
    target = batch["target_3d"]
    root = target[:, base_joint]
    kw = {}
    if train:
        kw = dict(row_valid=mask, valid_rows=None if rows is None
                  else rows[0])
    pred, logits = model(batch["image"], batch["proj"], root, theta,
                         return_logits=True, **kw)
    B, J = target.shape[:2]
    w = batch["target_weight"].float()
    n_rows = _masked_count(mask, B, w.device)
    if mask is not None:
        w = w * mask.float()[:, None]
    w_sum = w.sum()
    if mesh is not None:
        w_sum, = _global(mesh, [w_sum.reshape(1)])
        w_sum, n_rows = w_sum.reshape(()), rows[0]
    l1 = ((pred * scale_3d - target * scale_3d).abs()
          * w[..., None]).sum() / (3.0 * w_sum.clamp_min(1.0))
    idx = nearest_voxel(target, root, theta, model.volume_size,
                        model.cuboid_side)
    flat = logits.view(B, -1, J)
    at = flat.gather(1, idx[:, None]).squeeze(1)
    p = torch.exp(at - torch.logsumexp(flat, dim=1))
    ce = (-torch.log(p + 1e-6) * w).sum() / (n_rows.clamp_min(1.0) * J)
    return l1 + CE_WEIGHT * ce, {"pred_3d": pred, "loss_3d": l1,
                                 "loss_ce": ce}


def _angles(gen, rows: int, device) -> torch.Tensor:
    """The cuboids' turns of a train step: one a row, uniform in
    [0, 2 pi), drawn from gen. Every rank of a mesh draws its rows' from
    the same seed, as it draws its occlusion."""
    return 2.0 * np.pi * torch.rand((rows,), generator=gen, device=device)


def _train_core_vol(scale_3d: float = 0.1, base_joint: int = 1,
                    mesh=None) -> Callable:
    """core(state, batch, gen, update) -> metrics: the volumetric train
    step, the cuboids turned by _angles drawn from gen (after the
    pipeline's occlusion draws), and the optimizer update as `update()`
    (see _train_core_cdr). No clip: the recipe has none."""

    def core(state: TrainState, batch, gen, update):
        model = state.model
        model.train()
        dev = _device_of(model)
        batch = _on_device(batch, dev)
        B = batch["image"].shape[0]
        rows = row_counts(mesh, batch.get("row_valid"), B, dev)
        theta = _angles(gen, B, dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = _vol_loss(model, batch, theta, scale_3d, base_joint,
                              True, rows, mesh)
        loss.backward()
        _sync_grads(mesh, state)
        grad_norm = global_grad_norm(state.grads())
        update()
        loss, l3, ce = _global(mesh, [loss.detach(), aux["loss_3d"].detach(),
                                      aux["loss_ce"].detach()])
        return {"loss": loss, "loss_3d": l3, "loss_ce": ce,
                "grad_norm": grad_norm}

    return core


def make_train_step_vol(scale_3d: float = 0.1, base_joint: int = 1,
                        mesh=None) -> Callable:
    """The volumetric model's train step: train_step(state, batch,
    use_3d, gen) -> loss, loss_3d (the L1 term), loss_ce and grad_norm,
    detached device scalars (of the global batch under a mesh). batch as
    make_train_step_cdr's; use_3d is not read (the loss is 3D from the
    first step; the argument keeps make_train_step_cdr's call); gen: the
    torch.Generator on the model's device that draws the cuboids'
    angles."""
    core = _train_core_vol(scale_3d, base_joint, mesh)

    def train_step(state: TrainState, batch, use_3d: bool = True, gen=None):
        return core(state, batch, gen, state.apply_gradients)

    return train_step


def make_eval_step_vol(scale_3d: float = 0.1, base_joint: int = 1,
                       mesh=None) -> Callable:
    """The volumetric model's eval step, the cuboid unturned on the
    ground-truth base joint: the keys of make_eval_step_cdr's, the 2D
    error that of the 3D joints projected into the crops."""
    from ..geometry.camera import project_points

    @torch.no_grad()
    def eval_step(state: TrainState, batch, use_3d: bool = True):
        model = state.model
        model.eval()
        dev = _device_of(model)
        batch = _on_device(batch, dev)
        mask = batch.get("row_valid")
        B = batch["image"].shape[0]
        rows = row_counts(mesh, mask, B, dev)
        theta = torch.zeros((B,), device=dev)
        loss, aux = _vol_loss(model, batch, theta, scale_3d, base_joint,
                              False, rows, mesh)
        pred_2d = project_points(aux["pred_3d"][:, None], batch["proj"])
        t2d = batch["target_2d"]
        e2_s, e3_s = per_sample_mpjpe(pred_2d, aux["pred_3d"],
                                      batch["target_3d"], t2d[:, 0],
                                      t2d[:, 1], batch["target_weight"])
        if mask is not None:
            m = mask.float()
            e2_s, e3_s = e2_s * m, e3_s * m
        e2_sum, e3_sum = e2_s.sum(), e3_s.sum()
        if mesh is None:
            n = _masked_count(mask, B, dev)
        else:
            n = rows[0]
            loss, e2_sum, e3_sum = _global(mesh, [loss, e2_sum, e3_sum])
        denom = n.clamp_min(1.0)
        return {"loss": loss, "mpjpe_2d": e2_sum / denom,
                "mpjpe_3d": e3_sum / denom, "loss_sum": loss * n,
                "e2_sum": e2_sum, "e3_sum": e3_sum, "n": n}

    return eval_step


def _train_core_2d(loss_fn, mesh=None) -> Callable:
    """core(state, batch, update) -> metrics: the PoseResNet train step
    with the optimizer update as `update()` (see _train_core_cdr)."""

    def core(state: TrainState, batch, update):
        model = state.model
        model.train()
        dev = _device_of(model)
        batch = _on_device(batch, dev)
        mask = batch.get("row_valid")
        rows = row_counts(mesh, mask, batch["image"].shape[0], dev)
        state.optimizer.zero_grad(set_to_none=True)
        out = model(batch["image"], row_valid=mask,
                    valid_rows=None if rows is None else rows[0])
        loss = loss_fn(out, batch["target"], batch["target_weight"],
                       sample_mask=mask, rows=rows)
        loss.backward()
        _sync_grads(mesh, state)
        grad_norm = global_grad_norm(state.grads())
        update()
        hits, cnt, _ = pck_counts(out.detach(), batch["target"],
                                  row_mask=mask)
        loss, hits, cnt = _global(mesh, [loss.detach(), hits, cnt])
        acc, _ = pck_from_counts(hits, cnt)
        return {"loss": loss, "acc": acc, "grad_norm": grad_norm}

    return core


def make_train_step_2d(loss_fn, mesh=None) -> Callable:
    """PoseResNet train step (steps.py:48-77): train_step(state, batch) ->
    loss, acc (PCK) and grad_norm, of the global batch under a mesh.

    batch: {"image": (B, H, W, 3), "target": (B, h, w, J),
            "target_weight": (B, J), optional "row_valid": (B,)}
    """
    core = _train_core_2d(loss_fn, mesh)

    def train_step(state: TrainState, batch):
        return core(state, batch, state.apply_gradients)

    return train_step


def make_eval_step_2d(loss_fn, mesh=None) -> Callable:
    """PoseResNet eval step (steps.py:80-100): batch-mean loss and acc, and
    the accumulatable loss_sum / hits / cnt / n; those of the global batch
    under a mesh. With a spatial model the images are this model rank's
    rows, and the heatmaps are gathered over the model group first where
    the forward returned the rank's rows (heatmap_split)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model
        model.eval()
        dev = _device_of(model)
        batch = _on_device(batch, dev)
        mask = batch.get("row_valid")
        rows = row_counts(mesh, mask, batch["image"].shape[0], dev)
        out = model(batch["image"])
        if heatmap_split(model, batch["image"].shape[1]):
            out = gather_height(out, model.spatial, 1)
        loss = loss_fn(out, batch["target"], batch["target_weight"],
                       sample_mask=mask, rows=rows)
        hits, cnt, _ = pck_counts(out, batch["target"], row_mask=mask)
        loss, hits, cnt = _global(mesh, [loss, hits, cnt])
        acc, _ = pck_from_counts(hits, cnt)
        n = (_masked_count(mask, out.shape[0], out.device) if mesh is None
             else rows[0])
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


def _frames_key(frames):
    return (frames.data_ptr(), tuple(frames.shape), frames.dtype)


def step_seed(epoch_seed: int, step: int) -> int:
    """The occlusion seed of one step of an epoch: from (the epoch's seed,
    the step index), as the JAX epoch folds the step index into the
    epoch's key, so an epoch is reproducible from its seed."""
    return int(np.random.SeedSequence((epoch_seed, step)).generate_state(
        1, np.uint64)[0])


def step_generator(device, epoch_seed: int, step: int) -> torch.Generator:
    """The occlusion generator of one step of an epoch, seeded with
    step_seed(epoch_seed, step)."""
    return torch.Generator(device=device).manual_seed(
        step_seed(epoch_seed, step))


def _occludes(occlusion) -> bool:
    return occlusion not in (None, "None")


_EVAL_KEYS_CDR = ("loss_sum", "e2_sum", "e3_sum", "n")
_EVAL_KEYS_2D = ("loss_sum", "hits", "cnt", "n")


def _stereo_batch(frames, x, image_size, gen, occlusion, train: bool):
    batch = preprocess_stereo_batch_cached(
        gen, frames, x["idx_l"], x["idx_r"], x["trans"], x["P_l"], x["P_r"],
        x["pose_3d"], x["joints_vis"], image_size=image_size,
        occlusion=occlusion, train=train)
    batch["row_valid"] = x["row_valid"]
    return batch


def _stereo_train_epoch(core, image_size, occlusion, graphed, mesh,
                        draws: bool) -> Callable:
    """A stereo model's training over an epoch of cached batches
    (make_train_epoch_cdr's contract). core(state, batch, use_3d, gen,
    update) -> metrics; step i's generator is seeded step_seed(epoch_seed,
    i) where the occlusion draws, or the core does (`draws`), else None."""
    image_size = tuple(image_size)
    graphs = StepGraphs(graphed, mesh)

    def epoch(state: TrainState, frames, xs, epoch_seed: int,
              use_3d: bool = True):
        xs = _stacked_on_device(state, frames, xs)

        def step(x, gen, update):
            batch = _stereo_batch(frames, x, image_size, gen, occlusion, True)
            return core(state, batch, use_3d, gen, update)

        n = xs["idx_l"].shape[0]
        seeds = ([step_seed(epoch_seed, i) for i in range(n)]
                 if draws or _occludes(occlusion) else None)
        return graphs.epoch(("train", use_3d, _frames_key(frames)), state,
                            xs, step, state=state, seeds=seeds)

    epoch.graphs = graphs
    return epoch


def _stereo_eval_epoch(step_fn, image_size, mesh) -> Callable:
    """A stereo model's evaluation over an epoch of cached batches
    (make_eval_epoch_cdr's contract); step_fn(state, batch, use_3d)."""
    image_size = tuple(image_size)
    graphs = StepGraphs(mesh=mesh)

    def epoch(state: TrainState, frames, xs, use_3d: bool = True):
        xs = _stacked_on_device(state, frames, xs)

        def step(x, gen, update):
            return step_fn(state, _stereo_batch(frames, x, image_size, None,
                                                None, False), use_3d)

        return graphs.epoch(("eval", use_3d, _frames_key(frames)), state, xs,
                            step, sum_keys=_EVAL_KEYS_CDR)

    epoch.graphs = graphs
    return epoch


def make_train_epoch_cdr(loss_fn, image_size, occlusion=None,
                         graphed: bool = True, **step_kwargs) -> Callable:
    """CDR training over an epoch of cached batches (steps.py:255-299).

    epoch(state, frames, xs, epoch_seed, use_3d) -> summed metrics
      frames: the (N, H0, W0, 3) uint8 cache on the model's device;
      xs: dict of (S, B, ...) arrays, as Stereo3DLoader.stacked_epoch
        stacks them: idx_l, idx_r (S, B), trans (S, B, 2, 3), P_l, P_r
        (S, B, 4, 4), pose_3d (S, B, J, 3), joints_vis (S, B, J),
        row_valid (S, B);
      epoch_seed: step i draws its occlusion from step_seed(epoch_seed, i);
      returns the per-step metrics (loss, loss_2d, loss_3d, grad_norm)
      summed over the S steps, device tensors (divide by S for means).
    The state is updated in place. On CUDA the steps replay a CUDA graph
    of the step (train/graphs.py), one a value of use_3d; graphed=False
    runs them eagerly (the reference that chip_smoke.py holds the graphs
    against). `epoch.graphs` holds the graphs. Under a mesh
    (step_kwargs["mesh"]) xs holds this rank's rows of the global batch
    (its loader's stacked epoch, or parallel.mesh.shard_stacked of a
    global stack), the steps are the global batch's, and their
    collectives are captured with them under NCCL (graphs.py).
    """
    core = _train_core_cdr(loss_fn, **step_kwargs)
    return _stereo_train_epoch(
        lambda state, batch, use_3d, gen, update: core(state, batch, use_3d,
                                                       update),
        image_size, occlusion, graphed, step_kwargs.get("mesh"), False)


def make_train_epoch_vol(image_size, occlusion=None, graphed: bool = True,
                         **step_kwargs) -> Callable:
    """The volumetric model's training over an epoch of cached batches:
    make_train_epoch_cdr's epoch, its metrics loss, loss_3d, loss_ce and
    grad_norm, use_3d not read. Step i draws its occlusion, then its
    cuboids' angles, from step_seed(epoch_seed, i). step_kwargs:
    make_train_step_vol's."""
    core = _train_core_vol(**step_kwargs)
    return _stereo_train_epoch(
        lambda state, batch, use_3d, gen, update: core(state, batch, gen,
                                                       update),
        image_size, occlusion, graphed, step_kwargs.get("mesh"), True)


def make_eval_epoch_cdr(loss_fn, image_size, **step_kwargs) -> Callable:
    """CDR evaluation over an epoch of cached batches (steps.py:302-330):
    epoch(state, frames, xs, use_3d) -> loss_sum, e2_sum, e3_sum and n
    summed over the S batches (of the global batch under a mesh), no
    augmentation; replayed as make_train_epoch_cdr's steps are."""
    return _stereo_eval_epoch(make_eval_step_cdr(loss_fn, **step_kwargs),
                              image_size, step_kwargs.get("mesh"))


def make_eval_epoch_vol(image_size, **step_kwargs) -> Callable:
    """The volumetric model's evaluation over an epoch of cached batches:
    make_eval_epoch_cdr's epoch (use_3d not read)."""
    return _stereo_eval_epoch(make_eval_step_vol(**step_kwargs), image_size,
                              step_kwargs.get("mesh"))


def _mono_batch(frames, x, image_size, heatmap_size, sigma):
    batch = preprocess_mono_batch_cached(
        frames, x["idx"], x["flip"], x["trans"], x["joints"], x["vis"],
        image_size=image_size, heatmap_size=heatmap_size, sigma=sigma)
    batch["row_valid"] = x["row_valid"]
    return batch


def make_train_epoch_2d(loss_fn, image_size, heatmap_size,
                        sigma: int = 3, mesh=None) -> Callable:
    """PoseResNet training over an epoch of cached batches
    (steps.py:103-131): epoch(state, frames, xs) -> summed loss, acc and
    grad_norm. xs as Mono2DLoader.stacked_epoch stacks them: idx (S, B),
    flip (S, B) bool, trans (S, B, 2, 3), joints (S, B, J, 2), vis
    (S, B, J), row_valid (S, B). The state is updated in place; on CUDA
    the steps replay a CUDA graph, and under a mesh they are the global
    batch's (make_train_epoch_cdr)."""
    core = _train_core_2d(loss_fn, mesh)
    image_size, heatmap_size = tuple(image_size), tuple(heatmap_size)
    graphs = StepGraphs(mesh=mesh)

    def epoch(state: TrainState, frames, xs):
        xs = _stacked_on_device(state, frames, xs)

        def step(x, gen, update):
            return core(state, _mono_batch(frames, x, image_size,
                                           heatmap_size, sigma), update)

        return graphs.epoch(("train", _frames_key(frames)), state, xs, step,
                            state=state)

    epoch.graphs = graphs
    return epoch


def make_eval_epoch_2d(loss_fn, image_size, heatmap_size,
                       sigma: int = 3, mesh=None) -> Callable:
    """PoseResNet evaluation over an epoch of cached batches
    (steps.py:134-159): epoch(state, frames, xs) -> loss_sum, hits, cnt
    and n summed over the S batches (of the global batch under a
    mesh)."""
    step_fn = make_eval_step_2d(loss_fn, **({} if mesh is None
                                            else {"mesh": mesh}))
    image_size, heatmap_size = tuple(image_size), tuple(heatmap_size)
    graphs = StepGraphs(mesh=mesh)

    def epoch(state: TrainState, frames, xs):
        xs = _stacked_on_device(state, frames, xs)

        def step(x, gen, update):
            return step_fn(state, _mono_batch(frames, x, image_size,
                                              heatmap_size, sigma))

        return graphs.epoch(("eval", _frames_key(frames)), state, xs, step,
                            sum_keys=_EVAL_KEYS_2D)

    epoch.graphs = graphs
    return epoch


# ------------------------------------------------------------- segments

def _make_select() -> Callable:
    """select(best, state, improved): best (a state dict of device tensors,
    train/loop2d.py _best_snapshot) takes the model's weights where the
    0-d bool `improved` is set, by a masked copy on the device (one graph
    on CUDA, captured as the epochs' steps are)."""
    graphs = StepGraphs()

    def select(best, state, improved):
        pairs = [(best[k], v) for k, v in state.model.state_dict().items()]

        def copy(x, gen, update):
            for b, c in pairs:
                b.copy_(torch.where(x["flag"], c, b))
            return {}

        graphs.epoch(("select",), (best, state.model),
                     {"flag": improved.reshape(1)}, copy)

    return select


def _epoch_at(xs_seq, e):
    return {k: v[e] for k, v in xs_seq.items()}


def _stack_epochs(rows):
    """Per-epoch metric trees (None for a padding epoch) -> one tree of
    (E, ...) device tensors, zeros on padding rows; None when every epoch
    is padding."""
    first = next((r for r in rows if r is not None), None)
    if first is None:
        return None

    def stack(path):
        def leaf(r):
            v = first if r is None else r
            for k in path:
                v = v[k]
            return torch.zeros_like(v) if r is None else v
        return torch.stack([leaf(r) for r in rows])

    return {k: ({kk: stack((k, kk)) for kk in v} if isinstance(v, dict)
                else stack((k,)))
            for k, v in first.items()}


def make_segment_stereo(train_epoch, eval_epoch, warmup: int = 0,
                        seed: int = 0) -> Callable:
    """A SEGMENT of E epochs of a stereo model, each a train epoch then an
    eval epoch, with the best state selected on the device
    (steps.py:333-453). train_epoch, eval_epoch: the model's epochs
    (make_train_epoch_cdr and make_eval_epoch_cdr, or the _vol pair).

    segment(state, best_state, best_err, t_frames, v_frames, xs_seq,
            vxs, epoch0, epoch_valid) -> (state, best_state, best_err, ms)
      xs_seq: dict of (E, S, B, ...) train metadata (E stacked
        Stereo3DLoader.stacked_epoch results);
      vxs: (S', B, ...) eval metadata (the same every epoch);
      epoch0: the global index of the segment's first epoch: epoch
        ep = epoch0 + e trains with use_3d = ep >= warmup and draws its
        occlusion from the epoch seed seed * 10007 + ep, whatever the
        loader's own epoch counter (which a resumed run restarts at 0);
      epoch_valid: (E,) bools; a False row is a PADDING epoch, skipped:
        it changes no state and reports zero metrics;
      best_state: a state dict of device tensors (loop2d._best_snapshot),
        overwritten in place by the model's weights at an epoch whose val
        MPJPE3D is below best_err, only when ep > warmup
        [ref: train_cdr.py:223-228]; best_err: a 0-d fp32 device tensor,
        returned updated;
      ms: per-epoch stacked metrics {"train": sums over S, "eval":
        {loss_sum, e2_sum, e3_sum, n}, "improved": (E,) bool}, device
        tensors that the host fetches once a segment.
    The state is updated in place and returned, as is best_state. On
    CUDA every step is a replay of the epochs' graphs, and the best
    state's masked copy one more graph an epoch; nothing waits for the
    host inside the segment. Under a mesh (the epochs') xs_seq and vxs
    hold this rank's rows (shard_stacked(mesh, ..., lead=2) of a global
    stack, or the rank's own loaders'), and the best is chosen from the
    global eval sums, so every rank takes the same `improved` and the
    same best state. `segment.graphs` is the train epoch's StepGraphs.
    """
    select = _make_select()

    def segment(state: TrainState, best_state, best_err, t_frames, v_frames,
                xs_seq, vxs, epoch0, epoch_valid):
        rows = []
        for e, valid in enumerate(np.asarray(epoch_valid, bool).tolist()):
            if not valid:
                rows.append(None)
                continue
            ep = int(epoch0) + e
            use_3d = ep >= warmup
            tsum = train_epoch(state, t_frames, _epoch_at(xs_seq, e),
                               seed * 10007 + ep, use_3d)
            esum = eval_epoch(state, v_frames, vxs, use_3d)
            e3 = esum["e3_sum"] / esum["n"].clamp_min(1.0)
            improved = (e3 < best_err) & (ep > warmup)
            select(best_state, state, improved)
            best_err = torch.where(improved, e3, best_err)
            rows.append({"train": tsum, "eval": esum, "improved": improved})
        return state, best_state, best_err, _stack_epochs(rows)

    segment.graphs = train_epoch.graphs
    return segment


def make_segment_cdr(loss_fn, image_size, occlusion=None,
                     warmup: int = 0, seed: int = 0,
                     loss_3d_weight: float = 4.0, scale_3d: float = 0.1,
                     base_joint: int = 1, num_joints: int = 19,
                     clip_norm: float = 100.0, mesh=None) -> Callable:
    """make_segment_stereo over CDRNet's epochs (make_train_epoch_cdr and
    make_eval_epoch_cdr with these step arguments)."""
    kw = dict(loss_3d_weight=loss_3d_weight, scale_3d=scale_3d,
              base_joint=base_joint, num_joints=num_joints)
    if mesh is not None:
        kw["mesh"] = mesh
    return make_segment_stereo(
        make_train_epoch_cdr(loss_fn, image_size, occlusion=occlusion,
                             clip_norm=clip_norm, **kw),
        make_eval_epoch_cdr(loss_fn, image_size, **kw), warmup, seed)


def make_segment_2d(loss_fn, image_size, heatmap_size,
                    sigma: int = 3, mesh=None) -> Callable:
    """2D counterpart of make_segment_stereo (steps.py:456-534): E epochs
    (train then eval each), the best selected on the device by val PCK
    (maximised, no warmup gate [ref: train.py:150-155]).

    segment(state, best_state, best_acc, t_frames, v_frames, xs_seq,
            vxs, epoch_valid) -> (state, best_state, best_acc, ms)
      epoch_valid: (E,) bools, padding rows skipped (zero metrics,
        improved False); ms per epoch: {"train": sums, "eval": {loss_sum,
        hits, cnt, n}, "val_acc": (E,), "improved": (E,) bool}.
    Under a mesh as make_segment_stereo: the best from the global PCK.
    """
    args = (loss_fn, image_size, heatmap_size, sigma, mesh)
    train_epoch = make_train_epoch_2d(*args)
    eval_epoch = make_eval_epoch_2d(*args)
    select = _make_select()

    def segment(state: TrainState, best_state, best_acc, t_frames, v_frames,
                xs_seq, vxs, epoch_valid):
        rows = []
        for e, valid in enumerate(np.asarray(epoch_valid, bool).tolist()):
            if not valid:
                rows.append(None)
                continue
            tsum = train_epoch(state, t_frames, _epoch_at(xs_seq, e))
            esum = eval_epoch(state, v_frames, vxs)
            va, _ = pck_from_counts(esum["hits"], esum["cnt"])
            improved = va > best_acc
            select(best_state, state, improved)
            best_acc = torch.where(improved, va, best_acc)
            rows.append({"train": tsum, "eval": esum, "val_acc": va,
                         "improved": improved})
        return state, best_state, best_acc, _stack_epochs(rows)

    segment.graphs = train_epoch.graphs
    return segment
