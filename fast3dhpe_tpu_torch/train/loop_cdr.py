"""CDRNet stereo fine-tune loop (MADS_3d). Port of
fast3dhpe_tpu/train/loop_cdr.py (:47-503, its epoch path).

MODEL.TYPE "volumetric" trains the volumetric model
(models/volumetric.py) through the same loop, loaders, caches and step
graphs, with its own steps (train/steps.py make_train_epoch_vol and its
kin): its loss is 3D from the first step, and MPJPE2D is that of its 3D
joints projected into the crops.

Reference semantics, as in the JAX package: 2D-only warmup for
TRAIN.WARMUP epochs (use_3d from `epoch >= warmup`), then loss =
LOSS_3D_WEIGHT * loss(0.1 * 3D) + the 2D losses with the gradient norm
clipped at 100; the best checkpoint by val MPJPE3D, only after the warmup
(`epoch > warmup`). Metrics are summed on the device and fetched once an
epoch (and once a --log_every window); the best metric is kept beside
`latest` so that --resume does not overwrite a better best.

The epochs run as loop2d describes: segments (make_segment_stereo, the
best selected on the device only after the warmup) when both caches
hold their datasets, else stacked epochs through make_train_epoch_cdr /
make_eval_epoch_cdr (or the _vol pair) when the train cache does, else
the loader's batches, and under a mesh on every path, as loop2d
describes (each rank's loaders cache and stack its own shard). A segment keys an epoch's
occlusion by its global index, seed * 10007 + epoch, so a resumed run
goes on with the draws where it stopped, as the JAX package's default
(segment) path does. Stacked epochs and batches key it by the loader's
epoch counter, which starts at 0 in every new loader, so there a resumed
run replays epoch 0's draws, as the JAX epoch path does.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from ..data.loader import load_data
from ..models.cdrnet import CDRNet
from ..models.layers import init_weights
from ..models.losses import make_loss
from ..models.volumetric import VolumetricNet
from ..parallel.mesh import barrier, mesh_device, replicate
from ..utils.interrupt import interruptible
from ..utils.logging import setup_logger
from ..utils.profiling import StepTracer, ThroughputMeter
from .checkpoint import make_checkpoint_writer
from .loop2d import (_best_snapshot, _compute_dtype, _fetch, _fetch_arrays,
                     _load_pretrained, _log_path, _plan, _prepare_model_dir,
                     _restore_state, _save_latest, _scan_allowed,
                     _segments_on, _stack_segment, _tree_add, _try_stacked,
                     segment_plan)
from .state import TrainState
from .steps import (make_eval_epoch_cdr, make_eval_epoch_vol,
                    make_eval_step_cdr, make_eval_step_vol,
                    make_segment_stereo, make_train_epoch_cdr,
                    make_train_epoch_vol, make_train_step_cdr,
                    make_train_step_vol)

SCALE_3D = 0.1      # [ref: train_cdr.py:74]
BASE_JOINT = 1      # [ref: train_cdr.py:73]


def _volumetric(config) -> bool:
    return config.MODEL.TYPE == "volumetric"


def _init_model(config, seed: int):
    model = (VolumetricNet if _volumetric(config) else
             CDRNet).from_config(config)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def run(config, mesh=None, overwrite: bool = False,
        weights_root: str = "weights", max_epochs: Optional[int] = None,
        max_steps_per_epoch: Optional[int] = None, seed: int = 0,
        compute_dtype: str = "float32", plot_dir: Optional[str] = None,
        resume: bool = False, log_every: Optional[int] = None,
        trace_dir: Optional[str] = None,
        scan_epochs: Optional[bool] = None,
        segments: Optional[bool] = None,
        checkpoint_every: int = 1,
        segment_epochs: Optional[int] = None,
        async_checkpoint: bool = False,
        early_stop_patience: Optional[int] = None,
        device="cuda") -> Dict:
    """Train CDRNet; returns the history (losses, grad norm and val MPJPE
    an epoch). The keywords are loop2d.run's; early_stop_patience counts
    post-warmup epochs without a better val MPJPE3D (once a segment on the
    segment path), and the LR schedule still follows TRAIN.EPOCH."""
    logger = setup_logger()
    dtype = _compute_dtype(compute_dtype)
    dev = mesh_device(mesh, device)
    model_path = os.path.join(weights_root, config.MODEL.NAME)
    if not resume:
        _prepare_model_dir(model_path, overwrite, logger, check_only=True)
    barrier(mesh)   # as in loop2d.run

    train_loader, valid_loader = load_data(config, mesh=mesh, seed=seed,
                                           device=dev)
    try:
        logger.info("Train samples: %d, valid samples: %d",
                    train_loader.num_samples, valid_loader.num_samples)
        if not resume:
            _prepare_model_dir(model_path, overwrite, logger)
        return _train(config, train_loader, valid_loader, model_path, dev,
                      logger, max_epochs, max_steps_per_epoch, seed,
                      plot_dir, resume, log_every, trace_dir, scan_epochs,
                      segments, checkpoint_every, segment_epochs,
                      async_checkpoint, early_stop_patience, dtype, mesh)
    finally:
        train_loader.close()
        valid_loader.close()


def _train(config, train_loader, valid_loader, model_path, dev, logger,
           max_epochs, max_steps_per_epoch, seed, plot_dir, resume,
           log_every, trace_dir, scan_epochs, segments, checkpoint_every,
           segment_epochs, async_checkpoint, early_stop_patience, dtype,
           mesh) -> Dict:
    model = _init_model(config, seed)
    model.dtype = dtype         # the compute dtype; parameters stay fp32
    _load_pretrained(model, config, logger)
    model.to(dev)
    steps_per_epoch = len(train_loader)
    state = TrainState.create(model, config, steps_per_epoch)

    start_epoch = 0
    best_err = float("inf")
    if resume:
        start_step, best = _restore_state(model_path, state, logger)
        start_epoch = start_step // max(steps_per_epoch, 1)
        if best is not None and best > 0:
            best_err = best
    if mesh is not None:
        # whole images on every model rank of a (D, M) mesh, as the JAX
        # loop trains them
        replicate(mesh, model, spatial=False)

    mesh_kw = {} if mesh is None else {"mesh": mesh}
    image_size = tuple(config.MODEL.IMAGE_SIZE)
    occlusion = config.DATASET.OCCLUSION
    # the one choice of the model's steps: the volumetric model's take
    # CDRNet's calls (steps.py)
    if _volumetric(config):
        kw = dict(scale_3d=SCALE_3D, base_joint=BASE_JOINT, **mesh_kw)
        vol_step = make_train_step_vol(**kw)
        angles = torch.Generator(device=dev).manual_seed(seed)

        def train_step(state, batch, use_3d):
            return vol_step(state, batch, use_3d, angles)

        eval_step = make_eval_step_vol(**kw)

        def epochs():
            return (make_train_epoch_vol(image_size, occlusion=occlusion,
                                         **kw),
                    make_eval_epoch_vol(image_size, **kw))
    else:
        loss_fn = make_loss(config.LOSS.TYPE, config.LOSS.USE_TARGET_WEIGHT)
        kw = dict(loss_3d_weight=config.TRAIN.LOSS_3D_WEIGHT,
                  scale_3d=SCALE_3D, base_joint=BASE_JOINT,
                  num_joints=config.MODEL.NUM_JOINTS, **mesh_kw)
        train_step = make_train_step_cdr(loss_fn, **kw)
        eval_step = make_eval_step_cdr(loss_fn, **kw)

        def epochs():
            return (make_train_epoch_cdr(loss_fn, image_size,
                                         occlusion=occlusion, **kw),
                    make_eval_epoch_cdr(loss_fn, image_size, **kw))

    scan_allowed = _scan_allowed(logger, scan_epochs, segments, log_every,
                                 trace_dir)
    train_epoch_fn = eval_epoch_fn = segment_fn = None
    if scan_allowed and (scan_epochs or config.DATASET.DEVICE_CACHE_BYTES):
        train_epoch_fn, eval_epoch_fn = epochs()
    whole, epoch_rows = _plan(mesh, (train_loader, valid_loader),
                              train_epoch_fn is not None,
                              max_steps_per_epoch)
    if _segments_on(segments, train_epoch_fn, whole):
        segment_fn = make_segment_stereo(*epochs(),
                                         warmup=config.TRAIN.WARMUP,
                                         seed=seed)
    _log_path(logger, mesh, segment_fn, train_epoch_fn, whole)
    # the pairs of the global batch a local one counts
    shards = 1 if mesh is None else mesh.size

    n_epochs = max_epochs if max_epochs is not None else config.TRAIN.EPOCH
    warmup = config.TRAIN.WARMUP
    best_state, best_dirty = None, False
    # 0-based epoch of the last val best; a resume restarts the patience
    # window from the resumed epoch
    last_best_epoch = max(start_epoch - 1, warmup)
    ckpt = make_checkpoint_writer(async_checkpoint)
    ev_stacked = None
    history = {"train_loss": [], "val_loss": [], "val_mpjpe_3d": [],
               "val_mpjpe_2d": [], "grad_norm": [],
               "train_pairs_per_sec": []}
    meter = ThroughputMeter(window=max(50, 2 * (log_every or 1)))
    global_step = start_epoch * steps_per_epoch
    tracer = StepTracer(trace_dir, logger)

    def latest_metric():
        return best_err if best_err != float("inf") else 0.0

    def epoch_slice(xs):
        if max_steps_per_epoch is not None:
            xs = {k: v[:max_steps_per_epoch] for k, v in xs.items()}
        return xs

    def run_segments():
        """The segment path (loop2d's run_segments): one segment_fn call
        and one fetch a segment, then each epoch's history and log; saves
        on the checkpoint_every grid, early stopping once a segment."""
        nonlocal best_state, best_dirty, best_err, global_step, \
            last_best_epoch
        vcache, vxs, _ = valid_loader.stacked_epoch()
        vxs = epoch_slice(vxs)
        best_state = _best_snapshot(state)
        best_dev = torch.tensor(best_err, dtype=torch.float32, device=dev)
        E_full, plan = segment_plan(start_epoch, n_epochs, checkpoint_every,
                                    segment_epochs)
        for epoch, boundary, save in plan:
            t0 = time.time()
            meter.reset()
            meter.start()
            xs_list = []
            for _ in range(boundary - epoch):
                tcache, xs, _ = train_loader.stacked_epoch()
                xs_list.append(epoch_slice(xs))
            seq, epoch_valid, _ = _stack_segment(xs_list, E_full)
            n_pairs = (boundary - epoch) * epoch_rows[0]
            S = seq["idx_l"].shape[1]
            step0 = state.step
            _, _, best_dev, ms = segment_fn(
                state, best_state, best_dev, tcache.frames, vcache.frames,
                seq, vxs, epoch, epoch_valid)
            msh = _fetch_arrays({"ms": ms, "best": best_dev})  # the one sync
            meter.step(n_pairs)
            global_step += (boundary - epoch) * S
            pps = meter.samples_per_sec
            dt = (time.time() - t0) / (boundary - epoch)
            ms = msh["ms"]
            for j in range(boundary - epoch):
                tl = float(ms["train"]["loss"][j]) / max(S, 1)
                gn = float(ms["train"]["grad_norm"][j]) / max(S, 1)
                nv = max(float(ms["eval"]["n"][j]), 1.0)
                vl = float(ms["eval"]["loss_sum"][j]) / nv
                e2 = float(ms["eval"]["e2_sum"][j]) / nv
                e3 = float(ms["eval"]["e3_sum"][j]) / nv
                history["train_loss"].append(tl)
                history["val_loss"].append(vl)
                history["val_mpjpe_2d"].append(e2)
                history["val_mpjpe_3d"].append(e3)
                history["grad_norm"].append(gn)
                history["train_pairs_per_sec"].append(pps)
                logger.info("epoch %d/%d%s  train loss %.5f |grad| %.2f "
                            "(%.1f pairs/s) | val loss %.5f MPJPE2D %.2fpx "
                            "MPJPE3D %.2fmm  (%.1fs)", epoch + j + 1,
                            n_epochs,
                            " [warmup]" if epoch + j < warmup else "",
                            tl, gn, pps, vl, e2, e3, dt)
                if ms["improved"][j]:
                    logger.info("New best (val 3D MPJPE %.2fmm)", e3)
                    last_best_epoch = epoch + j
                    best_state._metadata[""]["train_step"] = \
                        step0 + (j + 1) * S
            if float(msh["best"]) < best_err:
                best_err = float(msh["best"])
                best_dirty = True
            stop = (early_stop_patience is not None
                    and boundary - 1 > warmup
                    and (boundary - 1) - last_best_epoch
                    >= early_stop_patience)
            if not (save or stop):
                continue
            if best_dirty:
                ckpt.save(os.path.join(model_path, "best.pth"), best_state)
                best_dirty = False
                logger.info("Saved best (val 3D MPJPE %.2fmm)", best_err)
            _save_latest(ckpt, model_path, state, latest_metric())
            if stop:
                logger.info(
                    "Early stop at epoch %d: no val improvement for %d "
                    "epochs (best %.2f mm at epoch %d)", boundary,
                    (boundary - 1) - last_best_epoch, best_err,
                    last_best_epoch + 1)
                break

    try:
        with interruptible():   # SIGTERM -> KeyboardInterrupt
            if segment_fn is not None:
                run_segments()
            epochs = (range(0) if segment_fn is not None
                      else range(start_epoch, n_epochs))
            for epoch in epochs:
                t0 = time.time()
                use_3d = epoch >= warmup
                meter.reset()
                meter.start()
                stacked = _try_stacked(train_loader, whole[0],
                                       max_steps_per_epoch)
                if stacked is not None:
                    cache, xs, n, ep_idx = stacked
                    tr = _fetch(train_epoch_fn(
                        state, cache.frames, xs, seed * 10007 + ep_idx,
                        use_3d))
                    global_step += n
                    meter.step(epoch_rows[0])
                else:
                    acc, n, pending, m = None, 0, 0, None
                    for i, batch in enumerate(train_loader):
                        if max_steps_per_epoch is not None and \
                                i >= max_steps_per_epoch:
                            break
                        m = train_step(state, batch, use_3d)
                        acc = m if acc is None else _tree_add(acc, m)
                        n += 1
                        global_step += 1
                        pending += batch["image"].shape[0] * shards
                        tracer.maybe(i, m)
                        if log_every and (i + 1) % log_every == 0:
                            mm = _fetch(m)   # the window's one sync
                            meter.step(pending)
                            pending = 0
                            parts = " ".join(
                                f"{k[5:]} {mm[k]:.5f}" for k in
                                ("loss_2d", "loss_3d", "loss_ce") if k in mm)
                            logger.info(
                                "  step %d/%d loss %.5f (%s) "
                                "|grad| %.2f lr %.2e  %.1f pairs/s",
                                i + 1, steps_per_epoch, mm["loss"], parts,
                                mm["grad_norm"], state.schedule(global_step),
                                meter.samples_per_sec)
                    tracer.finish(m)
                    tr = (_fetch(acc) if acc is not None
                          else {"loss": 0.0, "grad_norm": 0.0})
                    if pending:     # the fetch above synchronised
                        meter.step(pending)
                tl = tr["loss"] / max(n, 1)
                gn = tr["grad_norm"] / max(n, 1)
                train_pps = meter.samples_per_sec

                # eval metadata is the same every epoch: stacked once
                if ev_stacked is None:
                    ev_stacked = _try_stacked(valid_loader, whole[1],
                                              max_steps_per_epoch)
                if ev_stacked is not None:
                    vcache, vxs = ev_stacked[:2]
                    ev = eval_epoch_fn(state, vcache.frames, vxs, use_3d)
                else:
                    ev = None
                    for i, batch in enumerate(valid_loader):
                        if max_steps_per_epoch is not None and \
                                i >= max_steps_per_epoch:
                            break
                        m = eval_step(state, batch, use_3d)
                        part = {k: m[k] for k in
                                ("loss_sum", "e2_sum", "e3_sum", "n")}
                        ev = part if ev is None else _tree_add(ev, part)
                if ev is not None:
                    ev = _fetch(ev)
                    nv = max(ev["n"], 1.0)
                    vl, e2, e3 = (ev["loss_sum"] / nv, ev["e2_sum"] / nv,
                                  ev["e3_sum"] / nv)
                else:
                    vl, e2, e3 = 0.0, 0.0, 0.0

                history["train_loss"].append(tl)
                history["val_loss"].append(vl)
                history["val_mpjpe_2d"].append(e2)
                history["val_mpjpe_3d"].append(e3)
                history["grad_norm"].append(gn)
                history["train_pairs_per_sec"].append(train_pps)
                logger.info("epoch %d/%d%s  train loss %.5f |grad| %.2f "
                            "(%.1f pairs/s) | val loss %.5f MPJPE2D %.2fpx "
                            "MPJPE3D %.2fmm  (%.1fs)",
                            epoch + 1, n_epochs,
                            " [warmup]" if epoch < warmup else "",
                            tl, gn, train_pps, vl, e2, e3, time.time() - t0)

                # best only after the warmup [ref: train_cdr.py:223-228];
                # held on the device, written at checkpoint boundaries
                if e3 < best_err and epoch > warmup:
                    best_err = e3
                    best_state, best_dirty = _best_snapshot(state), True
                    last_best_epoch = epoch
                    logger.info("New best (val 3D MPJPE %.2fmm)", e3)
                stop = (early_stop_patience is not None and epoch > warmup
                        and epoch - last_best_epoch >= early_stop_patience)
                if (epoch + 1) % checkpoint_every == 0 or \
                        epoch + 1 == n_epochs or stop:
                    if best_dirty:
                        ckpt.save(os.path.join(model_path, "best.pth"),
                                  best_state)
                        best_dirty = False
                        logger.info("Saved best (val 3D MPJPE %.2fmm)",
                                    best_err)
                    _save_latest(ckpt, model_path, state, latest_metric())
                if stop:
                    logger.info(
                        "Early stop at epoch %d: no val improvement for %d "
                        "epochs (best %.2f mm at epoch %d)", epoch + 1,
                        epoch - last_best_epoch, best_err,
                        last_best_epoch + 1)
                    break

    except KeyboardInterrupt:
        logger.warning("Interrupted — saving latest checkpoint before exit "
                       "(resume with --resume)")
        if best_dirty:
            ckpt.save(os.path.join(model_path, "best.pth"), best_state)
        _save_latest(ckpt, model_path, state, latest_metric())
        ckpt.close()    # the process is about to exit: flush
        raise
    ckpt.close()        # drain background saves; re-raise worker errors

    if plot_dir:
        from ..utils.visualize import plot_loss
        plot_loss(history["train_loss"], plot_dir, "Training Loss")
        plot_loss(history["val_loss"], plot_dir, "Validation Loss")
        plot_loss(history["val_mpjpe_3d"], plot_dir, "MPJPE")
    logger.info("Training is done!")
    return history
