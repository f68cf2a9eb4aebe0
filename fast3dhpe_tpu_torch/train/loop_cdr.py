"""CDRNet stereo fine-tune loop (MADS_3d). Port of
fast3dhpe_tpu/train/loop_cdr.py (:47-503, its epoch path).

Reference semantics, as in the JAX package: 2D-only warmup for
TRAIN.WARMUP epochs (use_3d from `epoch >= warmup`), then loss =
LOSS_3D_WEIGHT * loss(0.1 * 3D) + the 2D losses with the gradient norm
clipped at 100; the best checkpoint by val MPJPE3D, only after the warmup
(`epoch > warmup`). Metrics are summed on the device and fetched once an
epoch (and once a --log_every window); the best metric is kept beside
`latest` so that --resume does not overwrite a better best.

The epoch runs as loop2d describes: stacked epochs through
make_train_epoch_cdr / make_eval_epoch_cdr when the device cache holds
the dataset, else the loader's batches; no segments. Occlusion is keyed
by the loader's epoch counter, which starts at 0 in every new loader, so a
resumed run replays epoch 0's draws, as the JAX epoch path does.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from ..data.loader import load_data
from ..device import resolve_device
from ..models.cdrnet import CDRNet
from ..models.layers import init_weights
from ..models.losses import make_loss
from ..utils.interrupt import interruptible
from ..utils.logging import setup_logger
from ..utils.profiling import StepTracer, ThroughputMeter
from .checkpoint import make_checkpoint_writer
from .loop2d import (_best_snapshot, _check_port_options, _fetch,
                     _load_pretrained, _prepare_model_dir, _restore_state,
                     _save_latest, _tree_add, _try_stacked)
from .state import TrainState
from .steps import (make_eval_epoch_cdr, make_eval_step_cdr,
                    make_train_epoch_cdr, make_train_step_cdr)

SCALE_3D = 0.1      # [ref: train_cdr.py:74]
BASE_JOINT = 1      # [ref: train_cdr.py:73]


def _init_model(config, seed: int) -> CDRNet:
    model = CDRNet.from_config(config)
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
    post-warmup epochs without a better val MPJPE3D, and the LR schedule
    still follows TRAIN.EPOCH."""
    logger = setup_logger()
    dtype = _check_port_options(logger, mesh, compute_dtype, segments,
                                segment_epochs)
    dev = resolve_device(device)
    model_path = os.path.join(weights_root, config.MODEL.NAME)
    if not resume:
        _prepare_model_dir(model_path, overwrite, logger, check_only=True)

    train_loader, valid_loader = load_data(config, seed=seed, device=dev)
    try:
        logger.info("Train samples: %d, valid samples: %d",
                    train_loader.num_samples, valid_loader.num_samples)
        if not resume:
            _prepare_model_dir(model_path, overwrite, logger)
        return _train(config, train_loader, valid_loader, model_path, dev,
                      logger, max_epochs, max_steps_per_epoch, seed,
                      plot_dir, resume, log_every, trace_dir, scan_epochs,
                      checkpoint_every, async_checkpoint,
                      early_stop_patience, dtype)
    finally:
        train_loader.close()
        valid_loader.close()


def _train(config, train_loader, valid_loader, model_path, dev, logger,
           max_epochs, max_steps_per_epoch, seed, plot_dir, resume,
           log_every, trace_dir, scan_epochs, checkpoint_every,
           async_checkpoint, early_stop_patience, dtype) -> Dict:
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

    loss_fn = make_loss(config.LOSS.TYPE, config.LOSS.USE_TARGET_WEIGHT)
    kw = dict(loss_3d_weight=config.TRAIN.LOSS_3D_WEIGHT, scale_3d=SCALE_3D,
              base_joint=BASE_JOINT, num_joints=config.MODEL.NUM_JOINTS)
    train_step = make_train_step_cdr(loss_fn, **kw)
    eval_step = make_eval_step_cdr(loss_fn, **kw)

    scan_allowed = (scan_epochs is not False and log_every is None
                    and trace_dir is None)
    if scan_epochs and not scan_allowed:
        logger.info("scan_epochs=True ignored: log_every/trace_dir need "
                    "the per-batch loop")
    train_epoch_fn = eval_epoch_fn = None
    if scan_allowed and (scan_epochs or config.DATASET.DEVICE_CACHE_BYTES):
        image_size = tuple(config.MODEL.IMAGE_SIZE)
        train_epoch_fn = make_train_epoch_cdr(
            loss_fn, image_size, occlusion=config.DATASET.OCCLUSION, **kw)
        eval_epoch_fn = make_eval_epoch_cdr(loss_fn, image_size, **kw)

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

    try:
        with interruptible():   # SIGTERM -> KeyboardInterrupt
            for epoch in range(start_epoch, n_epochs):
                t0 = time.time()
                use_3d = epoch >= warmup
                meter.reset()
                meter.start()
                stacked = _try_stacked(train_loader, train_epoch_fn,
                                       max_steps_per_epoch)
                if stacked is not None:
                    cache, xs, n, pending, ep_idx = stacked
                    tr = _fetch(train_epoch_fn(
                        state, cache.frames, xs, seed * 10007 + ep_idx,
                        use_3d))
                    global_step += n
                    meter.step(pending)
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
                        pending += batch["image"].shape[0]
                        tracer.maybe(i, m)
                        if log_every and (i + 1) % log_every == 0:
                            mm = _fetch(m)   # the window's one sync
                            meter.step(pending)
                            pending = 0
                            logger.info(
                                "  step %d/%d loss %.5f (2d %.5f 3d %.5f) "
                                "|grad| %.2f lr %.2e  %.1f pairs/s",
                                i + 1, steps_per_epoch, mm["loss"],
                                mm["loss_2d"], mm["loss_3d"],
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
                    ev_stacked = _try_stacked(valid_loader, eval_epoch_fn,
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
