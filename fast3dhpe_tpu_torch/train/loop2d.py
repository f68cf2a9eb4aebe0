"""2D backbone training loop (MPII / MADS_2d). Port of
fast3dhpe_tpu/train/loop2d.py.

As in the JAX package: the step metrics are summed on the device and
fetched once an epoch (and once a --log_every window); padded final
batches are masked out; checkpoints hold the weights, and beside
`latest` the optimizer state, step and best metric (train/checkpoint.py),
so --resume continues where a run stopped; the overwrite prompt of the
reference is a flag.

With the device frame cache holding the whole dataset, an epoch runs from
`stacked_epoch()` through `make_train_epoch_2d` / `make_eval_epoch_2d`
(on CUDA, replays of a CUDA graph of the step, train/graphs.py);
otherwise it iterates the loader batch by batch. When both loaders'
caches hold their whole datasets, the run goes by segments by default,
as the JAX package's does (`segments=None`; `False` keeps the stacked
epochs): a segment trains and evaluates the epochs up to the next
checkpoint boundary (`segment_epochs` of them at most, clamped to
`checkpoint_every`) through make_segment_2d, selects the best state on
the device, and the host fetches the segment's metrics once, then logs
each epoch and saves on the `checkpoint_every` grid. Every segment has
the same length: a short one is padded with epochs that change nothing.
Early stopping is checked once a segment.

PyTorch updates weights in place where XLA's buffers are immutable, so the
best state is a clone of the model's state dict at the improving epoch
(on the segment path one clone, updated by a masked copy on the device),
and the checkpoint writers copy what they are given before they return.

Data parallelism (`mesh=`, parallel/mesh.py; the training CLIs under
torchrun): each rank loads its data shard of the records, the model is
`replicate`d once it is built or restored, and every step is the global
batch's (train/steps.py), so the history and the best decisions are the
same on every rank. A (D, M) mesh with M > 1 means what the JAX loop makes
of it: D data shards of whole images, each replicated over its M model
ranks, which load the same records and run the same steps (their
histories and weights agree bit for bit). The stacked epochs and
segments run under a mesh as alone: a rank's loader caches its own
shard's frames and stacks its own rows of each step (data/loader.py),
which are its block of the global stack that the JAX loops shard over
the mesh (parallel/mesh.py shard_stacked), and every step is the global
batch's. Under NCCL each step replays a CUDA graph that holds its
collectives; under gloo the steps run eagerly (train/graphs.py). The
ranks agree the path once a run (_plan): one collective over the world
says whether every rank's caches hold its shard whole, so that all take
the same path (a rank that took another would wait in its first
collective for ever), and gives the global valid rows of an epoch, which
the history's throughput counts; the throughput counts the global batch
on every path. Only rank 0 deletes or creates the model directory and
writes checkpoints (checkpoint.NullCheckpointWriter elsewhere); the
directory is assumed shared by every host.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.loader import load_data
from ..models.layers import init_weights
from ..models.losses import make_loss
from ..models.metrics import pck_from_counts
from ..models.poseresnet import PoseResNet
from ..parallel.distributed import process_index
from ..parallel.mesh import barrier, mesh_device, replicate, world_rows
from ..utils.interrupt import interruptible
from ..utils.logging import setup_logger
from ..utils.profiling import StepTracer, ThroughputMeter
from .checkpoint import (OPT_FILE, load_resume, load_variables,
                         make_checkpoint_writer, merge_encoder_only,
                         resume_payload, snapshot, weights_with_step)
from .state import TrainState
from .steps import (make_eval_epoch_2d, make_eval_step_2d,
                    make_segment_2d, make_train_epoch_2d, make_train_step_2d)


def _prepare_model_dir(model_path: str, overwrite: bool, logger,
                       check_only: bool = False) -> None:
    """check_only=True checks the overwrite flag without deleting: the
    loops call it before load_data and delete only after the data loaded,
    so a wrong dataset path never costs an existing checkpoint.

    Every rank checks, so all of them raise together; the deleting call
    does nothing on ranks other than 0 (as in the JAX package): the ranks
    share the directory, and another rank would find the one rank 0 has
    just made, or race its rmtree and makedirs."""
    if not check_only and process_index() != 0:
        return
    if os.path.exists(model_path):
        if not overwrite:
            raise FileExistsError(
                f"Model dir {model_path} exists; pass overwrite=True "
                f"(--overwrite) to replace it")
        if check_only:
            return
        logger.info("Overwriting existing model dir %s", model_path)
        shutil.rmtree(model_path)
    if not check_only:
        os.makedirs(model_path, exist_ok=True)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _compute_dtype(compute_dtype) -> torch.dtype:
    """Refuse an unknown compute dtype. Returns it: "float32" or
    "bfloat16" (parameters, Adam's state and the BN statistics stay
    fp32)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[compute_dtype]


def _restore_state(model_path, state: TrainState, logger):
    """Resume from <model_path>/latest.pth + latest.opt.pt into `state`;
    returns (start_step, best_metric or None). No latest.pth: a fresh
    start. Under a process group every rank reads the files (nothing in
    the run writes them before) and rank 0 alone makes a missing dir."""
    loaded = load_resume(model_path)
    if loaded is None:
        if process_index() == 0:
            os.makedirs(model_path, exist_ok=True)
        logger.info("No checkpoint to resume; starting fresh")
        return 0, None
    weights, payload = loaded
    state.model.load_state_dict(weights, strict=True)
    state.load_optimizer_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    logger.info("Resumed from step %d (best metric %s)", state.step,
                payload["best_metric"])
    return state.step, payload["best_metric"]


def _save_latest(ckpt, model_path, state: TrainState, best: float) -> None:
    ckpt.save(os.path.join(model_path, "latest.pth"),
              weights_with_step(state.model, state.step))
    ckpt.save(os.path.join(model_path, OPT_FILE),
              resume_payload(state, best))


def _best_snapshot(state: TrainState):
    """The model's weights now, cloned where they lie."""
    return snapshot(weights_with_step(state.model, state.step))


def _tree_add(a, b):
    return {k: a[k] + b[k] for k in a}


def _fetch(tree) -> Dict[str, float]:
    """Scalar device tensors -> floats, in one synchronisation."""
    keys = list(tree)
    vals = torch.stack([torch.as_tensor(tree[k]).float().reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def _fetch_arrays(tree):
    """A nested dict of device tensors -> the same of fp32 numpy arrays, in
    one synchronisation (a segment's metrics)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        leaves.append(t)
        return len(leaves) - 1

    shape = walk(tree)
    flat = torch.cat([t.detach().float().reshape(-1)
                      for t in leaves]).cpu().numpy()
    ends = np.cumsum([t.numel() for t in leaves])

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        start = ends[t] - leaves[t].numel()
        return flat[start:ends[t]].reshape(tuple(leaves[t].shape))

    return fill(shape)


def _stack_segment(xs_list, E_full):
    """Stack E epochs of stacked-epoch metadata into one (E_full, S, ...)
    tree for a segment, padding a short segment by repeating its last
    epoch (skipped by the segment: epoch_valid False), as
    fast3dhpe_tpu/train/loop2d.py:83-93. Returns (seq, epoch_valid,
    n_valid_rows)."""
    n_valid = int(sum(np.asarray(x["row_valid"]).sum() for x in xs_list))
    E = len(xs_list)
    xs_list = xs_list + [xs_list[-1]] * (E_full - E)
    epoch_valid = np.arange(E_full) < E
    seq = {k: np.stack([np.asarray(x[k]) for x in xs_list])
           for k in xs_list[0]}
    return seq, epoch_valid, n_valid


def segment_plan(start_epoch, n_epochs, checkpoint_every, segment_epochs):
    """The segments of a run, as the JAX loops tile them: (first epoch,
    end epoch, whether a save follows) for each, every segment E_full
    epochs long with padding, where E_full = min(seg_len, n_epochs) and
    seg_len = segment_epochs (default checkpoint_every) clamped to
    checkpoint_every. Segments tile the seg_len grid, never cross a
    checkpoint boundary, and saves fall on the checkpoint_every grid and
    at the end. Returns (E_full, [(epoch, boundary, save), ...])."""
    seg_len = max(1, min(segment_epochs or checkpoint_every,
                         checkpoint_every))
    E_full = min(seg_len, n_epochs) or 1
    plan, epoch = [], start_epoch
    while epoch < n_epochs:
        boundary = min((epoch // seg_len + 1) * seg_len,
                       (epoch // checkpoint_every + 1) * checkpoint_every,
                       n_epochs)
        plan.append((epoch, boundary, boundary % checkpoint_every == 0
                     or boundary == n_epochs))
        epoch = boundary
    return E_full, plan


def _init_model(config, seed: int) -> PoseResNet:
    model = PoseResNet.from_config(config)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def _load_pretrained(model, config, logger) -> None:
    """The reference's staged recipe: the encoder from MODEL.PRETRAINED
    (a .pth, or a directory holding one), the rest freshly initialised."""
    if config.MODEL.PRETRAINED:
        logger.info("Loading pretrained encoder from %s",
                    config.MODEL.PRETRAINED)
        model.load_state_dict(merge_encoder_only(
            model.state_dict(), load_variables(config.MODEL.PRETRAINED)),
            strict=True)


def _try_stacked(loader, whole, max_steps_per_epoch):
    """(cache, xs, n_steps, epoch_index) of the loader's next stacked
    epoch when the run stacks its epochs (`whole`: _plan's agreed word
    that the device cache holds the loader's records), else None (the
    per-batch loop, which still uses a partial cache through its upload
    lane)."""
    if not whole:
        return None
    cache, xs, ep_idx = loader.stacked_epoch()
    if max_steps_per_epoch is not None:
        xs = {k: v[:max_steps_per_epoch] for k, v in xs.items()}
    return cache, xs, xs["row_valid"].shape[0], ep_idx


def _plan(mesh, loaders, stacking: bool, max_steps_per_epoch):
    """Once a run, for the train and the valid loader: whether its device
    cache holds its records whole (False for both when the run does not
    stack its epochs), and the valid rows of one of its epochs, of the
    global batch under a mesh (read only where the run stacks).

    An epoch's valid rows are a prefix of its rows (the loaders pad the
    last batch), so a rank holds min(its records, S * B) of them. Under a
    mesh the ranks agree both in one collective over the world
    (world_rows): whole only where every rank's cache is whole, so that
    every rank takes the same path, and the rows summed over the data
    shards (the M model ranks of a data index hold the same rows). It
    raises ValueError, naming both, where two ranks' stacked epochs would
    have different step counts, which would leave one waiting in its
    collectives for ever."""
    whole, steps, rows = [], [], []
    for loader in loaders:
        probe = loader.ensure_device_cache() if stacking else None
        whole.append(probe is not None and not probe.partial)
        n = len(loader)
        if max_steps_per_epoch is not None:
            n = min(n, max_steps_per_epoch)
        steps.append(n)
        rows.append(min(len(loader.records), n * loader.batch_size))
    if mesh is None or not stacking:
        return whole, rows
    mine = rows if mesh.model_rank == 0 else [0] * len(rows)
    got = world_rows(mesh, whole + steps + mine, "plan")
    k = len(loaders)
    for i, loader in enumerate(loaders):
        lo, hi = int(got[:, k + i].min()), int(got[:, k + i].max())
        if lo != hi:
            raise ValueError(f"{loader.image_set}: the ranks' stacked "
                             f"epochs hold {lo} and {hi} steps")
    return ([bool(got[:, i].min()) for i in range(k)],
            [int(got[:, 2 * k + i].sum()) for i in range(k)])


def _log_path(logger, mesh, segment_fn, epoch_fn, whole) -> None:
    """Name the run's path once: segments, stacked epochs or batches,
    and under a mesh whether its steps replay CUDA graphs."""
    if segment_fn is not None:
        path, graphs = "segments", segment_fn.graphs
    elif epoch_fn is not None and whole[0]:
        path, graphs = "stacked epochs", epoch_fn.graphs
    else:
        path, graphs = "batch by batch", None
    under = ""
    if mesh is not None:
        under = f" under a {mesh.size} x {mesh.model_size} mesh"
        if graphs is not None:
            under += (f" ({graphs.backend}: each step replays a CUDA graph "
                      f"with its collectives)" if graphs.graphed else
                      f" ({graphs.backend}: the steps run eagerly)")
    logger.info("Training path: %s%s; eval %s", path, under,
                "stacked" if whole[1] else "batch by batch")


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
    """Train PoseResNet; returns the history (losses and PCK an epoch).

    The keywords are the JAX run's (fast3dhpe_tpu/train/loop2d.py), plus
    `device` (the GPU unless "cpu" is asked for):
      resume: continue from weights/<NAME>/latest.pth + latest.opt.pt.
      log_every: log the step's loss, PCK, grad norm, LR and images/s
        every N steps, one synchronisation a window.
      trace_dir: a torch.profiler trace of steps 1-4 there.
      scan_epochs: False forces the per-batch loop; otherwise stacked
        epochs run when the device cache holds the dataset and neither
        log_every nor trace_dir asks for per-step hooks.
      segments: None (auto): segments whenever stacked epochs run and
        both loaders' caches hold their whole datasets; False keeps the
        stacked epochs (module docstring).
      segment_epochs: epochs a segment at most (default and upper bound:
        checkpoint_every).
      checkpoint_every: write `latest` every N epochs, and at the end, an
        early stop or an interrupt; an improved best is held as a clone on
        the device and written at the same points.
      async_checkpoint: write on a background thread
        (checkpoint.AsyncCheckpointWriter).
      early_stop_patience: stop once val PCK has not improved for this
        many epochs (checked once a segment on the segment path).
      compute_dtype: "float32" or "bfloat16" (bf16 compute, fp32
        parameters, Adam state and BN statistics);
      mesh: a parallel.mesh.Mesh: data-parallel training on its device,
        which takes the place of `device` (see the module's docstring).
    """
    logger = setup_logger()
    dtype = _compute_dtype(compute_dtype)
    dev = mesh_device(mesh, device)
    model_path = os.path.join(weights_root, config.MODEL.NAME)
    if not resume:
        _prepare_model_dir(model_path, overwrite, logger, check_only=True)
    # every rank has checked before rank 0 deletes or makes the dir: the
    # one write of a run that another rank could race
    barrier(mesh)

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


def _scan_allowed(logger, scan_epochs, segments, log_every,
                  trace_dir) -> bool:
    """Whether stacked epochs (and so segments) may run: not for per-step
    hooks. Under a mesh too, every rank alike (_plan)."""
    allowed = (scan_epochs is not False and log_every is None
               and trace_dir is None)
    if (scan_epochs or segments) and not allowed:
        logger.info("scan_epochs=%s, segments=%s ignored: log_every and "
                    "trace_dir need the per-batch loop", scan_epochs,
                    segments)
    return allowed


def _segments_on(segments, train_epoch_fn, whole) -> bool:
    """Segments run where stacked epochs do and both caches hold their
    whole datasets (_plan's agreed `whole`), unless segments is False (the
    JAX loops' rule)."""
    return segments is not False and train_epoch_fn is not None and \
        all(whole)


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
    best_acc = -1.0
    if resume:
        start_step, best = _restore_state(model_path, state, logger)
        start_epoch = start_step // max(steps_per_epoch, 1)
        if best is not None:
            best_acc = best
    if mesh is not None:
        # whole images on every model rank of a (D, M) mesh, as the JAX
        # loop trains them
        replicate(mesh, model, spatial=False)

    loss_fn = make_loss(config.LOSS.TYPE, config.LOSS.USE_TARGET_WEIGHT,
                        layout="NHWC")
    # the steps' single-process call is the one without the keyword
    mesh_kw = {} if mesh is None else {"mesh": mesh}
    train_step = make_train_step_2d(loss_fn, **mesh_kw)
    eval_step = make_eval_step_2d(loss_fn, **mesh_kw)

    scan_allowed = _scan_allowed(logger, scan_epochs, segments, log_every,
                                 trace_dir)
    train_epoch_fn = eval_epoch_fn = segment_fn = None
    args = (loss_fn, config.MODEL.IMAGE_SIZE,
            config.MODEL.EXTRA.HEATMAP_SIZE, config.MODEL.EXTRA.SIGMA)
    if scan_allowed and (scan_epochs or config.DATASET.DEVICE_CACHE_BYTES):
        train_epoch_fn = make_train_epoch_2d(*args, **mesh_kw)
        eval_epoch_fn = make_eval_epoch_2d(*args, **mesh_kw)
    whole, epoch_rows = _plan(mesh, (train_loader, valid_loader),
                              train_epoch_fn is not None,
                              max_steps_per_epoch)
    if _segments_on(segments, train_epoch_fn, whole):
        segment_fn = make_segment_2d(*args, **mesh_kw)
    _log_path(logger, mesh, segment_fn, train_epoch_fn, whole)
    # the pairs or images of the global batch a local one counts
    shards = 1 if mesh is None else mesh.size

    n_epochs = max_epochs if max_epochs is not None else config.TRAIN.EPOCH
    best_state, best_dirty = None, False
    # 0-based epoch of the last val best; a resume restarts the patience
    # window from the resumed epoch
    last_best_epoch = start_epoch - 1
    ckpt = make_checkpoint_writer(async_checkpoint)
    ev_stacked = None
    history = {"train_loss": [], "val_loss": [], "train_acc": [],
               "val_acc": [], "train_imgs_per_sec": []}
    meter = ThroughputMeter(window=max(50, 2 * (log_every or 1)))
    global_step = start_epoch * steps_per_epoch
    tracer = StepTracer(trace_dir, logger)

    def epoch_slice(xs):
        if max_steps_per_epoch is not None:
            xs = {k: v[:max_steps_per_epoch] for k, v in xs.items()}
        return xs

    def run_segments():
        """The segment path: one segment_fn call and one fetch a segment
        (segment_plan), then each epoch's history and log; saves on the
        checkpoint_every grid, early stopping once a segment."""
        nonlocal best_state, best_dirty, best_acc, global_step, \
            last_best_epoch
        vcache, vxs, _ = valid_loader.stacked_epoch()
        vxs = epoch_slice(vxs)
        best_state = _best_snapshot(state)
        best_dev = torch.tensor(best_acc, dtype=torch.float32, device=dev)
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
            n_imgs = (boundary - epoch) * epoch_rows[0]
            S = seq["idx"].shape[1]
            step0 = state.step
            _, _, best_dev, ms = segment_fn(
                state, best_state, best_dev, tcache.frames, vcache.frames,
                seq, vxs, epoch_valid)
            msh = _fetch_arrays({"ms": ms, "best": best_dev})  # the one sync
            meter.step(n_imgs)
            global_step += (boundary - epoch) * S
            ips = meter.samples_per_sec
            dt = (time.time() - t0) / (boundary - epoch)
            ms = msh["ms"]
            for j in range(boundary - epoch):
                tl = float(ms["train"]["loss"][j]) / max(S, 1)
                ta = float(ms["train"]["acc"][j]) / max(S, 1)
                nv = max(float(ms["eval"]["n"][j]), 1.0)
                vl = float(ms["eval"]["loss_sum"][j]) / nv
                va = float(ms["val_acc"][j])
                history["train_loss"].append(tl)
                history["val_loss"].append(vl)
                history["train_acc"].append(ta)
                history["val_acc"].append(va)
                history["train_imgs_per_sec"].append(ips)
                logger.info("epoch %d/%d  train loss %.5f acc %.4f "
                            "(%.1f imgs/s) | val loss %.5f acc %.4f  "
                            "(%.1fs)", epoch + j + 1, n_epochs, tl, ta, ips,
                            vl, va, dt)
                if ms["improved"][j]:
                    logger.info("New best (val acc %.4f)", va)
                    last_best_epoch = epoch + j
                    best_state._metadata[""]["train_step"] = \
                        step0 + (j + 1) * S
            if float(msh["best"]) > best_acc:
                best_acc = float(msh["best"])
                best_dirty = True
            stop = (early_stop_patience is not None
                    and (boundary - 1) - last_best_epoch
                    >= early_stop_patience)
            if not (save or stop):
                continue
            if best_dirty:
                ckpt.save(os.path.join(model_path, "best.pth"), best_state)
                best_dirty = False
                logger.info("Saved best (val acc %.4f)", best_acc)
            _save_latest(ckpt, model_path, state, best_acc)
            if stop:
                logger.info(
                    "Early stop at epoch %d: no val improvement for %d "
                    "epochs (best acc %.4f at epoch %d)", boundary,
                    (boundary - 1) - last_best_epoch, best_acc,
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
                meter.reset()
                meter.start()
                stacked = _try_stacked(train_loader, whole[0],
                                       max_steps_per_epoch)
                if stacked is not None:
                    cache, xs, n, _ = stacked
                    tr = _fetch(train_epoch_fn(state, cache.frames, xs))
                    global_step += n
                    meter.step(epoch_rows[0])
                else:
                    acc, n, pending, m = None, 0, 0, None
                    for i, batch in enumerate(train_loader):
                        if max_steps_per_epoch is not None and \
                                i >= max_steps_per_epoch:
                            break
                        m = train_step(state, batch)
                        acc = m if acc is None else _tree_add(acc, m)
                        n += 1
                        global_step += 1
                        pending += batch["image"].shape[0] * shards
                        tracer.maybe(i, m)
                        if log_every and (i + 1) % log_every == 0:
                            mm = _fetch(m)   # the window's one sync
                            meter.step(pending)
                            pending = 0
                            logger.info(
                                "  step %d/%d loss %.5f acc %.4f "
                                "|grad| %.2f lr %.2e  %.1f imgs/s",
                                i + 1, steps_per_epoch, mm["loss"],
                                mm["acc"], mm["grad_norm"],
                                state.schedule(global_step),
                                meter.samples_per_sec)
                    tracer.finish(m)
                    tr = (_fetch(acc) if acc is not None
                          else {"loss": 0.0, "acc": 0.0})
                    if pending:     # the fetch above synchronised
                        meter.step(pending)
                tl, ta = tr["loss"] / max(n, 1), tr["acc"] / max(n, 1)
                train_ips = meter.samples_per_sec

                # eval metadata is the same every epoch: stacked once
                if ev_stacked is None:
                    ev_stacked = _try_stacked(valid_loader, whole[1],
                                              max_steps_per_epoch)
                if ev_stacked is not None:
                    vcache, vxs = ev_stacked[:2]
                    ev = eval_epoch_fn(state, vcache.frames, vxs)
                else:
                    ev = None
                    for i, batch in enumerate(valid_loader):
                        if max_steps_per_epoch is not None and \
                                i >= max_steps_per_epoch:
                            break
                        m = eval_step(state, batch)
                        part = {k: m[k] for k in
                                ("loss_sum", "hits", "cnt", "n")}
                        ev = part if ev is None else _tree_add(ev, part)
                if ev is not None:
                    vl, va = _fetch({
                        "vl": ev["loss_sum"] / ev["n"].clamp_min(1.0),
                        "va": pck_from_counts(ev["hits"], ev["cnt"])[0],
                    }).values()
                else:
                    vl, va = 0.0, 0.0

                history["train_loss"].append(tl)
                history["val_loss"].append(vl)
                history["train_acc"].append(ta)
                history["val_acc"].append(va)
                history["train_imgs_per_sec"].append(train_ips)
                logger.info("epoch %d/%d  train loss %.5f acc %.4f "
                            "(%.1f imgs/s) | val loss %.5f acc %.4f  "
                            "(%.1fs)", epoch + 1, n_epochs, tl, ta,
                            train_ips, vl, va, time.time() - t0)

                if va > best_acc:
                    best_acc = va
                    best_state, best_dirty = _best_snapshot(state), True
                    last_best_epoch = epoch
                    logger.info("New best (val acc %.4f)", va)
                stop = (early_stop_patience is not None
                        and epoch - last_best_epoch >= early_stop_patience)
                if (epoch + 1) % checkpoint_every == 0 or \
                        epoch + 1 == n_epochs or stop:
                    if best_dirty:
                        ckpt.save(os.path.join(model_path, "best.pth"),
                                  best_state)
                        best_dirty = False
                        logger.info("Saved best (val acc %.4f)", best_acc)
                    _save_latest(ckpt, model_path, state, best_acc)
                if stop:
                    logger.info(
                        "Early stop at epoch %d: no val improvement for %d "
                        "epochs (best acc %.4f at epoch %d)", epoch + 1,
                        epoch - last_best_epoch, best_acc,
                        last_best_epoch + 1)
                    break

    except KeyboardInterrupt:
        logger.warning("Interrupted — saving latest checkpoint before exit "
                       "(resume with --resume)")
        if best_dirty:
            ckpt.save(os.path.join(model_path, "best.pth"), best_state)
        _save_latest(ckpt, model_path, state, best_acc)
        ckpt.close()    # the process is about to exit: flush
        raise
    ckpt.close()        # drain background saves; re-raise worker errors

    if plot_dir:
        from ..utils.visualize import plot_loss
        plot_loss(history["train_loss"], plot_dir, "Training Loss")
        plot_loss(history["val_loss"], plot_dir, "Validation Loss")
        plot_loss(history["train_acc"], plot_dir, "Training Accuracy")
        plot_loss(history["val_acc"], plot_dir, "Validation Accuracy")
    logger.info("Training is done!")
    return history
