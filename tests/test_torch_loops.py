"""The PyTorch port's training loops (fast3dhpe_tpu_torch/train/loop_cdr.py
and loop2d.py), their checkpoints, resume, early stop, SIGTERM handling
and run_with_retries, on the CPU device, on a small synthetic MADS tree
(depth 18, 64 px, 16 px heatmaps, batch 4).

Parity: one JAX loop run of each kind (per-batch, scan_epochs=False) and
the port's loop from the same initial weights (the port's model
construction is monkeypatched to load JAX's init through convert.py; the
JAX loop takes its init with the head scaled by HEAD_SCALE through a
monkeypatched encoder merge, as tests/test_torch_loader.py scales it for
unit-spread logits). The port runs its stacked epochs from the device
cache, JAX iterates its loader over the same cache; the batches are
bit-equal (tests/test_torch_loader.py). Bounds, relative, set from
measurement on this tree at LR = 1e-7 (1e-6 moves the CDR loop's last grad
norm 14% apart), and held per epoch:
  - 2D loop: losses within TOL_2D (measured 1e-6), PCK exactly.
  - CDR loop, warmup epoch: losses and MPJPE2D within TOL_2D (measured
    6e-6), grad norm within GRAD_TOL (1.1e-4).
  - CDR loop, after the warmup: the 3D terms go through the DLT of an
    untrained model's keypoints on the tree's parallel rig (they
    triangulate at the 1e-9 floor of w: MPJPE3D ~1e9 mm), which turns
    rounding-level differences of the 2D keypoints into larger ones
    (tests/test_torch_loader.py holds loss_3d to 5e-2 for that reason):
    the losses and MPJPE3D within TOL_3D (measured 3.8e-4), the grad norm,
    whose 3D part is the gradient of that DLT, within GRAD_3D_TOL
    (measured 6.9e-3 and 6.3e-2).
The throughput keys are wall-clock figures of two different programs and
are checked positive and finite only.
"""

import errno
import os
import signal

import numpy as np
import pytest
import torch

import jax

from fast3dhpe_tpu.config import config_from_dict as jax_config_from_dict
from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
from fast3dhpe_tpu.train import loop2d as jax_loop2d
from fast3dhpe_tpu.train import loop_cdr as jax_loop_cdr
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.data.loader import load_data
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.train import checkpoint, loop2d, loop_cdr, steps
from fast3dhpe_tpu_torch.train.resilience import run_with_retries
from fast3dhpe_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

LR = 1e-7
HEAD_SCALE = 50.0
TOL_2D, GRAD_TOL, TOL_3D, GRAD_3D_TOL = 1e-4, 1e-2, 2e-3, 0.2
FRAMES = 4                          # a movement: 2 movements, 8 pairs
SPE = 2                             # steps an epoch at batch 4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("loops")
    make_synthetic_mads(str(root / "mads"), n_frames=FRAMES, img_w=128,
                        img_h=96, movements=("HipHop", "Jazz"))
    return root


def _dict(root, dataset, name="t", epochs=3, warmup=1, lr=LR,
          lr_step=(40,), cache=0):
    return {
        "DATASET": {"TYPE": dataset, "ROOT": str(root / "mads"),
                    "OCCLUSION": "None", "DEVICE_CACHE_BYTES": cache},
        "MODEL": {"NAME": name, "NUM_LAYERS": 18, "IMAGE_SIZE": [64, 64],
                  "PRETRAINED": "",
                  "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}},
        "TRAIN": {"BATCH_SIZE": 4, "EPOCH": epochs, "WARMUP": warmup,
                  "LR": lr, "LR_STEP": list(lr_step), "LR_FACTOR": 0.1},
        "TEST": {"BATCH_SIZE": 4},
        "LOSS": {"TYPE": "JointsMSESmooth" if dataset == "MADS_3d"
                 else "JointsMSE", "USE_TARGET_WEIGHT": True}}


def _cfg(root, dataset="MADS_3d", **kw):
    return config_from_dict(_dict(root, dataset, **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _parity_runs(tree, tmp, dataset, jax_loop, port_loop, port_cls):
    """The JAX loop and the port's from JAX's init (head scaled for the
    CDR net)."""
    d = _dict(tree, dataset, cache=1 << 30)
    jcfg = jax_config_from_dict(d)
    jcfg.MODEL.PRETRAINED = "jax-init"
    init = {}

    def merge(variables, _pretrained):
        v = _np(variables)
        if dataset == "MADS_3d":
            head = v["params"]["decoder"]["final_layer"]
            head["kernel"] = head["kernel"] * HEAD_SCALE
        init["v"] = v
        return v

    def port_model(config, seed):
        model = port_cls.from_config(config)
        model.load_state_dict(jax_variables_to_state_dict(init["v"]),
                              strict=True)
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "load_variables", lambda path: None)
        mp.setattr(jax_loop, "merge_encoder_only", merge)
        ref = jax_loop.run(jcfg, overwrite=True, seed=0, scan_epochs=False,
                           weights_root=str(tmp / "jax"))
        mp.setattr(port_loop, "_init_model", port_model)
        got = port_loop.run(config_from_dict(d), overwrite=True, seed=0,
                            weights_root=str(tmp / "port"), device="cpu")
    return ref, got


@pytest.fixture(scope="module")
def cdr_runs(tree, tmp_path_factory):
    return _parity_runs(tree, tmp_path_factory.mktemp("cdr"), "MADS_3d",
                        jax_loop_cdr, loop_cdr, CDRNet)


@pytest.fixture(scope="module")
def runs_2d(tree, tmp_path_factory):
    return _parity_runs(tree, tmp_path_factory.mktemp("2d"), "MADS_2d",
                        jax_loop2d, loop2d, PoseResNet)


def _close(got, ref, rel, key):
    np.testing.assert_allclose(got, ref, rtol=rel, err_msg=key)


def test_cdr_loop_history_matches_jax(cdr_runs):
    """3 epochs, WARMUP 1, at LR: the warmup epoch within TOL_2D (grad norm
    GRAD_TOL), MPJPE2D within TOL_2D throughout, the 3D terms after the
    warmup within TOL_3D and GRAD_3D_TOL (module docstring)."""
    ref, got = cdr_runs
    assert got.keys() == ref.keys()
    assert all(len(v) == 3 for v in got.values())
    for key in ("train_loss", "val_loss"):
        _close(got[key][0], ref[key][0], TOL_2D, key)
        _close(got[key][1:], ref[key][1:], TOL_3D, key)
    _close(got["grad_norm"][0], ref["grad_norm"][0], GRAD_TOL, "grad_norm")
    _close(got["grad_norm"][1:], ref["grad_norm"][1:], GRAD_3D_TOL,
           "grad_norm")
    _close(got["val_mpjpe_2d"], ref["val_mpjpe_2d"], TOL_2D, "val_mpjpe_2d")
    _close(got["val_mpjpe_3d"], ref["val_mpjpe_3d"], TOL_3D, "val_mpjpe_3d")
    assert all(np.isfinite(v) and v > 0 for v in got["train_pairs_per_sec"])


def test_2d_loop_history_matches_jax(runs_2d):
    """3 epochs at LR: losses within TOL_2D, PCK exactly."""
    ref, got = runs_2d
    assert got.keys() == ref.keys()
    for key in ("train_loss", "val_loss"):
        _close(got[key], ref[key], TOL_2D, key)
    for key in ("train_acc", "val_acc"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert all(np.isfinite(v) and v > 0 for v in got["train_imgs_per_sec"])


# ------------------------------------------------------------- port only

def _run(loop, cfg, tmp, **kw):
    kw.setdefault("overwrite", True)
    return loop.run(cfg, weights_root=str(tmp), seed=0, device="cpu", **kw)


def _weights(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _eval_mpjpe_3d(cfg, state_dict):
    """val MPJPE3D of a state dict, computed as the loop's eval does."""
    _, valid = load_data(cfg, seed=0, device="cpu")
    model = CDRNet.from_config(cfg)
    model.load_state_dict(state_dict, strict=True)
    state = TrainState.create(model, cfg, 1)
    step = steps.make_eval_step_cdr(make_loss(cfg.LOSS.TYPE, True),
                                    loss_3d_weight=4.0)
    e3 = n = 0.0
    for batch in valid:
        m = step(state, batch, True)
        e3, n = e3 + float(m["e3_sum"]), n + float(m["n"])
    valid.close()
    return e3 / n


def test_cdr_per_batch_equals_stacked_epochs(tree, tmp_path):
    """The per-batch loop over the loader and the stacked epochs from the
    device cache give the same history, exactly (the loaders' batches are
    bit-equal, tests/test_torch_loader.py)."""
    got = _run(loop_cdr, _cfg(tree, epochs=2, lr=1e-4), tmp_path / "a")
    ref = _run(loop_cdr, _cfg(tree, epochs=2, lr=1e-4, cache=1 << 30),
               tmp_path / "b")
    for key in ("train_loss", "val_loss", "val_mpjpe_2d", "val_mpjpe_3d",
                "grad_norm"):
        assert got[key] == ref[key], key


@pytest.mark.parametrize("loop,dataset", [(loop_cdr, "MADS_3d"),
                                          (loop2d, "MADS_2d")])
def test_early_stop_patience(tree, tmp_path, loop, dataset):
    """LR 0 freezes the weights: after the first best the val metric moves
    only with the BN running statistics, and patience 2 ends a 30-epoch
    schedule early, still writing latest and (CDR: after the warmup)
    best."""
    cfg = _cfg(tree, dataset, epochs=30, warmup=0, lr=0.0)
    h = _run(loop, cfg, tmp_path, early_stop_patience=2)
    n = len(h["val_loss"])
    assert 3 <= n < 30
    model_dir = tmp_path / "t"
    assert {"latest.pth", "latest.opt.pt", "best.pth"} <= set(
        os.listdir(model_dir))
    assert checkpoint.weights_step(_weights(model_dir / "latest.pth")) \
        == n * SPE


def test_overwrite_refused_before_any_deletion(tree, tmp_path):
    """Without overwrite an existing model dir raises FileExistsError and
    keeps its files; with overwrite but a missing dataset, load_data fails
    before the directory is deleted."""
    cfg = _cfg(tree, epochs=1)
    _run(loop_cdr, cfg, tmp_path, max_steps_per_epoch=1)
    model_dir = tmp_path / "t"
    before = {p: (model_dir / p).read_bytes() for p in os.listdir(model_dir)}
    with pytest.raises(FileExistsError, match="--overwrite"):
        _run(loop_cdr, cfg, tmp_path, overwrite=False)
    cfg.DATASET.ROOT = str(tmp_path / "missing")
    with pytest.raises(FileNotFoundError):
        _run(loop_cdr, cfg, tmp_path)
    assert {p: (model_dir / p).read_bytes()
            for p in os.listdir(model_dir)} == before


def test_best_written_at_boundary_holds_best_epochs_state(tree, tmp_path,
                                                         monkeypatch):
    """checkpoint_every=4: the best epoch's weights are cloned when it
    improves and written at the boundary, after later epochs changed the
    model. The eval step reports epochs 3-4's MPJPE3D x 1000, so that
    epoch 2 is the best (training lowers it every epoch here). best.pth
    carries epoch 2's step, its weights evaluate to epoch 2's MPJPE3D (the
    CPU is deterministic), and they differ from latest.pth's."""
    make, calls = loop_cdr.make_eval_step_cdr, []

    def make_eval(loss_fn, **kw):
        step = make(loss_fn, **kw)

        def scaled(state, batch, use_3d):
            m = step(state, batch, use_3d)
            calls.append(1)
            if len(calls) > 2 * SPE:     # 2 eval batches an epoch
                m["e3_sum"] = m["e3_sum"] * 1000.0
            return m
        return scaled

    monkeypatch.setattr(loop_cdr, "make_eval_step_cdr", make_eval)
    cfg = _cfg(tree, epochs=4, warmup=0, lr=1e-3)
    h = _run(loop_cdr, cfg, tmp_path, checkpoint_every=4)
    e3 = h["val_mpjpe_3d"]
    assert int(np.argmin(e3[1:])) + 1 == 1, e3  # best only after warmup
    best = _weights(tmp_path / "t" / "best.pth")
    latest = _weights(tmp_path / "t" / "latest.pth")
    assert checkpoint.weights_step(best) == 2 * SPE
    assert checkpoint.weights_step(latest) == 4 * SPE
    assert not torch.equal(best["decoder.final_layer.weight"],
                           latest["decoder.final_layer.weight"])
    assert _eval_mpjpe_3d(cfg, best) == pytest.approx(e3[1], rel=1e-6)


def test_resume_across_lr_step(tree, tmp_path, monkeypatch):
    """2 epochs, then --resume to 4 with LR_STEP [3] (2 steps an epoch):
    the resumed run trains epochs 3-4, its updates run at steps 4-7 with
    LR, LR, LR/10, LR/10, Adam continues its bias correction from the
    restored per-parameter step, and the result equals the JAX package's
    resume semantics, rebuilt by hand: the saved weights, optimizer state
    and step, then 2 epochs of a new loader (whose epoch counter restarts
    at 0, so epoch 0's augmentation draws are replayed)."""
    lr = 1e-3
    cfg = _cfg(tree, "MADS_2d", epochs=4, lr=lr, lr_step=(3,))
    h1 = _run(loop2d, cfg, tmp_path, max_epochs=2)
    assert len(h1["train_loss"]) == 2
    model_dir = tmp_path / "t"
    saved_w = _weights(model_dir / "latest.pth")
    saved_o = torch.load(model_dir / checkpoint.OPT_FILE, weights_only=True)
    assert saved_o["step"] == 2 * SPE
    assert checkpoint.weights_step(saved_w) == saved_o["step"]

    seen = []
    apply = TrainState.apply_gradients

    def spy(self):
        adam_step = float(next(iter(self.optimizer.state.values()))["step"])
        seen.append((self.step, self.schedule(self.step), adam_step))
        apply(self)

    monkeypatch.setattr(TrainState, "apply_gradients", spy)
    h2 = _run(loop2d, cfg, tmp_path, resume=True, overwrite=False)
    monkeypatch.undo()
    assert len(h2["train_loss"]) == 2
    assert seen == [(4, lr, 4.0), (5, lr, 5.0), (6, lr * 0.1, 6.0),
                    (7, lr * 0.1, 7.0)]

    # the JAX resume semantics by hand
    model = PoseResNet.from_config(cfg)
    model.load_state_dict(saved_w, strict=True)
    state = TrainState.create(model, cfg, SPE)
    state.optimizer.load_state_dict(saved_o["optimizer"])
    state.step = saved_o["step"]
    train, valid = load_data(cfg, seed=0, device="cpu")
    step = steps.make_train_step_2d(make_loss("JointsMSE", True,
                                              layout="NHWC"))
    for _ in range(2):
        for batch in train:
            step(state, batch)
    train.close()
    valid.close()
    got = _weights(model_dir / "latest.pth")
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_sigterm_mid_epoch_saves_latest_and_reraises(tree, tmp_path,
                                                     monkeypatch):
    """SIGTERM after the 3rd step (in epoch 2) becomes KeyboardInterrupt:
    latest.pth and latest.opt.pt of step 3 are written, then it
    re-raises; the handler is restored afterwards."""
    make = loop2d.make_train_step_2d

    def make_step(loss_fn):
        step = make(loss_fn)

        def killed(state, batch):
            m = step(state, batch)
            if state.step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return m
        return killed

    monkeypatch.setattr(loop2d, "make_train_step_2d", make_step)
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.raises(KeyboardInterrupt):
        _run(loop2d, _cfg(tree, "MADS_2d", epochs=3), tmp_path)
    assert signal.getsignal(signal.SIGTERM) is handler
    w, payload = checkpoint.load_resume(str(tmp_path / "t"))
    assert payload["step"] == 3 and checkpoint.weights_step(w) == 3


@pytest.mark.parametrize("fail_at,resumed", [(3, True), (1, False)])
def test_run_with_retries(tree, tmp_path, monkeypatch, fail_at, resumed):
    """An EIO after the first checkpoint (step 3, in epoch 2) resumes from
    latest and trains the rest; one before any checkpoint (step 1)
    restarts fresh with overwrite. The final latest is of step 6 either
    way."""
    make = loop2d.make_train_step_2d
    failed, calls = [], []

    def make_step(loss_fn):
        step = make(loss_fn)

        def flaky(state, batch):
            m = step(state, batch)
            if state.step == fail_at and not failed:
                failed.append(state.step)
                raise OSError(errno.EIO, "Input/output error")
            return m
        return flaky

    def run(config, **kw):
        calls.append((kw["resume"], kw["overwrite"]))
        return loop2d.run(config, **kw)

    monkeypatch.setattr(loop2d, "make_train_step_2d", make_step)
    h = run_with_retries(run, _cfg(tree, "MADS_2d", epochs=3), retries=1,
                         retry_backoff_s=0.0, weights_root=str(tmp_path),
                         seed=0, device="cpu", resume=False, overwrite=True)
    assert calls == [(False, True), (resumed, not resumed)]
    assert len(h["train_loss"]) == (2 if resumed else 3)
    w, payload = checkpoint.load_resume(str(tmp_path / "t"))
    assert payload["step"] == 3 * SPE


def test_run_with_retries_raises_non_retryable_at_once(tree, tmp_path):
    calls = []

    def run(config, **kw):
        calls.append(kw)
        raise ValueError("a bug, not an outage")

    with pytest.raises(ValueError):
        run_with_retries(run, _cfg(tree), retries=3, retry_backoff_s=0.0,
                         weights_root=str(tmp_path), device="cpu")
    assert len(calls) == 1
    for exc in (RuntimeError("CUDA error: an illegal memory access was "
                             "encountered"),
                torch.cuda.OutOfMemoryError("CUDA out of memory")):
        assert not run_with_retries.__globals__["is_retryable"](exc)
    assert run_with_retries.__globals__["is_retryable"](RuntimeError(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"))


def test_log_every_trace_and_plots(tree, tmp_path, caplog):
    """log_every logs each step (one fetch a window), trace_dir gets a
    torch.profiler Chrome trace of the steps, plot_dir the loss curves;
    log_every keeps the per-batch loop although the cache holds the
    dataset."""
    import json
    from fast3dhpe_tpu_torch.utils.logging import setup_logger
    cfg = _cfg(tree, "MADS_2d", epochs=1, cache=1 << 30)
    logger = setup_logger()
    logger.addHandler(caplog.handler)
    try:
        _run(loop2d, cfg, tmp_path, log_every=1,
             trace_dir=str(tmp_path / "trace"),
             plot_dir=str(tmp_path / "plots"))
    finally:
        logger.removeHandler(caplog.handler)
    steps_logged = [r for r in caplog.records
                    if r.getMessage().startswith("  step ")]
    assert len(steps_logged) == SPE
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert {"Training Loss.png", "Validation Accuracy.png"} <= set(
        os.listdir(tmp_path / "plots"))
