"""The PyTorch port's one-dispatch training (fast3dhpe_tpu_torch/train/
steps.py make_segment_cdr / make_segment_2d, the loops' segment path,
train/graphs.py on the CPU) against the JAX package's segments; depth 18
at 64 px, on the CPU, on the same weights, frames and stacked metadata
(numpy, from a seed), occlusion off where JAX runs, so that the two RNGs
need not agree.

Bounds, as tests/test_torch_train_epoch.py holds one epoch (LR 1e-6, BN
statistics within BN_TOL of each buffer's range; its module docstring
says why), unless a test's docstring says otherwise; the loops within
tests/test_torch_loops.py's bounds."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fast3dhpe_tpu.config import config_from_dict as jax_config_from_dict
from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
from fast3dhpe_tpu.models import make_loss as jax_make_loss
from fast3dhpe_tpu.train import loop2d as jax_loop2d
from fast3dhpe_tpu.train import loop_cdr as jax_loop_cdr
from fast3dhpe_tpu.train import steps as jsteps
from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
from fast3dhpe_tpu.train.state import multistep_lr as jax_multistep_lr
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.train import checkpoint, loop2d, loop_cdr, steps
from fast3dhpe_tpu_torch.train.loop2d import _best_snapshot, segment_plan
from fast3dhpe_tpu_torch.train.state import TrainState

from test_torch_loops import (GRAD_3D_TOL, GRAD_TOL, HEAD_SCALE, TOL_2D,
                              TOL_3D, _close, _dict)
from test_torch_train_epoch import (BN_TOL, CFG, HM, IMG, J2, LR, _mono_xs,
                                    _np, _stereo_xs)
from test_torch_train_epoch import frames  # noqa: F401 (a fixture)

torch.set_num_threads(2)

E_FULL, E_VALID, WARMUP, SEED = 3, 2, 1, 0
# one step an epoch, so that the two valid epochs make the two Adam updates
# (the second at LR / 10) of tests/test_torch_train_epoch.py, whose 2.5 LR
# bound on the parameters they keep
S = 1


def _one_step(xs):
    """The first step of stacked metadata, its last row padded."""
    xs = {k: np.array(v[:S]) for k, v in xs.items()}
    xs["row_valid"][-1, -1] = 0.0
    return xs


def _seq(xs_list):
    """(E_FULL, S, ...) numpy metadata and epoch_valid, padded with the
    last epoch as the loops pad."""
    return loop2d._stack_segment(xs_list, E_FULL)[:2]


def _state_close(got, ref, tag):
    """Parameters within 2.5 lr of JAX's, BN statistics within BN_TOL of
    each buffer's range (tests/test_torch_train_epoch.py)."""
    for name, t in got.items():
        if name not in ref or "num_batches" in name:
            continue
        r = torch.as_tensor(np.asarray(ref[name]))
        if "running" in name:
            assert float((t - r).abs().max()) <= BN_TOL * float(
                r.abs().max()), (tag, name)
        else:
            assert float((t - r).abs().max()) <= 2.5 * LR, (tag, name)


# ------------------------------------------------------------------ CDR

@pytest.fixture(scope="module")
def cdr_segments(frames):
    """JAX's make_segment_cdr and the port's, E_FULL = 3 with 2 valid
    epochs and a padding one, WARMUP 1, from the same weights: once from
    epoch 0 (a warmup epoch, then one with the 3D loss, no best) and once
    from epoch 1 (both with the 3D loss, the second improves the best).
    The config's Adam, its LR / 10 from the second epoch."""
    _, cache, jcache = frames
    xs_list = [_one_step(_stereo_xs(40 + e)) for e in range(E_VALID)]
    vxs = _stereo_xs(50)
    seq, valid = _seq(xs_list)
    model = JaxCDRNet(num_layers=18)
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, IMG, IMG, 3)),
        jnp.asarray(vxs["P_l"][0, :1, None, :3].repeat(2, 1)),
        train=False))
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    head["bias"] = head["bias"] + np.random.RandomState(3).randn(19).astype(
        np.float32)
    init = jax_variables_to_state_dict(v)
    jloss = jax_make_loss("JointsMSESmooth", True)
    tx = optax.adam(jax_multistep_lr(LR, [1], 0.1, S))
    jseg = jsteps.make_segment_cdr(model, jloss, (IMG, IMG), occlusion=None,
                                   warmup=WARMUP, seed=SEED)
    jseq = {k: jnp.asarray(a) for k, a in seq.items()}
    jvxs = {k: jnp.asarray(a) for k, a in vxs.items()}

    cfg = config_from_dict(CFG)
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    seg = steps.make_segment_cdr(loss, (IMG, IMG), occlusion=None,
                                 warmup=WARMUP, seed=SEED)
    out = {"init": init, "xs": xs_list, "vxs": vxs, "seq": seq,
           "valid": valid}
    for epoch0 in (0, 1):
        st = JaxTrainState.create(v, tx)
        jst, jbest, jerr, jms = jseg(
            st, st, jnp.asarray(np.inf, jnp.float32), jcache.frames,
            jcache.frames, jseq, jvxs, jnp.asarray(epoch0),
            jnp.asarray(valid))
        port = CDRNet(num_layers=18)
        port.load_state_dict(init, strict=True)
        state = TrainState.create(port, cfg, steps_per_epoch=S)
        best = _best_snapshot(state)
        _, _, err, ms = seg(state, best, torch.tensor(float("inf")),
                            cache.frames, cache.frames, seq, vxs, epoch0,
                            valid)
        out[epoch0] = {
            "jax": {"ms": _np(jms), "err": float(jerr),
                    "state": jax_variables_to_state_dict(
                        _np(jst.variables)),
                    "best": jax_variables_to_state_dict(
                        _np(jbest.variables))},
            "port": {"ms": ms, "err": float(err), "state": state,
                     "best": best}}
    return out


@pytest.mark.parametrize("epoch0", [0, 1])
def test_segment_cdr_matches_jax(cdr_segments, epoch0):
    """Per-epoch train sums: the losses within 1e-4 relative (the 3D
    terms of the epochs with the 3D loss within tests/test_torch_loops.py's
    TOL_3D, the DLT of an untrained net) and grad_norm within 1e-2
    (GRAD_3D_TOL with the 3D loss); eval sums within 1e-4 (TOL_3D for the
    3D ones), n exact; the padding epoch's metrics 0 in both; `improved`
    and the best error as JAX's; the final state after the valid epochs
    within the module's bounds."""
    ref, got = (cdr_segments[epoch0][k] for k in ("jax", "port"))
    rm, gm = ref["ms"], got["ms"]
    for e in range(E_FULL):
        ep = epoch0 + e
        use_3d = ep >= WARMUP
        for k, t in gm["train"].items():
            r = float(rm["train"][k][e])
            if e >= E_VALID:
                assert float(t[e]) == r == 0.0, (e, k)
                continue
            tol = ((GRAD_3D_TOL if use_3d else 1e-2) if k == "grad_norm"
                   else TOL_3D if use_3d and k != "loss_2d" else 1e-4)
            assert float(t[e]) == pytest.approx(r, rel=tol), (e, k)
        for k, t in gm["eval"].items():
            r = float(rm["eval"][k][e])
            tol = 1e-4 if k in ("n", "e2_sum") or not use_3d else TOL_3D
            assert float(t[e]) == pytest.approx(r, rel=tol), (e, k)
    assert [bool(x) for x in gm["improved"]] == \
        [bool(x) for x in rm["improved"]]
    assert any(rm["improved"]) == (epoch0 == 1)
    if epoch0 == 1:
        assert got["err"] == pytest.approx(ref["err"], rel=TOL_3D)
    else:
        assert got["err"] == ref["err"] == float("inf")
    assert got["state"].step == E_VALID * S
    _state_close(got["state"].model.state_dict(), ref["state"], "final")


@pytest.mark.parametrize("epoch0", [0, 1])
def test_segment_cdr_best_state_matches_jax(cdr_segments, epoch0):
    """From epoch 0 no epoch is after the warmup: the best state stays the
    initial weights, bit for bit. From epoch 1 the second epoch improves:
    the best state is its weights (the final ones; JAX's within the module's
    bounds), with the train step of that epoch in its metadata as the
    loops write it."""
    ref, got = (cdr_segments[epoch0][k] for k in ("jax", "port"))
    best = got["best"]
    if epoch0 == 0:
        for k, t in cdr_segments["init"].items():
            assert torch.equal(best[k], t), k
        return
    _state_close(best, ref["best"], "best")
    for k, t in got["state"].model.state_dict().items():
        assert torch.equal(best[k], t), k


def test_segment_equals_sequential_epochs_with_cutout(frames):
    """With CUTOUT on, a segment (2 valid epochs and a padding one, from
    epoch 1) is bit for bit the stacked epochs run one after the other with
    the epoch seeds seed * 10007 + epoch and the best chosen on the host:
    per-epoch metrics, `improved`, the best error and state, the final
    weights and Adam's state; the padding epoch reports zeros."""
    _, cache, _ = frames
    xs_list = [_one_step(_stereo_xs(60 + e)) for e in range(E_VALID)]
    vxs = _stereo_xs(70)
    seq, valid = _seq(xs_list)
    cfg = config_from_dict(CFG)
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    torch.manual_seed(1)
    init = CDRNet(num_layers=18).state_dict()

    def fresh():
        model = CDRNet(num_layers=18)
        model.load_state_dict(init)
        return TrainState.create(model, cfg, steps_per_epoch=S)

    seed, epoch0 = 5, 1
    seg_state = fresh()
    best = _best_snapshot(seg_state)
    _, _, err, ms = steps.make_segment_cdr(
        loss, (IMG, IMG), occlusion="CUTOUT", warmup=WARMUP, seed=seed)(
        seg_state, best, torch.tensor(float("inf")), cache.frames,
        cache.frames, seq, vxs, epoch0, valid)

    st = fresh()
    train = steps.make_train_epoch_cdr(loss, (IMG, IMG), occlusion="CUTOUT")
    evaluate = steps.make_eval_epoch_cdr(loss, (IMG, IMG))
    berr, best_ref = torch.tensor(float("inf")), None
    for e in range(E_VALID):
        ep = epoch0 + e
        tsum = train(st, cache.frames, xs_list[e], seed * 10007 + ep,
                     ep >= WARMUP)
        esum = evaluate(st, cache.frames, vxs, ep >= WARMUP)
        for k, t in tsum.items():
            assert torch.equal(ms["train"][k][e], t), (e, k)
        for k, t in esum.items():
            assert torch.equal(ms["eval"][k][e], t), (e, k)
        e3 = esum["e3_sum"] / esum["n"].clamp_min(1.0)
        improved = bool(e3 < berr) and ep > WARMUP
        assert bool(ms["improved"][e]) == improved
        if improved:
            berr = e3
            best_ref = {k: v.clone() for k, v in st.model.state_dict().items()}
    for part in ("train", "eval"):
        for k, t in ms[part].items():
            assert float(t[E_VALID]) == 0.0, (part, k)
    assert not bool(ms["improved"][E_VALID])
    assert torch.equal(err, berr) and best_ref is not None
    for k, t in best_ref.items():
        assert torch.equal(best[k], t), k
    for k, t in st.model.state_dict().items():
        assert torch.equal(seg_state.model.state_dict()[k], t), k
    assert seg_state.step == st.step == E_VALID * S
    for a, b in zip(seg_state.optimizer.state.values(),
                    st.optimizer.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_padding_epochs_change_nothing(frames):
    """Padding epochs anywhere in a segment are skipped: [valid, padding,
    valid, padding] leaves the state bit-equal to [valid, valid] on the
    same two epochs (weights, BN statistics, Adam, the step count, the best
    state), with zero metrics on the padding rows; a segment of padding
    only changes nothing and reports no metrics."""
    _, cache, _ = frames
    xs_list = [_one_step(_stereo_xs(80 + e)) for e in range(E_VALID)]
    vxs = _stereo_xs(90)
    cfg = config_from_dict(CFG)
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    torch.manual_seed(2)
    init = CDRNet(num_layers=18).state_dict()
    seg = steps.make_segment_cdr(loss, (IMG, IMG), warmup=0)

    def run(order, valid):
        model = CDRNet(num_layers=18)
        model.load_state_dict(init)
        st = TrainState.create(model, cfg, steps_per_epoch=S)
        best = _best_snapshot(st)
        seq = {k: np.stack([xs_list[i][k] for i in order])
               for k in xs_list[0]}
        _, _, err, ms = seg(st, best, torch.tensor(float("inf")),
                            cache.frames, cache.frames, seq, vxs, 0, valid)
        return st, best, err, ms

    ref = run([0, 1], [True, True])
    got = run([0, 0, 1, 1], [True, False, True, False])
    for k, t in ref[0].model.state_dict().items():
        assert torch.equal(got[0].model.state_dict()[k], t), k
        assert torch.equal(got[1][k], ref[1][k]), k
    assert got[0].step == ref[0].step == E_VALID * S
    for a, b in zip(got[0].optimizer.state.values(),
                    ref[0].optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for part in ("train", "eval"):
        for k, t in got[3][part].items():
            assert torch.equal(t[[0, 2]], ref[3][part][k]), (part, k)
            assert float(t[1]) == float(t[3]) == 0.0, (part, k)
    st, best, err, ms = run([0], [False])
    assert ms is None and st.step == 0 and float(err) == float("inf")
    for k, t in init.items():
        assert torch.equal(st.model.state_dict()[k], t), k


# ------------------------------------------------------------------- 2D

def test_segment_2d_matches_jax(frames):
    """make_segment_2d against JAX's: E_FULL = 3 with 2 valid epochs and a
    padding one: the per-epoch train and eval sums (loss within 1e-4
    relative, acc and hits/cnt exactly, grad_norm within 1e-2), val PCK
    and `improved` (maximised, no warmup gate: the first epoch improves on
    -1), the best PCK, the padding row's zeros, the final and best states
    within the module's bounds."""
    _, cache, jcache = frames
    xs_list = [_one_step(_mono_xs(100 + e)) for e in range(E_VALID)]
    vxs = _mono_xs(110)
    seq, valid = _seq(xs_list)
    model = JaxPoseResNet(num_joints=J2, num_layers=18)
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    jloss = jax_make_loss("JointsMSE", True, layout="NHWC")
    tx = optax.adam(jax_multistep_lr(LR, [1], 0.1, S))
    st = JaxTrainState.create(v, tx)
    jst, jbest, jacc, jms = jsteps.make_segment_2d(
        model, jloss, (IMG, IMG), (HM, HM), 2)(
        st, st, jnp.asarray(-1.0, jnp.float32), jcache.frames, jcache.frames,
        {k: jnp.asarray(a) for k, a in seq.items()},
        {k: jnp.asarray(a) for k, a in vxs.items()}, jnp.asarray(valid))
    jms = _np(jms)

    port = PoseResNet(num_joints=J2, num_layers=18)
    port.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    state = TrainState.create(port, config_from_dict(CFG), steps_per_epoch=S)
    best = _best_snapshot(state)
    loss = make_loss("JointsMSE", True, layout="NHWC")
    _, _, acc, ms = steps.make_segment_2d(loss, (IMG, IMG), (HM, HM), 2)(
        state, best, torch.tensor(-1.0), cache.frames, cache.frames, seq,
        vxs, valid)
    for e in range(E_FULL):
        for k, t in ms["train"].items():
            tol = 1e-2 if k == "grad_norm" else 1e-4
            r = float(jms["train"][k][e])
            if k == "acc":
                assert float(t[e]) == r, (e, k)
            else:
                assert float(t[e]) == pytest.approx(r, rel=tol), (e, k)
        assert float(ms["eval"]["loss_sum"][e]) == pytest.approx(
            float(jms["eval"]["loss_sum"][e]), rel=1e-4)
        for k in ("hits", "cnt", "n"):
            np.testing.assert_array_equal(ms["eval"][k][e].numpy(),
                                          jms["eval"][k][e])
        assert float(ms["val_acc"][e]) == float(jms["val_acc"][e])
    assert [bool(x) for x in ms["improved"]] == \
        [bool(x) for x in jms["improved"]]
    assert bool(ms["improved"][0]) and not bool(ms["improved"][E_VALID])
    assert float(acc) == float(jacc)
    _state_close(state.model.state_dict(),
                 jax_variables_to_state_dict(_np(jst.variables)), "final")
    _state_close(best, jax_variables_to_state_dict(_np(jbest.variables)),
                 "best")


# ----------------------------------------------------------- the loops

@pytest.mark.parametrize("start,n,every,seg,want", [
    (0, 4, 3, None, (3, [(0, 3, True), (3, 4, True)])),
    (0, 5, 4, None, (4, [(0, 4, True), (4, 5, True)])),
    (0, 5, 4, 2, (2, [(0, 2, False), (2, 4, True), (4, 5, True)])),
    (0, 5, 4, 9, (4, [(0, 4, True), (4, 5, True)])),
    (1, 4, 3, None, (3, [(1, 3, True), (3, 4, True)])),
    (3, 7, 2, 1, (1, [(3, 4, True), (4, 5, False), (5, 6, True),
                      (6, 7, True)])),
    (0, 2, 5, None, (2, [(0, 2, True)])),
])
def test_segment_tiling(start, n, every, seg, want):
    """segment_plan tiles a run as the JAX loops' _run_segments do
    (fast3dhpe_tpu/train/loop_cdr.py:239-338; tests/test_device_cache.py
    :405-515): segments on the segment_epochs grid (clamped to
    checkpoint_every), never across a checkpoint boundary, a fixed length
    E_full = min(seg_len, epochs) padded where a segment is shorter (a
    ragged final segment, a resume offset), saves on the checkpoint_every
    grid and at the end."""
    assert segment_plan(start, n, every, seg) == want


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("segtree")
    make_synthetic_mads(str(root / "mads"), n_frames=4, img_w=128,
                        img_h=96, movements=("HipHop", "Jazz"))
    return root


def _cfg(tree, dataset="MADS_3d", **kw):
    return config_from_dict(_dict(tree, dataset, cache=1 << 30, **kw))


class _Spy:
    """Records checkpoint writes (file, train step) and the occlusion epoch
    seeds (step 0's epoch_seed of every train epoch)."""

    def __init__(self, monkeypatch):
        self.saves, self.seeds = [], []
        save_file, step_seed = checkpoint.save_file, steps.step_seed

        def save(path, obj):
            step = (obj["step"] if path.endswith(".opt.pt")
                    else checkpoint.weights_step(obj))
            self.saves.append((os.path.basename(path), step))
            save_file(path, obj)

        def seed(epoch_seed, step):
            if step == 0:
                self.seeds.append(epoch_seed)
            return step_seed(epoch_seed, step)

        monkeypatch.setattr(checkpoint, "save_file", save)
        monkeypatch.setattr(steps, "step_seed", seed)


def _run(loop, cfg, root, **kw):
    kw.setdefault("overwrite", True)
    return loop.run(cfg, weights_root=str(root), seed=SEED, device="cpu",
                    **kw)


def test_segment_epochs_tiling_in_the_loop(tree, tmp_path, monkeypatch):
    """loop_cdr.run with checkpoint_every 4 and segment_epochs 2 over 5
    epochs (segments 2, 2 and a padded 1) gives the history of the stacked
    epochs (segments=False) bit for bit, and writes latest only after
    epochs 4 and 5 (2 steps an epoch), best only there."""
    spy = _Spy(monkeypatch)
    cfg = _cfg(tree, epochs=5, lr=1e-4)
    got = _run(loop_cdr, cfg, tmp_path / "seg", checkpoint_every=4,
               segment_epochs=2)
    saves = list(spy.saves)
    ref = _run(loop_cdr, cfg, tmp_path / "ep", checkpoint_every=4,
               segments=False)
    for key in ("train_loss", "val_loss", "val_mpjpe_2d", "val_mpjpe_3d",
                "grad_norm"):
        assert got[key] == ref[key], key
    latest = [s for f, s in saves if f == "latest.pth"]
    best = [s for f, s in saves if f == "best.pth"]
    assert latest == [8, 10] and best and set(best) <= {8, 10}
    assert checkpoint.weights_step(torch.load(
        tmp_path / "seg" / "t" / "latest.pth", weights_only=True)) == 10


@pytest.mark.parametrize("segments,resumed_seeds", [(None, [2]),
                                                    (False, [0])])
def test_resume_occlusion_seeds(tree, tmp_path, monkeypatch, segments,
                                resumed_seeds):
    """With CUTOUT and the tree in the cache: a fresh run keys epoch e's
    occlusion by seed * 10007 + e either way; after --resume at epoch 2 the
    segment path goes on with the global epoch (the JAX package's default),
    the stacked epochs with the new loader's counter, 0."""
    spy = _Spy(monkeypatch)
    d = _dict(tree, "MADS_3d", epochs=3, cache=1 << 30)
    d["DATASET"]["OCCLUSION"] = "CUTOUT"
    cfg = config_from_dict(d)
    _run(loop_cdr, cfg, tmp_path, max_epochs=2, segments=segments)
    assert spy.seeds == [0, 1]
    del spy.seeds[:]
    h = _run(loop_cdr, cfg, tmp_path, resume=True, overwrite=False,
             segments=segments)
    assert len(h["train_loss"]) == 1
    assert spy.seeds == [SEED * 10007 + s for s in resumed_seeds]


def _jax_parity(tree, tmp, dataset, jax_loop, port_loop, port_cls, **kw):
    """JAX's loop by segments (the tree in its device cache) and the
    port's, from JAX's init (the CDR head scaled by HEAD_SCALE), as
    tests/test_torch_loops.py _parity_runs runs them per batch."""
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
        ref = jax_loop.run(jcfg, overwrite=True, seed=SEED,
                           weights_root=str(tmp / "jax"), **kw)
        mp.setattr(port_loop, "_init_model", port_model)
        got = port_loop.run(config_from_dict(d), overwrite=True, seed=SEED,
                            weights_root=str(tmp / "port"), device="cpu",
                            **kw)
    return ref, got


@pytest.mark.slow
def test_cdr_loop_segments_match_jax(tree, tmp_path):
    """loop_cdr.run by segments (checkpoint_every 2: segments of 2 and a
    padded 1 over 3 epochs, WARMUP 1) against JAX's loop by segments:
    tests/test_torch_loops.py's bounds (its module docstring)."""
    ref, got = _jax_parity(tree, tmp_path, "MADS_3d", jax_loop_cdr,
                           loop_cdr, CDRNet, checkpoint_every=2)
    assert all(len(v) == 3 for v in got.values())
    for key in ("train_loss", "val_loss"):
        _close(got[key][0], ref[key][0], TOL_2D, key)
        _close(got[key][1:], ref[key][1:], TOL_3D, key)
    _close(got["grad_norm"][0], ref["grad_norm"][0], GRAD_TOL, "grad_norm")
    _close(got["grad_norm"][1:], ref["grad_norm"][1:], GRAD_3D_TOL,
           "grad_norm")
    _close(got["val_mpjpe_2d"], ref["val_mpjpe_2d"], TOL_2D, "val_mpjpe_2d")
    _close(got["val_mpjpe_3d"], ref["val_mpjpe_3d"], TOL_3D, "val_mpjpe_3d")


def test_2d_loop_segments_match_jax(tree, tmp_path):
    """loop2d.run by segments (checkpoint_every 2 over 3 epochs) against
    JAX's loop by segments: losses within TOL_2D, PCK exactly
    (tests/test_torch_loops.py)."""
    ref, got = _jax_parity(tree, tmp_path, "MADS_2d", jax_loop2d, loop2d,
                           PoseResNet, checkpoint_every=2)
    assert got.keys() == ref.keys()
    for key in ("train_loss", "val_loss"):
        _close(got[key], ref[key], TOL_2D, key)
    for key in ("train_acc", "val_acc"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
