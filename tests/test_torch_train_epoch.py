"""The PyTorch port's epoch functions (fast3dhpe_tpu_torch/train/steps.py
make_{train,eval}_epoch_{cdr,2d}: cached batches preprocessed on the
device, then stepped) against the JAX package's lax.scan epochs, and
CDRNetInferencer.predict_batch(trans=...) against the JAX inferencer's
raw-frame path; depth 18 at 64 px, on the CPU, on the same weights,
frames and stacked metadata (numpy, from a seed)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fast3dhpe_tpu.apps.inference import CDRNetInferencer as JaxInferencer
from fast3dhpe_tpu.config import config_from_dict as jax_config_from_dict
from fast3dhpe_tpu.data.device_cache import DeviceFrameCache as JaxCache
from fast3dhpe_tpu.geometry.triangulation import dlt_triangulate as jax_dlt
from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
from fast3dhpe_tpu.models import make_loss as jax_make_loss
from fast3dhpe_tpu.train import steps as jsteps
from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
from fast3dhpe_tpu.train.state import multistep_lr as jax_multistep_lr
from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.data.device_cache import DeviceFrameCache
from fast3dhpe_tpu_torch.geometry.affine import get_affine_transform
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                soft_argmax_fused)
from fast3dhpe_tpu_torch.train import steps
from fast3dhpe_tpu_torch.train.state import TrainState

from test_torch_device_pipeline import _decoder, _rig
from test_torch_pipeline_ops import _smooth_frames

torch.set_num_threads(2)

S, B, J, IMG, H0, W0 = 2, 3, 19, 64, 60, 80
# Adam's first update moves every weight by lr in its gradient's sign, and
# elements whose gradient is rounding noise take the other sign in the other
# framework. The second step's batch statistics are taken at those weights:
# at lr 0 the BN running statistics after two steps agree within 1.9e-5 of
# each buffer's range, at lr 1e-6 within 1.1e-4 (CDRNet; the decoder's
# near-zero means) and 4.6e-4 (PoseResNet), growing with lr. So lr 1e-6,
# and BN statistics within 1e-3 of their range; a wrong mask or batch
# order moves them by 1e-2 or more.
LR, BN_TOL = 1e-6, 1e-3
CFG = {"MODEL": {"NAME": "tiny_cdr", "NUM_LAYERS": 18,
                 "IMAGE_SIZE": [IMG, IMG],
                 "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}},
       "TRAIN": {"LR": LR, "LR_STEP": [1], "LR_FACTOR": 0.1},
       "LOSS": {"TYPE": "JointsMSESmooth", "USE_TARGET_WEIGHT": True}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(n):
    return [f"f{i:02d}" for i in range(n)]


@pytest.fixture(scope="module")
def frames():
    """12 smooth 60x80 frames (6 stereo pairs), in both packages' caches."""
    fr = dict(zip(_paths(12), _smooth_frames(30, 12, H0, W0)))
    return (fr, DeviceFrameCache.build(list(fr), _decoder(fr), 1 << 30,
                                       device="cpu"),
            JaxCache.build(list(fr), _decoder(fr), 1 << 30))


def _trans(r, n):
    return np.stack([get_affine_transform(
        (W0 / 2, H0 / 2), np.clip(r.randn() * 0.25 + 1, 0.75, 1.25),
        r.uniform(-30, 30), min(H0, W0), (IMG, IMG)) for _ in range(n)])


def _stereo_xs(seed):
    """S stacked batches of B pairs, as Stereo3DLoader.stacked_epoch stacks
    them; the last row of the last batch is padded."""
    r = np.random.RandomState(seed)
    order = r.permutation(6)[:S * B].reshape(S, B)
    P_l, P_r = _rig(S * B, H0, W0)
    rv = np.ones((S, B), np.float32)
    rv[-1, -1] = 0.0
    return {"idx_l": (2 * order).astype(np.int32),
            "idx_r": (2 * order + 1).astype(np.int32),
            "trans": _trans(r, S * B).reshape(S, B, 2, 3).astype(np.float32),
            "P_l": P_l.reshape(S, B, 4, 4), "P_r": P_r.reshape(S, B, 4, 4),
            "pose_3d": r.uniform(-250, 250, (S, B, J, 3)).astype(np.float32),
            "joints_vis": np.ones((S, B, J), np.float32), "row_valid": rv}


# ------------------------------------------------------------------ CDR

@pytest.fixture(scope="module")
def cdr_runs(frames):
    """One warmup train epoch (occlusion off; the config's Adam, its LR
    decayed after the first update, as in tests/test_torch_train_step.py)
    and one eval epoch at the initial weights, through JAX's scan epochs
    and the port's, from the same weights, frames and metadata."""
    _, cache, jcache = frames
    xs = _stereo_xs(31)
    model = JaxCDRNet(num_layers=18)
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, IMG, IMG, 3)),
        jnp.asarray(xs["P_l"][0, :1, None, :3].repeat(2, 1)), train=False)
    v = _np(v)
    # the N(0, 0.001) head decodes every view to the centre: scale it so
    # that the views decode apart (tests/test_torch_train_step.py)
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    head["bias"] = head["bias"] + np.random.RandomState(3).randn(J).astype(
        np.float32)
    jloss = jax_make_loss("JointsMSESmooth", True)
    tx = optax.adam(jax_multistep_lr(LR, [1], 0.1, 1))
    jxs = {k: jnp.asarray(a) for k, a in xs.items()}
    ev = jsteps.make_eval_epoch_cdr(model, jloss, (IMG, IMG))(
        JaxTrainState.create(v, tx), jcache.frames, jxs, True)
    state, tm = jsteps.make_train_epoch_cdr(model, jloss, (IMG, IMG))(
        JaxTrainState.create(v, tx), jcache.frames, jxs,
        jax.random.PRNGKey(0), False)
    jax_out = {"train": _np(tm), "eval": _np(ev),
               "state": jax_variables_to_state_dict(_np(state.variables))}

    cfg = config_from_dict(CFG)
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    port = CDRNet(num_layers=18)
    port.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    pstate = TrainState.create(port, cfg, steps_per_epoch=1)
    pev = steps.make_eval_epoch_cdr(loss, (IMG, IMG))(pstate, cache.frames,
                                                      xs, True)
    k1, k2 = soft_argmax_fused.launches, soft_argmax_bwd_fused.launches
    ptm = steps.make_train_epoch_cdr(loss, (IMG, IMG))(
        pstate, cache.frames, xs, 0, False)
    return {"jax": jax_out, "port": {
        "train": {k: float(t) for k, t in ptm.items()},
        "eval": {k: float(t) for k, t in pev.items()}, "state": pstate,
        "launches": (soft_argmax_fused.launches - k1,
                     soft_argmax_bwd_fused.launches - k2)},
        "init": jax_variables_to_state_dict(v)}


def test_cdr_train_epoch_matches_jax(cdr_runs):
    """Summed losses within 1e-4 relative and grad_norm within 1e-2 (the
    bounds of one step, tests/test_torch_train_step.py); after the
    epoch's two Adam updates (the second at 0.1 lr) the parameters within
    2.5 lr, as test_adam_steps_match_jax holds them (Adam's first update is
    lr * sign(g), and an element near 0 may take the other sign), and the
    BN running statistics within BN_TOL of each buffer's range."""
    ref, got = cdr_runs["jax"], cdr_runs["port"]
    for key in ("loss", "loss_2d", "loss_3d"):
        assert got["train"][key] == pytest.approx(float(ref["train"][key]),
                                                  rel=1e-4), key
    assert got["train"]["loss"] == got["train"]["loss_2d"]    # warmup
    assert got["train"]["grad_norm"] == pytest.approx(
        float(ref["train"]["grad_norm"]), rel=1e-2)
    state = got["state"]
    assert state.step == S
    for name, t in state.model.state_dict().items():
        r = ref["state"][name]
        if "running" in name:
            assert float((t - r).abs().max()) <= BN_TOL * float(
                r.abs().max()), name
        elif "num_batches" not in name:
            assert float((t - r).abs().max()) <= 2.5 * LR, name
            assert not torch.equal(t, cdr_runs["init"][name]), name


def test_cdr_train_epoch_launches_k1_k2_once_a_step_none_on_cpu(cdr_runs):
    """On the CPU the soft-argmax wrappers take their plain versions: the
    epoch launched no kernel."""
    assert cdr_runs["port"]["launches"] == (0, 0)


def test_cdr_eval_epoch_matches_jax(cdr_runs):
    """Summed eval statistics (padding excluded): 1e-4 relative, n exact."""
    ref, got = cdr_runs["jax"]["eval"], cdr_runs["port"]["eval"]
    assert set(got) == set(ref) == {"loss_sum", "e2_sum", "e3_sum", "n"}
    assert got["n"] == float(ref["n"]) == S * B - 1
    for key in ("loss_sum", "e2_sum", "e3_sum"):
        assert got[key] == pytest.approx(float(ref[key]), rel=1e-4), key


def test_train_epoch_is_reproducible_from_its_seed(frames):
    """With CUTOUT, the same epoch seed gives the same losses and weights;
    another seed other occlusion draws."""
    _, cache, _ = frames
    xs = _stereo_xs(32)
    cfg = config_from_dict(CFG)
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    torch.manual_seed(0)
    init = CDRNet(num_layers=18).state_dict()
    epoch = steps.make_train_epoch_cdr(loss, (IMG, IMG), occlusion="CUTOUT")
    outs = []
    for seed in (7, 7):
        model = CDRNet(num_layers=18)
        model.load_state_dict(init)
        st = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
        outs.append({k: float(v) for k, v in
                     epoch(st, cache.frames, xs, seed, False).items()})
    assert outs[0] == outs[1]
    g = [steps.step_generator("cpu", s, 1) for s in (7, 8)]
    assert not torch.equal(torch.rand(8, generator=g[0]),
                           torch.rand(8, generator=g[1]))


# ------------------------------------------------------------------- 2D

HM, J2 = 16, 4


def _mono_xs(seed):
    r = np.random.RandomState(seed)
    rv = np.ones((S, B), np.float32)
    rv[-1, -1] = 0.0
    return {"idx": r.permutation(12)[:S * B].reshape(S, B).astype(np.int32),
            "flip": (r.rand(S, B) > 0.5),
            "trans": _trans(r, S * B).reshape(S, B, 2, 3).astype(np.float32),
            "joints": r.uniform(4, IMG - 4, (S, B, J2, 2)).astype(np.float32),
            "vis": (r.rand(S, B, J2) > 0.2).astype(np.float32),
            "row_valid": rv}


@pytest.fixture(scope="module")
def runs_2d(frames):
    _, cache, jcache = frames
    xs = _mono_xs(33)
    model = JaxPoseResNet(num_joints=J2, num_layers=18)
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    jloss = jax_make_loss("JointsMSE", True, layout="NHWC")
    tx = optax.adam(jax_multistep_lr(LR, [1], 0.1, 1))
    jxs = {k: jnp.asarray(a) for k, a in xs.items()}
    args = (model, jloss, (IMG, IMG), (HM, HM), 2)
    ev = jsteps.make_eval_epoch_2d(*args)(JaxTrainState.create(v, tx),
                                          jcache.frames, jxs)
    state, tm = jsteps.make_train_epoch_2d(*args)(
        JaxTrainState.create(v, tx), jcache.frames, jxs)

    port = PoseResNet(num_joints=J2, num_layers=18)
    port.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    pstate = TrainState.create(port, config_from_dict(CFG),
                               steps_per_epoch=1)
    loss = make_loss("JointsMSE", True, layout="NHWC")
    pargs = (loss, (IMG, IMG), (HM, HM), 2)
    pev = steps.make_eval_epoch_2d(*pargs)(pstate, cache.frames, xs)
    ptm = steps.make_train_epoch_2d(*pargs)(pstate, cache.frames, xs)
    return {"jax": {"train": _np(tm), "eval": _np(ev),
                    "state": jax_variables_to_state_dict(
                        _np(state.variables))},
            "port": {"train": ptm, "eval": pev, "state": pstate}}


def test_train_epoch_2d_matches_jax(runs_2d):
    """Summed loss within 1e-4 relative, acc exactly, grad_norm within
    1e-2; parameters within 2.5 lr, BN statistics within BN_TOL of range."""
    ref, got = runs_2d["jax"], runs_2d["port"]
    assert float(got["train"]["loss"]) == pytest.approx(
        float(ref["train"]["loss"]), rel=1e-4)
    assert float(got["train"]["acc"]) == float(ref["train"]["acc"])
    assert float(got["train"]["grad_norm"]) == pytest.approx(
        float(ref["train"]["grad_norm"]), rel=1e-2)
    for name, t in got["state"].model.state_dict().items():
        r = ref["state"][name]
        if "running" in name:
            assert float((t - r).abs().max()) <= BN_TOL * float(
                r.abs().max()), name
        elif "num_batches" not in name:
            assert float((t - r).abs().max()) <= 2.5 * LR, name


def test_eval_epoch_2d_matches_jax(runs_2d):
    ref, got = runs_2d["jax"]["eval"], runs_2d["port"]["eval"]
    assert set(got) == set(ref) == {"loss_sum", "hits", "cnt", "n"}
    assert float(got["n"]) == float(ref["n"]) == S * B - 1
    assert float(got["loss_sum"]) == pytest.approx(float(ref["loss_sum"]),
                                                   rel=1e-4)
    for key in ("hits", "cnt"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key])


# ---------------------------------------------------------- raw serving

def test_predict_batch_raw_frames_matches_jax(frames):
    """Raw 60x80 uint8 frames and per-sample affines: the port warps on the
    device to MODEL.IMAGE_SIZE, as the JAX inferencer's raw path does.
    pred_2d within 1e-3 px and pred_3d within 1e-4 of the JAX DLT of the
    port's own pred_2d (test_torch_model.py's bounds: the DLT amplifies a
    1e-3 px difference)."""
    fr, _, _ = frames
    cfg = dict(CFG, MODEL=dict(CFG["MODEL"], NUM_JOINTS=J))
    model = JaxCDRNet(num_layers=18)
    xs = _stereo_xs(34)
    proj = np.stack([xs["P_l"][0, :, :3], xs["P_r"][0, :, :3]], 1)
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, IMG, IMG, 3)),
        jnp.asarray(proj[:1]), train=False))
    # smooth frames give features of small spread: a larger head scale
    # than the other tests' so that the views decode apart
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 500.0
    img_l = np.stack([fr[p] for p in _paths(12)[0:6:2]])
    img_r = np.stack([fr[p] for p in _paths(12)[1:6:2]])
    trans = xs["trans"][0]
    # the cropped view's projection, as the loaders compose it
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :2, :3] = trans
    cproj = np.stack([(T @ xs["P_l"][0])[:, :3], (T @ xs["P_r"][0])[:, :3]],
                     1).astype(np.float32)
    jinf = JaxInferencer(jax_config_from_dict(cfg), variables=v)
    jkp, jp3 = (np.asarray(a) for a in jinf.predict_batch(
        img_l, img_r, cproj, trans=trans))
    inf = CDRNetInferencer(config_from_dict(cfg), device="cpu",
                           state_dict=jax_variables_to_state_dict(v))
    kp, p3 = inf.predict_batch(img_l, img_r, cproj, trans=trans)
    assert kp.shape == (B, 2, J, 2) and p3.shape == (B, J, 3)
    np.testing.assert_allclose(kp.numpy(), jkp, atol=1e-3)
    assert kp.numpy().std() > 1.0
    ref3 = np.asarray(jax_dlt(
        jnp.asarray(np.broadcast_to(cproj[:, None], (B, J, 2, 3, 4))),
        jnp.asarray(np.swapaxes(kp.numpy(), 1, 2))))
    assert np.abs(p3.numpy() - ref3).max() <= 1e-4 * np.abs(ref3).max()
    assert np.isfinite(jp3).all()


def test_epoch_refuses_frames_on_another_device(frames):
    """The pipeline runs where the frames lie: frames on another device
    than the model's are refused before anything runs."""
    _, cache, _ = frames
    cfg = config_from_dict(CFG)
    model = CDRNet(num_layers=18)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    elsewhere = torch.empty(cache.frames.shape, dtype=torch.uint8,
                            device="meta")
    with pytest.raises(ValueError, match="frame cache is on meta"):
        steps.make_train_epoch_cdr(loss, (IMG, IMG))(
            state, elsewhere, _stereo_xs(35), 0, False)
    with pytest.raises(ValueError, match="frame cache is on meta"):
        steps.make_eval_epoch_2d(loss, (IMG, IMG), (HM, HM))(
            state, elsewhere, _mono_xs(36))
