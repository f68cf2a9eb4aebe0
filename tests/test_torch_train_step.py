"""The PyTorch port's training path (fast3dhpe_tpu_torch: masked train-mode
BN, optimizer, schedule and clip, the CDR train and eval steps) against the
JAX package on the CPU, on the same weights and batches (numpy, from a
seed). JAX variables and gradients cross over through
fast3dhpe_tpu_torch/convert.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu.models import make_loss as jax_make_loss
from fast3dhpe_tpu.geometry.triangulation import dlt_triangulate as jax_dlt
from fast3dhpe_tpu.models.layers import bn_row_mask as jax_bn_row_mask
from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
from fast3dhpe_tpu.train.state import clip_grads_by_norm as jax_clip
from fast3dhpe_tpu.train.state import multistep_lr as jax_multistep_lr
from fast3dhpe_tpu.train.steps import make_eval_step_cdr as jax_eval_step
from fast3dhpe_tpu.train.steps import make_train_step_cdr as jax_train_step
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.layers import BatchNorm2d, bn_row_mask
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                soft_argmax_fused)
from fast3dhpe_tpu_torch.train.state import (TrainState, clip_grads_by_norm,
                                             multistep_lr)
from fast3dhpe_tpu_torch.train.steps import (make_eval_step_cdr,
                                             make_train_step_cdr)

torch.set_num_threads(2)

B, IMG, J = 3, 64, 19
ROW_VALID = np.array([1, 1, 0], np.float32)
CFG = {"MODEL": {"NUM_LAYERS": 18, "IMAGE_SIZE": [IMG, IMG]},
       "TRAIN": {"LR": 1e-3, "LR_STEP": [1], "LR_FACTOR": 0.1},
       "LOSS": {"TYPE": "JointsMSESmooth", "USE_TARGET_WEIGHT": True}}


# ------------------------------------------------------ masked train BN

def _flax_bn(x_nhwc, scale, bias, mask):
    """flax's BatchNorm as the JAX package builds it (layers.batch_norm),
    train mode, with the (B, 1, 1, 1) mask of bn_row_mask."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    C = x_nhwc.shape[-1]
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": jnp.zeros(C),
                                 "var": jnp.ones(C)}}

    def f(x, params):
        return bn.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        x, mask=mask, mutable=["batch_stats"])

    return f, variables["params"]


@pytest.mark.parametrize("row_valid", [None, [1, 1, 0, 1], [0, 0, 0, 0]],
                         ids=["no_mask", "masked", "all_invalid"])
def test_masked_batch_norm_matches_flax(row_valid):
    """Output, running mean/var, and the gradients of x, scale and bias,
    against flax's BatchNorm with the same mask (an all-invalid mask falls
    back to the whole batch). fp32 sums in another order: 1e-5."""
    r = np.random.RandomState(1)
    x = (r.randn(4, 6, 5, 7) * 2 + 0.5).astype(np.float32)     # NCHW
    scale = r.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = r.randn(6).astype(np.float32)
    cot = r.randn(*x.shape).astype(np.float32)
    jmask = jax_bn_row_mask(None if row_valid is None
                            else jnp.asarray(row_valid, jnp.float32))
    f, params = _flax_bn(jnp.asarray(x.transpose(0, 2, 3, 1)),
                         jnp.asarray(scale), jnp.asarray(bias), jmask)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    y_ref, stats = f(x_nhwc, params)

    def obj(xx, pp):
        return jnp.sum(f(xx, pp)[0] * jnp.asarray(cot.transpose(0, 2, 3, 1)))

    gx_ref, gp_ref = jax.grad(obj, argnums=(0, 1))(x_nhwc, params)

    bn = BatchNorm2d(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    mask = bn_row_mask(None if row_valid is None
                       else torch.tensor(row_valid, dtype=torch.float32))
    y = bn(xt, mask)
    (y * torch.from_numpy(cot)).sum().backward()

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    close(y.detach().numpy(), np.asarray(y_ref).transpose(0, 3, 1, 2))
    close(bn.running_mean.numpy(), np.asarray(stats["batch_stats"]["mean"]))
    close(bn.running_var.numpy(), np.asarray(stats["batch_stats"]["var"]))
    close(xt.grad.numpy(), np.asarray(gx_ref).transpose(0, 3, 1, 2))
    close(bn.weight.grad.numpy(), np.asarray(gp_ref["scale"]))
    close(bn.bias.grad.numpy(), np.asarray(gp_ref["bias"]))


def test_train_bn_takes_the_biased_variance_and_rejects_bf16():
    """The running variance takes the biased batch variance. bf16 input,
    refused until bf16 training was ported, now trains: fp32 statistics
    of the bf16 values, the output in bf16 (tests/test_torch_bf16_train.py
    holds it against flax)."""
    x = torch.randn(2, 3, 4, 4)
    bn = BatchNorm2d(3).train()
    bn(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased)
    xb = x.bfloat16()
    before = bn.running_var.clone()
    y = bn(xb)
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    torch.testing.assert_close(
        bn.running_var,
        0.9 * before + 0.1 * xb.float().var(dim=(0, 2, 3), unbiased=False))
    bn.eval()
    assert bn(x.bfloat16()).dtype == torch.bfloat16     # eval stays bf16


# ------------------------------------------- optimizer, schedule, clip

@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_optimizer_schedule_clip_match_optax(clip):
    """Adam + MultiStepLR + the global-norm clip on an identical gradient
    sequence, across an LR boundary (update 3, steps_per_epoch 3): the
    parameters agree with optax to 1e-6 after every update."""
    r = np.random.RandomState(2)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    p0 = [r.randn(*s).astype(np.float32) for s in shapes]
    sched = jax_multistep_lr(1e-2, [1, 2], 0.5, 3)
    tx = optax.adam(sched)
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    ours = multistep_lr(1e-2, [1, 2], 0.5, 3)
    opt = torch.optim.Adam(tp, lr=ours(0), betas=(0.9, 0.999), eps=1e-8)
    state = TrainState(torch.nn.ParameterList(tp), opt, ours)
    for k in range(8):
        assert ours(k) == pytest.approx(float(sched(k)), rel=1e-6)
        # norms from ~1 to ~30: the clip at 10 binds on some updates
        gs = [(r.randn(*s) * (0.3 + 4 * (k % 3))).astype(np.float32)
              for s in shapes]
        jg, jnorm = jax_clip([jnp.asarray(g) for g in gs], 10.0, clip)
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        norm = clip_grads_by_norm(state.grads(), 10.0, clip)
        state.apply_gradients()
        assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
    assert state.step == 8


# ------------------------------------------------------ CDR train step

def _rig(batch, img):
    """Two cameras 3 m from the origin at x = -+400 mm, each turned toward
    the origin, with bench.py's intrinsics scaled to img pixels. (The bench
    rig's parallel cameras share no view at 3 m; these rays cross at the
    origin, so a prediction near the image centre triangulates near it.)"""
    f, c = 1100.0 * img / 256, img / 2
    K = np.array([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]])
    Ps = []
    for cx in (-400.0, 400.0):
        centre = np.array([cx, 0.0, -3000.0])
        z = -centre / np.linalg.norm(centre)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Ps.append(K @ np.hstack([R, -R @ centre[:, None]]))
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


def _batch(seed):
    """Poses within +-300 mm of the origin, their exact projections as
    target_2d, weights 1, and a padded last row."""
    r = np.random.RandomState(seed)
    proj = _rig(B, IMG)
    p3 = r.uniform(-300, 300, (B, J, 3)).astype(np.float32)
    hom = np.concatenate([p3, np.ones((B, J, 1), np.float32)], -1)
    uvw = np.einsum("bvij,bkj->bvki", proj, hom)
    t2d = (uvw[..., :2] / uvw[..., 2:]).astype(np.float32)
    return {"image": r.randn(B, 2, IMG, IMG, 3).astype(np.float32),
            "proj": proj, "target_3d": p3, "target_2d": t2d,
            "target_weight": np.ones((B, J), np.float32),
            "row_valid": ROW_VALID}


def test_dlt_gradient_matches_jax():
    """The gradient through the Jacobi-SVD DLT (autograd in both
    frameworks, the same unrolled rotations) at keypoints near the exact
    projections of poses within +-300 mm: 1e-4 of its norm."""
    r = np.random.RandomState(4)
    t2d = _batch(1)["target_2d"]                       # (B, V, J, 2)
    pts = (t2d + r.randn(*t2d.shape) * 2.0).astype(np.float32)
    pts = np.swapaxes(pts, 1, 2)                       # (B, J, V, 2)
    proj = np.broadcast_to(_rig(B, IMG)[:, None],
                           (B, J, 2, 3, 4)).astype(np.float32)
    cot = r.randn(B, J, 3).astype(np.float32)
    ref = np.asarray(jax.grad(lambda p: jnp.sum(
        jax_dlt(jnp.asarray(proj), p) * cot))(jnp.asarray(pts)))
    pt = torch.from_numpy(pts).requires_grad_(True)
    (dlt_triangulate(torch.from_numpy(proj), pt)
     * torch.from_numpy(cot)).sum().backward()
    assert (np.linalg.norm(pt.grad.numpy() - ref)
            <= 1e-4 * np.linalg.norm(ref))


def _recording(inner):
    """`inner`, with the gradient it was handed kept in its state: the
    JAX step's clipped gradient, read without a second compile."""
    def init(params):
        return (jax.tree_util.tree_map(jnp.zeros_like, params),
                inner.init(params))

    def update(grads, state, params=None):
        upd, inner_state = inner.update(grads, state[1], params)
        return upd, (grads, inner_state)

    return optax.GradientTransformation(init, update)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX train step at depth 18, 64 px, 3 pairs with the last padded:
    warmup, then use_3d, at the initial parameters (the optimizer is
    sgd(lr=0), recording the clipped gradient), then one eval step. Then
    two Adam updates with the config's schedule, the second from the
    gradient at the first's result. One compile of each step."""
    cfg = config_from_dict(CFG)
    batch = _batch(0)
    model = JaxCDRNet(num_layers=18)
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"]),
        jnp.asarray(batch["proj"]), train=False)
    v = _np(v)
    # the N(0, 0.001) head decodes every view to the centre: scale it so
    # the logits spread (unit std) and the views decode apart
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    head["bias"] = head["bias"] + np.random.RandomState(3).randn(J).astype(
        np.float32)
    loss_fn = jax_make_loss("JointsMSESmooth", True)
    step = jax_train_step(model, loss_fn)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    state = JaxTrainState.create(v, _recording(optax.sgd(0.0)))
    steps = []
    for use_3d in (False, True):
        state, m = step(state, jb, use_3d)
        steps.append({"metrics": {k: float(x) for k, x in m.items()},
                      "grads": _np(state.opt_state[0]),
                      "variables": _np(state.variables)})
    ev = jax_eval_step(model, loss_fn)(state, jb, True)

    tx = optax.adam(jax_multistep_lr(cfg.TRAIN.LR, cfg.TRAIN.LR_STEP,
                                     cfg.TRAIN.LR_FACTOR, 1))
    params = v["params"]
    adam_state = tx.init(params)
    at = JaxTrainState.create(v, _recording(optax.sgd(0.0)))
    for use_3d in (False, True):
        at, _ = step(at.replace(params=params), jb, use_3d)
        upd, adam_state = tx.update(at.opt_state[0], adam_state, params)
        params = optax.apply_updates(params, upd)
    return {"init": v, "batch": batch, "steps": steps,
            "eval": {k: float(x) for k, x in ev.items()},
            "adam": _np({"params": params})}


def _port_model(jax_run):
    model = CDRNet(num_layers=18)
    model.load_state_dict(jax_variables_to_state_dict(jax_run["init"]),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The same steps through the port, on the CPU: two steps with SGD at
    lr 0, the eval step, and two steps with the config's Adam."""
    cfg = config_from_dict(CFG)
    loss_fn = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    step = make_train_step_cdr(loss_fn)
    model = _port_model(jax_run)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    k1, k2 = soft_argmax_fused.launches, soft_argmax_bwd_fused.launches
    steps = []
    for use_3d in (False, True):
        m = step(state, jax_run["batch"], use_3d)
        steps.append({
            "metrics": {k: float(x) for k, x in m.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: t.clone() for k, t in model.state_dict().items()}})
    launches = (soft_argmax_fused.launches - k1,
                soft_argmax_bwd_fused.launches - k2)
    ev = make_eval_step_cdr(loss_fn)(state, jax_run["batch"], True)
    adam = TrainState.create(_port_model(jax_run), cfg, steps_per_epoch=1)
    for use_3d in (False, True):
        step(adam, jax_run["batch"], use_3d)
    return {"steps": steps, "adam": adam, "launches": launches,
            "eval": {k: float(x) for k, x in ev.items()}}


def _global_rel(got, ref):
    num = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref)
    den = sum(float((ref[n] ** 2).sum()) for n in ref)
    return (num / den) ** 0.5


@pytest.mark.parametrize("k", [0, 1], ids=["warmup", "use_3d"])
def test_cdr_train_step_matches_jax(jax_run, port_run, k):
    """Losses within 1e-4 relative, the new BN statistics within 1e-4 of
    each buffer's range.

    Gradients: the two frameworks round the forward differently, and every
    ReLU unit within that rounding of zero can switch, which moves a
    gradient by about the square root of the share switched. The port
    against itself, with the images scaled by 1 +- 1e-7, moves grad_norm by
    up to 0.3%, the whole gradient by up to 0.5% and a leaf by up to 0.6% of
    its norm at this size. So grad_norm is held to 1e-2, the whole gradient
    to 2e-2 of its norm, and each leaf to 5e-2 of the larger of its norm and
    1e-6 of the global norm (the conv biases in front of a BN have a zero
    gradient in exact arithmetic: theirs is rounding noise). A fault of the
    path (a tiled view mask, a wrong BN backward) moves them by O(1).
    """
    ref, got = jax_run["steps"][k], port_run["steps"][k]
    rm, gm = ref["metrics"], got["metrics"]
    for key in ("loss", "loss_2d", "loss_3d"):
        assert gm[key] == pytest.approx(rm[key], rel=1e-4), key
    assert gm["grad_norm"] == pytest.approx(rm["grad_norm"], rel=1e-2)
    if k == 0:
        assert gm["loss"] == gm["loss_2d"]
    else:
        assert gm["loss"] == pytest.approx(gm["loss_2d"] + 4 * gm["loss_3d"],
                                           rel=1e-6)
    ref_g = jax_variables_to_state_dict({"params": ref["grads"]})
    assert set(ref_g) == set(got["grads"])
    assert _global_rel(got["grads"], ref_g) <= 2e-2
    floor = 1e-6 * rm["grad_norm"]
    for name, g in got["grads"].items():
        r = ref_g[name]
        scale = max(float(r.norm()), floor)
        assert float((g - r).norm()) <= 5e-2 * scale, name
    ref_sd = jax_variables_to_state_dict(ref["variables"])
    for name, t in got["state"].items():
        if "running" in name:
            r = ref_sd[name]
            assert float((t - r).abs().max()) <= 1e-4 * float(
                r.abs().max()), name


def test_adam_steps_match_jax(jax_run, port_run):
    """After the config's Adam takes two updates (the second at the decayed
    LR), the parameters agree to 2.5 lr: Adam's first update is
    lr * sign(g), and a gradient element near 0 may take the other sign in
    the other framework."""
    lr = CFG["TRAIN"]["LR"]
    ref = jax_variables_to_state_dict(jax_run["adam"])
    state = port_run["adam"]
    assert state.step == 2
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(lr * 0.1)
    init = jax_variables_to_state_dict(jax_run["init"])
    for name, p in state.model.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= 2.5 * lr, name
        assert not torch.equal(p.detach(), init[name]), name


def test_one_k1_and_one_k2_per_step_none_on_cpu(port_run):
    """Each train step runs the soft-argmax forward and backward once; on
    the CPU both take their plain versions, so no kernel launches."""
    assert port_run["launches"] == (0, 0)


def test_cdr_eval_step_matches_jax(jax_run, port_run):
    """Masked sums of the eval step (eval-mode BN, absolute coordinates),
    1e-4 relative; n counts the valid rows."""
    ref, got = jax_run["eval"], port_run["eval"]
    assert got["n"] == ref["n"] == 2.0
    for key in ("loss", "mpjpe_2d", "mpjpe_3d", "loss_sum", "e2_sum",
                "e3_sum"):
        assert got[key] == pytest.approx(ref[key], rel=1e-4), key
