"""bf16 training in the port (train-mode BatchNorm2d on bf16, the CDR and
2D train steps, both loops' compute_dtype="bfloat16" and the CLIs'
--bf16) against the JAX package's bf16 training on the CPU: depth 18,
64 px, the same weights and batches (numpy, from a seed).

Tolerances:
- train-mode BN on bf16 against flax's BatchNorm(dtype=bf16): the fp32
  running statistics within 1e-5 (fp32 sums in another order); y and dx
  within one bf16 rounding of their largest value, 2^-7 (y rounds once
  from fp32 values that differ by ~1e-7; dx is the bf16 sum of two
  rounded parts, as JAX's gradient is); the parameters' fp32 gradients
  within 1e-4 of their largest value;
- the soft-argmax's bf16 gradient against jax.grad through JAX's
  h.astype(float32) decode: one bf16 rounding of the largest value;
- a bf16 CDR step (warmup) and a bf16 2D step against JAX's: the losses
  within 1e-2 relative (measured 1.5e-3 and 2.7e-4); the gradient and the
  new BN statistics, by their global relative difference, within
  BF16_NOISE_X = 2 times the difference between JAX's own bf16 and fp32
  steps, since bf16 rounding at untrained weights moves a whole step's
  gradient by 13-44% (JAX against itself) and oneDNN and XLA round bf16
  convolutions apart (measured 1.09-1.14 times for the gradients, 1.34
  for the statistics; the fp32 steps agree to 7e-3);
- one bf16 epoch of each loop and `train_cdr --bf16`: finite histories,
  fp32 checkpoints.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
from fast3dhpe_tpu.models import make_loss as jax_make_loss
from fast3dhpe_tpu.models.layers import bn_row_mask as jax_bn_row_mask
from fast3dhpe_tpu.ops.heatmap import soft_argmax as jax_soft_argmax
from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
from fast3dhpe_tpu.train.steps import make_train_step_2d as jax_step_2d
from fast3dhpe_tpu.train.steps import make_train_step_cdr as jax_step_cdr
from fast3dhpe_tpu_torch.apps import train_cdr
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.layers import BatchNorm2d, bn_row_mask
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused
from fast3dhpe_tpu_torch.train.state import TrainState
from fast3dhpe_tpu_torch.train.steps import (make_train_step_2d,
                                             make_train_step_cdr)
from test_torch_train_2d import _batch as _batch_2d
from test_torch_train_step import _batch as _batch_cdr

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7          # one bf16 rounding, relative
BF16_NOISE_X = 2.0            # x JAX's own bf16-vs-fp32 step difference


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("row_valid", [None, [1, 1, 0, 1]],
                         ids=["no_mask", "masked"])
def test_bf16_train_bn_matches_flax(row_valid):
    r = np.random.RandomState(1)
    x = (r.randn(4, 6, 5, 7) * 2 + 0.5).astype(np.float32)     # NCHW
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    scale = r.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = r.randn(6).astype(np.float32)
    cot = np.asarray(jnp.asarray(r.randn(*x.shape), jnp.bfloat16)
                     .astype(jnp.float32))
    jmask = jax_bn_row_mask(None if row_valid is None
                            else jnp.asarray(row_valid, jnp.float32))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.bfloat16,
                       param_dtype=jnp.float32)
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    xj = jnp.asarray(xb.transpose(0, 2, 3, 1), jnp.bfloat16)
    cj = jnp.asarray(cot.transpose(0, 2, 3, 1), jnp.bfloat16)

    def f(xx, pp):
        y, upd = bn.apply({"params": pp, "batch_stats": stats}, xx,
                          mask=jmask, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y_ref, new = f(xj, params)
    assert y_ref.dtype == jnp.bfloat16
    gx_ref, gp_ref = jax.grad(
        lambda xx, pp: jnp.sum((f(xx, pp)[0] * cj).astype(jnp.float32)),
        argnums=(0, 1))(xj, params)

    mod = BatchNorm2d(6).train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(xb).bfloat16().contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    mask = bn_row_mask(None if row_valid is None
                       else torch.tensor(row_valid, dtype=torch.float32))
    y = mod(xt, mask)
    assert y.dtype == torch.bfloat16 and mod.running_mean.dtype == \
        torch.float32
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16

    def close(got, ref, rel):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max()

    close(y.detach().float().numpy(),
          np.asarray(y_ref, np.float32).transpose(0, 3, 1, 2), BF16_ULP)
    close(mod.running_mean.numpy(), new["mean"], 1e-5)
    close(mod.running_var.numpy(), new["var"], 1e-5)
    close(xt.grad.float().numpy(),
          np.asarray(gx_ref, np.float32).transpose(0, 3, 1, 2), BF16_ULP)
    close(mod.weight.grad.numpy(), gp_ref["scale"], 1e-4)
    close(mod.bias.grad.numpy(), gp_ref["bias"], 1e-4)


def test_bf16_softargmax_gradient_matches_jax_cast():
    """K1/K2 on bf16 logits (their plain versions here) against JAX's
    soft_argmax(h.astype(float32)) and its gradient."""
    r = np.random.RandomState(13)
    h = np.asarray(jnp.asarray(r.randn(2, 16, 16, 6) * 3, jnp.bfloat16)
                   .astype(jnp.float32))
    g = r.randn(2, 6, 2).astype(np.float32)
    hj = jnp.asarray(h, jnp.bfloat16)
    out_ref = jax_soft_argmax(hj.astype(jnp.float32))
    d_ref = jax.grad(lambda x: jnp.sum(
        jax_soft_argmax(x.astype(jnp.float32)) * g))(hj)
    assert d_ref.dtype == jnp.bfloat16
    ht = torch.from_numpy(h).bfloat16().requires_grad_(True)
    out = soft_argmax_fused(ht)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-5)
    d_ref = np.asarray(d_ref, np.float32)
    assert ht.grad.dtype == torch.bfloat16
    assert (np.abs(ht.grad.float().numpy() - d_ref).max()
            <= BF16_ULP * np.abs(d_ref).max())


def _recording_sgd0():
    """sgd(lr=0) that keeps the gradient it was handed in its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _global_rel(got, ref):
    num = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref)
    den = sum(float((ref[n] ** 2).sum()) for n in ref)
    return (num / den) ** 0.5


def _grads_and_stats(jstate):
    return (jax_variables_to_state_dict({"params": _np(jstate.opt_state)}),
            {k: v for k, v in jax_variables_to_state_dict(
                _np(jstate.variables)).items() if "running" in k})


def _compare_step(j16, j32, model, pm):
    """A port bf16 step against JAX's bf16 step (j16) with the recording
    optimizer: the losses, and the gradient and the new BN statistics
    against BF16_NOISE_X times how far JAX's own bf16 step is from its fp32
    step (j32)."""
    (s16, m16), (s32, _) = j16, j32
    for k in m16:
        if k.startswith("loss"):
            assert float(pm[k]) == pytest.approx(float(m16[k]), rel=1e-2), k
    g16, st16 = _grads_and_stats(s16)
    g32, st32 = _grads_and_stats(s32)
    got = {n: p.grad for n, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    assert _global_rel(got, g16) <= BF16_NOISE_X * _global_rel(g16, g32)
    assert _global_rel(stats, st16) <= BF16_NOISE_X * _global_rel(st16,
                                                                  st32)


def test_cdr_step_bf16_matches_jax():
    """The warmup step (2D loss through K1/K2 on bf16 heatmaps); with the
    3D loss the DLT at untrained weights amplifies every rounding a
    millionfold (grad_norm ~5e5), which leaves nothing to compare."""
    batch = _batch_cdr(0)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    v, runs = None, []
    for dt in (jnp.bfloat16, jnp.float32):
        jmodel = JaxCDRNet(num_layers=18, dtype=dt)
        if v is None:
            v = _np(jax.jit(jmodel.init, static_argnames=("train",))(
                jax.random.PRNGKey(0), jb["image"], jb["proj"], train=False))
            head = v["params"]["decoder"]["final_layer"]
            head["kernel"] = head["kernel"] * 50.0
        runs.append(jax_step_cdr(jmodel, jax_make_loss(
            "JointsMSESmooth", True))(
            JaxTrainState.create(v, _recording_sgd0()), jb, False))

    model = CDRNet(num_layers=18, dtype=torch.bfloat16)
    model.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    pm = make_train_step_cdr(make_loss("JointsMSESmooth", True))(
        state, batch, False)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _compare_step(*runs, model, pm)


def test_2d_step_bf16_matches_jax():
    batch = _batch_2d()
    J = batch["target"].shape[-1]
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    v, runs = None, []
    for dt in (jnp.bfloat16, jnp.float32):
        jmodel = JaxPoseResNet(num_joints=J, num_layers=18, dtype=dt)
        if v is None:
            v = _np(jax.jit(jmodel.init, static_argnames=("train",))(
                jax.random.PRNGKey(0), jb["image"], train=False))
        runs.append(jax_step_2d(jmodel, jax_make_loss(
            "JointsMSE", True, layout="NHWC"))(
            JaxTrainState.create(v, _recording_sgd0()), jb))

    model = PoseResNet(num_joints=J, num_layers=18, dtype=torch.bfloat16)
    model.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    pm = make_train_step_2d(make_loss("JointsMSE", True, layout="NHWC"))(
        state, batch)
    _compare_step(*runs, model, pm)


def _config(path, root, dataset, epochs):
    with open(path, "w") as f:
        yaml.safe_dump({
            "DATASET": {"TYPE": dataset, "ROOT": str(root),
                        "OCCLUSION": "None"},
            "MODEL": {"NAME": f"{dataset}_bf16", "NUM_LAYERS": 18,
                      "IMAGE_SIZE": [64, 64], "PRETRAINED": "",
                      "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}},
            "TRAIN": {"BATCH_SIZE": 4, "EPOCH": epochs, "WARMUP": 1,
                      "LR": 1e-3, "LR_STEP": [40]},
            "TEST": {"BATCH_SIZE": 4},
            "LOSS": {"TYPE": "JointsMSESmooth" if dataset == "MADS_3d"
                     else "JointsMSE", "USE_TARGET_WEIGHT": True}}, f)
    return str(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
    root = tmp_path_factory.mktemp("bf16")
    make_synthetic_mads(str(root / "data"), n_frames=4, img_w=128,
                        img_h=96, movements=("HipHop",))
    return root


@pytest.mark.parametrize("dataset", ["MADS_3d", "MADS_2d"])
def test_bf16_loop_epochs(tree, tmp_path, monkeypatch, dataset):
    """Two epochs of each loop in bf16 (the CDR loop's second with the 3D
    loss): finite history, fp32 weights in latest.pth; the same history,
    bit for bit, through a mesh of one rank."""
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.train import loop2d, loop_cdr
    cfg = load_config(_config(tmp_path / "c.yaml", tree / "data", dataset,
                              2))
    run = loop_cdr.run if dataset == "MADS_3d" else loop2d.run
    weights = str(tmp_path / "w")
    hist = run(cfg, overwrite=True, weights_root=weights,
               compute_dtype="bfloat16", device="cpu")
    assert all(np.isfinite(v).all() for v in hist.values())
    sd = torch.load(os.path.join(weights, cfg.MODEL.NAME, "latest.pth"),
                    weights_only=True)
    assert all(t.dtype in (torch.float32, torch.int64) for t in sd.values())
    with pytest.raises(ValueError, match="compute_dtype"):
        run(cfg, overwrite=True, weights_root=weights,
            compute_dtype="float16", device="cpu")
    # mesh= runs since slice 7 (tests/test_torch_distributed.py): through
    # a gloo group of one rank, whose mesh device (the CPU) takes the place
    # of the default `device`, the bf16 history is the one above bit for
    # bit but the throughput
    from fast3dhpe_tpu_torch.parallel import distributed, make_mesh
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert distributed.init_distributed(
            device="cpu", init_method="file://" + str(tmp_path / "store"))
        meshed = run(cfg, mesh=make_mesh(), overwrite=True,
                     weights_root=str(tmp_path / "w_mesh"),
                     compute_dtype="bfloat16")
    finally:
        distributed.destroy_distributed()
    for k in hist:
        if not k.endswith("_per_sec"):
            assert meshed[k] == hist[k], k


def test_train_cdr_cli_bf16(tree, tmp_path):
    cfg = _config(tmp_path / "c.yaml", tree / "data", "MADS_3d", 1)
    hist = train_cdr.main(["--config_path", cfg, "--overwrite", "--bf16",
                           "--device", "cpu", "--weights_root",
                           str(tmp_path / "w")])
    assert len(hist["train_loss"]) == 1
    assert all(np.isfinite(v).all() for v in hist.values())
