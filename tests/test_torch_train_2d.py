"""The PyTorch port's PoseResNet and 2D train/eval steps
(fast3dhpe_tpu_torch/models/poseresnet.py, train/steps.py) against the JAX
package at depth 18, 64 px, on the CPU, on the same weights and batch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
from fast3dhpe_tpu.models import make_loss as jax_make_loss
from fast3dhpe_tpu.ops import render_gaussian_heatmaps
from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
from fast3dhpe_tpu.train.steps import make_eval_step_2d as jax_eval_step
from fast3dhpe_tpu.train.steps import make_train_step_2d as jax_train_step
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.train.state import TrainState
from fast3dhpe_tpu_torch.train.steps import (make_eval_step_2d,
                                             make_train_step_2d)

torch.set_num_threads(2)

B, IMG, HM, J = 3, 64, 16, 4


def _batch():
    r = np.random.RandomState(0)
    joints = r.uniform(5, IMG - 5, size=(B, J, 2)).astype(np.float32)
    target, weight = render_gaussian_heatmaps(
        joints, np.ones((B, J), np.float32), (HM, HM), (IMG, IMG), sigma=1)
    return {"image": r.randn(B, IMG, IMG, 3).astype(np.float32),
            "target": np.array(target), "target_weight": np.array(weight),
            "row_valid": np.array([1, 1, 0], np.float32)}


def _recording_sgd0():
    """sgd(lr=0) that keeps the gradient it was handed in its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def runs():
    batch = _batch()
    model = JaxPoseResNet(num_joints=J, num_layers=18)
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    loss_fn = jax_make_loss("JointsMSE", True, layout="NHWC")
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    state = JaxTrainState.create(v, _recording_sgd0())
    state, jm = jax_train_step(model, loss_fn)(state, jb)
    jev = jax_eval_step(model, loss_fn)(state, jb)
    jout = model.apply(v, jb["image"], train=False)

    port = PoseResNet(num_joints=J, num_layers=18)
    port.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(batch["image"]))
    pstate = TrainState(port, torch.optim.SGD(port.parameters(), lr=0.0))
    tloss = make_loss("JointsMSE", True, layout="NHWC")
    pm = make_train_step_2d(tloss)(pstate, batch)
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    pev = make_eval_step_2d(tloss)(pstate, batch)
    return {"jax": {"out": np.asarray(jout), "metrics": jm, "eval": jev,
                    "grads": jax_variables_to_state_dict(
                        {"params": jax.tree_util.tree_map(
                            np.asarray, state.opt_state)}),
                    "stats": jax_variables_to_state_dict(
                        jax.tree_util.tree_map(np.asarray,
                                               state.variables))},
            "port": {"out": out.numpy(), "metrics": pm, "eval": pev,
                     "grads": grads, "state": port.state_dict()}}


def test_poseresnet_forward_matches_jax(runs):
    """Eval-mode NHWC heatmaps within 1e-4 of their range."""
    ref, got = runs["jax"]["out"], runs["port"]["out"]
    assert got.shape == ref.shape == (B, HM, HM, J)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_train_step_2d_matches_jax(runs):
    """loss within 1e-4 relative, acc exactly, grad_norm within 1e-2 and
    the gradient within 2e-2 of its norm (ReLU units within the two
    frameworks' rounding of zero switch; see
    tests/test_torch_train_step.py), masked BN statistics within 1e-4."""
    jm, pm = runs["jax"]["metrics"], runs["port"]["metrics"]
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(pm["acc"]) == float(jm["acc"])
    assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-2)
    ref, got = runs["jax"]["grads"], runs["port"]["grads"]
    num = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref)
    den = sum(float((ref[n] ** 2).sum()) for n in ref)
    assert (num / den) ** 0.5 <= 2e-2
    for name, t in runs["port"]["state"].items():
        if "running" in name:
            r = runs["jax"]["stats"][name]
            assert float((t - r).abs().max()) <= 1e-4 * float(
                r.abs().max()), name


def test_eval_step_2d_matches_jax(runs):
    je, pe = runs["jax"]["eval"], runs["port"]["eval"]
    assert float(pe["n"]) == float(je["n"]) == 2.0
    for key in ("loss", "loss_sum"):
        assert float(pe[key]) == pytest.approx(float(je[key]), rel=1e-4)
    for key in ("acc", "hits", "cnt"):
        np.testing.assert_array_equal(np.asarray(pe[key]),
                                      np.asarray(je[key]))
