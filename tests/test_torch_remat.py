"""Remat in the port (ResNetEncoder / CDRNet / PoseResNet remat and
remat_policy, torch.utils.checkpoint a block), mirroring
tests/test_train_steps.py:146-178 on the CPU at depth 18, 64 px: a CDR
train step with remat=True (policy None and "convs") against the plain
step from the same weights and batch.

Tolerances, as the JAX test's: the loss within rtol 1e-6 and the updated
parameters within rtol 1e-5 / atol 1e-7 (the same operations recomputed;
measured equal). The BN running statistics must be equal: a recomputed
block that updated them a second time would move them by another
momentum step. An unknown policy raises ValueError.
"""

import numpy as np
import pytest
import torch

from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.layers import init_weights
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.models.resnet import ResNetEncoder
from fast3dhpe_tpu_torch.train.state import TrainState
from fast3dhpe_tpu_torch.train.steps import (make_train_step_2d,
                                             make_train_step_cdr)
from test_torch_train_2d import _batch as _batch_2d
from test_torch_train_step import CFG
from test_torch_train_step import _batch as _batch_cdr

torch.set_num_threads(2)

VARIANTS = ((False, None), (True, None), (True, "convs"))


def _step_cdr(sd, remat, policy, batch):
    model = CDRNet(num_layers=18, remat=remat, remat_policy=policy)
    model.load_state_dict(sd, strict=True)
    state = TrainState.create(model, config_from_dict(CFG), 1)
    m = make_train_step_cdr(make_loss("JointsMSESmooth", True))(
        state, batch, True)
    return m, model


@pytest.fixture(scope="module")
def cdr_runs():
    base = CDRNet(num_layers=18)
    init_weights(base, torch.Generator().manual_seed(0))
    batch = _batch_cdr(0)
    return [_step_cdr(base.state_dict(), r, p, batch) for r, p in VARIANTS]


@pytest.mark.parametrize("i", [1, 2], ids=["full", "convs"])
def test_remat_step_matches_plain(cdr_runs, i):
    (m0, model0), (m, model) = cdr_runs[0], cdr_runs[i]
    assert model.encoder.remat and not model0.encoder.remat
    np.testing.assert_allclose(float(m["loss"]), float(m0["loss"]),
                               rtol=1e-6)
    for (n, a), (_, b) in zip(model0.named_parameters(),
                              model.named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("i", [1, 2], ids=["full", "convs"])
def test_remat_updates_bn_statistics_once(cdr_runs, i):
    """The running statistics equal the plain step's, so the recomputed
    forward left them alone; and they moved from their init."""
    b0 = dict(cdr_runs[0][1].named_buffers())
    moved = 0
    for n, t in cdr_runs[i][1].named_buffers():
        assert torch.equal(t, b0[n]), n
        moved += "running_mean" in n and bool(t.abs().max() > 0)
    assert moved > 10


def test_remat_2d_step_matches_plain():
    batch = _batch_2d()
    J = batch["target"].shape[-1]
    base = PoseResNet(num_joints=J, num_layers=18)
    init_weights(base, torch.Generator().manual_seed(1))
    out = []
    for remat, policy in VARIANTS:
        model = PoseResNet(num_joints=J, num_layers=18, remat=remat,
                           remat_policy=policy)
        model.load_state_dict(base.state_dict(), strict=True)
        state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                  lr=0.1))
        m = make_train_step_2d(make_loss("JointsMSE", True, layout="NHWC"))(
            state, batch)
        out.append((float(m["loss"]), model.state_dict()))
    for loss, sd in out[1:]:
        assert loss == pytest.approx(out[0][0], rel=1e-6)
        for k, t in sd.items():
            np.testing.assert_allclose(t.numpy(), out[0][1][k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        ResNetEncoder(18, remat=True, remat_policy="dots")
    with pytest.raises(ValueError, match="remat_policy"):
        CDRNet(num_layers=18, remat=True, remat_policy="everything")


def test_remat_leaves_eval_and_no_grad_alone():
    """Without gradients nothing is checkpointed: an eval forward equals
    the plain model's."""
    base = CDRNet(num_layers=18)
    init_weights(base, torch.Generator().manual_seed(2))
    model = CDRNet(num_layers=18, remat=True, remat_policy="convs")
    model.load_state_dict(base.state_dict())
    b = _batch_cdr(1)
    with torch.no_grad():
        a = base.eval()(torch.from_numpy(b["image"]),
                        torch.from_numpy(b["proj"]))
        c = model.eval()(torch.from_numpy(b["image"]),
                         torch.from_numpy(b["proj"]))
    for x, y in zip(a, c):
        assert torch.equal(x, y)
