"""The PyTorch port's losses and metrics (fast3dhpe_tpu_torch/models/
losses.py, metrics.py, ops/heatmap.py hard_argmax) against the JAX package
on the same numpy inputs, on the CPU. fp32 reductions in another order:
1e-5 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast3dhpe_tpu.models import losses as jl
from fast3dhpe_tpu.models import metrics as jm
from fast3dhpe_tpu.ops.heatmap import hard_argmax as jax_hard_argmax
from fast3dhpe_tpu_torch.models import losses as tl
from fast3dhpe_tpu_torch.models import metrics as tm
from fast3dhpe_tpu_torch.ops.heatmap import hard_argmax

torch.set_num_threads(2)

RTOL = 1e-5
B, J = 4, 5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _inputs(kind, seed):
    r = np.random.RandomState(seed)
    if kind == "heatmap_bjhw":
        shape = (B, J, 8, 6)
    elif kind == "heatmap_nhwc":
        shape = (B, 8, 6, J)
    else:                                   # coordinates; residuals > 20
        shape = (B, J, 3)
    scale = 40.0 if kind == "coords" else 1.0
    pred = (r.randn(*shape) * scale).astype(np.float32)
    target = (r.randn(*shape) * scale).astype(np.float32)
    weight = (r.rand(B, J) > 0.3).astype(np.float32)
    return pred, target, weight


CASES = [("JointsMSE", "heatmap_bjhw", "BJHW"),
         ("JointsMSE", "heatmap_nhwc", "NHWC"),
         ("JointsMSESmooth", "coords", "BJHW"),
         ("JointsMSESmooth", "heatmap_nhwc", "NHWC"),
         ("MPJPE", "coords", "BJHW")]


@pytest.mark.parametrize("loss_type,kind,layout", CASES)
@pytest.mark.parametrize("use_weight", [True, False])
@pytest.mark.parametrize("mask", [None, [1, 0, 1, 1], [0, 0, 0, 0]],
                         ids=["no_mask", "mask", "all_masked"])
def test_make_loss_matches_jax(loss_type, kind, layout, use_weight, mask):
    """Each loss with and without target weights and sample_mask (the
    B / max(sum(mask), 1) renormalisation, an all-zero mask included);
    the coordinate cases have residuals above the smooth threshold 400."""
    pred, target, weight = _inputs(kind, seed=len(loss_type) + len(kind))
    ref_fn = jl.make_loss(loss_type, use_weight, layout=layout)
    fn = tl.make_loss(loss_type, use_weight, layout=layout)
    m = None if mask is None else np.asarray(mask, np.float32)
    ref = ref_fn(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight),
                 sample_mask=None if m is None else jnp.asarray(m))
    got = fn(_t(pred), _t(target), _t(weight),
             sample_mask=None if m is None else _t(m))
    _close(float(got), float(ref))
    if kind == "coords" and loss_type == "JointsMSESmooth":
        assert ((pred - target) ** 2 > 400).mean() > 0.5


def test_smooth_loss_threshold_and_gradient_match_jax():
    """Residuals around the threshold: the (max(d^2, 1e-30))^0.1 * 400^0.9
    branch and its gradient, including an exact zero residual."""
    import jax
    d = np.array([0.0, 5.0, 19.9, 20.1, 35.0, -60.0], np.float32)
    pred = d.reshape(1, 6, 1)
    target = np.zeros_like(pred)
    ref_v, ref_g = jax.value_and_grad(
        lambda p: jl.joints_mse_smooth_loss(p, jnp.asarray(target)))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    v = tl.joints_mse_smooth_loss(p, _t(target))
    v.backward()
    _close(float(v.detach()), float(ref_v))
    _close(p.grad.numpy(), np.asarray(ref_g))


def test_unknown_loss_type_raises():
    with pytest.raises(NotImplementedError):
        tl.make_loss("L1", True)


def test_hard_argmax_matches_jax():
    """First maximum on ties, (x, y) order, zeroed where the max <= 0."""
    r = np.random.RandomState(3)
    hm = r.randn(2, 3, 7, 9, 4).astype(np.float32)
    hm[0, 0, :, :, 1] = -1.0                 # max <= 0: zeroed
    hm[0, 1, 2, 3, 2] = hm[0, 1, 4, 1, 2] = 50.0     # a tie
    ref_p, ref_v = jax_hard_argmax(jnp.asarray(hm))
    p, v = hard_argmax(_t(hm))
    _close(p.numpy(), np.asarray(ref_p), rtol=0, atol=0)
    _close(v.numpy(), np.asarray(ref_v), rtol=0, atol=0)


def _heatmaps(seed):
    r = np.random.RandomState(seed)
    out = r.rand(B, 16, 12, J).astype(np.float32)
    tgt = r.rand(B, 16, 12, J).astype(np.float32)
    tgt[0, :, :, 0] = 0.0                     # no max > 0: gt (0, 0), excluded
    tgt[:, 0, :, 1] = 5.0                     # gt on row 0: excluded
    # some predictions land on the gt
    out[:, :, :, 2] = tgt[:, :, :, 2]
    return out, tgt


@pytest.mark.parametrize("row_mask", [None, [1, 1, 0, 1]],
                         ids=["no_mask", "row_mask"])
@pytest.mark.parametrize("thr", [0.05, 0.5])
def test_pck_matches_jax(row_mask, thr):
    """pck_counts, pck_from_counts and pck_accuracy: the [H, W]/10
    normalisation, the gt <= 1 exclusion, padded rows out, -1 for a joint
    with no valid sample."""
    out, tgt = _heatmaps(seed=5)
    rm = None if row_mask is None else np.asarray(row_mask, np.float32)
    ref = jm.pck_counts(jnp.asarray(out), jnp.asarray(tgt), thr,
                        None if rm is None else jnp.asarray(rm))
    got = tm.pck_counts(_t(out), _t(tgt), thr, None if rm is None else _t(rm))
    for a, b in zip(got, ref):
        _close(a.numpy(), np.asarray(b), rtol=0, atol=0)
    ra, rp, rpred = jm.pck_accuracy(jnp.asarray(out), jnp.asarray(tgt), thr,
                                    None if rm is None else jnp.asarray(rm))
    a, p, pred = tm.pck_accuracy(_t(out), _t(tgt), thr,
                                 None if rm is None else _t(rm))
    _close(float(a), float(ra))
    _close(p.numpy(), np.asarray(rp))
    assert float(p[1]) == -1.0                # joint 1: gt on row 0 only


def test_pck_from_counts_without_valid_joints():
    a, p = tm.pck_from_counts(torch.zeros(3), torch.zeros(3))
    ra, rp = jm.pck_from_counts(jnp.zeros(3), jnp.zeros(3))
    assert float(a) == float(ra) == 0.0
    _close(p.numpy(), np.asarray(rp), rtol=0, atol=0)


@pytest.mark.parametrize("weight_shape", [None, (B, J), (B, J, 1)],
                         ids=["no_weight", "bj", "bj1"])
@pytest.mark.parametrize("fn", ["calc_mpjpe", "per_sample_mpjpe"])
def test_mpjpe_metrics_match_jax(weight_shape, fn):
    """The weight multiplied into predictions and targets, with invisible
    joints still in the denominator."""
    r = np.random.RandomState(6)
    p2 = (r.randn(B, 2, J, 2) * 20).astype(np.float32)
    p3 = (r.randn(B, J, 3) * 300).astype(np.float32)
    g3 = (r.randn(B, J, 3) * 300).astype(np.float32)
    gl = (r.randn(B, J, 2) * 20).astype(np.float32)
    gr = (r.randn(B, J, 2) * 20).astype(np.float32)
    w = (None if weight_shape is None
         else (r.rand(*weight_shape) > 0.3).astype(np.float32))
    ref = getattr(jm, fn)(*(jnp.asarray(a) for a in (p2, p3, g3, gl, gr)),
                          None if w is None else jnp.asarray(w))
    got = getattr(tm, fn)(*(_t(a) for a in (p2, p3, g3, gl, gr)),
                          None if w is None else _t(w))
    for a, b in zip(got, ref):
        _close(a.numpy(), np.asarray(b))
