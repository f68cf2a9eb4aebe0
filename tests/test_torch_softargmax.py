"""Soft-argmax of the PyTorch port (fast3dhpe_tpu_torch/ops/heatmap.py and
the kernel wrapper ops/softargmax.py), forward and backward, against the
JAX package's Pallas kernels in interpret mode, its closed-form backward and
its jnp version, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.ops.heatmap import soft_argmax as jax_soft_argmax
from fast3dhpe_tpu.ops.pallas_softargmax import (_bwd_pallas, _fused_bwd,
                                                 _fwd_pallas,
                                                 _jnp_soft_argmax)
from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax, soft_argmax_bwd
from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                soft_argmax_fused)

torch.set_num_threads(2)

# tests/test_pallas_kernels.py:22,28 hold the Pallas kernel to 1e-3 px
ATOL_PX = 1e-3


def _logits(shape, seed, scale=3.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (3, 64, 64, 19),
                                   (2, 12, 20, 5)])
def test_matches_pallas_interpret_and_jnp(shape):
    hm = _logits(shape, seed=sum(shape))
    got = soft_argmax(torch.from_numpy(hm)).numpy()
    kern = np.asarray(_fwd_pallas(jnp.asarray(hm), interpret=True))
    ref = np.asarray(_jnp_soft_argmax(jnp.asarray(hm)))
    np.testing.assert_allclose(got, kern, rtol=1e-4, atol=ATOL_PX)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=ATOL_PX)


def test_leading_axes_match_jax_op():
    hm = _logits((2, 3, 16, 16, 4), seed=7)
    got = soft_argmax(torch.from_numpy(hm)).numpy()
    ref = np.asarray(jax_soft_argmax(jnp.asarray(hm)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=ATOL_PX)


def test_peak_recovery():
    # as tests/test_pallas_kernels.py:52-58
    hm = np.zeros((1, 32, 32, 2), np.float32)
    hm[0, 7, 21, 0] = 40.0
    hm[0, 30, 3, 1] = 40.0
    kp = soft_argmax_fused(torch.from_numpy(hm)).numpy()
    np.testing.assert_allclose(kp[0, 0], [21, 7], atol=ATOL_PX)
    np.testing.assert_allclose(kp[0, 1], [3, 30], atol=ATOL_PX)


def test_bf16_input_is_jax_cast_then_decode():
    """The model decodes bf16 heatmaps; JAX casts them to fp32 first."""
    hm = torch.from_numpy(_logits((2, 16, 16, 6), seed=3)).bfloat16()
    got = soft_argmax_fused(hm).numpy()
    ref = np.asarray(jax_soft_argmax(
        jnp.asarray(hm.float().numpy(), jnp.float32)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=ATOL_PX)


def test_wrapper_takes_any_strides_on_cpu():
    """The decoder hands over a channels_last NCHW tensor viewed as NHWC,
    and (N, J, H, W)-contiguous logits viewed as NHWC also decode."""
    hm = torch.from_numpy(_logits((2, 19, 16, 16), seed=5))
    as_nhwc = hm.permute(0, 2, 3, 1)
    assert not as_nhwc.is_contiguous()
    ref = soft_argmax(as_nhwc.contiguous())
    torch.testing.assert_close(soft_argmax_fused(as_nhwc), ref)
    before = soft_argmax_fused.launches
    soft_argmax_fused(as_nhwc)
    assert soft_argmax_fused.launches == before     # no kernel on the CPU


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        soft_argmax_fused(torch.zeros((1, 4, 4, 2), device="meta"))


# ---------------------------------------------------------------- backward

# the closed form against JAX's in fp32: cx and cy are sums of H*W terms
# up to W, summed in another order, and their rounding (~1e-5 relative)
# multiplies p * g, so gradients agree to 1e-5 of their largest value
RTOL_GRAD = 1e-5


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (3, 64, 64, 19),
                                   (2, 12, 20, 5)])
def test_backward_matches_pallas_interpret_and_jax_grad(shape):
    """K2's plain version against `_bwd_pallas` in interpret mode,
    `_fused_bwd` (the closed-form jnp backward) and jax.grad of the jnp
    forward."""
    hm = _logits(shape, seed=sum(shape) + 1)
    g = _logits((shape[0], shape[3], 2), seed=sum(shape) + 2, scale=1.0)
    got = soft_argmax_bwd(torch.from_numpy(hm), torch.from_numpy(g)).numpy()
    jh, jg = jnp.asarray(hm), jnp.asarray(g)
    kern = np.asarray(_bwd_pallas(jh, jg, interpret=True))
    closed = np.asarray(_fused_bwd(False, jh, jg)[0])
    auto = np.asarray(jax.grad(
        lambda h: jnp.sum(_jnp_soft_argmax(h) * jg))(jh))
    for ref in (kern, closed, auto):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=RTOL_GRAD * np.abs(ref).max())


def test_autograd_runs_the_closed_form_on_cpu():
    """The gradient of soft_argmax_fused is soft_argmax_bwd, and equals
    autograd through the plain forward; neither kernel launches on the
    CPU."""
    hm = torch.from_numpy(_logits((2, 19, 16, 16), seed=11)).permute(
        0, 2, 3, 1)                                  # channels-last view
    g = torch.from_numpy(_logits((2, 19, 2), seed=12, scale=1.0))
    before = (soft_argmax_fused.launches, soft_argmax_bwd_fused.launches)
    h1 = hm.clone().requires_grad_(True)
    (soft_argmax_fused(h1) * g).sum().backward()
    h2 = hm.clone().requires_grad_(True)
    (soft_argmax(h2) * g).sum().backward()
    torch.testing.assert_close(h1.grad, soft_argmax_bwd(hm, g))
    torch.testing.assert_close(h1.grad, h2.grad, rtol=0,
                               atol=RTOL_GRAD * float(h2.grad.abs().max()))
    assert (soft_argmax_fused.launches,
            soft_argmax_bwd_fused.launches) == before


def test_bf16_gradient_is_the_fp32_one_rounded_once():
    """The JAX model decodes h.astype(float32); the cast's backward rounds
    the fp32 gradient to bf16 once. The port's bf16 logits get exactly
    that."""
    hm = torch.from_numpy(_logits((2, 16, 16, 6), seed=13)).bfloat16()
    g = torch.from_numpy(_logits((2, 6, 2), seed=14, scale=1.0))
    h = hm.clone().requires_grad_(True)
    (soft_argmax_fused(h) * g).sum().backward()
    assert h.grad.dtype == torch.bfloat16
    ref = soft_argmax_bwd(hm.float(), g).bfloat16()
    assert torch.equal(h.grad, ref)
    assert torch.equal(soft_argmax_bwd_fused(hm, g), ref)


def test_inference_mode_runs_no_backward():
    hm = torch.from_numpy(_logits((1, 8, 8, 3), seed=15))
    before = soft_argmax_bwd_fused.launches
    with torch.inference_mode():
        out = soft_argmax_fused(hm)
    assert out.shape == (1, 3, 2) and not out.requires_grad
    assert soft_argmax_bwd_fused.launches == before


def test_backward_wrapper_checks_the_cotangent():
    with pytest.raises(ValueError):
        soft_argmax_bwd_fused(torch.zeros((1, 4, 4, 2)), torch.zeros((1, 3, 2)))
    with pytest.raises(ValueError):
        soft_argmax_bwd_fused(torch.zeros((1, 4, 4, 2), device="meta"),
                              torch.zeros((1, 2, 2)))
