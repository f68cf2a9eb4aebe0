"""Soft-argmax of the PyTorch port (fast3dhpe_tpu_torch/ops/heatmap.py and
the kernel wrapper ops/softargmax.py) against the JAX package's Pallas
kernel in interpret mode and its jnp version, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast3dhpe_tpu.ops.heatmap import soft_argmax as jax_soft_argmax
from fast3dhpe_tpu.ops.pallas_softargmax import _fwd_pallas, _jnp_soft_argmax
from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused

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
