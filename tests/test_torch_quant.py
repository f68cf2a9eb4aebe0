"""The port's int8 primitives (fast3dhpe_tpu_torch/ops/quant.py) against
the JAX package's (fast3dhpe_tpu/ops/quant.py) on the CPU, on the same
numpy inputs from a seed.

Tolerances: quantize_kernel's codes and scales, conv_i8,
conv_transpose_i8, max_pool_i8 and requant bit-equal (integer arithmetic,
and the same fp32 division and round-half-to-even); fold_bn within 2e-5
(the JAX test's bound; the port multiplies in the same order, measured
equal); abs_stat by max equal, by percentile within 1 ulp of the
interpolated order statistics (measured equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast3dhpe_tpu.ops import quant as JQ
from fast3dhpe_tpu_torch.ops import quant as Q

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quantize_kernel_codes_and_scales_equal_jax():
    """HWIO in JAX, OIHW in the port: the same per-channel codes and
    scales, with an all-zero channel at scale 1."""
    r = np.random.RandomState(0)
    w = (r.randn(3, 3, 8, 16) * r.rand(16) * 5).astype(np.float32)
    w[..., 5] = 0.0
    jq, js = JQ.quantize_kernel(jnp.asarray(w))
    q, s = Q.quantize_kernel(_t(w.transpose(3, 2, 0, 1)), out_axis=0)
    assert q.dtype == torch.int8 and s.shape == (16,)
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[5] == 1.0 and not q[5].any()
    # a transposed kernel, (kh, kw, O, I) in JAX, (I, O, kh, kw) here
    wt = r.randn(4, 4, 6, 5).astype(np.float32)
    jq, js = JQ.quantize_kernel(jnp.asarray(wt), out_axis=2)
    q, s = Q.quantize_kernel(_t(wt.transpose(3, 2, 0, 1)), out_axis=1)
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_fold_bn_matches_jax():
    r = np.random.RandomState(1)
    w = r.randn(3, 3, 4, 8).astype(np.float32)
    bn = [(r.rand(8) + 0.5), r.randn(8), r.randn(8), r.rand(8) + 0.1]
    bn = [b.astype(np.float32) for b in bn]
    jw, jb = JQ.fold_bn(jnp.asarray(w), *map(jnp.asarray, bn))
    fw, fb = Q.fold_bn(_t(w.transpose(3, 2, 0, 1)), *map(_t, bn))
    np.testing.assert_allclose(fw.permute(2, 3, 1, 0).numpy(),
                               np.asarray(jw), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(fb.numpy(), np.asarray(jb), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("k,stride,pad,cin,cout,hw", [
    (7, 2, 3, 3, 64, 20), (3, 1, 1, 16, 24, 9), (3, 2, 1, 8, 16, 10),
    (1, 1, 0, 32, 19, 6), (1, 2, 0, 16, 32, 7)],
    ids=["stem", "3x3", "3x3_s2", "head", "downsample"])
def test_conv_i8_bit_equal_jax(k, stride, pad, cin, cout, hw):
    """int32 accumulators: bit-equal, through the K and N padding (the
    stem's K = 147, the head's N = 19) and the M padding (the head's 36
    rows pass, a 2-image 1x1 stride-2 case has 32)."""
    r = np.random.RandomState(2)
    x = r.randint(-127, 128, (2, hw, hw, cin)).astype(np.int8)
    w = r.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    ref = np.asarray(JQ.conv_i8(jnp.asarray(x), jnp.asarray(w), stride, pad))
    got = Q.conv_i8(_t(x), Q.gemm_weight(_t(w)), cout, k, stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_conv_i8_pads_few_rows():
    """Fewer than 17 rows (one image at 2x2): padded rows, exact."""
    r = np.random.RandomState(5)
    x = r.randint(-127, 128, (1, 2, 2, 16)).astype(np.int8)
    w = r.randint(-127, 128, (1, 1, 16, 8)).astype(np.int8)
    ref = np.asarray(JQ.conv_i8(jnp.asarray(x), jnp.asarray(w), 1, 0))
    got = Q.conv_i8(_t(x), Q.gemm_weight(_t(w)), 8, 1, 1, 0)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("cin,cout,hw", [(16, 8, 4), (8, 24, 5)])
def test_conv_transpose_i8_bit_equal_jax(cin, cout, hw):
    r = np.random.RandomState(3)
    x = r.randint(-127, 128, (2, hw, hw, cin)).astype(np.int8)
    w = r.randint(-127, 128, (4, 4, cout, cin)).astype(np.int8)
    ref = np.asarray(JQ.conv_transpose_i8(jnp.asarray(x), jnp.asarray(w)))
    got = Q.conv_transpose_i8(_t(x), Q.gemm_weight_transposed(_t(w)), cout)
    assert got.shape == (2, 2 * hw, 2 * hw, cout)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_max_pool_i8_bit_equal_jax():
    r = np.random.RandomState(4)
    x = r.randint(-128, 128, (2, 9, 10, 4)).astype(np.int8)
    ref = np.asarray(JQ.max_pool_i8(jnp.asarray(x)))
    got = Q.max_pool_i8(_t(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_requant_dequant_bit_equal_jax():
    r = np.random.RandomState(6)
    y = np.concatenate([r.randn(5000).astype(np.float32) * 40,
                        np.array([-300, -1, 0, 0.25, 0.5, 0.75, 1.25, 300],
                                 np.float32)])
    for s in (0.5, 0.3137, 1e-3):
        s32 = np.float32(s)
        ref = np.asarray(JQ.requant(jnp.asarray(y), jnp.float32(s32)))
        got = Q.requant(_t(y), torch.tensor(s32))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            Q.dequant(got, torch.tensor(s32)).numpy(),
            np.asarray(JQ.dequant(jnp.asarray(ref), jnp.float32(s32))))


@pytest.mark.parametrize("percentile", [None, 100, 99.9, 50, 12.5])
def test_abs_stat_matches_jax(percentile):
    r = np.random.RandomState(7)
    t = (r.randn(3, 17, 13, 5) * 3).astype(np.float32)
    ref = float(JQ.abs_stat(jnp.asarray(t), percentile))
    got = float(Q.abs_stat(_t(t), percentile))
    assert got == pytest.approx(ref, rel=1.2e-7, abs=0)
