"""Fused bottleneck of the PyTorch port (fast3dhpe_tpu_torch/ops/
bottleneck.py, models/resnet.py) against the JAX package's Pallas kernel in
interpret mode, on the CPU: the plain version at the kernel's rounding
points, BN folding, the wrapper's CPU path, and the fusion gate."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast3dhpe_tpu.ops.pallas_bottleneck import fold_bn as jax_fold_bn
from fast3dhpe_tpu.ops.pallas_bottleneck import fused_bottleneck as jax_fused
from fast3dhpe_tpu_torch.models.resnet import ResNetEncoder
from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain, fold_bn,
                                                fused_bottleneck)

torch.set_num_threads(2)


def _bn(C, r):
    return [r.rand(C).astype(np.float32) + 0.5,
            r.randn(C).astype(np.float32) * 0.1,
            r.randn(C).astype(np.float32) * 0.1,
            r.rand(C).astype(np.float32) + 0.5]


def _block(ds, seed, P=16, H=8, B=2):
    """Random block inputs as numpy: x (B, H, H, Cin) NHWC plus weights in
    the JAX layouts and raw BN statistics."""
    r = np.random.RandomState(seed)
    Cout = 4 * P
    Cin = 64 if ds else Cout
    x = r.randn(B, H, H, Cin).astype(np.float32)
    w = dict(w1=r.randn(Cin, P) * 0.1, w2=r.randn(3, 3, P, P) * 0.1,
             w3=r.randn(P, Cout) * 0.1)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    bns = {"1": _bn(P, r), "2": _bn(P, r), "3": _bn(Cout, r)}
    if ds:
        w["wd"] = (r.randn(Cin, Cout) * 0.1).astype(np.float32)
        bns["d"] = _bn(Cout, r)
    return x, w, bns


def _run_both(x, w, bns, dtype_np, dtype_t):
    jfold = {k: jax_fold_bn(*map(jnp.asarray, v)) for k, v in bns.items()}
    tfold = {k: fold_bn(*map(torch.from_numpy, v)) for k, v in bns.items()}
    ds = "wd" in w
    jargs = [w["w1"], *jfold["1"], w["w2"], *jfold["2"], w["w3"],
             *jfold["3"]]
    targs = [torch.from_numpy(w["w1"]), *tfold["1"],
             torch.from_numpy(w["w2"]), *tfold["2"],
             torch.from_numpy(w["w3"]), *tfold["3"]]
    if ds:
        jargs += [w["wd"], *jfold["d"]]
        targs += [torch.from_numpy(w["wd"]), *tfold["d"]]
    ref = np.asarray(jax_fused(jnp.asarray(x, dtype_np), *jargs,
                               interpret=True), np.float32)
    xt = torch.from_numpy(x).to(dtype_t).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = fused_bottleneck(xt, *targs)
    assert got.dtype == dtype_t
    assert got.is_contiguous(memory_format=torch.channels_last)
    return got.float().permute(0, 2, 3, 1).numpy(), ref


def test_fold_bn_matches_jax():
    r = np.random.RandomState(0)
    bn = _bn(32, r)
    s, b = fold_bn(*map(torch.from_numpy, bn))
    js, jb = jax_fold_bn(*map(jnp.asarray, bn))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("ds", [True, False])
def test_plain_matches_pallas_interpret_fp32(ds):
    x, w, bns = _block(ds, seed=0)
    got, ref = _run_both(x, w, bns, jnp.float32, torch.float32)
    # tests/test_pallas_kernels.py:97
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("ds", [True, False])
def test_plain_matches_pallas_interpret_bf16(ds):
    x, w, bns = _block(ds, seed=1)
    got, ref = _run_both(x, w, bns, jnp.bfloat16, torch.bfloat16)
    # bf16 bounds of tests/test_pallas_kernels.py:116-119
    denom = max(np.abs(ref).max(), 1e-3)
    assert np.abs(got - ref).max() / denom < 0.05
    assert np.abs(got - ref).mean() / denom < 0.005


def test_halo_is_zero_padded_h1_not_x():
    """With b1 > 0, zero-padding x instead of h1 would leave relu(b1) in
    the 3x3 conv's border taps; the plain version must not."""
    x, w, bns = _block(False, seed=2, P=16, H=8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    s1 = torch.ones(16)
    b1 = torch.full((16,), 2.0)
    args = [torch.from_numpy(w["w1"]) * 0, s1, b1,
            torch.from_numpy(w["w2"]), torch.ones(16), torch.zeros(16),
            torch.from_numpy(w["w3"]), torch.ones(64), torch.zeros(64)]
    out = bottleneck_plain(xt, *args)
    # with w1 = 0, h1 = relu(b1) = 2 inside the image and 0 outside: the
    # corner pixel sees the 4 taps (ky, kx) in {1, 2}^2, an interior pixel 9
    tap_sum = 2.0 * torch.from_numpy(w["w2"]).sum(dim=2)     # (3, 3, P)
    w3 = torch.from_numpy(w["w3"])
    h3_corner = torch.relu(tap_sum[1:, 1:].sum((0, 1))) @ w3
    h3_inner = torch.relu(tap_sum.sum((0, 1))) @ w3
    torch.testing.assert_close(out[:, :, 0, 0],
                               torch.relu(h3_corner + xt[:, :, 0, 0]),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[:, :, 3, 3],
                               torch.relu(h3_inner + xt[:, :, 3, 3]),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_cpu_path_is_plain_and_counts_nothing():
    x, w, bns = _block(True, seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    tf = {k: fold_bn(*map(torch.from_numpy, v)) for k, v in bns.items()}
    args = [torch.from_numpy(w["w1"]), *tf["1"], torch.from_numpy(w["w2"]),
            *tf["2"], torch.from_numpy(w["w3"]), *tf["3"],
            torch.from_numpy(w["wd"]), *tf["d"]]
    before = fused_bottleneck.launches
    torch.testing.assert_close(fused_bottleneck(xt, *args),
                               bottleneck_plain(xt, *args))
    assert fused_bottleneck.launches == before


def test_gate_at_256px_fuses_the_jax_blocks():
    """At 256 px the JAX gate (models/resnet.py:107-118) fuses layer1.0
    (10 MiB) and layer2.1-3 (6.5 MiB); layer1.1-2 sit at exactly 13 MiB and
    the test is a strict '<'; stage 3-4 planes are under 1024 pixels."""
    enc = ResNetEncoder(101, fused_inference=True).eval()
    assert enc.fused_blocks((256, 256), torch.bfloat16) == [
        "layer1.0", "layer2.1", "layer2.2", "layer2.3"]
    assert not enc.layer1[1].fusable(64, 64, torch.bfloat16)
    assert enc.layer1[0].fusable(64, 64, torch.bfloat16)
    assert 2 * 64 * 64 * (2 * 256 + 8 * 64 + 9 * 64 + 64) == 13 * 2 ** 20
    # at 128 px stage 1 fuses and stage 2 (16x16) does not
    assert enc.fused_blocks((128, 128), torch.bfloat16) == [
        "layer1.0", "layer1.1", "layer1.2"]
    # nothing fuses in fp32, in train mode, or with the option off
    assert enc.fused_blocks((256, 256), torch.float32) == []
    assert enc.train().fused_blocks((256, 256), torch.bfloat16) == []
    off = ResNetEncoder(101).eval()
    assert off.fused_blocks((256, 256), torch.bfloat16) == []
