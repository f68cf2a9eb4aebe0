"""Drive the PyTorch/CUDA port (fast3dhpe_tpu_torch) on one GPU.

    python3 chip_smoke.py             # everything below
    python3 chip_smoke.py --kernels   # steps 1, 2 and the kernel timings

1. Prints the card's name and power limit, builds the kernels
   (csrc/softargmax.cu and csrc/fused_bottleneck.cu, one nvcc each, in
   parallel), timing the build.
2. Kernel phase: holds each kernel (K1 soft-argmax forward, K2 its
   backward, K3 fused bottleneck) against its plain PyTorch version on the
   card, at the shapes the main paths give it and at batch 32 pairs; K1
   and K2 also at batch 1 pair, on a ragged plane, with one chunk's logits
   120 above the rest, and (K1) at J = 2, and shows that their wrappers
   refuse strided or misaligned logits; K3 also at batch 1 pair, at
   layer1.1 and on a plane that is not a multiple of its tile.
3. Serving path: three requests of four uint8 stereo pairs through
   `CDRNetInferencer.predict_batch` at the width of configs/mads_3d.yaml
   (CDRNet-101, 256 px, 19 joints), bf16 with fused_inference=True, from
   seeded random weights. Checks shapes, finite values, that each request
   launched K1 once, K2 never and K3 once per fused block, and one request
   against the same module on the CPU.
4. Times each kernel beside its bound, its plain version and its library
   comparison: `device_ms`, the kernel's own duration under torch.profiler
   with L2 cold (a 128 MiB read between launches; `ms` in the kernels
   line) and warm, and `call_ms`, CUDA events around one wrapper call
   (host plus device). K1 at 2 and 64 images bf16 and 64 fp32, K2 at 64
   images fp32 and bf16, K3 also at batch 1 pair and at layer1.1, which
   the gate leaves unfused, with its TFLOP/s and share of the bound (it
   fails if a K3 call is not faster than the unfused cuDNN block's at the
   main path's shapes),
   predict_batch at batch 1-64 and the geometry's share, and splits a
   request's device time by kernel group (torch.profiler).
5. Training path: four CDR train steps (two warmup, two with the 3D loss)
   of CDRNet-101 at full width, fp32, on a synthetic batch of 32 pairs with
   4 padded rows. Checks finite metrics, the loss arithmetic, that the
   parameters and BN statistics moved, that three BN sites updated their
   running statistics from the valid rows with the biased variance, and
   that each step launched K1 and K2 once and K3 never. Times the step and
   splits one step's device time by kernel group.
6. Card vs CPU: one train step with and one without the 3D loss at 2
   pairs (one padded), full width, from the same weights and batch on the
   card and on the CPU: losses, grad_norm, every gradient and the BN
   statistics, beside how far rounding-sized noise moves them on the CPU.
7. Prints a {"kernels": [...]} line and, last, {"ok": true, ...}.

It needs one CUDA device. Without one, or when any phase fails, it exits
non-zero and prints no result.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

SEED = 0
REQUESTS, PAIRS = 3, 4            # the serving path: 3 requests of 4 pairs
TIMING_PAIRS = 32                 # kernel timings at batch 32 pairs
TRAIN_PAIRS, TRAIN_PAD = 32, 4    # the training path: TRAIN.BATCH_SIZE pairs
TRAIN_MODES = (False, False, True, True)   # use_3d of the checked steps
TIMED_STEPS = 4                   # further use_3d steps, timed only


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def call_ms(fn, iters=20, warmup=3):
    """Median time of one fn() call in ms, by CUDA events recorded around
    it: host plus device. The host's share of the call (checks, allocation,
    the launch itself) lies between the two events, so for a kernel shorter
    than its launch this measures the host."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


L2_FLUSH_BYTES = 128 * 2 ** 20     # read between launches: > the 50 MB L2


def device_ms(fn, kernel, cold, iters=30, warmup=3):
    """Median device duration in ms of the CUDA kernels whose name contains
    `kernel`, one a call of fn(), under torch.profiler (CUPTI). cold: a
    128 MiB buffer is read before each call, so the kernel finds its
    inputs in HBM and not in the 50 MB L2, and the L2 holds no dirty lines
    whose write-back would bill the kernel (the number held against the
    HBM bound); warm: the calls run back to back. The profile sometimes
    holds fewer kernel records than calls (25 of 30 in one H100 run), so
    the median is taken over those it holds; it fails if they are fewer
    than half the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    times = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    require(2 * len(times) >= iters,
            f"the profile holds {len(times)} kernels named *{kernel}* for "
            f"{iters} calls")
    if len(times) < iters:
        print(f"# device_ms: {len(times)} records of *{kernel}* for "
              f"{iters} calls")
    return statistics.median(times)


def kernel_times(fn, kernel):
    """device_ms L2 cold and warm, and call_ms, of one kernel's wrapper."""
    return {"device_ms_cold": device_ms(fn, kernel, cold=True),
            "device_ms_warm": device_ms(fn, kernel, cold=False),
            "call_ms": call_ms(fn)}


def host_ms(fn, iters=10, warmup=2):
    """Median wall time of fn() plus a synchronize, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def rig(batch):
    """bench.py's stereo rig: f = 1100 px, principal point (128, 128),
    cameras at x = +-400 mm, 3000 mm from the origin."""
    K = np.array([[1100.0, 0.0, 128.0], [0.0, 1100.0, 128.0],
                  [0.0, 0.0, 1.0]])
    Ps = [K @ np.hstack([np.eye(3), np.array([[dx], [0.0], [3000.0]])])
          for dx in (-400.0, 400.0)]
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


def stereo_request(rng, pairs, size=256):
    return (rng.randint(0, 256, (pairs, size, size, 3), dtype=np.uint8),
            rng.randint(0, 256, (pairs, size, size, 3), dtype=np.uint8),
            rig(pairs))


# ----------------------------------------------------------------- kernels

# K1 and K2 are checked at a request's and a train step's images, at
# batch 1 pair and on a ragged plane: (name, (N, H, W, J))
SOFTARGMAX_SHAPES = (("2 images", (2, 64, 64, 19)),
                     ("8 images", (2 * PAIRS, 64, 64, 19)),
                     ("64 images", (2 * TIMING_PAIRS, 64, 64, 19)),
                     ("ragged", (2, 36, 44, 17)))
# row 0, columns 0-31 of the logits (in K1's first chunk of an image) lie
# 120 above the rest, so that e^{m_c - M} of every other chunk, and of the
# first chunk's other runs, underflows to 0 in fp32 where K1 combines them
UNDERFLOW = ("chunk 120 above", (2, 64, 64, 19))


def _nhwc_logits(gen, dev, shape, dt, underflow=False):
    """Random logits in the decoder's layout: (N, J, H, W) channels_last
    viewed as (N, H, W, J)."""
    n, hh, ww, j = shape
    h = torch.randn((n, j, hh, ww), generator=gen) * 3
    if underflow:
        h[:, :, 0, :32] += 120.0
    h = h.to(dt).to(dev).contiguous(memory_format=torch.channels_last)
    return h.permute(0, 2, 3, 1)


def _softargmax_cases(gen, dev):
    for name, shape in SOFTARGMAX_SHAPES + (UNDERFLOW,):
        for dt in (torch.float32, torch.bfloat16):
            yield (f"{name} {str(dt).replace('torch.', '')}",
                   _nhwc_logits(gen, dev, shape, dt, name == UNDERFLOW[0]))


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def check_softargmax(dev, gen):
    """K1 against its plain version on the decoder's layout, fp32 and bf16,
    at SOFTARGMAX_SHAPES and the UNDERFLOW case; its statistics against
    their definition; peak recovery at J = 2; the wrappers' refusals; the
    shared-memory formula of ops/softargmax.py against the kernel's."""
    from fast3dhpe_tpu_torch.ops._build import load_library
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
    from fast3dhpe_tpu_torch.ops.softargmax import (fwd_smem_bytes,
                                                    soft_argmax_bwd_fused,
                                                    soft_argmax_fused,
                                                    soft_argmax_fwd_fused)
    kernel_smem = load_library("softargmax").softargmax_fwd_smem_bytes
    kernel_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    kernel_smem.restype = ctypes.c_int
    for j in (1, 2, 17, 19, 64):
        for elt in (2, 4):
            require(kernel_smem(j, elt) == fwd_smem_bytes(j, elt),
                    f"K1 shared memory at J={j}, {elt}-byte logits: the "
                    f"kernel says {kernel_smem(j, elt)}, ops/softargmax.py "
                    f"{fwd_smem_bytes(j, elt)}")
    # tests/test_pallas_kernels.py:28 holds the Pallas kernel to 1e-3 px of
    # its jnp version; fp32 sums in another order stay well inside that
    tol_px = 1e-3
    err = 0.0
    for what, hm in _softargmax_cases(gen, dev):
        got, stats = soft_argmax_fwd_fused(hm)
        ref = soft_argmax(hm)
        flat = hm.float().flatten(1, 2)
        m = flat.amax(dim=1)
        s = (flat - m[:, None]).exp().sum(dim=1)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        e_s = ((stats[..., 1] * s - 1).abs().max().item())
        require(got.shape == ref.shape and e <= tol_px,
                f"K1 {what} differs from its plain version by {e} px "
                f"(tolerance {tol_px} px)")
        # m is the exact max; 1/S within fp32 sums' rounding; (cx, cy) the
        # output itself
        require(torch.equal(stats[..., 0], m)
                and torch.equal(stats[..., 2:], got) and e_s <= 1e-5,
                f"K1 {what} statistics: m exact "
                f"{torch.equal(stats[..., 0], m)}, (cx, cy) = output "
                f"{torch.equal(stats[..., 2:], got)}, |S/S_plain - 1| {e_s}")
        print(f"# K1 {what}: max |kernel - plain| {e:.3g} px, "
              f"|S/S_plain - 1| {e_s:.3g}")
        err = max(err, e)
    # peak recovery (tests/test_pallas_kernels.py:52-58)
    peak = torch.zeros((1, 32, 32, 2), device=dev)
    peak[0, 7, 21, 0] = 40.0
    peak[0, 30, 3, 1] = 40.0
    kp = soft_argmax_fused(peak).cpu()
    require(torch.allclose(kp, torch.tensor([[[21.0, 7.0], [3.0, 30.0]]]),
                           atol=tol_px), f"soft-argmax peak recovery: {kp}")
    # on CUDA the wrappers take only a contiguous (N, H, W, J) tensor at a
    # 16-byte aligned address, and launch nothing otherwise
    before = (soft_argmax_fused.launches, soft_argmax_bwd_fused.launches)
    strided = torch.randn((2, 19, 64, 64), device=dev).permute(0, 2, 3, 1)
    buf = torch.randn(2 * 64 * 64 * 19 + 1, device=dev)
    shifted = buf[1:].view(2, 64, 64, 19)
    g = torch.zeros((2, 19, 2), device=dev)
    for what, bad in (("(N, J, H, W) memory viewed as NHWC", strided),
                      ("a storage offset of 4 bytes", shifted)):
        require(_raises(lambda: soft_argmax_fused(bad))
                and _raises(lambda: soft_argmax_bwd_fused(bad, g)),
                f"the K1/K2 wrappers took {what}")
    require((soft_argmax_fused.launches,
             soft_argmax_bwd_fused.launches) == before,
            "a refused call launched a kernel")
    print(f"# K1 soft-argmax: max |kernel - plain| = {err:.3g} px "
          f"(tolerance {tol_px} px); peak recovered; strided and "
          f"misaligned logits refused")
    return err


# K2 against its plain version, relative to max|plain|. fp32: both compute
# in fp32 from the same logits and differ only in the order of the H*W-term
# sums for S, cx and cy (~1e-6 relative), which multiplies p * g: 1e-5 (the
# first H100 runs measured 1.8e-6). bf16: both round an fp32 value once;
# where those values straddle a rounding boundary the results differ by one
# bf16 ulp (<= 2^-7 of a value, so of max|plain|). Such elements are rare
# (under 1e-3 of them), which the mean bound of 2^-17 holds (measured
# 1e-10).
K2_FP32_MAX = 1e-5
K2_BF16_MAX, K2_BF16_MEAN = 2.0 ** -7, 2.0 ** -17


def _k2_bounds(got, ref, dt, what):
    scale = ref.abs().max().item()
    d = (got.float() - ref.float()).abs()
    dmax, dmean = d.max().item() / scale, d.mean().item() / scale
    if dt == torch.float32:
        ok = dmax <= K2_FP32_MAX
        bound = f"max {K2_FP32_MAX}"
    else:
        ok = dmax <= K2_BF16_MAX and dmean <= K2_BF16_MEAN
        bound = f"max {K2_BF16_MAX} / mean {K2_BF16_MEAN}"
    require(ok, f"{what} differs from its plain version: max {dmax:.3g}, "
                f"mean {dmean:.3g} of max|plain| (bound {bound})")
    return d.max().item(), dmax, dmean


def check_softargmax_bwd(dev, gen):
    """K2 against soft_argmax_bwd at SOFTARGMAX_SHAPES and the UNDERFLOW
    case, fp32 and bf16, three ways: standalone from K1's statistics,
    standalone without them (the wrapper runs K1 first), and the gradient
    of soft_argmax_fused by autograd (statistics saved by the Function)
    against autograd through the plain forward. Not at the J = 2 peak:
    there p*(x - cx) is rounding noise of cx, and so is max|plain|."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax, soft_argmax_bwd
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fused,
                                                    soft_argmax_fwd_fused)
    err = 0.0
    for what, hm in _softargmax_cases(gen, dev):
        dt = hm.dtype
        g = torch.randn((hm.shape[0], hm.shape[3], 2), generator=gen).to(dev)
        ref = soft_argmax_bwd(hm, g)
        _, stats = soft_argmax_fwd_fused(hm)
        got = soft_argmax_bwd_fused(hm, g, stats)
        alone = soft_argmax_bwd_fused(hm, g)
        torch.cuda.synchronize()
        require(got.dtype == dt and got.stride() == hm.stride(),
                f"K2 output {got.dtype} {got.stride()}, logits {dt} "
                f"{hm.stride()}")
        require(torch.equal(alone, got),
                f"K2 {what}: the call without statistics differs from the "
                f"one with K1's")
        e, dmax, dmean = _k2_bounds(got, ref, dt, f"K2 {what}")
        a = hm.detach().clone().requires_grad_(True)
        (soft_argmax_fused(a) * g).sum().backward()
        b = hm.detach().clone().requires_grad_(True)
        (soft_argmax(b) * g).sum().backward()
        torch.cuda.synchronize()
        _, gmax, gmean = _k2_bounds(a.grad, b.grad, dt,
                                    f"autograd through K2 ({what})")
        print(f"# K2 {what}: kernel vs plain max {dmax:.3g} / mean "
              f"{dmean:.3g} of max|plain|; autograd max {gmax:.3g} / "
              f"mean {gmean:.3g}")
        err = max(err, e)
    return err


def bottleneck_case(gen, dev, n, cin, planes, downsample, hw):
    """Random bf16 block inputs with b1 > 0, so that a halo taken from
    relu(b1) instead of 0 shows at the image border. hw: H (square) or
    (H, W)."""
    cout = 4 * planes
    h, w = (hw, hw) if isinstance(hw, int) else hw

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def pos(c, lo, hi):
        return torch.rand(c, generator=gen) * (hi - lo) + lo

    x = rnd(n, cin, h, w)
    args = [rnd(cin, planes, scale=cin ** -0.5), pos(planes, 0.5, 1.5),
            pos(planes, 0.5, 1.5),
            rnd(3, 3, planes, planes, scale=(9 * planes) ** -0.5),
            pos(planes, 0.5, 1.5), rnd(planes, scale=0.1),
            rnd(planes, cout, scale=planes ** -0.5), pos(cout, 0.5, 1.5),
            rnd(cout, scale=0.1)]
    if downsample:
        args += [rnd(cin, cout, scale=cin ** -0.5), pos(cout, 0.5, 1.5),
                 rnd(cout, scale=0.1)]
    else:
        args += [None, None, None]
    x = x.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dev_args = [None if a is None else
                a.to(dev, torch.bfloat16 if a.dim() > 1 else torch.float32)
                .contiguous() for a in args]
    return x, dev_args


BLOCK_SHAPES = {  # name -> (Cin, P, downsample, H) on the main path at 256 px
    "layer1.0": (64, 64, True, 64),
    "layer2.x": (512, 128, False, 32),
}
# measured beside them, off the main path: layer1.1, which the gate leaves
# unfused at 256 px (exactly 13 MiB by the JAX VMEM estimate), and a plane
# that is not a multiple of the 8x16 tile in either direction
LAYER11 = (256, 64, False, 64)
RAGGED = (64, 64, True, (36, 44))


def check_bottleneck(dev, gen):
    """K3 against its plain version (same rounding points) at the two block
    shapes that fuse at 256 px, at 2, 8 and 64 images; at layer1.1; on a
    ragged plane, through the entry the model serves and the timing runs
    (weights packed once). Also holds ops/bottleneck.py's shared-memory
    formula against the kernel's own."""
    from fast3dhpe_tpu_torch.ops._build import load_library
    from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain,
                                                    fused_bottleneck_packed,
                                                    pack_weights, smem_bytes)
    kernel_smem = load_library("fused_bottleneck").fused_bottleneck_smem_bytes
    kernel_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    kernel_smem.restype = ctypes.c_int
    for planes in (64, 128, 256):
        for ds in (False, True):
            got = kernel_smem(planes, int(ds))
            require(got == smem_bytes(planes, ds),
                    f"K3 shared memory at P={planes}, downsample={ds}: the "
                    f"kernel says {got}, ops/bottleneck.py "
                    f"{smem_bytes(planes, ds)}")
    # both sum in fp32 in different orders, so a value next to a bf16
    # rounding boundary can round to the other neighbour in h1, h2, h3 or
    # the output: a few elements differ by a few bf16 ulps (2^-7 relative),
    # the mean barely moves. A wrong halo moves every border pixel by
    # ~relu(b1)-sized terms and fails the mean bound.
    max_rel, mean_rel = 2.0 ** -5, 2.0 ** -11
    cases = [(name, n, shape) for name, shape in BLOCK_SHAPES.items()
             for n in (2, 2 * PAIRS, 2 * TIMING_PAIRS)]
    cases += [("layer1.1", 2 * PAIRS, LAYER11), ("ragged 36x44", 2, RAGGED)]
    err = 0.0
    for name, n, (cin, planes, ds, hw) in cases:
        x, args = bottleneck_case(gen, dev, n, cin, planes, ds, hw)
        got = fused_bottleneck_packed(x, pack_weights(*args)).float()
        ref = bottleneck_plain(x, *args).float()
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        d = (got - ref).abs()
        border = torch.cat([d[:, :, 0].flatten(), d[:, :, -1].flatten(),
                            d[:, :, :, 0].flatten(), d[:, :, :, -1].flatten()])
        print(f"# K3 {name} n={n}: max|d| {d.max().item():.4g}, "
              f"mean|d| {d.mean().item():.3g}, border mean "
              f"{border.mean().item():.3g}, max|ref| {scale:.4g}")
        require(d.max().item() <= max_rel * scale
                and d.mean().item() <= mean_rel * scale
                and border.mean().item() <= mean_rel * scale,
                f"fused bottleneck {name} (n={n}) differs from its plain "
                f"version beyond max {max_rel} / mean {mean_rel} of "
                f"max|ref|")
        err = max(err, d.max().item())
    print(f"# K3 fused bottleneck: max |kernel - plain| = {err:.4g}")
    return err


# -------------------------------------------------------------------- path

def seeded_inferencer(cfg, device, state_dict=None):
    from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.layers import init_weights
    if state_dict is None:
        model = CDRNet.from_config(cfg)
        init_weights(model, torch.Generator().manual_seed(SEED))
        state_dict = model.state_dict()
    return CDRNetInferencer(cfg, dtype=torch.bfloat16, fused_inference=True,
                            state_dict=state_dict, device=device)


def normalized(img_l, img_r, device):
    from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet
    return torch.stack([normalize_imagenet(torch.as_tensor(i).to(device))
                        for i in (img_l, img_r)], dim=1)


def run_path(cfg, dev):
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    from fast3dhpe_tpu_torch.ops.bottleneck import fused_bottleneck
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fused)

    t0 = time.perf_counter()
    inf = seeded_inferencer(cfg, "cuda")
    model = inf.model
    fused = model.encoder.fused_blocks(tuple(cfg.MODEL.IMAGE_SIZE),
                                       torch.bfloat16)
    require(fused == ["layer1.0", "layer2.1", "layer2.2", "layer2.3"],
            f"unexpected fused blocks {fused}")
    rng = np.random.RandomState(SEED)
    requests = [stereo_request(rng, PAIRS) for _ in range(REQUESTS)]

    # The N(0, 0.001) head decodes every view to the heatmap centre, where
    # the stereo rays are parallel and triangulation degenerates. Scale it
    # so the logits have unit spread on the first request: the views then
    # decode apart and the soft-argmax stays smooth.
    with torch.inference_mode():
        _, _, hm = model(normalized(*requests[0][:2], dev),
                         torch.as_tensor(requests[0][2], device=dev),
                         return_heatmaps=True)
        head = model.decoder.final_layer.weight
        head.mul_(1.0 / hm.float().std().item())
    print(f"# path: CDRNet-{cfg.MODEL.NUM_LAYERS} built and calibrated in "
          f"{time.perf_counter() - t0:.1f} s; fused blocks {fused}")

    soft_argmax_fused.launches = 0
    soft_argmax_bwd_fused.launches = 0
    fused_bottleneck.launches = 0
    outs = [inf.predict_batch(*req) for req in requests]
    torch.cuda.synchronize()
    launches = {"soft_argmax": soft_argmax_fused.launches,
                "soft_argmax_bwd": soft_argmax_bwd_fused.launches,
                "fused_bottleneck": fused_bottleneck.launches}
    print(f"# path: {REQUESTS} requests x {PAIRS} pairs, launches "
          f"{launches}")
    require(launches["soft_argmax"] == REQUESTS,
            f"soft-argmax kernel launched {launches['soft_argmax']} times "
            f"for {REQUESTS} requests")
    require(launches["soft_argmax_bwd"] == 0,
            f"soft-argmax backward launched {launches['soft_argmax_bwd']} "
            f"times while serving")
    require(launches["fused_bottleneck"] == REQUESTS * len(fused),
            f"fused bottleneck launched {launches['fused_bottleneck']} times "
            f"for {REQUESTS} requests x {len(fused)} blocks")
    for kp, p3d in outs:
        require(kp.shape == (PAIRS, 2, 19, 2) and p3d.shape == (PAIRS, 19, 3),
                f"output shapes {tuple(kp.shape)}, {tuple(p3d.shape)}")
        require(bool(torch.isfinite(kp).all() and torch.isfinite(p3d).all()),
                "non-finite output")

    # one request against the same module on the CPU
    t0 = time.perf_counter()
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu_model = seeded_inferencer(cfg, "cpu", state_dict=sd).model
    img_l, img_r, proj = requests[0]
    with torch.inference_mode():
        gkp, gp3d, ghm = model(normalized(img_l, img_r, dev),
                               torch.as_tensor(proj, device=dev),
                               return_heatmaps=True)
        ckp, cp3d, chm = cpu_model(normalized(img_l, img_r, "cpu"),
                                   torch.as_tensor(proj),
                                   return_heatmaps=True)
        # the GPU's geometry against the CPU's on the GPU's own keypoints
        proj_j = torch.as_tensor(proj)[:, None].expand(PAIRS, 19, 2, 3, 4)
        ref3 = dlt_triangulate(proj_j, gkp.cpu().transpose(1, 2))
    torch.testing.assert_close(gkp, outs[0][0], rtol=0, atol=0)
    ghm, chm = ghm.float().cpu(), chm.float()
    hm_scale = chm.abs().max().item()
    hm_max = (ghm - chm).abs().max().item() / hm_scale
    hm_mean = (ghm - chm).abs().mean().item() / hm_scale
    kp_err = (gkp.cpu() - ckp).abs().max().item()
    p3_rel = ((gp3d.cpu() - ref3).norm(dim=-1)
              / ref3.norm(dim=-1)).max().item()
    p3_cpu_rel = ((gp3d.cpu() - cp3d).norm(dim=-1)
                  / cp3d.norm(dim=-1)).median().item()
    print(f"# path vs CPU ({time.perf_counter() - t0:.1f} s): heatmaps max "
          f"{hm_max:.3g} / mean {hm_mean:.3g} of max|cpu| {hm_scale:.3g}; "
          f"pred_2d max {kp_err:.3g} px; pred_3d vs CPU DLT of the GPU's "
          f"pred_2d {p3_rel:.3g} relative; pred_3d vs the CPU run, median "
          f"{p3_cpu_rel:.3g} relative; pred_2d spread "
          f"{gkp.std().item():.3g} px")
    # bf16 bounds of tests/test_pallas_kernels.py:116-119: cuDNN and
    # oneDNN round bf16 convolutions differently
    require(hm_max < 0.05 and hm_mean < 0.005,
            f"heatmaps differ from the CPU run: max {hm_max}, mean {hm_mean}")
    # with unit-spread logits those heatmap errors move a centre of mass by
    # a fraction of a heatmap pixel (4 image pixels)
    require(kp_err < 2.0, f"pred_2d differs from the CPU run by {kp_err} px")
    # fp32 Jacobi SVD on either device, same keypoints
    require(p3_rel < 1e-3, f"pred_3d differs from the CPU DLT by {p3_rel}")
    return inf, launches, requests


# ---------------------------------------------------------------- training

def converging_rig(batch, size=256):
    """bench.py's intrinsics and camera centres (x = -+400 mm, 3000 mm from
    the origin), each camera turned toward the origin. bench.py's own rig
    keeps the axes parallel, and at 3 m each camera sees only
    128 * 3000 / 1100 = 349 mm either side of its axis, which lies 400 mm
    off the origin: no pose near the origin projects into both views."""
    f, c = 1100.0 * size / 256, size / 2
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


def train_batch(rng, pairs, pad, size=256):
    """Normalised random images, 3D poses within +-250 mm of the origin,
    their exact projections as target_2d, target weights 1, and the last
    `pad` rows marked padded (a final batch)."""
    proj = converging_rig(pairs, size)
    p3 = rng.uniform(-250, 250, (pairs, 19, 3)).astype(np.float32)
    hom = np.concatenate([p3, np.ones((pairs, 19, 1), np.float32)], -1)
    uvw = np.einsum("bvij,bkj->bvki", proj, hom)
    t2d = (uvw[..., :2] / uvw[..., 2:]).astype(np.float32)
    require(t2d.min() > 0 and t2d.max() < size,
            "a target joint projects outside the image")
    row_valid = np.ones(pairs, np.float32)
    row_valid[pairs - pad:] = 0.0
    return {"image": rng.randn(pairs, 2, size, size, 3).astype(np.float32),
            "proj": proj, "target_3d": p3, "target_2d": t2d,
            "target_weight": np.ones((pairs, 19), np.float32),
            "row_valid": row_valid}


def on_device(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def calibrate_train_head(model, batch):
    """Scale the N(0, 0.001) heatmap head so that the train-mode logits
    have unit spread on this batch, as the serving phase does in eval mode:
    the views then decode apart and the DLT is well conditioned. The BN
    running statistics are left as they were."""
    saved = {k: v.clone() for k, v in model.named_buffers()}
    model.train()
    with torch.no_grad():
        _, _, hm = model(batch["image"], batch["proj"], return_heatmaps=True,
                         row_valid=batch["row_valid"])
        model.decoder.final_layer.weight.mul_(1.0 / hm.float().std().item())
        for k, v in model.named_buffers():
            v.copy_(saved[k])


# BN sites whose first update the training phase recomputes, and whether
# their rows are the view-stacked (B*V) batch. encoder.bn1 has 917k valid
# values a channel, so its mean shows which rows were taken; the CF sites
# have 56 x 64 and 28 x 64, where an unbiased variance is 2.8e-4 and
# 5.6e-4 larger than the biased one.
BN_SITES = {"encoder.bn1": True, "CF.conv_layer1.1": True,
            "CF.out_layer.0.1": False}
BN_MEAN_TOL, BN_VAR_TOL = 1e-5, 1e-4     # of the batch std and variance


class BNUpdateCheck:
    """Holds the first running-statistic update of the BN_SITES against an
    independent computation: torch.var_mean in fp64 (two-pass, biased)
    over the rows that this script marks valid (np.repeat per view for the
    stacked sites). The port's batch statistics are read back from the
    update, (new - (1 - m) * old) / m."""

    def __init__(self, model, row_valid):
        self.mods = dict(model.named_modules())
        self.valid, self.old, self.inputs, self.handles = {}, {}, {}, []
        for name, stacked in BN_SITES.items():
            m = self.mods[name]
            rv = np.repeat(row_valid, 2) if stacked else row_valid
            self.valid[name] = torch.as_tensor(rv > 0)
            self.old[name] = (m.running_mean.double().clone(),
                              m.running_var.double().clone())
            self.handles.append(m.register_forward_pre_hook(self._hook(name)))

    def _hook(self, name):
        def hook(mod, args):
            self.inputs.setdefault(name, args[0].detach())
        return hook

    def check(self):
        for h in self.handles:
            h.remove()
        worst = 0.0
        for name in BN_SITES:
            m, x = self.mods[name], self.inputs[name]
            var, mean = torch.var_mean(
                x[self.valid[name].to(x.device)].double(), dim=(0, 2, 3),
                correction=0)
            mom = m.momentum
            old_mean, old_var = self.old[name]
            got_mean = (m.running_mean.double() - (1 - mom) * old_mean) / mom
            got_var = (m.running_var.double() - (1 - mom) * old_var) / mom
            e_mean = ((got_mean - mean).abs() / var.sqrt()).max().item()
            e_var = ((got_var - var) / var).abs().max().item()
            print(f"# train BN {name}: batch mean within {e_mean:.3g} std, "
                  f"variance within {e_var:.3g} of fp64 over the valid rows")
            require(e_mean <= BN_MEAN_TOL and e_var <= BN_VAR_TOL,
                    f"BN {name} updated its running statistics from other "
                    f"statistics than the biased ones of the valid rows: "
                    f"mean {e_mean:.3g} std (bound {BN_MEAN_TOL}), variance "
                    f"{e_var:.3g} (bound {BN_VAR_TOL})")
            worst = max(worst, e_var)
        return worst


def seeded_train_model(cfg):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.layers import init_weights
    model = CDRNet.from_config(cfg)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model


def train_step_fn(cfg):
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.steps import make_train_step_cdr
    return make_train_step_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
        loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
        num_joints=cfg.MODEL.NUM_JOINTS)


def run_train(cfg, dev):
    """The training path: CDRNet-101 at full width, fp32, the config's
    Adam, loss and 3D weight, TRAIN_PAIRS pairs with TRAIN_PAD padded."""
    from fast3dhpe_tpu_torch.ops.bottleneck import fused_bottleneck
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fused)
    from fast3dhpe_tpu_torch.train.state import TrainState

    t0 = time.perf_counter()
    batch = train_batch(np.random.RandomState(SEED + 2), TRAIN_PAIRS,
                        TRAIN_PAD, cfg.MODEL.IMAGE_SIZE[0])
    db = on_device(batch, dev)
    model = seeded_train_model(cfg).to(dev)
    calibrate_train_head(model, db)
    start_sd = {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    step = train_step_fn(cfg)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if "running" in n}
    bn_check = BNUpdateCheck(model, batch["row_valid"])
    torch.cuda.synchronize()
    print(f"# train: CDRNet-{cfg.MODEL.NUM_LAYERS} fp32 built and "
          f"calibrated in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    counters = (soft_argmax_fused, soft_argmax_bwd_fused, fused_bottleneck)
    for c in counters:
        c.launches = 0
    times, per_step, metrics = [], [], []
    for i, use_3d in enumerate(TRAIN_MODES):
        before = [c.launches for c in counters]
        t = time.perf_counter()
        m = step(state, db, use_3d)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        per_step.append(tuple(c.launches - b for c, b in zip(counters, before)))
        metrics.append({k: v.item() for k, v in m.items()})
        print(f"# train step {i} use_3d={use_3d}: {times[-1]:.1f} ms, "
              f"launches K1/K2/K3 {per_step[-1]}, "
              + ", ".join(f"{k} {v:.6g}" for k, v in metrics[-1].items()))
        if i == 0:
            bn_err = bn_check.check()
    launches = {"soft_argmax": soft_argmax_fused.launches,
                "soft_argmax_bwd": soft_argmax_bwd_fused.launches,
                "fused_bottleneck": fused_bottleneck.launches}

    for i, (use_3d, m, n) in enumerate(zip(TRAIN_MODES, metrics, per_step)):
        require(n == (1, 1, 0), f"train step {i} launched K1/K2/K3 {n} "
                                f"times, not (1, 1, 0)")
        require(all(np.isfinite(v) for v in m.values()),
                f"train step {i}: non-finite metrics {m}")
        if use_3d:
            want = m["loss_2d"] + cfg.TRAIN.LOSS_3D_WEIGHT * m["loss_3d"]
            require(abs(m["loss"] - want) <= 1e-6 * abs(want),
                    f"train step {i}: loss {m['loss']} is not loss_2d + "
                    f"{cfg.TRAIN.LOSS_3D_WEIGHT} loss_3d = {want}")
        else:
            require(m["loss"] == m["loss_2d"],
                    f"warmup step {i}: loss {m['loss']} != loss_2d "
                    f"{m['loss_2d']}")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), params0[n])]
    still += [n for n, b in model.named_buffers()
              if n in stats0 and torch.equal(b, stats0[n])]
    require(not still, f"unchanged after {len(TRAIN_MODES)} steps: {still}")

    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        step(state, db, True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"# train step at {TRAIN_PAIRS} pairs: median {step_ms:.1f} ms "
          f"over steps 2-{len(times)} ({TRAIN_PAIRS / step_ms * 1e3:.1f} "
          f"pairs/s); steps {[round(t, 1) for t in times]} ms; peak device "
          f"memory {peak:.2f} GiB")
    return {"state": state, "step": step, "batch": db, "start_sd": start_sd,
            "launches": launches, "bn_err": bn_err,
            "summary": {"pairs": TRAIN_PAIRS, "step_ms": step_ms,
                        "pairs_per_s": TRAIN_PAIRS / step_ms * 1e3,
                        "step_times_ms": times, "peak_gib": peak,
                        "metrics": metrics}}


# Card vs CPU: one train step with and one without the 3D loss, at 2 pairs
# (one padded), full width, from the same weights and batch. The losses are
# fp32 sums in another order: CPU_LOSS_TOL relative. grad_norm, the
# gradients and the BN running statistics pass through ReLUs, whose units
# within rounding of zero switch between devices, and, with the 3D loss,
# through the Jacobi-SVD DLT, whose backward at untrained weights amplifies
# rounding a millionfold (grad_norm ~1e6). So each is held to CPU_NOISE_X
# times the change that rounding-sized noise makes on the CPU itself (its
# images x (1 + 1e-7)), and never looser than that noise allows: at least
# CPU_FLOOR.
CPU_LOSS_TOL, CPU_NOISE_X, CPU_FLOOR = 1e-4, 3.0, 1e-3


def _step_errors(a, b):
    """How far run a is from run b: losses (relative), grad_norm
    (relative), the gradients (of their norm), the BN running statistics
    (per buffer, of its range; the worst buffers named)."""
    (am, ag, ast), (bm, bg, bst) = a, b
    num = sum(float(((ag[n] - bg[n]) ** 2).sum()) for n in bg)
    stats = sorted(((float((ast[n] - bst[n]).abs().max())
                     / float(bst[n].abs().max()), n) for n in bst),
                   reverse=True)
    return {"loss": max(abs(am[k] - bm[k]) / abs(bm[k])
                        for k in ("loss", "loss_2d", "loss_3d")),
            "grad_norm": abs(am["grad_norm"] - bm["grad_norm"])
            / bm["grad_norm"],
            "grads": (num / sum(float((bg[n] ** 2).sum()) for n in bg))
            ** 0.5,
            "bn_stats": stats[0][0],
            "bn_worst": [f"{n} {e:.3g}" for e, n in stats[:3]]}


def train_vs_cpu(cfg, start_sd, dev):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.train.state import TrainState

    t0 = time.perf_counter()
    batch = train_batch(np.random.RandomState(SEED + 3), 2, 1,
                        cfg.MODEL.IMAGE_SIZE[0])
    step = train_step_fn(cfg)

    def one_step(device, use_3d, images_scale=1.0):
        model = CDRNet.from_config(cfg)
        model.load_state_dict(start_sd, strict=True)
        model.to(device)
        # lr 0: the gradients are compared, the parameters stay put
        state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                  lr=0.0))
        b = dict(batch, image=batch["image"] * np.float32(images_scale))
        m = step(state, on_device(b, device), use_3d)
        return ({k: v.item() for k, v in m.items()},
                {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()},
                {n: t.detach().cpu() for n, t in model.named_buffers()
                 if "running" in n})

    out = {}
    for use_3d in (True, False):
        cpu = one_step("cpu", use_3d)
        err = _step_errors(one_step(dev, use_3d), cpu)
        noise = _step_errors(one_step("cpu", use_3d, 1.0 + 1e-7), cpu)
        label = "use_3d" if use_3d else "warmup"
        print(f"# train card vs CPU, {label} step: "
              + ", ".join(f"{k} {err[k]:.3g} (CPU noise {noise[k]:.3g})"
                          for k in ("loss", "grad_norm", "grads",
                                    "bn_stats"))
              + f"; worst BN buffers {err['bn_worst']}")
        require(err["loss"] <= CPU_LOSS_TOL,
                f"{label} losses differ from the CPU's by {err['loss']:.3g} "
                f"(bound {CPU_LOSS_TOL})")
        for k in ("grad_norm", "grads", "bn_stats"):
            bound = max(CPU_FLOOR, CPU_NOISE_X * noise[k])
            require(err[k] <= bound,
                    f"{label} {k} differs from the CPU's by {err[k]:.3g}, "
                    f"beyond {CPU_NOISE_X} x the CPU's own noise "
                    f"{noise[k]:.3g} (bound {bound:.3g})")
        out[label] = {"card_vs_cpu": err, "cpu_noise": noise}
    print(f"# train card vs CPU: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ timing

def _decoder_logits(gen, dev, n, dt):
    """Random logits in the decoder's layout: (n, 19, 64, 64) channels_last
    viewed as (n, 64, 64, 19)."""
    h = (torch.randn((n, 19, 64, 64), generator=gen) * 3).to(dt)
    return h.to(dev).contiguous(memory_format=torch.channels_last).permute(
        0, 2, 3, 1)


def _show_times(what, t):
    print(f"# {what}: device {t['device_ms_cold']:.4f} ms L2 cold, "
          f"{t['device_ms_warm']:.4f} ms L2 warm "
          f"({100 * t['share_of_bound']:.1f}% of the bound cold); call "
          f"{t['call_ms']:.4f} ms (host + device); plain "
          f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, {t['mbytes']:.2f} MB)")


def _timed_row(times, plain, nbytes, flops):
    bound, by = bound_ms(nbytes, flops, FP32_FLOPS)
    return dict(times, ms=times["device_ms_cold"], plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                mbytes=nbytes / 1e6,
                share_of_bound=bound / times["device_ms_cold"])


# (images, dtype) at which K1 and K2 are timed; the first is the row's
K1_TIMED = ((2 * TIMING_PAIRS, torch.bfloat16), (2, torch.bfloat16),
            (2 * TIMING_PAIRS, torch.float32))
K2_TIMED = ((2 * TIMING_PAIRS, torch.float32),
            (2 * TIMING_PAIRS, torch.bfloat16))


def time_softargmax(dev, gen):
    """K1 at a batch-32 request (64 images, bf16), at batch 1 pair (2
    images) and at a train step's fp32 (64 images). Bound: read the logits
    once, write (x, y) and the statistics once; ~6 fp32 operations a
    logit."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
    from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused
    rows = []
    for n, dt in K1_TIMED:
        hm = _decoder_logits(gen, dev, n, dt)
        t = kernel_times(lambda: soft_argmax_fused(hm), "softargmax_fwd")
        nbytes = hm.numel() * hm.element_size() + n * 19 * 6 * 4
        row = _timed_row(t, call_ms(lambda: soft_argmax(hm)), nbytes,
                         6 * hm.numel())
        row["shape"] = f"({n}, 64, 64, 19) {str(dt).replace('torch.', '')}"
        _show_times(f"K1 {row['shape']}", row)
        rows.append(row)
    return dict(rows[0], variants=rows[1:])


def time_softargmax_bwd(dev, gen):
    """K2 at 64 images of 64x64x19 in the decoder's layout, fp32 (the
    training path's type) and bf16. Bound: read the logits, g and the
    statistics once, write dh once; ~12 fp32 operations a logit."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax_bwd
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fwd_fused)
    rows = []
    for n, dt in K2_TIMED:
        hm = _decoder_logits(gen, dev, n, dt)
        g = torch.randn((n, 19, 2), generator=gen).to(dev)
        _, stats = soft_argmax_fwd_fused(hm)
        t = kernel_times(lambda: soft_argmax_bwd_fused(hm, g, stats),
                         "softargmax_bwd")
        nbytes = 2 * hm.numel() * hm.element_size() + n * 19 * 6 * 4
        row = _timed_row(t, call_ms(lambda: soft_argmax_bwd(hm, g)), nbytes,
                         12 * hm.numel())
        row["shape"] = f"({n}, 64, 64, 19) {str(dt).replace('torch.', '')}"
        _show_times(f"K2 {row['shape']}", row)
        rows.append(row)
    return dict(rows[0], variants=rows[1:])


def _time_block(dev, gen, n, cin, planes, ds, hw, plain=False):
    """K3 at one shape with its weights packed once (as the model runs
    it), beside the unfused block on cuDNN: the port's Bottleneck module,
    bf16, BN in eval mode. Bound: x and the weights read once, the output
    written once; the block's FLOPs at the bf16 tensor-core peak."""
    from fast3dhpe_tpu_torch.models.resnet import Bottleneck
    from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain,
                                                    fused_bottleneck_packed,
                                                    pack_weights)
    x, args = bottleneck_case(gen, dev, n, cin, planes, ds, hw)
    packed = pack_weights(*args)
    cout = 4 * planes
    t = kernel_times(lambda: fused_bottleneck_packed(x, packed),
                     "bottleneck_kernel")
    ms = t["device_ms_cold"]
    blk = Bottleneck(cin, planes, 1, ds).to(dev).eval()
    with torch.inference_mode():
        lib = call_ms(lambda: blk(x))
    flops = 2 * n * hw * hw * planes * (
        cin + 9 * planes + cout + (cin * cout // planes if ds else 0))
    wbytes = 2 * (cin * planes + 9 * planes * planes + planes * cout
                  + (cin * cout if ds else 0))
    nbytes = 2 * n * hw * hw * (cin + cout) + wbytes
    bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
    out = dict(t, n=n, ms=ms, bound_ms=bound, bound_by=by, library_ms=lib,
               gflop=flops / 1e9, mbytes=nbytes / 1e6,
               tflops=flops / ms / 1e9, share_of_bound=bound / ms)
    if plain:
        out["plain_ms"] = call_ms(lambda: bottleneck_plain(x, *args), iters=5)
    return out


def time_bottleneck(dev, gen):
    """K3 at the forward's launches at 64 images (layer1.0 + 3 x
    layer2.x), at batch 1 pair (2 images), and at layer1.1, which the gate
    leaves unfused."""
    n = 2 * TIMING_PAIRS
    per_forward = {"layer1.0": 1, "layer2.x": 3}
    parts, total = [], {"ms": 0.0, "device_ms_cold": 0.0,
                        "device_ms_warm": 0.0, "call_ms": 0.0,
                        "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bytes_t = ops_t = 0.0
    extra = {}

    def show(name, t):
        print(f"# K3 {name} at {t['n']} images: device {t['ms']:.4f} ms L2 "
              f"cold, {t['device_ms_warm']:.4f} ms warm ({t['tflops']:.1f} "
              f"TFLOP/s, {100 * t['share_of_bound']:.1f}% of the bound cold);"
              f" call {t['call_ms']:.4f} ms, unfused cuDNN block call "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; {t['gflop']:.2f} GFLOP, "
              f"{t['mbytes']:.1f} MB)"
              + (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t
                 else ""))

    for name, (cin, planes, ds, hw) in BLOCK_SHAPES.items():
        t = _time_block(dev, gen, n, cin, planes, ds, hw, plain=True)
        show(name, t)
        # like for like: both by CUDA events around one call
        require(t["call_ms"] < t["library_ms"],
                f"K3 {name} at {n} images takes {t['call_ms']:.4f} ms a "
                f"call, the unfused cuDNN block {t['library_ms']:.4f} ms")
        k = per_forward[name]
        bytes_t += k * t["mbytes"] * 1e6 / HBM_BPS * 1e3
        ops_t += k * t["gflop"] * 1e9 / BF16_FLOPS * 1e3
        for key in total:
            total[key] += k * t[key]
        parts.append(dict(block=name, per_forward=k, **t))
        t1 = _time_block(dev, gen, 2, cin, planes, ds, hw)
        show(name, t1)
        extra[f"{name} batch 1 pair"] = t1
    t = _time_block(dev, gen, n, *LAYER11)
    show("layer1.1 (unfused by the gate)", t)
    extra["layer1.1"] = t
    total["bound_by"] = "bytes" if bytes_t >= ops_t else "operations"
    total["parts"] = parts
    total["measured_only"] = extra
    return total


def time_serving(inf, dev):
    from fast3dhpe_tpu_torch.geometry.triangulation import (dlt_triangulate,
                                                            pinv_projection)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(SEED + 1)
    serving = {}
    for pairs in (1, 16, 32, 64):
        img_l, img_r, proj = stereo_request(rng, pairs)
        args = (torch.as_tensor(img_l, device=dev),
                torch.as_tensor(img_r, device=dev),
                torch.as_tensor(proj, device=dev))
        ms = host_ms(lambda: inf.predict_batch(*args),
                     iters=20 if pairs == 1 else 10)
        proj_t = args[2]
        kp = torch.rand((pairs, 19, 2, 2), device=dev) * 256

        def geometry():
            pinv_projection(proj_t)
            dlt_triangulate(proj_t[:, None].expand(pairs, 19, 2, 3, 4), kp)

        geo = host_ms(geometry, iters=10)
        serving[pairs] = {"ms": ms, "pairs_per_s": pairs / ms * 1e3,
                          "geometry_ms": geo}
        print(f"# predict_batch batch {pairs}: {ms:.3f} ms, "
              f"{pairs / ms * 1e3:.1f} pairs/s; pinv + Jacobi DLT alone "
              f"{geo:.3f} ms ({100 * geo / ms:.0f}%)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"# peak device memory while serving {peak:.2f} GiB")
    return serving


CONV_KERNELS = ("xmma", "cutlass", "nvjet", "cudnn", "gemm", "conv")
KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel's name)
    ("K3 fused bottleneck", ("bottleneck_kernel",)),
    ("K1 soft-argmax", ("softargmax_fwd",)),
    ("cuDNN/cuBLAS conv and matmul", CONV_KERNELS),
    ("batch norm", ("batch_norm",)),
)


def profile_serving(inf, dev, pairs, wall_ms, calls=3):
    """Device time of predict_batch by kernel group (torch.profiler), and
    the device's idle share against the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    img_l, img_r, proj = stereo_request(np.random.RandomState(SEED), pairs)
    args = [torch.as_tensor(a, device=dev) for a in (img_l, img_r, proj)]
    inf.predict_batch(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            inf.predict_batch(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (elementwise, copies, reductions)"] = 0.0
    launches = 0
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / calls
        launches += e.count
        key = next((name for name, subs in KERNEL_GROUPS
                    if any(s in e.key for s in subs)),
                   "other (elementwise, copies, reductions)")
        groups[key] += ms
    busy = sum(groups.values())
    require(busy > 0, "the profiler recorded no device time")
    for name in ("K3 fused bottleneck", "K1 soft-argmax"):
        require(groups[name] > 0, f"no kernel of the group {name} in the "
                                  f"profile of predict_batch")
    print(f"# profile predict_batch batch {pairs}: device busy {busy:.3f} ms "
          f"of {wall_ms:.3f} ms wall (idle {100 * (1 - busy / wall_ms):.0f}%)"
          f", {launches // calls} kernel launches a call")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"#   {name}: {ms:.3f} ms ({100 * ms / busy:.0f}%)")
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "launches": launches // calls, "groups": groups}


TRAIN_GROUPS = (  # (group, substrings of the CUDA kernel's name)
    ("K1 soft-argmax", ("softargmax_fwd",)),
    ("K2 soft-argmax backward", ("softargmax_bwd",)),
    ("cuDNN/cuBLAS conv and matmul", CONV_KERNELS),
)
# CPU ranges whose kernels are train-mode BN: the forward, wrapped in a
# record_function range while profiling, and the backward node
BN_RANGES = ("train_bn", "MaskedBatchNormBackward")


def profile_train(train, wall_ms):
    """Device time of one use_3d train step by kernel group, and the
    device's idle share against the unprofiled median step. Train-mode BN
    runs as elementwise and reduction kernels, so it is told apart by the
    CPU range that launched them: each kernel is linked to the CPU op that
    launched it, and that op to the BN forward or backward range around it
    on the same thread."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from fast3dhpe_tpu_torch.models.layers import BatchNorm2d

    def traced(self, *args, **kwargs):
        with record_function("train_bn"):
            return bn_forward(self, *args, **kwargs)

    flops = []              # forward FLOPs of each convolution, from shapes

    def count(mod, args, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            x = args[0]             # every input pixel meets every tap
            flops.append(2 * x.numel() * mod.out_channels
                         * mod.weight[0, 0].numel())
        else:
            flops.append(2 * out.numel() * mod.weight[0].numel())

    hooks = [m.register_forward_hook(count)
             for m in train["state"].model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    bn_forward = BatchNorm2d.forward
    BatchNorm2d.forward = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train["step"](train["state"], train["batch"], True)
            torch.cuda.synchronize()
    finally:
        BatchNorm2d.forward = bn_forward
        for h in hooks:
            h.remove()
    # the backward takes the weight gradient and, for every convolution but
    # the first (whose input is the images), the input gradient
    conv_flop = 3 * sum(flops) - flops[0]

    def group(name):
        return next((g for g, subs in TRAIN_GROUPS
                     if any(s in name for s in subs)), None)

    events = prof.events()
    groups = {g: 0.0 for g, _ in TRAIN_GROUPS}
    rest, launches = 0.0, 0
    for e in events:
        # a record_function range also shows on the device's timeline
        if (e.device_type == DeviceType.CUDA and e.name not in BN_RANGES
                and not getattr(e, "is_user_annotation", False)):
            ms = (e.time_range.end - e.time_range.start) / 1e3
            launches += 1
            g = group(e.name)
            if g is None:
                rest += ms
            else:
                groups[g] += ms
    ranges = {}
    for e in events:
        if e.device_type == DeviceType.CPU and any(r in e.name
                                                   for r in BN_RANGES):
            ranges.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end))
    for thread, spans in ranges.items():     # the union of nested ranges
        merged = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        ranges[thread] = merged
    bn = linked = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        spans = ranges.get(e.thread, [])
        i = bisect.bisect_right(spans, (e.time_range.start, float("inf")))
        in_bn = i > 0 and spans[i - 1][1] >= e.time_range.end
        for k in e.kernels:
            linked += k.duration / 1e3
            if in_bn and group(k.name) is None:
                bn += k.duration / 1e3
    groups["train-mode BN (elementwise, reductions)"] = bn
    groups["other (elementwise, copies, reductions, geometry)"] = rest - bn
    busy = sum(groups.values())
    require(busy > 0, "the profiler recorded no device time")
    for name in ("K1 soft-argmax", "K2 soft-argmax backward"):
        require(groups[name] > 0, f"no kernel of the group {name} in the "
                                  f"profile of a train step")
    print(f"# profile train step ({TRAIN_PAIRS} pairs, use_3d): device busy "
          f"{busy:.3f} ms of {wall_ms:.3f} ms wall (idle "
          f"{100 * (1 - busy / wall_ms):.0f}%), {launches} kernel launches; "
          f"{100 * linked / busy:.0f}% of device time linked to a CPU op")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"#   {name}: {ms:.3f} ms ({100 * ms / busy:.0f}%)")
    conv_ms = groups["cuDNN/cuBLAS conv and matmul"]
    print(f"# train step convolutions: {conv_flop / 1e12:.3f} TFLOP forward "
          f"and backward, {conv_flop / conv_ms / 1e9:.1f} TFLOP/s in the "
          f"cuDNN/cuBLAS group (fp32 peak {FP32_FLOPS / 1e12:.0f})")
    return {"busy_ms": busy, "wall_ms": wall_ms, "launches": launches,
            "linked_ms": linked, "groups": groups,
            "conv_tflop": conv_flop / 1e12}


def main():
    args = sys.argv[1:]
    if args not in ([], ["--kernels"]):
        sys.exit("usage: python3 chip_smoke.py [--kernels]")
    kernels_only = args == ["--kernels"]
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs a CUDA device")
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.ops._build import build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # fp32 references and the fp32 train step run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build(["fused_bottleneck", "softargmax"])
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"# nvcc {name}: {line.strip()}")
    print(f"# build: nvcc {time.perf_counter() - t0:.1f} s")

    phases = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t
        return out

    gen = torch.Generator().manual_seed(SEED)
    err_k1 = phase("K1 check", check_softargmax, dev, gen)
    err_k2 = phase("K2 check", check_softargmax_bwd, dev, gen)
    err_k3 = phase("K3 check", check_bottleneck, dev, gen)

    if kernels_only:
        times = {"K1": phase("K1 timing", time_softargmax, dev, gen),
                 "K2": phase("K2 timing", time_softargmax_bwd, dev, gen),
                 "K3": phase("K3 timing", time_bottleneck, dev, gen)}
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"kernel_times": times}))
        return

    cfg = load_config("configs/mads_3d.yaml")
    inf, serve_launches, _ = phase("serving path", run_path, cfg, dev)
    k1 = phase("K1 timing", time_softargmax, dev, gen)
    k2 = phase("K2 timing", time_softargmax_bwd, dev, gen)
    k3 = phase("K3 timing", time_bottleneck, dev, gen)
    serving = phase("serving timing", time_serving, inf, dev)
    prof = phase("serving profile", profile_serving, inf, dev, TIMING_PAIRS,
                 serving[TIMING_PAIRS]["ms"])

    train = phase("training path", run_train, cfg, dev)
    train_launches, train_summary = train["launches"], train["summary"]
    train_prof = phase("train profile", profile_train, train,
                       train["summary"]["step_ms"])
    start_sd = train["start_sd"]
    del inf, train
    vs_cpu = phase("train card vs CPU", train_vs_cpu, cfg, start_sd, dev)

    def launch_counts(key):
        by_path = {"serving": serve_launches[key],
                   "training": train_launches[key]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    kernels = [
        dict(name="soft_argmax_fwd", route="cuda",
             source="fast3dhpe_tpu_torch/csrc/softargmax.cu",
             replaces="fast3dhpe_tpu/ops/pallas_softargmax.py:64",
             max_abs_err=err_k1, **launch_counts("soft_argmax"), **k1),
        dict(name="soft_argmax_bwd", route="cuda",
             source="fast3dhpe_tpu_torch/csrc/softargmax.cu",
             replaces="fast3dhpe_tpu/ops/pallas_softargmax.py:79",
             max_abs_err=err_k2, **launch_counts("soft_argmax_bwd"), **k2),
        dict(name="fused_bottleneck", route="cuda",
             source="fast3dhpe_tpu_torch/csrc/fused_bottleneck.cu",
             replaces="fast3dhpe_tpu/ops/pallas_bottleneck.py:191",
             max_abs_err=err_k3,
             shape=(f"one forward's launches at {2 * TIMING_PAIRS} images: "
                    f"layer1.0 + 3 x layer2.x"),
             **launch_counts("fused_bottleneck"), **k3),
    ]
    print(json.dumps({"serving": {str(k): v for k, v in serving.items()},
                      "profile": prof}))
    print(json.dumps({"train": train_summary, "train_profile": train_prof,
                      "train_vs_cpu": vs_cpu}))
    print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in phases.items()))
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
