"""Drive the PyTorch/CUDA port (fast3dhpe_tpu_torch) on one GPU.

    python3 chip_smoke.py             # everything below
    python3 chip_smoke.py --kernels   # steps 1, 2 and the kernel timings
    python3 chip_smoke.py --slice6    # steps 1-3, 5, 8a and 11

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
6. Input pipeline: builds a DeviceFrameCache of 1024 seeded 768x1024
   uint8 frames (2.4 GB) on the card, and one at half the budget that
   must keep an even partial prefix; checks the pipeline's output there
   (occluded pixels gray 128, the rest the eval output, target weights
   recomputed from the keep-masks, Cutout's gate share and holes over 512
   samples, Hide-and-Seek's 6 of 16 cells, an eval batch against the
   CPU); trains CDRNet-101 through make_train_epoch_cdr from the cache
   with CUTOUT (a warmup and a use_3d epoch of 3 steps: one K1 and one K2
   launch a step, no K3, finite sums, the loss arithmetic, the parameters
   moved); times the pipeline alone and a pipeline-fed step beside the
   precomputed-batch step.
7. Raw-frame serving: three requests of four raw pairs from the cache
   through predict_batch(..., trans=...) (1 K1 + 0 K2 + 4 K3 launches a
   request), one against the CPU, and raw against pre-warped requests
   timed at batch 1 and 32.
8. Host data, from JPEGs on disk in a temporary directory:
   a. writes a MADS tree at MADS's frame size (768x1024; train 2 movements
      x 45 frames, valid 1 x 40, a NaN joint every 7th frame) and an MPII
      tree with data/synthetic.py; names the JPEG decoder in use, times
      its decode rate over the 260 MADS frames with 1 and 4 threads, and
      holds one decoded frame of each view against its rendered source;
   b. trains CDRNet-101 (configs/mads_3d.yaml, fp32, CUTOUT) through
      load_data -> Stereo3DLoader.stacked_epoch -> make_train_epoch_cdr
      with the tree whole on the card (a warmup and a use_3d epoch of 3
      steps): shapes, row_valid, cache rows against the decoded frames,
      the loss arithmetic, one K1 and one K2 launch a step, no K3;
   c. then with half the tree on the card (partial cache): two epochs of
      Stereo3DLoader iteration through make_train_step_cdr, fixed lanes,
      every record once an epoch, stacked_epoch refused; the step beside
      b's, with the upload lane's bytes and host decode ms a step;
   d. PoseResNet-101 from Mono2DLoader: two MPII steps from host batches
      padded to multiples of 128 and warped on the card, and a stacked
      MADS_2d epoch from the cache (finite losses, no kernel launched);
   e. evaluate_movement of valid/HipHop by the serving phase's bf16
      inferencer with the movement whole on the card, half on it, a
      batch-aligned part on it, and streamed: one K1 and four K3 launches
      a batch, MPJPE2D within 1e-3 relative in all four and MPJPE3D in the
      three whose batches hold the same frames, frames/s of each; the
      same frames' predictions at other rows of a batch; one batch's
      first rows against the CPU.
9. Card vs CPU: one train step with and one without the 3D loss at 2
   pairs (one padded), full width, from the same weights and batch on the
   card and on the CPU: losses, grad_norm, every gradient and the BN
   statistics, beside how far rounding-sized noise moves them on the CPU.
10. The CLI apps at full width, on the trees of step 8 (an app is
    called through its `main(argv)`, with the kernels' counts set to 0
    just before and read just after):
   a. `train` (configs/mads_2d.yaml: PoseResNet-101, fp32), 2 epochs of
      loader iteration: finite history, latest.pth loads strict, no kernel
      launched;
   b. `train_cdr` (configs/mads_3d.yaml: CDRNet-101, fp32, CUTOUT) from
      a's latest.pth, 3 epochs with WARMUP 1 and the LR / 10 from epoch 4,
      stacked from the card: before the first step the encoder is a's bit
      for bit and the rest a fresh seeded init; latest.pth, latest.opt.pt
      and best.pth (of the last epoch, the only one after the warmup);
      one K1 a train step and an eval batch, one K2 a train step, no K3;
   c. the same command without --overwrite raises FileExistsError and
      leaves the files byte for byte;
   d. the optimizer state a resume loads equals the saved one; then
      `python -m fast3dhpe_tpu_torch.apps.train_cdr --resume` as a
      subprocess with EPOCH 4: exit 0, one epoch, Adam's step and the
      train step continue from the saved step at LR / 10, best.pth
      rewritten only if MPJPE3D improved;
   e. `inference --bf16 --fused_inference --movement all`: one K1 and four
      K3 a batch, no K2; the printed MPJPEs against evaluate_movement on
      the same weights; with --save_frames 3 its GIF and test.jpg decode,
      or, where matplotlib is missing, render_frames raises an ImportError
      that names it and the cv2 2D overlays are drawn, written and
      decoded instead (a line says so);
   f. `baseline` on a's weights: finite MPJPE, no kernel; one batch
      against the CPU (pred_2d equal but at near-ties of a heatmap's
      maximum, pred_3d within 1e-3 where pred_2d agrees);
   g. dlt_triangulate by jacobi, svd and sii and triangulate_closed_form
      on 32 x 19 systems, against the CPU: launches, device and host ms;
   h. prints each epoch's wall time, checkpoint bytes and save ms
      (synchronous and asynchronous), the resume load ms and the apps'
      frames/s beside the card's name and power limit.
11. Slice 6, CDRNet-101 at 256 px on the serving phase's weights (a
    train step's calibrated head for b-e), each path with the kernels'
    counts set to 0 just before and read just after:
   a. int8 serving: CDRNetInferencer(int8=True) calibrates a pack on 8
      batches of 16 seeded pairs and writes it; 3 requests of 32 pairs
      (1 K1, 0 K2, 0 K3 each); 2 pairs of one against the CPU's int8 path
      on the same pack: every int8 code before cf_out bit-equal, cf_out's
      (after the bf16 trunk) flipped in at most CF_FLIPS by one code, the
      decoder on the CPU's cf_out codes bit-equal, heatmaps, pred_2d and
      pred_3d within the serving phase's bounds; the request against the
      bf16 fused one (heatmap correlation > 0.99, max error < 0.12 of the
      max); both timed (wall, device busy by kernel group, peak memory);
   b. `inference --bf16 --fused_inference`, `inference --int8 --int8_pack`
      (calibrating on the tree, writing the pack) and the same from the
      pack with no fp checkpoint, on valid/HipHop: MPJPEs side by side,
      the pack's run equal to the calibrating one, launches;
   c. exports fp32 and int8 at batch 32 (torch.export), saves them, loads
      each in a new process that imports only fast3dhpe_tpu_torch.export,
      and holds its call against predict_batch on the same frames (rtol
      1e-4, atol 1e-3): one K1 launch inside each loaded call; a float
      frame raises TypeError and a wrong batch ValueError; export seconds,
      artifact bytes;
   d. bf16 training: the train-mode BN layer on a bf16 input against the
      CPU; the step at 32 pairs (4 padded, converging_rig) against the
      card's fp32 step from the same weights (losses, encoder.bn1's
      output; see BF16_LOSS_TOL), and at 2 pairs against the CPU's bf16
      step; its time, device busy, peak memory, 1 K1 + 1 K2 a step and
      K2's dtype; one `train_cdr --bf16` epoch on the tree;
   e. remat: fp32 steps with remat None and "convs" against the plain
      step (cuDNN deterministic): loss, gradients and BN statistics equal;
      peak memory and step ms of all three at 32 and 96 pairs.
12. Prints a {"kernels": [...]} line and, last, {"ok": true, ...}.

It needs one CUDA device. Without one, or when any phase fails, it exits
non-zero and prints no result.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
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
PROFILE_TRIES = 3


def device_ms(fn, kernel, cold, iters=30, warmup=3):
    """Median device duration in ms of the CUDA kernels whose name contains
    `kernel`, one a call of fn(), under torch.profiler (CUPTI). cold: a
    128 MiB buffer is read before each call, so the kernel finds its
    inputs in HBM and not in the 50 MB L2, and the L2 holds no dirty lines
    whose write-back would bill the kernel (the number held against the
    HBM bound); warm: the calls run back to back. The profile sometimes
    holds fewer kernel records than calls (25 of 30 in one H100 run), so
    the median is taken over those it holds. Once it held 3 of 30, so a
    profile that holds fewer than half the calls is taken again, up to
    PROFILE_TRIES times in all, and then it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
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
        if len(times) < iters:
            print(f"# device_ms: {len(times)} records of *{kernel}* for "
                  f"{iters} calls (profile {attempt + 1})")
        if 2 * len(times) >= iters:
            return statistics.median(times)
    raise RuntimeError(f"chip_smoke: {PROFILE_TRIES} profiles each held "
                       f"fewer than half the {iters} kernels named "
                       f"*{kernel}* (the last {len(times)})")


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


def kernel_counters():
    from fast3dhpe_tpu_torch.ops.bottleneck import fused_bottleneck
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fused)
    return {"soft_argmax": soft_argmax_fused,
            "soft_argmax_bwd": soft_argmax_bwd_fused,
            "fused_bottleneck": fused_bottleneck}


def serve_counted(inf, requests, n_fused, what):
    """predict_batch(*request) for each request, with the kernels' launch
    counts set to 0 just before and read just after: each request must
    launch K1 once, K2 never and K3 once per fused block; outputs of the
    request's shapes, finite."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    outs = [inf.predict_batch(*req) for req in requests]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    n = len(requests)
    print(f"# {what}: {n} requests x {len(requests[0][0])} pairs, launches "
          f"{launches}")
    require(launches == {"soft_argmax": n, "soft_argmax_bwd": 0,
                         "fused_bottleneck": n * n_fused},
            f"{what}: {n} requests launched K1/K2/K3 {launches}, not "
            f"{n}/0/{n * n_fused}")
    for req, (kp, p3d) in zip(requests, outs):
        pairs = len(req[0])
        require(kp.shape == (pairs, 2, 19, 2) and p3d.shape == (pairs, 19, 3),
                f"{what}: output shapes {tuple(kp.shape)}, "
                f"{tuple(p3d.shape)}")
        require(bool(torch.isfinite(kp).all() and torch.isfinite(p3d).all()),
                f"{what}: non-finite output")
    return outs, launches


def run_path(cfg, dev):
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

    outs, launches = serve_counted(inf, requests, len(fused), "path")

    # one request against the same module on the CPU
    t0 = time.perf_counter()
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu_inf = seeded_inferencer(cfg, "cpu", state_dict=sd)
    img_l, img_r, proj = requests[0]
    check_vs_cpu(model, cpu_inf.model, normalized(img_l, img_r, dev),
                 normalized(img_l, img_r, "cpu"), proj, outs[0][0],
                 "path vs CPU", t0)
    return inf, launches, cpu_inf


def check_vs_cpu(model, cpu_model, imgs, cpu_imgs, proj, served_kp, what,
                 t0):
    """One request's heatmaps, pred_2d and pred_3d on the card against the
    same module on the CPU, from the same normalised images; served_kp is
    what predict_batch returned for them."""
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    dev = imgs.device
    pairs = proj.shape[0]
    with torch.inference_mode():
        gkp, gp3d, ghm = model(imgs, torch.as_tensor(proj, device=dev),
                               return_heatmaps=True)
        ckp, cp3d, chm = cpu_model(cpu_imgs, torch.as_tensor(proj).cpu(),
                                   return_heatmaps=True)
        # the GPU's geometry against the CPU's on the GPU's own keypoints
        proj_j = torch.as_tensor(proj).cpu()[:, None].expand(
            pairs, 19, 2, 3, 4)
        ref3 = dlt_triangulate(proj_j, gkp.cpu().transpose(1, 2))
    torch.testing.assert_close(gkp, served_kp, rtol=0, atol=0)
    ghm, chm = ghm.float().cpu(), chm.float()
    hm_scale = chm.abs().max().item()
    hm_max = (ghm - chm).abs().max().item() / hm_scale
    hm_mean = (ghm - chm).abs().mean().item() / hm_scale
    kp_err = (gkp.cpu() - ckp).abs().max().item()
    p3_rel = ((gp3d.cpu() - ref3).norm(dim=-1)
              / ref3.norm(dim=-1)).max().item()
    p3_cpu_rel = ((gp3d.cpu() - cp3d).norm(dim=-1)
                  / cp3d.norm(dim=-1)).median().item()
    print(f"# {what} ({time.perf_counter() - t0:.1f} s): heatmaps max "
          f"{hm_max:.3g} / mean {hm_mean:.3g} of max|cpu| {hm_scale:.3g}; "
          f"pred_2d max {kp_err:.3g} px; pred_3d vs CPU DLT of the GPU's "
          f"pred_2d {p3_rel:.3g} relative; pred_3d vs the CPU run, median "
          f"{p3_cpu_rel:.3g} relative; pred_2d spread "
          f"{gkp.std().item():.3g} px")
    # bf16 bounds of tests/test_pallas_kernels.py:116-119: cuDNN and
    # oneDNN round bf16 convolutions differently
    require(hm_max < 0.05 and hm_mean < 0.005,
            f"{what}: heatmaps differ from the CPU run: max {hm_max}, mean "
            f"{hm_mean}")
    # with unit-spread logits those heatmap errors move a centre of mass by
    # a fraction of a heatmap pixel (4 image pixels)
    require(kp_err < 2.0,
            f"{what}: pred_2d differs from the CPU run by {kp_err} px")
    # fp32 Jacobi SVD on either device, same keypoints
    require(p3_rel < 1e-3,
            f"{what}: pred_3d differs from the CPU DLT by {p3_rel}")
    return {"hm_max": hm_max, "hm_mean": hm_mean, "kp_px": kp_err,
            "p3_rel": p3_rel}


# ---------------------------------------------------------------- training

def converging_rig(batch, size=256, height=None):
    """bench.py's intrinsics and camera centres (x = -+400 mm, 3000 mm from
    the origin), each camera turned toward the origin. bench.py's own rig
    keeps the axes parallel, and at 3 m each camera sees only
    128 * 3000 / 1100 = 349 mm either side of its axis, which lies 400 mm
    off the origin: no pose near the origin projects into both views.
    size: the image width; height: its height if it is not square (f then
    scales with the shorter side, the principal point is the centre)."""
    height = size if height is None else height
    f = 1100.0 * min(size, height) / 256
    K = np.array([[f, 0.0, size / 2], [0.0, f, height / 2],
                  [0.0, 0.0, 1.0]])
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


# ---------------------------------------------------------- input pipeline

RAW_H, RAW_W = 768, 1024          # MADS frames (fast3dhpe_tpu/ops/warp.py)
CACHE_PAIRS = 512                 # 1024 frames, 2.4 GB resident
EPOCH_BATCHES = 3                 # S: an epoch of 3 batches of TRAIN_PAIRS
OCCL_BATCHES = 16                 # 512 samples for the Cutout statistics
OCCL_PROB = 0.3                   # device_pipeline.py's gate
CUTOUT_HOLES, CUTOUT_LEN = 6, 40  # ops/occlusion.py's defaults
HNS_HIDDEN, HNS_CELLS = 6, 4      # int(0.4 * 16) of a 4 x 4 grid
# the CPU tests' warp bound (tests/test_torch_pipeline_ops.py: 1e-3
# intensity levels) over the smallest ImageNet std, in normalised units
IMAGE_TOL = 1e-3 / 255.0 / 0.224
META_TOL = 1e-4                   # proj, targets, weights: of max|cpu|


def frame_paths(pairs):
    return [f"pair{i:04d}_{v}" for i in range(pairs) for v in "lr"]


def decode_frames(paths):
    """The cache's decode_batch: a seeded uint8 768x1024x3 frame a path."""
    return [np.random.default_rng([SEED, int(p[4:8]), int(p.endswith("r"))])
            .integers(0, 256, (RAW_H, RAW_W, 3), dtype=np.uint8)
            for p in paths]


def build_cache(dev):
    """The frame cache of CACHE_PAIRS stereo pairs on the card, through
    DeviceFrameCache.build in chunks of 64 with a budget that fits, and a
    second build at half that budget (plus one frame) with allow_partial
    and pair_stride=2, which must keep an even prefix."""
    from fast3dhpe_tpu_torch.data.device_cache import DeviceFrameCache
    paths = frame_paths(CACHE_PAIRS)
    frame = RAW_H * RAW_W * 3
    budget = len(paths) * frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = DeviceFrameCache.build(paths, decode_frames, budget,
                                   chunk_frames=64, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(cache is not None and not cache.partial
            and tuple(cache.frames.shape) == (len(paths), RAW_H, RAW_W, 3)
            and cache.frames.is_cuda,
            f"the full cache build gave {cache and cache.frames.shape}")
    for p in (paths[0], paths[64], paths[-1]):      # first, second chunk
        row = int(cache.rows([p])[0])
        require(torch.equal(cache.frames[row].cpu(),
                            torch.from_numpy(decode_frames([p])[0])),
                f"cache row {row} is not the frame of {p}")
    t0 = time.perf_counter()
    half = DeviceFrameCache.build(paths, decode_frames, budget // 2 + frame,
                                  chunk_frames=64, allow_partial=True,
                                  pair_stride=2, device=dev)
    torch.cuda.synchronize()
    half_s = time.perf_counter() - t0
    rows = half.frames.shape[0]
    require(half.partial and rows == len(paths) // 2
            and half.has(paths[rows - 1]) and not half.has(paths[rows]),
            f"the half-budget build kept {rows} rows, partial {half.partial}")
    del half
    torch.cuda.empty_cache()
    print(f"# cache: {len(paths)} frames of {RAW_H}x{RAW_W} uint8, "
          f"{cache.nbytes / 1e9:.3f} GB resident, built in {build_s:.1f} s "
          f"(decode + copy, chunks of 64); half budget: partial, {rows} "
          f"rows, {half_s:.1f} s")
    return cache, {"frames": len(paths), "nbytes": cache.nbytes,
                   "build_s": build_s, "partial_rows": rows,
                   "partial_build_s": half_s}


def raw_rig(batch):
    """converging_rig for the raw frame as (B, 2, 4, 4)."""
    P = np.zeros((batch, 2, 4, 4), np.float32)
    P[:, :, :3] = converging_rig(batch, RAW_W, RAW_H)
    P[:, :, 3, 3] = 1.0
    return P


def stacked_meta(cache, cfg, rng, batches, pad):
    """`batches` stacked batches of TRAIN_PAIRS cached pairs, as
    Stereo3DLoader.stacked_epoch stacks them: a shuffle of the pairs, the
    last `pad` rows padded (repeating the last pair); each row's train-time
    scale and rotation drawn as data/loader.py:154-159 draws them, its
    affine from get_affine_transform (centre = frame centre, origin_size =
    min(H, W)); the raw rig; poses within +-250 mm; 5% of joints
    invisible."""
    from fast3dhpe_tpu_torch.geometry.affine import get_affine_transform
    n = batches * TRAIN_PAIRS
    order = rng.permutation(CACHE_PAIRS)[:n - pad]
    order = np.concatenate([order, np.repeat(order[-1:], pad)])
    sf, rf = cfg.DATASET.SCALE_FACTOR, cfg.DATASET.ROT_FACTOR
    trans = []
    for _ in range(n):
        s = np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
        r = (np.clip(rng.randn() * rf, -rf * 2, rf * 2)
             if rng.random_sample() <= 0.6 else 0.0)
        trans.append(get_affine_transform((RAW_W / 2, RAW_H / 2), s, r,
                                          min(RAW_H, RAW_W),
                                          cfg.MODEL.IMAGE_SIZE))
    P = raw_rig(n)
    row_valid = np.ones(n, np.float32)
    row_valid[n - pad:] = 0.0
    paths = frame_paths(CACHE_PAIRS)
    xs = {"idx_l": cache.rows([paths[2 * i] for i in order]),
          "idx_r": cache.rows([paths[2 * i + 1] for i in order]),
          "trans": np.stack(trans).astype(np.float32),
          "P_l": P[:, 0], "P_r": P[:, 1],
          "pose_3d": rng.uniform(-250, 250, (n, 19, 3)).astype(np.float32),
          "joints_vis": (rng.rand(n, 19) > 0.05).astype(np.float32),
          "row_valid": row_valid}
    return {k: v.reshape((batches, TRAIN_PAIRS) + v.shape[1:])
            for k, v in xs.items()}


def pipeline_batch(frames, xs, i, cfg, gen=None, occlusion=None,
                   train=False, return_masks=False):
    """Batch i of the stacked metadata xs through the cached stereo
    pipeline, on the frames' device."""
    from fast3dhpe_tpu_torch.data.device_pipeline import (
        preprocess_stereo_batch_cached)
    return preprocess_stereo_batch_cached(
        gen, frames, xs["idx_l"][i], xs["idx_r"][i], xs["trans"][i],
        xs["P_l"][i], xs["P_r"][i], xs["pose_3d"][i], xs["joints_vis"][i],
        image_size=tuple(cfg.MODEL.IMAGE_SIZE), occlusion=occlusion,
        train=train, return_masks=return_masks)


def on_card(xs, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in xs.items()}


def expected_weight(t2d, vis, keep):
    """target_weight recomputed on the host: joints_vis x both views'
    boundary checks x the keep-mask at each joint's truncated pixel, with
    the -1 of an out-of-image joint wrapping to the last pixel. t2d: the
    eval-mode (unchecked) (B, 2, J, 2); keep: (B, 2, H, W)."""
    H, W = keep.shape[-2:]
    inside = ((t2d[..., 0] >= 0) & (t2d[..., 0] < W) & (t2d[..., 1] >= 0)
              & (t2d[..., 1] < H))
    want = vis * inside[:, 0] * inside[:, 1]
    rows = np.arange(len(vis))[:, None]
    for v in (0, 1):
        xy = np.where(inside[:, v, :, None], t2d[:, v], -1.0).astype(
            np.int32)
        want = want * keep[rows, v, xy[..., 1], xy[..., 0]]
    return want


def cutout_holes_needed(hidden):
    """The fewest CUTOUT_LEN-square holes that could make up a hidden mask
    (H, W): a connected union of n such squares has a bounding box of at
    most n * CUTOUT_LEN on each side and at most n * CUTOUT_LEN^2 pixels."""
    from scipy import ndimage
    labels, n = ndimage.label(hidden)
    need = 0
    for sl, k in zip(ndimage.find_objects(labels), range(1, n + 1)):
        h, w = sl[0].stop - sl[0].start, sl[1].stop - sl[1].start
        area = int((labels[sl] == k).sum())
        need += max(-(-h // CUTOUT_LEN), -(-w // CUTOUT_LEN),
                    -(-area // CUTOUT_LEN ** 2))
    return need


def check_pipeline(cache, cfg, dev):
    """The pipeline's output on the card: the keep-mask invariants, the
    target weights recomputed from the masks, the occlusion statistics of
    Cutout (OCCL_BATCHES x 32 samples) and Hide-and-Seek (one batch), and
    one eval batch against the same function on the CPU."""
    from fast3dhpe_tpu_torch.data.device_pipeline import (
        preprocess_stereo_batch)
    from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 5)
    xs = stacked_meta(cache, cfg, rng, OCCL_BATCHES, 0)
    dxs = on_card(xs, dev)
    out = {}

    # keep-mask invariants and target weights, batch 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    occ = pipeline_batch(cache.frames, dxs, 0, cfg, gen, "CUTOUT", True, True)
    ev = pipeline_batch(cache.frames, dxs, 0, cfg)
    keep = occ["keep_mask"]
    gray = normalize_imagenet(torch.full((3,), 128.0, device=dev))
    hidden = int((~keep).sum())
    require(hidden > 0, "Cutout hid nothing in a batch of 32")
    require(torch.equal(occ["image"][~keep], gray.expand(hidden, 3)),
            "an occluded pixel is not normalize_imagenet(128)")
    require(torch.equal(occ["image"][keep], ev["image"][keep]),
            "a kept pixel differs from the eval-mode output")
    want = expected_weight(ev["target_2d"].cpu().numpy(),
                           xs["joints_vis"][0], keep.cpu().numpy())
    got = occ["target_weight"].cpu().numpy()
    require(np.array_equal(got, want),
            f"target_weight differs from joints_vis x boundary x keep in "
            f"{int((got != want).sum())} joints")
    print(f"# pipeline masks: {hidden} occluded pixels are gray 128, the "
          f"rest equal the eval output; target_weight = vis x boundary x "
          f"keep ({int(want.sum())} of {want.size} joints weighted)")

    # Cutout statistics: one gate a sample for both views, the gated
    # share, and at most 6 holes of at most 40 x 40 an image
    gated, holes = [], []
    for i in range(OCCL_BATCHES):
        gen = torch.Generator(device=dev).manual_seed(SEED * 1000 + i)
        k = pipeline_batch(cache.frames, dxs, i, cfg, gen, "CUTOUT", True,
                           True)["keep_mask"].cpu().numpy()
        g = (~k).any(axis=(2, 3))                          # (B, 2)
        require(np.array_equal(g[:, 0], g[:, 1]),
                f"batch {i}: a sample was occluded in one view only")
        gated.append(g[:, 0])
        holes += [cutout_holes_needed(~k[b, v]) for b in np.flatnonzero(
            g[:, 0]) for v in (0, 1)]
    gated = np.concatenate(gated)
    share, n = float(gated.mean()), len(gated)
    sigma = (OCCL_PROB * (1 - OCCL_PROB) / n) ** 0.5
    require(abs(share - OCCL_PROB) <= 4 * sigma,
            f"Cutout gated {share:.4f} of {n} samples, not within 4 sigma "
            f"({4 * sigma:.4f}) of {OCCL_PROB}")
    require(max(holes) <= CUTOUT_HOLES,
            f"a gated image needs {max(holes)} holes of {CUTOUT_LEN} px")
    out["cutout"] = {"samples": n, "gated_share": share,
                     "four_sigma": 4 * sigma, "max_holes": max(holes)}

    # Hide-and-Seek: exactly 6 of the 16 64x64 cells of a gated image
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k = pipeline_batch(cache.frames, dxs, 0, cfg, gen, "HNS", True,
                       True)["keep_mask"].cpu().numpy()
    H = k.shape[-1] // HNS_CELLS
    cells = (~k).reshape(TRAIN_PAIRS, 2, HNS_CELLS, H, HNS_CELLS, H)
    whole = cells.all(axis=(3, 5))
    require(np.array_equal(whole, cells.any(axis=(3, 5))),
            "Hide-and-Seek hid part of a cell")
    count = whole.sum(axis=(2, 3))                         # (B, 2)
    g = count > 0
    require(np.array_equal(g[:, 0], g[:, 1]) and g.any()
            and (count[g] == HNS_HIDDEN).all(),
            f"Hide-and-Seek hid {sorted(set(count[g].tolist()))} cells")
    out["hns"] = {"gated": int(g[:, 0].sum()), "cells_hidden": HNS_HIDDEN}
    print(f"# pipeline occlusion: Cutout gated {share:.4f} of {n} samples "
          f"(0.3 +- {4 * sigma:.4f}), one gate for both views, at most "
          f"{max(holes)} holes of 40 px an image; Hide-and-Seek hid exactly "
          f"6 of 16 cells in each of {int(g[:, 0].sum())} gated samples")

    # one eval batch on the card against the same function on the CPU
    rows_l = torch.as_tensor(xs["idx_l"][0], device=dev).long()
    rows_r = torch.as_tensor(xs["idx_r"][0], device=dev).long()
    cpu = preprocess_stereo_batch(
        None, cache.frames.index_select(0, rows_l).cpu(),
        cache.frames.index_select(0, rows_r).cpu(), xs["trans"][0],
        xs["P_l"][0], xs["P_r"][0], xs["pose_3d"][0], xs["joints_vis"][0],
        image_size=tuple(cfg.MODEL.IMAGE_SIZE))
    err = {"image": (ev["image"].cpu() - cpu["image"]).abs().max().item()}
    for key in ("proj", "target_2d", "target_weight", "target_3d"):
        err[key] = ((ev[key].cpu() - cpu[key]).abs().max()
                    / cpu[key].abs().max()).item()
    require(err["image"] <= IMAGE_TOL,
            f"pipeline image differs from the CPU's by {err['image']:.3g} "
            f"(bound {IMAGE_TOL:.3g})")
    require(all(err[k] <= META_TOL for k in err if k != "image"),
            f"pipeline proj/targets/weights differ from the CPU's: {err}")
    out["vs_cpu"] = err
    print(f"# pipeline vs CPU (eval batch of {TRAIN_PAIRS} pairs): image "
          f"max {err['image']:.3g} (bound {IMAGE_TOL:.3g}), "
          + ", ".join(f"{k} {err[k]:.3g}" for k in err if k != "image")
          + f" of max|cpu| (bound {META_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def profile_calls(fn, calls=5):
    """Device time and the number of device activities (kernels, copies,
    fills) of one fn() call, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    busy = sum((e.time_range.end - e.time_range.start) / 1e3 for e in ks)
    require(busy > 0, "the profiler recorded no device time")
    return {"device_ms": busy / calls, "launches": len(ks) / calls}


def run_pipeline_train(cfg, dev, cache, precomputed_step_ms):
    """make_train_epoch_cdr from the cache at full width: one warmup and one
    use_3d epoch of EPOCH_BATCHES batches of TRAIN_PAIRS pairs (the last
    TRAIN_PAD rows padded), the config's occlusion (CUTOUT), fp32. Then the
    pipeline alone and a pipeline-fed step are timed."""
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_train_epoch_cdr
    t0 = time.perf_counter()
    xs = stacked_meta(cache, cfg, np.random.RandomState(SEED + 6),
                      EPOCH_BATCHES, TRAIN_PAD)
    dxs = on_card(xs, dev)
    model = seeded_train_model(cfg).to(dev)
    first = pipeline_batch(cache.frames, dxs, 0, cfg, train=True)
    first["row_valid"] = dxs["row_valid"][0]
    calibrate_train_head(model, first)
    state = TrainState.create(model, cfg, steps_per_epoch=EPOCH_BATCHES)
    occlusion = cfg.DATASET.OCCLUSION
    epoch = make_train_epoch_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
        cfg.MODEL.IMAGE_SIZE, occlusion=occlusion,
        loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
        num_joints=cfg.MODEL.NUM_JOINTS)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = kernel_counters()
    launches = {k: 0 for k in counters}
    epochs = []
    for seed, use_3d in ((0, False), (1, True)):
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        m = epoch(state, cache.frames, dxs, seed, use_3d)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        n = {k: c.launches for k, c in counters.items()}
        m = {k: v.item() for k, v in m.items()}
        print(f"# pipeline epoch seed {seed} use_3d={use_3d} "
              f"({EPOCH_BATCHES} steps, {occlusion}): {wall:.1f} ms, "
              f"launches {n}, summed "
              + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
        require(n == {"soft_argmax": EPOCH_BATCHES,
                      "soft_argmax_bwd": EPOCH_BATCHES,
                      "fused_bottleneck": 0},
                f"an epoch of {EPOCH_BATCHES} steps launched {n}, not one "
                f"K1 and one K2 a step and no K3")
        require(all(np.isfinite(v) for v in m.values()),
                f"non-finite epoch metrics {m}")
        if use_3d:
            want = m["loss_2d"] + cfg.TRAIN.LOSS_3D_WEIGHT * m["loss_3d"]
            require(abs(m["loss"] - want) <= 1e-6 * abs(want),
                    f"summed loss {m['loss']} is not loss_2d + "
                    f"{cfg.TRAIN.LOSS_3D_WEIGHT} loss_3d = {want}")
        else:
            require(m["loss"] == m["loss_2d"],
                    f"warmup epoch: loss {m['loss']} != loss_2d "
                    f"{m['loss_2d']}")
        for k in launches:
            launches[k] += n[k]
        epochs.append({"use_3d": use_3d, "wall_ms": wall, "metrics": m,
                       "launches": n})
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), params0[n])]
    require(not still, f"unchanged after two pipeline epochs: {still}")

    # the pipeline alone, a batch of TRAIN_PAIRS pairs with Cutout
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def pipeline():
        return pipeline_batch(cache.frames, dxs, 0, cfg, gen, occlusion,
                              True)

    timing = {"call_ms": call_ms(pipeline), "host_ms": host_ms(pipeline)}
    timing.update(profile_calls(pipeline))
    walls = []
    for seed in range(2, 4):                       # pipeline-fed steps
        t = time.perf_counter()
        epoch(state, cache.frames, dxs, seed, True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / EPOCH_BATCHES)
    timing["fed_step_ms"] = statistics.median(walls)
    timing["precomputed_step_ms"] = precomputed_step_ms
    share = timing["device_ms"] / precomputed_step_ms
    print(f"# pipeline alone ({TRAIN_PAIRS} pairs, train, {occlusion}): "
          f"device {timing['device_ms']:.3f} ms in "
          f"{timing['launches']:.0f} launches (profiler), events "
          f"{timing['call_ms']:.3f} ms, host {timing['host_ms']:.3f} ms; "
          f"{100 * share:.2f}% of a precomputed step")
    print(f"# pipeline-fed step {timing['fed_step_ms']:.1f} ms (epochs of "
          f"{EPOCH_BATCHES}, {walls}) vs precomputed-batch step "
          f"{precomputed_step_ms:.1f} ms; phase {time.perf_counter() - t0:.1f}"
          f" s")
    return {"launches": launches, "epochs": epochs, "timing": timing}


def raw_request(cache, first, pairs, cfg, dev):
    """`pairs` raw 768x1024 stereo pairs from the cache (already on the
    card), the eval-mode centre crop's affine and the cropped views'
    projections, as predict_batch(img_l, img_r, proj, trans) takes them."""
    from fast3dhpe_tpu_torch.geometry.affine import get_affine_transform
    paths = frame_paths(CACHE_PAIRS)
    trans = get_affine_transform((RAW_W / 2, RAW_H / 2), 1.0, 0.0,
                                 min(RAW_H, RAW_W), cfg.MODEL.IMAGE_SIZE)
    T = np.eye(4)
    T[:2, :3] = trans
    proj = (T @ raw_rig(1)[0].astype(np.float64))[:, :3].astype(np.float32)
    sel = range(first, first + pairs)
    rows = [torch.as_tensor(cache.rows([paths[2 * i + v] for i in sel]),
                            device=dev).long() for v in (0, 1)]
    return (cache.frames.index_select(0, rows[0]),
            cache.frames.index_select(0, rows[1]),
            torch.as_tensor(np.broadcast_to(proj, (pairs, 2, 3, 4)).copy(),
                            device=dev),
            torch.as_tensor(np.broadcast_to(trans.astype(np.float32),
                                            (pairs, 2, 3)).copy(),
                            device=dev))


def run_raw_serving(inf, cpu_model, cache, cfg, dev):
    """predict_batch(..., trans=...) on raw frames: REQUESTS requests of
    PAIRS pairs, counted; one against the CPU; then raw and pre-warped
    requests timed at batch 1 and 32 pairs."""
    from fast3dhpe_tpu_torch.ops.warp import affine_warp
    t0 = time.perf_counter()
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    requests = [raw_request(cache, k * PAIRS, PAIRS, cfg, dev)
                for k in range(REQUESTS)]
    fused = inf.model.encoder.fused_blocks(size, torch.bfloat16)
    outs, launches = serve_counted(inf, requests, len(fused), "raw serving")
    img_l, img_r, proj, trans = requests[0]
    vs_cpu = check_vs_cpu(
        inf.model, cpu_model,
        normalized(affine_warp(img_l, trans, size),
                   affine_warp(img_r, trans, size), dev),
        normalized(affine_warp(img_l.cpu(), trans.cpu(), size),
                   affine_warp(img_r.cpu(), trans.cpu(), size), "cpu"),
        proj.cpu().numpy(), outs[0][0], "raw serving vs CPU", t0)
    times = {}
    rng = np.random.RandomState(SEED + 7)
    for pairs in (1, TIMING_PAIRS):
        raw = raw_request(cache, 0, pairs, cfg, dev)
        pre_l, pre_r, _ = stereo_request(rng, pairs, size[0])
        pre = (torch.as_tensor(pre_l, device=dev),
               torch.as_tensor(pre_r, device=dev), raw[2])
        row = {"raw_ms": host_ms(lambda: inf.predict_batch(*raw)),
               "prewarped_ms": host_ms(lambda: inf.predict_batch(*pre))}
        if pairs == TIMING_PAIRS:
            for k, args in (("raw", raw), ("prewarped", pre)):
                p = profile_calls(lambda: inf.predict_batch(*args), calls=3)
                row[f"{k}_device_ms"] = p["device_ms"]
                row[f"{k}_launches"] = p["launches"]
        times[pairs] = row
        print(f"# raw serving batch {pairs}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items()))
    return {"launches": launches, "vs_cpu": vs_cpu, "times": times}


# --------------------------------------------------------------- host data

TREE_MOVEMENTS, TREE_TRAIN_FRAMES = ("HipHop", "Jazz"), 45   # 90 pairs
TREE_VALID_FRAMES = 40            # valid/HipHop: 2 batches, 24 rows padded
NAN_JOINT_EVERY = 7               # one NaN joint every 7th frame
DECODE_THREADS = (1, 4)
# A decoded frame against the frame the tree rendered: JPEG at quality 95
# with 4:2:0 chroma (cv2's and PIL's default) leaves at most 32-34 levels
# at the dots' coloured edges and 0.017-0.019 levels on average on these
# frames (cv2 and PIL alike); a frame of another pose or with swapped
# channels breaks one of the two bounds.
JPEG_MAX_TOL, JPEG_MEAN_TOL = 48, 0.05
EVAL_MOVEMENT = "HipHop"
EVAL_CPU_PAIRS = 4                # rows of one eval batch also run on the CPU
EVAL_REL_TOL = 1e-3               # the cache modes' MPJPEs agree
# evaluate_movement's cache budgets, in frames of the 80 (40 pairs) of
# valid/HipHop: whole, half (20 pairs: an index batch of 20, then 20
# streamed), 64 (32 pairs: the full cache's first batch, then its second
# streamed, so every batch holds the frames it holds with the whole
# movement resident) and none
EVAL_MODES = (("full cache", 80), ("partial cache", 40),
              ("partial cache, batch-aligned", 64), ("streamed", 0))


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_counts():
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    return counters


def read_counts(counters):
    sync()
    return {k: c.launches for k, c in counters.items()}


def require_counts(got, steps, k1, k2, k3, what):
    want = {"soft_argmax": k1 * steps, "soft_argmax_bwd": k2 * steps,
            "fused_bottleneck": k3 * steps}
    require(got == want, f"{what}: {steps} steps or batches launched "
                         f"K1/K2/K3 {got}, not {want}")


def write_trees(root):
    """The MADS tree at MADS's frame size (train: 2 movements x 45 frames;
    valid: 1 x 40; a NaN joint every 7th frame) and the default MPII tree
    (frames of mixed sizes), written by the port's data/synthetic.py. Then
    the decode route, its rate over the MADS frames with 1 and 4 threads,
    and one decoded frame of each view against the rendered source."""
    import glob
    import os
    from concurrent.futures import ThreadPoolExecutor
    from fast3dhpe_tpu_torch.data import native_jpeg, synthetic
    from fast3dhpe_tpu_torch.data.loader import _BatchDecoder
    t0 = time.perf_counter()
    mads, mpii = os.path.join(root, "mads"), os.path.join(root, "mpii")
    synthetic.make_synthetic_mads(
        mads, n_frames=TREE_TRAIN_FRAMES, movements=TREE_MOVEMENTS,
        img_w=RAW_W, img_h=RAW_H, splits=("train",),
        nan_joint_every=NAN_JOINT_EVERY)
    synthetic.make_synthetic_mads(
        mads, n_frames=TREE_VALID_FRAMES, movements=(EVAL_MOVEMENT,),
        img_w=RAW_W, img_h=RAW_H, splits=("valid",),
        nan_joint_every=NAN_JOINT_EVERY)
    synthetic.make_synthetic_mpii(mpii)
    write_s = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(mads, "**", "*.jpg"),
                             recursive=True))
    want = 2 * (len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES + TREE_VALID_FRAMES)
    require(len(paths) == want, f"the MADS tree holds {len(paths)} JPEGs, "
                                f"not {want}")
    rates = {}
    for threads in DECODE_THREADS:
        with ThreadPoolExecutor(threads) as pool:
            dec = _BatchDecoder(pool)
            t = time.perf_counter()
            if dec.route == "native":
                frames = native_jpeg.decode_batch(paths, RAW_H, RAW_W,
                                                  n_threads=threads)
            else:
                frames = dec(paths)
            rates[threads] = len(paths) / (time.perf_counter() - t)
        route = dec.name
    require(all(f.shape == (RAW_H, RAW_W, 3) for f in frames),
            "a decoded frame is not 768x1024x3")
    calibs = synthetic.synthetic_rig(RAW_W, RAW_H)
    err = {}
    for cam, view in (("cam_left", "left"), ("cam_right", "right")):
        src = synthetic._render_frame(synthetic._project(
            synthetic.synthetic_pose(0.0), calibs[cam]), RAW_W, RAW_H)
        path = os.path.join(mads, "train", TREE_MOVEMENTS[0], "Take_1",
                            view, "0000.jpg")
        got = frames[paths.index(path)].astype(np.int16)
        d = np.abs(got - src)
        err[view] = {"max": int(d.max()), "mean": float(d.mean())}
        require(d.max() <= JPEG_MAX_TOL and d.mean() <= JPEG_MEAN_TOL,
                f"decoded {path} differs from its rendered frame: {err[view]}"
                f" (bounds {JPEG_MAX_TOL} max, {JPEG_MEAN_TOL} mean)")
    print(f"# trees: {len(paths)} MADS JPEGs of {RAW_H}x{RAW_W} and an MPII "
          f"tree written in {write_s:.1f} s; decoder {route!r} (native: "
          f"{native_jpeg.build_error() or 'built'}); decode "
          + ", ".join(f"{rates[k]:.1f} frames/s with {k} thread"
                      f"{'s' if k > 1 else ''}" for k in DECODE_THREADS)
          + f"; frame 0 vs its render {err} (bounds {JPEG_MAX_TOL} max, "
          f"{JPEG_MEAN_TOL} mean)")
    return mads, mpii, {"write_s": write_s, "decoder": route,
                        "native_build": native_jpeg.build_error() or "built",
                        "decode_fps": rates, "jpeg_vs_render": err}


def tree_cfg(path, root, budget):
    """configs/<path> with DATASET.ROOT at the tree and a device-cache
    budget."""
    from fast3dhpe_tpu_torch.config import load_config
    cfg = load_config(path)
    cfg.DATASET.ROOT = root
    cfg.DATASET.DEVICE_CACHE_BYTES = budget
    return cfg


def _epoch_metrics(m, cfg, use_3d, what):
    m = {k: float(v) for k, v in m.items()}
    require(all(np.isfinite(v) for v in m.values()),
            f"{what}: non-finite metrics {m}")
    if use_3d:
        want = m["loss_2d"] + cfg.TRAIN.LOSS_3D_WEIGHT * m["loss_3d"]
        require(abs(m["loss"] - want) <= 1e-6 * abs(want),
                f"{what}: loss {m['loss']} is not loss_2d + "
                f"{cfg.TRAIN.LOSS_3D_WEIGHT} loss_3d = {want}")
    else:
        require(m["loss"] == m["loss_2d"],
                f"{what}: warmup loss {m['loss']} != loss_2d {m['loss_2d']}")
    return m


def run_loader_train(mads, dev):
    """CDRNet-101 trained from the JPEG tree: load_data -> Stereo3DLoader.
    stacked_epoch -> make_train_epoch_cdr with the whole tree on the card
    (a warmup and a use_3d epoch), then per-batch iteration through the
    upload lane with half the tree on the card (two use_3d epochs)."""
    from fast3dhpe_tpu_torch.data import Stereo3DLoader, load_data
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_train_epoch_cdr
    t0 = time.perf_counter()
    n_pairs = len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES
    tree_bytes = 2 * n_pairs * RAW_H * RAW_W * 3
    cfg = tree_cfg("configs/mads_3d.yaml", mads, tree_bytes)
    B = cfg.TRAIN.BATCH_SIZE
    steps = -(-n_pairs // B)
    loader, valid = load_data(cfg, seed=SEED, device=dev)
    valid.close()
    t = time.perf_counter()
    cache, xs, e = loader.stacked_epoch()
    sync()
    build_s = time.perf_counter() - t
    require(not cache.partial and cache.frames.device.type == dev.type
            and tuple(cache.frames.shape) == (2 * n_pairs, RAW_H, RAW_W, 3),
            f"the full cache holds {tuple(cache.frames.shape)}")
    shapes = {"idx_l": (steps, B), "idx_r": (steps, B),
              "trans": (steps, B, 2, 3), "P_l": (steps, B, 4, 4),
              "P_r": (steps, B, 4, 4), "pose_3d": (steps, B, 19, 3),
              "joints_vis": (steps, B, 19), "row_valid": (steps, B)}
    require({k: v.shape for k, v in xs.items()} == shapes,
            f"stacked_epoch shapes {({k: v.shape for k, v in xs.items()})}")
    require(xs["row_valid"].sum() == n_pairs
            and xs["row_valid"][-1].sum() == n_pairs - (steps - 1) * B,
            f"row_valid sums to {xs['row_valid'].sum(1)}")
    recs = loader.records
    for rec in (recs[0], recs[n_pairs // 2], recs[-1]):
        for key in ("image_left", "image_right"):
            row = int(cache.rows([rec[key]])[0])
            require(torch.equal(cache.frames[row].cpu(), torch.from_numpy(
                loader._decode_paths([rec[key]])[0])),
                f"cache row {row} is not the decoded {rec[key]}")
    model = seeded_train_model(cfg).to(dev)
    dxs = on_card(xs, dev)
    first = pipeline_batch(cache.frames, dxs, 0, cfg, train=True)
    first["row_valid"] = dxs["row_valid"][0]
    calibrate_train_head(model, first)
    state = TrainState.create(model, cfg, steps_per_epoch=steps)
    epoch = make_train_epoch_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
        cfg.MODEL.IMAGE_SIZE, occlusion=cfg.DATASET.OCCLUSION,
        loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
        num_joints=cfg.MODEL.NUM_JOINTS)
    full = {"cache_build_s": build_s, "decoder": loader.decoder_name,
            "epochs": []}
    launches = {k: 0 for k in kernel_counters()}
    for use_3d in (False, True):
        if use_3d:
            cache, xs, e = loader.stacked_epoch()
        counters = reset_counts()
        t = time.perf_counter()
        m = epoch(state, cache.frames, xs, SEED * 10007 + e, use_3d)
        sync()
        wall = (time.perf_counter() - t) * 1e3
        n = read_counts(counters)
        require_counts(n, steps, 1, 1, 0, f"full-cache epoch {e}")
        m = _epoch_metrics(m, cfg, use_3d, f"full-cache epoch {e}")
        full["epochs"].append({"use_3d": use_3d, "wall_ms": wall,
                               "step_ms": wall / steps, "metrics": m})
        launches = {k: launches[k] + n[k] for k in n}
        print(f"# loader training, full cache, epoch {e} use_3d={use_3d}: "
              f"{steps} steps, {wall / steps:.1f} ms a step, launches {n}, "
              f"summed " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    full["launches"] = launches
    loader.close()
    del loader, cache, xs, dxs, first
    torch.cuda.empty_cache()

    # half the tree on the card: partial cache and the upload lane
    cfg.DATASET.DEVICE_CACHE_BYTES = tree_bytes // 2
    loader = Stereo3DLoader(cfg, cfg.DATASET.TRAIN_SET, seed=SEED,
                            device_cache_bytes=tree_bytes // 2, device=dev)
    t = time.perf_counter()
    cache = loader.ensure_device_cache()
    sync()
    require(cache is not None and cache.partial
            and cache.frames.shape[0] == n_pairs,
            f"the half-budget cache holds {cache and cache.frames.shape} "
            f"(partial {cache and cache.partial})")
    try:
        loader.stacked_epoch()
        refused = "nothing"
    except RuntimeError as err:
        refused = str(err)
    require("FULL device cache" in refused,
            f"stacked_epoch on a partial cache raised {refused}")
    partial = {"cache_build_s": time.perf_counter() - t,
               "resident_frames": int(cache.frames.shape[0]), "epochs": []}
    step = train_step_fn(cfg)
    everyone = sorted(r["image_left"] for r in loader.records)
    launches = {k: 0 for k in launches}
    for _ in range(2):
        counters = reset_counts()
        times, rv = [], 0.0
        t = time.perf_counter()
        for batch in loader:
            m = step(state, batch, True)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            rv += float(batch["row_valid"].sum())
            t = time.perf_counter()
        n = read_counts(counters)
        require_counts(n, steps, 1, 1, 0, "partial-cache epoch")
        log = loader.batch_log
        lanes = {(b["rows"], b["uploaded"]) for b in log}
        require(len(log) == steps and len(lanes) == 1,
                f"partial-cache lanes (cached rows, uploaded frames) a batch "
                f"{[(b['rows'], b['uploaded']) for b in log]}")
        seen = sorted(p for b in log for p in b["valid"])
        require(seen == everyone and rv == n_pairs,
                f"a partial-cache epoch covered {len(seen)} records "
                f"({len(set(seen))} distinct), row_valid {rv}, not each of "
                f"the {n_pairs} once")
        m = _epoch_metrics({k: v.item() for k, v in m.items()}, cfg, True,
                           "partial-cache step")
        rec = {"lanes": {"cached_rows": log[0]["rows"],
                         "uploaded_frames": log[0]["uploaded"]},
               "step_ms": times, "upload_mb": [b["upload_bytes"] / 1e6
                                               for b in log],
               "decode_ms": [b["decode_ms"] for b in log],
               "last_metrics": m}
        partial["epochs"].append(rec)
        launches = {k: launches[k] + n[k] for k in n}
        print(f"# loader training, partial cache ({cache.frames.shape[0]} of "
              f"{2 * n_pairs} frames resident): lanes {rec['lanes']}, steps "
              f"{[round(x, 1) for x in times]} ms, upload "
              f"{[round(x, 1) for x in rec['upload_mb']]} MB and host decode "
              f"{[round(x, 1) for x in rec['decode_ms']]} ms a step, "
              f"launches {n}")
    partial["launches"] = launches
    partial["step_ms"] = statistics.median(partial["epochs"][-1]["step_ms"])
    loader.close()
    print(f"# loader training: full-cache step "
          f"{full['epochs'][-1]['step_ms']:.1f} ms vs partial-cache step "
          f"{partial['step_ms']:.1f} ms (upload "
          f"{statistics.median(partial['epochs'][-1]['upload_mb']):.1f} MB, "
          f"host decode "
          f"{statistics.median(partial['epochs'][-1]['decode_ms']):.1f} ms a "
          f"step, in the prefetch thread); phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {"full": full, "partial": partial}


def seeded_pose_resnet(cfg, dev):
    from fast3dhpe_tpu_torch.models.layers import init_weights
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    model = PoseResNet.from_config(cfg)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model.to(dev)


def run_loader_2d(mads, mpii, dev):
    """PoseResNet-101 from the trees: Mono2DLoader on MPII (host batches
    zero-padded to multiples of 128, warped on the card; two epochs of one
    step) and on MADS_2d (one stacked epoch from the full cache)."""
    from fast3dhpe_tpu_torch.data import Mono2DLoader
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import (make_train_epoch_2d,
                                                 make_train_step_2d)
    t0 = time.perf_counter()
    out = {}
    cfg = tree_cfg("configs/mpii.yaml", mpii, 1 << 30)
    loader = Mono2DLoader(cfg, cfg.DATASET.TRAIN_SET, seed=SEED,
                          device_cache_bytes=cfg.DATASET.DEVICE_CACHE_BYTES,
                          device=dev)
    state = TrainState.create(seeded_pose_resnet(cfg, dev), cfg,
                              steps_per_epoch=len(loader))
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT, layout="NHWC")
    step = make_train_step_2d(loss)
    counters = reset_counts()
    mets, shapes = [], set()
    for _ in range(2):
        for batch in loader:
            mets.append({k: v.item() for k, v in step(state, batch).items()})
        shapes |= {b["frame_shape"] for b in loader.batch_log}
    n = read_counts(counters)
    require(not loader.device_cached, "MPII's mixed sizes built a cache")
    require(all(s[0] % 128 == 0 and s[1] % 128 == 0 for s in shapes),
            f"MPII host batches of {shapes}, not multiples of 128")
    require(len(mets) == 2 * len(loader) and all(np.isfinite(v) for m in mets
                                   for v in m.values()),
            f"MPII steps: {mets}")
    require_counts(n, len(mets), 0, 0, 0, "MPII steps")
    out["mpii"] = {"steps": mets, "padded_shapes": sorted(shapes),
                   "launches": n, "decoder": loader.decoder_name}
    loader.close()
    print(f"# 2D MPII: {len(mets)} PoseResNet-101 steps from host batches "
          f"padded to {sorted(shapes)}, launches {n}, "
          + "; ".join(", ".join(f"{k} {v:.4g}" for k, v in m.items())
                      for m in mets))
    del state, step
    torch.cuda.empty_cache()

    cfg = tree_cfg("configs/mads_2d.yaml", mads, 1 << 30)
    loader = Mono2DLoader(cfg, cfg.DATASET.TRAIN_SET, seed=SEED,
                          device_cache_bytes=cfg.DATASET.DEVICE_CACHE_BYTES,
                          device=dev)
    cache, xs, _ = loader.stacked_epoch()
    steps = xs["idx"].shape[0]
    state = TrainState.create(seeded_pose_resnet(cfg, dev), cfg,
                              steps_per_epoch=steps)
    epoch = make_train_epoch_2d(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT, layout="NHWC"),
        cfg.MODEL.IMAGE_SIZE, cfg.MODEL.EXTRA.HEATMAP_SIZE,
        cfg.MODEL.EXTRA.SIGMA)
    counters = reset_counts()
    t = time.perf_counter()
    m = {k: float(v) for k, v in epoch(state, cache.frames, xs).items()}
    sync()
    wall = (time.perf_counter() - t) * 1e3
    n = read_counts(counters)
    require(all(np.isfinite(v) for v in m.values()), f"MADS_2d epoch {m}")
    require(xs["row_valid"].sum() == len(loader.records),
            f"MADS_2d row_valid sums to {xs['row_valid'].sum()}")
    require_counts(n, steps, 0, 0, 0, "MADS_2d epoch")
    out["mads_2d"] = {"steps": steps, "step_ms": wall / steps, "metrics": m,
                      "launches": n}
    loader.close()
    print(f"# 2D MADS_2d: a stacked epoch of {steps} PoseResNet-101 steps "
          f"from the full cache, {wall / steps:.1f} ms a step, launches {n}, "
          f"summed " + ", ".join(f"{k} {v:.4g}" for k, v in m.items())
          + f"; phase {time.perf_counter() - t0:.1f} s")
    out["launches"] = {k: out["mpii"]["launches"][k] + n[k] for k in n}
    return out


def moved_rows(inf, batch, lo, size):
    """Frames lo..B-1 of a streamed batch, run in their rows and again in
    other batches of B: the same batch; the half cache's second batch
    (those frames at rows 0.., every other row a copy of the last); the
    batch rolled so that they take rows 0.. beside the same other frames;
    and their own rows with every other row a copy of the last. For each,
    how far their heatmaps (of max|heatmap|), pred_2d (px) and pred_3d
    (relative) move, with the fused blocks (K3) and with cuDNN alone."""
    from fast3dhpe_tpu_torch.models.resnet import Bottleneck
    from fast3dhpe_tpu_torch.ops.warp import affine_warp
    B = len(batch["proj"])
    k = B - lo
    layouts = {  # name -> (the batch's frame at each row, rows of lo..B-1)
        "the same batch": (list(range(B)), list(range(lo, B))),
        "other rows and neighbours": (list(range(lo, B)) + [B - 1] * lo,
                                      list(range(k))),
        "other rows, same neighbours": (list(range(lo, B)) + list(range(lo)),
                                        list(range(k))),
        "same rows, other neighbours": ([B - 1] * lo + list(range(lo, B)),
                                        list(range(lo, B)))}
    blocks = [m for m in inf.model.modules() if isinstance(m, Bottleneck)]
    fused = [b.fused_inference for b in blocks]

    def run(order):
        idx = torch.as_tensor(order, device=batch["img_l"].device)
        trans = torch.as_tensor(batch["trans"][order], device=idx.device)
        imgs = normalized(affine_warp(batch["img_l"][idx], trans, size),
                          affine_warp(batch["img_r"][idx], trans, size),
                          idx.device)
        with torch.inference_mode():
            kp, p3, hm = inf.model(imgs, torch.as_tensor(
                batch["proj"][order], device=idx.device),
                return_heatmaps=True)
        return hm.float(), kp, p3

    out = {name: {} for name in layouts}
    try:
        for mode, on in (("fused", fused), ("cudnn", [False] * len(blocks))):
            for b, f in zip(blocks, on):
                b.fused_inference = f
            hm0, kp0, p30 = (o[lo:] for o in run(list(range(B))))
            for name, (order, rows) in layouts.items():
                hm, kp, p3 = (o[rows] for o in run(order))
                out[name][mode] = {
                    "hm": float((hm - hm0).abs().max() / hm0.abs().max()),
                    "kp_px": float((kp - kp0).abs().max()),
                    "p3_rel": float(((p3 - p30).norm(dim=-1)
                                     / p30.norm(dim=-1)).max())}
    finally:
        for b, f in zip(blocks, fused):
            b.fused_inference = f
    return out


def run_movement_eval(inf, cpu_inf, mads, cfg, dev):
    """evaluate_movement over valid/HipHop with the movement whole on the
    card, half of it, a batch-aligned part, and streamed: one K1 and four
    K3 launches a batch; MPJPE2D the same in every mode, MPJPE3D where the
    batches hold the same frames (the DLT of untrained keypoints turns the
    bf16 forward's dependence on a batch's other rows into a visible 3D
    difference; measured below on the same frames at other rows of a
    batch); frames/s of a call with the movement already held (the first
    call builds the cache). One batch's errors against the CPU."""
    import os
    from fast3dhpe_tpu_torch.apps.eval_loop import ground_truth
    from fast3dhpe_tpu_torch.data import LoadMADSData
    from fast3dhpe_tpu_torch.ops.warp import affine_warp
    t0 = time.perf_counter()
    data = os.path.join(mads, cfg.DATASET.TEST_SET)
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    B = cfg.TEST.BATCH_SIZE
    batches = -(-TREE_VALID_FRAMES // B)
    modes, launches = {}, {}
    for mode, frames in EVAL_MODES:
        cache_bytes = frames * RAW_H * RAW_W * 3
        stream = LoadMADSData(data, size, EVAL_MOVEMENT, device=dev)
        counters = reset_counts()
        t = time.perf_counter()
        e2, e3 = inf.evaluate_movement(stream, B, cache_bytes)
        first_s = time.perf_counter() - t
        n = read_counts(counters)
        require_counts(n, batches, 1, 0, 4, f"evaluate_movement, {mode}")
        cache = stream.build_device_cache(cache_bytes) if cache_bytes else None
        require((cache is None) == (cache_bytes == 0)
                and (cache is None or cache.partial
                     == mode.startswith("partial")),
                f"{mode}: the stream's cache is {cache}")
        t = time.perf_counter()
        again = inf.evaluate_movement(stream, B, cache_bytes)
        second_s = time.perf_counter() - t
        modes[mode] = {"mpjpe_2d": e2, "mpjpe_3d": e3,
                       "again": dict(zip(("mpjpe_2d", "mpjpe_3d"), again)),
                       "first_call_s": first_s,
                       "frames_per_s": TREE_VALID_FRAMES / second_s,
                       "decoder": stream.decoder_name}
        launches[mode] = n
        print(f"# movement eval, {mode}: MPJPE2D {e2:.6g} px, MPJPE3D "
              f"{e3:.6g} mm; {TREE_VALID_FRAMES} frames in {second_s:.3f} s "
              f"({TREE_VALID_FRAMES / second_s:.1f} frames/s; first call, "
              f"which builds the cache, {first_s:.3f} s); launches {n}")
    ref = modes["full cache"]
    for mode, r in modes.items():
        for k in ("mpjpe_2d", "mpjpe_3d"):
            if k == "mpjpe_3d" and mode == "partial cache":
                continue        # other batches: reported, held in 2D
            for got in (r[k], r["again"][k]):
                require(np.isfinite(got) and abs(got - ref[k])
                        <= EVAL_REL_TOL * abs(ref[k]),
                        f"{mode} {k} {got} differs from the full cache's "
                        f"{ref[k]} beyond {EVAL_REL_TOL} relative")

    half = modes["partial cache"]
    rel3 = abs(half["mpjpe_3d"] - ref["mpjpe_3d"]) / abs(ref["mpjpe_3d"])
    stream = LoadMADSData(data, size, EVAL_MOVEMENT, device=dev)
    batch = next(iter(stream.batches(B, device_warp=True)))
    moved = moved_rows(inf, batch, TREE_VALID_FRAMES // 2, size)
    print(f"# movement eval: MPJPE3D of the half cache differs by {rel3:.3g} "
          f"relative from the whole cache's. Frames "
          f"{TREE_VALID_FRAMES // 2}-{B - 1} of the whole cache's first "
          f"batch run in other batches of {B} (heatmaps max of max|hm|, "
          f"pred_2d px, pred_3d max relative; fused / cuDNN only): "
          + "; ".join(f"{k} " + " / ".join(
              f"{v[m]['hm']:.3g}, {v[m]['kp_px']:.3g}, {v[m]['p3_rel']:.3g}"
              for m in ("fused", "cudnn")) for k, v in moved.items()))
    modes["partial cache"]["mpjpe_3d_rel_to_full"] = rel3
    modes["partial cache"]["rows_moved"] = moved

    # one streamed batch's first rows on the card and on the CPU
    k = EVAL_CPU_PAIRS
    img_l, img_r = batch["img_l"][:k], batch["img_r"][:k]
    trans, proj = batch["trans"][:k], batch["proj"][:k]
    pose, vis = ground_truth(batch["pose_3d"][:k])
    with torch.inference_mode():
        kp, p3 = inf.predict_batch(img_l, img_r, proj, trans=trans)
        e2, e3 = inf.predict_eval(img_l, img_r, trans, proj, pose, vis)
        c2, c3 = cpu_inf.predict_eval(img_l.cpu(), img_r.cpu(), trans, proj,
                                      pose, vis)
        r2, r3 = cpu_inf.eval_errors(kp.cpu(), p3.cpu(), proj, pose, vis)
    vs_cpu = check_vs_cpu(
        inf.model, cpu_inf.model,
        normalized(affine_warp(img_l, trans, size),
                   affine_warp(img_r, trans, size), dev),
        normalized(affine_warp(img_l.cpu(), trans, size),
                   affine_warp(img_r.cpu(), trans, size), "cpu"),
        proj, kp, "movement eval vs CPU", t0)
    metric = max(float(((a.cpu() - b).abs() / b.abs()).max())
                 for a, b in ((e2, r2), (e3, r3)))
    vs_cpu.update(metric_rel=metric,
                  e2_px=float((e2.cpu() - c2).abs().max()),
                  e3_rel=float(((e3.cpu() - c3).abs() / c3.abs()).median()))
    print(f"# movement eval vs CPU ({k} pairs): the card's errors vs the "
          f"CPU's metric on the card's predictions {metric:.3g} relative; vs "
          f"the CPU run: MPJPE2D max {vs_cpu['e2_px']:.3g} px, MPJPE3D "
          f"median {vs_cpu['e3_rel']:.3g} relative; phase "
          f"{time.perf_counter() - t0:.1f} s")
    require(metric <= 1e-5, f"the card's per-sample errors differ from the "
                            f"CPU's metric of its predictions by {metric}")
    # the errors of pred_2d within 2 px (check_vs_cpu) move by as much
    require(vs_cpu["e2_px"] < 2.0,
            f"MPJPE2D differs from the CPU run by {vs_cpu['e2_px']} px")
    return {"modes": modes, "launches": launches, "vs_cpu": vs_cpu}


# -------------------------------------------------------------------- apps

APPS_EPOCHS_2D = 2                # `train`: PoseResNet-101, WARMUP 0
APPS_EPOCHS_CDR, APPS_WARMUP = 3, 1   # `train_cdr`: best.pth after epoch 3
APPS_LR_STEP = 3                  # LR / 10 from epoch 4: the resumed epoch
NEAR_TIE = 1e-3                   # of a heatmap's range: an argmax near-tie
GEOMETRY_TOL = 1e-3               # of max|CPU|: a DLT on the card vs the CPU


class EpochTimes:
    """A logging handler that keeps the seconds of each 'epoch ...' line
    the training loops log (its last argument)."""

    def __init__(self):
        import logging
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.seconds = []
        self.logger = logging.getLogger("fast3dhpe_tpu_torch")

    def _emit(self, rec):
        if str(rec.msg).startswith("epoch "):
            self.seconds.append(float(rec.args[-1]))

    def __enter__(self):
        from fast3dhpe_tpu_torch.utils.logging import setup_logger
        setup_logger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def app_config(src, path, root, **sections):
    """configs/<src> with DATASET.ROOT at the tree and the given keys of
    each section replaced, written to path for an app's --config_path."""
    import yaml
    with open(src) as f:
        d = yaml.safe_load(f)
    d["DATASET"]["ROOT"] = root
    for name, keys in sections.items():
        d[name].update(keys)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def digests(d):
    import hashlib
    import os
    return {n: hashlib.sha256(open(os.path.join(d, n), "rb").read())
            .hexdigest() for n in sorted(os.listdir(d))}


def counted(fn, *args):
    """fn(*args) with the kernels' counts set to 0 just before and read
    just after; (result, launches, wall s)."""
    counters = reset_counts()
    t = time.perf_counter()
    out = fn(*args)
    sync()
    return out, read_counts(counters), time.perf_counter() - t


def _finite_history(h, what):
    bad = {k: v for k, v in h.items() if not np.isfinite(v).all()}
    require(not bad, f"{what}: non-finite history {bad}")


def run_train_apps(mads, work, dev):
    """a-d: `train` (PoseResNet-101, loader iteration), `train_cdr`
    (CDRNet-101 from a's encoder, stacked epochs from the card), the
    overwrite guard, and `train_cdr --resume` as a subprocess."""
    import logging
    import os
    import re
    from fast3dhpe_tpu_torch.apps import train, train_cdr
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.train import checkpoint, loop2d, loop_cdr
    from fast3dhpe_tpu_torch.train.state import TrainState
    weights = os.path.join(work, "weights")
    n_pairs = len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES
    out = {}

    # a. 2D training, from JPEGs through the loader's iteration
    cfg2 = app_config("configs/mads_2d.yaml", os.path.join(work, "2d.yaml"),
                      mads, MODEL={"PRETRAINED": ""},
                      TRAIN={"EPOCH": APPS_EPOCHS_2D, "WARMUP": 0})
    with EpochTimes() as et:
        h2, n, wall = counted(train.main, [
            "--config_path", cfg2, "--overwrite", "--weights_root", weights,
            "--device", dev.type])
    require_counts(n, 1, 0, 0, 0, "the train app")
    _finite_history(h2, "the train app")
    require(len(h2["val_acc"]) == APPS_EPOCHS_2D, f"train app history {h2}")
    dir2 = os.path.join(weights, load_config(cfg2).MODEL.NAME)
    a_latest = os.path.join(dir2, "latest.pth")
    a_sd = checkpoint.load_variables(a_latest)
    PoseResNet.from_config(load_config(cfg2)).load_state_dict(a_sd,
                                                              strict=True)
    out["train"] = {"epoch_s": et.seconds, "wall_s": wall, "launches": n,
                    "history": h2}
    print(f"# apps a, train (PoseResNet-101, {APPS_EPOCHS_2D} epochs of "
          f"loader iteration): epochs {[round(s, 2) for s in et.seconds]} s, "
          f"wall {wall:.1f} s, launches {n}, val acc {h2['val_acc']}")

    # b. CDR training from a's encoder, stacked epochs from the card
    tree_bytes = 2 * n_pairs * RAW_H * RAW_W * 3
    cdr = dict(MODEL={"PRETRAINED": a_latest},
               DATASET={"DEVICE_CACHE_BYTES": tree_bytes},
               TRAIN={"EPOCH": APPS_EPOCHS_CDR, "WARMUP": APPS_WARMUP,
                      "LR_STEP": [APPS_LR_STEP]})
    cfg3 = app_config("configs/mads_3d.yaml", os.path.join(work, "3d.yaml"),
                      mads, **cdr)
    argv3 = ["--config_path", cfg3, "--weights_root", weights, "--device",
             dev.type]
    cfg = load_config(cfg3)
    start, load_pretrained = {}, loop_cdr._load_pretrained

    def spy(model, config, logger):
        load_pretrained(model, config, logger)
        start.update({k: v.detach().clone()
                      for k, v in model.state_dict().items()})

    loop_cdr._load_pretrained = spy
    try:
        with EpochTimes() as et:
            h3, n, wall = counted(train_cdr.main, argv3 + ["--overwrite"])
    finally:
        loop_cdr._load_pretrained = load_pretrained
    fresh = loop_cdr._init_model(cfg, SEED).state_dict()
    wrong = [k for k, v in start.items()
             if not torch.equal(v, a_sd[k] if k.startswith("encoder.")
                                else fresh[k])]
    require(not wrong and len(start) == len(fresh),
            f"before the first step, {len(wrong)} tensors were neither a's "
            f"encoder nor a fresh seeded init: {wrong[:5]}")
    steps = -(-n_pairs // cfg.TRAIN.BATCH_SIZE)
    evals = -(-TREE_VALID_FRAMES // cfg.TEST.BATCH_SIZE)
    want = {"soft_argmax": APPS_EPOCHS_CDR * (steps + evals),
            "soft_argmax_bwd": APPS_EPOCHS_CDR * steps,
            "fused_bottleneck": 0}
    require(n == want, f"the train_cdr app launched {n}, not {want}")
    _finite_history(h3, "the train_cdr app")
    dir3 = os.path.join(weights, cfg.MODEL.NAME)
    files = digests(dir3)
    require(set(files) == {"best.pth", "latest.pth", checkpoint.OPT_FILE},
            f"the train_cdr app wrote {sorted(files)}")
    best = checkpoint.load_variables(os.path.join(dir3, "best.pth"))
    # best only after the warmup (`epoch > WARMUP`): the last epoch here
    require(checkpoint.weights_step(best) == APPS_EPOCHS_CDR * steps,
            f"best.pth is of step {checkpoint.weights_step(best)}")
    saved = torch.load(os.path.join(dir3, checkpoint.OPT_FILE),
                       weights_only=True)
    out["train_cdr"] = {"epoch_s": et.seconds, "wall_s": wall,
                        "launches": n, "history": h3}
    print(f"# apps b, train_cdr (CDRNet-101 from a's encoder, "
          f"{APPS_EPOCHS_CDR} epochs, WARMUP {APPS_WARMUP}, stacked from the "
          f"card): epochs {[round(s, 2) for s in et.seconds]} s, wall "
          f"{wall:.1f} s, launches {n}, val MPJPE3D {h3['val_mpjpe_3d']}, "
          f"best.pth of step {checkpoint.weights_step(best)}; the merged "
          f"encoder is a's, the rest a fresh seeded init")

    # c. the overwrite guard
    try:
        train_cdr.main(argv3)
        refused = None
    except FileExistsError as err:
        refused = str(err)
    require(refused and "--overwrite" in refused,
            f"train_cdr without --overwrite raised {refused}")
    require(digests(dir3) == files, "the refused run changed the files")

    # d. resume, as a subprocess through the module's entry point
    cfg4 = app_config("configs/mads_3d.yaml", os.path.join(work, "4d.yaml"),
                      mads, **dict(cdr, TRAIN=dict(cdr["TRAIN"],
                                                   EPOCH=APPS_EPOCHS_CDR + 1)))
    model = CDRNet.from_config(cfg).to(dev)
    state = TrainState.create(model, cfg, steps)
    t = time.perf_counter()
    step, best_metric = loop2d._restore_state(dir3, state,
                                              logging.getLogger("chip"))
    sync()
    resume_ms = (time.perf_counter() - t) * 1e3
    loaded = state.optimizer.state_dict()
    same = all(torch.equal(v.cpu(), saved["optimizer"]["state"][i][k])
               for i, s in loaded["state"].items() for k, v in s.items())
    require(same and step == saved["step"] == APPS_EPOCHS_CDR * steps
            and loaded["param_groups"] == saved["optimizer"]["param_groups"],
            "the optimizer state a resume loads differs from the saved one")
    times = checkpoint_times(state, work)
    del model, state, loaded
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fast3dhpe_tpu_torch.apps.train_cdr",
         "--config_path", cfg4, "--resume", "--weights_root", weights,
         "--device", dev.type], capture_output=True, text=True, timeout=900)
    sub_s = time.perf_counter() - t
    require(proc.returncode == 0,
            f"train_cdr --resume exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    epochs = re.findall(r"epoch (\d+)/(\d+)", proc.stderr)
    after = torch.load(os.path.join(dir3, checkpoint.OPT_FILE),
                       weights_only=True)
    adam = {float(s["step"]) for s in after["optimizer"]["state"].values()}
    lr = cfg.TRAIN.LR * cfg.TRAIN.LR_FACTOR
    require(epochs == [(str(APPS_EPOCHS_CDR + 1), str(APPS_EPOCHS_CDR + 1))]
            and f"Resumed from step {step}" in proc.stderr
            and after["step"] == step + steps
            and adam == {float(step + steps)}
            and after["optimizer"]["param_groups"][0]["lr"] == lr,
            f"the resumed run logged epochs {epochs}, reached step "
            f"{after['step']}, Adam steps {adam}, lr "
            f"{after['optimizer']['param_groups'][0]['lr']} (want one epoch "
            f"from step {step}, Adam {step + steps}, lr {lr})")
    improved = after["best_metric"] < best_metric
    now = digests(dir3)
    require((now["best.pth"] != files["best.pth"]) == improved,
            f"best.pth {'unchanged' if improved else 'changed'} while "
            f"MPJPE3D went {best_metric} -> {after['best_metric']}")
    out["resume"] = {"subprocess_s": sub_s, "load_ms": resume_ms,
                     "best_metric": [best_metric, after["best_metric"]]}
    print(f"# apps c, the overwrite guard refused and left the files as they "
          f"were; d, train_cdr --resume (subprocess, {sub_s:.1f} s): one "
          f"epoch from step {step} to {after['step']} at lr {lr:g}, Adam's "
          f"step {adam}, best.pth {'rewritten' if improved else 'kept'} "
          f"(MPJPE3D {best_metric:.6g} -> {after['best_metric']:.6g}); the "
          f"resume load {resume_ms:.1f} ms")
    out["checkpoint"] = times
    return out, cfg2, cfg3, weights


def checkpoint_times(state, work):
    """Save ms and bytes of latest.pth + latest.opt.pt, synchronous and
    asynchronous (the time save() takes to return, and to the end of the
    write), twice each."""
    import os
    from fast3dhpe_tpu_torch.train import checkpoint, loop2d
    out = {"sync_ms": [], "async_return_ms": [], "async_total_ms": []}
    for i in range(2):
        for mode in ("sync", "async"):
            d = os.path.join(work, f"ckpt_{mode}_{i}")
            os.makedirs(d)
            writer = checkpoint.make_checkpoint_writer(mode == "async")
            sync()
            t = time.perf_counter()
            loop2d._save_latest(writer, d, state, 0.0)
            returned = (time.perf_counter() - t) * 1e3
            writer.close()
            total = (time.perf_counter() - t) * 1e3
            if mode == "sync":
                out["sync_ms"].append(total)
            else:
                out["async_return_ms"].append(returned)
                out["async_total_ms"].append(total)
            out["bytes"] = {n: os.path.getsize(os.path.join(d, n))
                            for n in sorted(os.listdir(d))}
    return out


def run_serve_apps(mads, work, cfg2, cfg3, weights, dev):
    """e-f: `inference --bf16 --fused_inference --movement all` and
    `baseline` on the trained weights, each against the library call it
    wraps and the CPU."""
    import contextlib
    import importlib.util
    import io
    import os
    import cv2
    from PIL import Image
    from fast3dhpe_tpu_torch.apps import baseline, inference
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.data import LoadMADSData
    from fast3dhpe_tpu_torch.geometry.camera import project_points_np
    from fast3dhpe_tpu_torch.utils.visualize import plot_pose_2d, save_gif
    valid = os.path.join(mads, "valid")
    cfg = load_config(cfg3)
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    B = cfg.TEST.BATCH_SIZE
    batches = -(-TREE_VALID_FRAMES // B)
    budget = 2048 << 20
    drawn = importlib.util.find_spec("matplotlib") is not None
    out = {"matplotlib": drawn}

    # e. the inference app
    argv = ["--config_path", cfg3, "--weights_root", weights, "--bf16",
            "--fused_inference", "--movement", "all", "--data_path", valid,
            "--batch_size", str(B), "--device", dev.type]
    if drawn:
        argv += ["--save_frames", "3"]
    here, printed = os.getcwd(), io.StringIO()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(printed):
            res, n, wall = counted(inference.main, argv)
    finally:
        os.chdir(here)
    require_counts(n, batches, 1, 0, 4, "the inference app")
    e2, e3 = res[EVAL_MOVEMENT]
    text = printed.getvalue()
    require(f"[{EVAL_MOVEMENT}] MPJPE2D:  {e2}" in text
            and f"[{EVAL_MOVEMENT}] MPJPE3D:  {e3}" in text
            and list(res) == [EVAL_MOVEMENT],
            f"the inference app printed {text!r} for {res}")
    inf = inference.CDRNetInferencer(cfg, weights_root=weights,
                                     dtype=torch.bfloat16,
                                     fused_inference=True, device=dev)
    stream = LoadMADSData(valid, size, EVAL_MOVEMENT, device=dev)
    r2, r3 = inf.evaluate_movement(stream, B, budget)
    t = time.perf_counter()
    inf.evaluate_movement(stream, B, budget)
    eval_s = time.perf_counter() - t
    for got, ref, k in ((e2, r2, "MPJPE2D"), (e3, r3, "MPJPE3D")):
        require(np.isfinite(got) and abs(got - ref) <= EVAL_REL_TOL
                * abs(ref), f"the inference app's {k} {got} differs from "
                            f"evaluate_movement's {ref}")
    if drawn:
        with Image.open(os.path.join(work, f"{EVAL_MOVEMENT}.gif")) as im:
            require(im.n_frames == 3, f"the GIF holds {im.n_frames} frames")
        require(cv2.imread(os.path.join(work, "test.jpg")) is not None,
                "test.jpg does not decode")
        note = "the GIF and test.jpg written by the app decode"
    else:
        try:
            inf.render_frames(stream, 1, os.path.join(work, "x.jpg"))
            missing = None
        except ImportError as err:
            missing = str(err)
        require(missing and "matplotlib" in missing,
                f"render_frames without matplotlib raised {missing}")
        print(f"# apps e: the 3D plot was not drawn: matplotlib is not "
              f"installed on this host ({missing}); the cv2 2D overlays are")
        batch = next(iter(stream.batches(B)))
        kp, _ = inf.predict_batch(batch["img_l"], batch["img_r"],
                                  batch["proj"])
        kp = kp.float().cpu().numpy()
        poses = np.nan_to_num(batch["pose_3d"]).astype(np.float32)
        gts = [project_points_np(poses, batch["proj"][:, v])
               for v in range(2)]
        raw = [np.concatenate([batch["img_l"][i].cpu().numpy(),
                               batch["img_r"][i].cpu().numpy()], axis=1)
               for i in range(3)]
        frames = [cv2.cvtColor(plot_pose_2d(
            (gts[0][i], gts[1][i]), (kp[i, 0], kp[i, 1]),
            (batch["img_l"][i].cpu().numpy(),
             batch["img_r"][i].cpu().numpy())), cv2.COLOR_BGR2RGB)
            for i in range(3)]
        require(all(f.shape == (size[1], 2 * size[0], 3) and
                    (cv2.cvtColor(f, cv2.COLOR_RGB2BGR) != r).any()
                    for f, r in zip(frames, raw)),
                "the 2D overlays drew nothing")
        save_gif(frames, os.path.join(work, f"{EVAL_MOVEMENT}_2d.gif"))
        cv2.imwrite(os.path.join(work, "test.jpg"),
                    cv2.cvtColor(frames[-1], cv2.COLOR_RGB2BGR))
        with Image.open(os.path.join(work,
                                     f"{EVAL_MOVEMENT}_2d.gif")) as im:
            require(im.n_frames == 3, f"the GIF holds {im.n_frames} frames")
        require(cv2.imread(os.path.join(work, "test.jpg")) is not None,
                "test.jpg does not decode")
        note = "a GIF and test.jpg of the 2D overlays decode"
    del inf
    torch.cuda.empty_cache()
    out["inference"] = {"mpjpe": [e2, e3], "evaluate_movement": [r2, r3],
                        "launches": n, "app_wall_s": wall,
                        "app_frames_per_s": TREE_VALID_FRAMES / wall,
                        "eval_frames_per_s": TREE_VALID_FRAMES / eval_s}
    print(f"# apps e, inference --bf16 --fused_inference --movement all: "
          f"MPJPE2D {e2:.6g} px, MPJPE3D {e3:.6g} mm (evaluate_movement "
          f"{r2:.6g}, {r3:.6g}), launches {n}; app {wall:.2f} s "
          f"({TREE_VALID_FRAMES / wall:.1f} frames/s), evaluate_movement "
          f"{TREE_VALID_FRAMES / eval_s:.1f} frames/s; {note}")

    # f. the baseline app, and one batch against the CPU
    bl_argv = ["--config_path", cfg2, "--weights_root", weights,
               "--data_path", valid, "--batch_size", str(B), "--device",
               dev.type]
    with contextlib.redirect_stdout(io.StringIO()):
        (b2, b3), n, wall = counted(baseline.main, bl_argv)
    require_counts(n, 1, 0, 0, 0, "the baseline app")
    require(np.isfinite([b2, b3]).all(), f"baseline MPJPE {b2}, {b3}")
    cfg_2d = load_config(cfg2)
    est = baseline.BaselineEstimator(cfg_2d, weights_root=weights,
                                     device=dev)
    stream = LoadMADSData(valid, size, EVAL_MOVEMENT, device=dev)
    est.evaluate_movement(stream, B, budget)
    t = time.perf_counter()
    est.evaluate_movement(stream, B, budget)
    bl_eval_s = time.perf_counter() - t
    cpu = baseline.BaselineEstimator(cfg_2d, weights_root=weights,
                                     device="cpu")
    batch = next(iter(LoadMADSData(valid, size, EVAL_MOVEMENT,
                                   device="cpu").batches(B)))
    kp, p3 = (x.cpu() for x in est.predict_batch(
        batch["img_l"], batch["img_r"], batch["proj"]))
    ckp, cp3 = cpu.predict_batch(batch["img_l"], batch["img_r"],
                                 batch["proj"])
    with torch.inference_mode():
        from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet
        hm = cpu.model(torch.cat([normalize_imagenet(batch["img_l"]),
                                  normalize_imagenet(batch["img_r"])]))
    views = torch.cat([kp[:, 0], kp[:, 1]]), torch.cat([ckp[:, 0],
                                                        ckp[:, 1]])
    differ = (views[0] != views[1]).any(-1).nonzero().tolist()
    scale = size[0] / cfg_2d.MODEL.EXTRA.HEATMAP_SIZE[0]
    for img, j in differ:
        h = hm[img, :, :, j]
        x, y = (views[0][img, j] / scale).long().tolist()
        gap, span = float(h.max() - h[y, x]), float(h.max() - h.min())
        # hard_argmax zeroes a joint whose maximum is <= 0
        require(gap <= NEAR_TIE * span or abs(float(h.max())) <= NEAR_TIE
                * span,
                f"baseline pred_2d of image {img} joint {j} differs from the "
                f"CPU's by more than a near-tie of its heatmap ({gap})")
    same = (kp == ckp).all(-1).all(1)                  # (B, J)
    floor = cp3.abs().amax(-1) > 1e8                   # |w| at its 1e-9 floor
    rel = ((p3 - cp3).norm(dim=-1) / cp3.norm(dim=-1))
    rel_abs = ((p3.abs() - cp3.abs()).norm(dim=-1) / cp3.norm(dim=-1))
    require(bool(same.any()), "no joint's pred_2d agrees with the CPU's")
    worst = float(torch.where(floor, rel_abs, rel)[same].max())
    require(worst <= 1e-3, f"baseline pred_3d differs from the CPU's by "
                           f"{worst} relative where pred_2d agrees")
    out["baseline"] = {"mpjpe": [b2, b3], "launches": n, "app_wall_s": wall,
                       "app_frames_per_s": TREE_VALID_FRAMES / wall,
                       "eval_frames_per_s": TREE_VALID_FRAMES / bl_eval_s,
                       "pred_2d_near_ties": len(differ),
                       "pred_3d_rel": worst,
                       "joints_at_w_floor": int(floor.sum())}
    print(f"# apps f, baseline: MPJPE2D {b2:.6g} px, MPJPE3D {b3:.6g} mm, "
          f"launches {n}; app {wall:.2f} s ({TREE_VALID_FRAMES / wall:.1f} "
          f"frames/s), evaluate_movement "
          f"{TREE_VALID_FRAMES / bl_eval_s:.1f} frames/s; one batch vs the "
          f"CPU: pred_2d differs at {len(differ)} near-ties, pred_3d within "
          f"{worst:.3g} relative ({int(floor.sum())} joints at the floor of "
          f"w compared in magnitude)")
    return out


def run_geometry(dev):
    """g. dlt_triangulate by jacobi, svd and sii and
    triangulate_closed_form on 32 x 19 systems of converging_rig with 1 px
    of noise, on the card against the CPU: launches and device ms a call
    (torch.profiler) and host ms a call."""
    from fast3dhpe_tpu_torch.geometry.triangulation import (
        dlt_triangulate, triangulate_closed_form)
    rng = np.random.RandomState(SEED + 7)
    P = converging_rig(TIMING_PAIRS)
    X = rng.uniform(-250, 250, (TIMING_PAIRS, 19, 3))
    hom = np.concatenate([X, np.ones((TIMING_PAIRS, 19, 1))], -1)
    uvw = np.einsum("bvij,bkj->bkvi", P.astype(np.float64), hom)
    pts = (uvw[..., :2] / uvw[..., 2:]
           + rng.randn(TIMING_PAIRS, 19, 2, 2)).astype(np.float32)
    proj = np.ascontiguousarray(np.broadcast_to(
        P[:, None], (TIMING_PAIRS, 19, 2, 3, 4)))
    flat = pts.reshape(-1, 2, 2)
    calls = {f"dlt {m}": (lambda d, m=m: dlt_triangulate(
        torch.as_tensor(proj, device=d), torch.as_tensor(pts, device=d),
        method=m)) for m in ("jacobi", "svd", "sii")}
    calls["closed form"] = lambda d: triangulate_closed_form(
        torch.as_tensor(P[0, 0], device=d), torch.as_tensor(P[0, 1],
                                                            device=d),
        torch.as_tensor(flat[:, 0], device=d),
        torch.as_tensor(flat[:, 1], device=d))
    out = {}
    for name, fn in calls.items():
        got, ref = fn(dev).cpu(), fn("cpu")
        err = float((got - ref).abs().max() / ref.abs().max())
        require(torch.isfinite(got).all() and err <= GEOMETRY_TOL,
                f"{name} on the card differs from the CPU by {err} of its "
                f"largest coordinate")
        prof = profile_calls(lambda: fn(dev))
        out[name] = {"max_err": err, "host_ms": host_ms(lambda: fn(dev)),
                     **prof}
    print("# apps g, geometry at 32 x 19 systems (launches, device ms, host "
          "ms a call; error vs the CPU): " + "; ".join(
              f"{k} {v['launches']:.0f}, {v['device_ms']:.3f}, "
              f"{v['host_ms']:.2f} ms, {v['max_err']:.2g}"
              for k, v in out.items()))
    return out


def run_apps(mads, dev, smi):
    """Phase 11: the CLI apps at full width on the JPEG trees, a-h."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        out, cfg2, cfg3, weights = run_train_apps(mads, work, dev)
        torch.cuda.empty_cache()
        out.update(run_serve_apps(mads, work, cfg2, cfg3, weights, dev))
    torch.cuda.empty_cache()
    out["geometry"] = run_geometry(dev)
    c = out["checkpoint"]
    print(f"# apps h ({smi}): epoch wall s: train {out['train']['epoch_s']}, "
          f"train_cdr {out['train_cdr']['epoch_s']}; checkpoint "
          f"{c['bytes']} bytes, sync save {[round(x, 1) for x in c['sync_ms']]}"
          f" ms, async save returns in "
          f"{[round(x, 1) for x in c['async_return_ms']]} ms and ends in "
          f"{[round(x, 1) for x in c['async_total_ms']]} ms; resume load "
          f"{out['resume']['load_ms']:.1f} ms; inference app "
          f"{out['inference']['app_frames_per_s']:.1f} frames/s "
          f"(evaluate_movement {out['inference']['eval_frames_per_s']:.1f}),"
          f" baseline app {out['baseline']['app_frames_per_s']:.1f} frames/s "
          f"(evaluate_movement {out['baseline']['eval_frames_per_s']:.1f}); "
          f"phase {time.perf_counter() - t0:.1f} s")
    return out


# ----------------------------------------------------------------- slice 6

S6_PAIRS = 32                     # int8 requests, exports, the bf16 step
S6_CALIB = 8                      # calibration batches of 16 pairs
S6_CPU_PAIRS = 2                  # rows of an int8 request also on the CPU
S6_REMAT_PAIRS = (32, 96)
# cf_out's int8 codes follow the bf16 trunk, which cuDNN and oneDNN round
# apart: at most CF_FLIPS of them may differ from the CPU's, by one code;
# every code before it is bit-equal (exact int32 accumulators, the same
# fp32 epilogue and division)
CF_FLIPS = 1e-3
# int8 against the bf16 request, as tests/test_quantized.py:129-139
INT8_CORR, INT8_MAX_ERR = 0.99, 0.12
EXPORT_RTOL, EXPORT_ATOL = 1e-4, 1e-3     # as tests/test_export.py
RIG_DISTANCE_MM = 3000.0                  # converging_rig's cameras
# bf16 training. At random init the train-mode forward of CDRNet-101 in
# bf16 leaves its fp32 twin far behind: the heatmaps differ by up to 0.9
# of their largest value and the gradients by more than their norm (the
# rounding compounds through 104 train-mode BNs; measured on the CPU at 2
# and 32 pairs), so neither is held against fp32. What is held: the
# losses (BF16_LOSS_TOL relative), the first BN site's output (the bf16
# bounds of tests/test_pallas_kernels.py:116-119), and against the CPU's
# bf16 step the gradient and BN statistics within BF16_NOISE_X times the
# CPU's own bf16-vs-fp32 difference (the rule of
# tests/test_torch_bf16_train.py), loose at this depth; the train-mode BN
# layer itself on a bf16 input against the CPU within one bf16 rounding.
BF16_LOSS_TOL, BF16_NOISE_X, BF16_ULP = 2e-2, 2.0, 2.0 ** -7
HM_MAX_TOL, HM_MEAN_TOL = 0.05, 0.005     # tests/test_pallas_kernels.py


def check_apis():
    """The APIs this slice needs from the card's torch, named if absent."""
    missing = [name for name, ok in (
        ("torch.library.custom_op", hasattr(torch.library, "custom_op")),
        ("torch.library.register_autograd",
         hasattr(torch.library, "register_autograd")),
        ("torch.export.export", hasattr(torch, "export")
         and hasattr(torch.export, "export")),
        ("torch._int_mm", hasattr(torch, "_int_mm"))) if not ok]
    try:
        import torch.export.passes as passes
        if not hasattr(passes, "move_to_device_pass"):
            missing.append("torch.export.passes.move_to_device_pass")
    except ImportError:
        missing.append("torch.export.passes")
    require(not missing, f"torch {torch.__version__} lacks {missing}")
    a = torch.ones((32, 32), dtype=torch.int8, device="cuda")
    try:
        got = torch._int_mm(a, a)
    except RuntimeError as err:
        raise RuntimeError(f"chip_smoke: torch._int_mm on CUDA failed: "
                           f"{err}") from err
    require(bool((got == 32).all()), "torch._int_mm on CUDA: wrong sums")


class CalibFrames:
    """A stream of seeded random uint8 pairs of bench.py's rig, as
    CDRNetInferencer(int8=True) draws calibration batches from one."""

    def __init__(self, seed, n):
        self.seed, self.n = seed, n

    def batches(self, batch_size):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.n):
            img_l, img_r, proj = stereo_request(rng, batch_size)
            yield {"img_l": img_l, "img_r": img_r, "proj": proj}


def requant_codes(fn):
    """fn() with every int8 requant of ops/quant.py recorded (on the
    CPU), in call order."""
    from fast3dhpe_tpu_torch.ops import quant as Q
    seen, orig = [], Q.requant

    def recorded(y, s):
        out = orig(y, s)
        seen.append(out.cpu())
        return out

    Q.requant = recorded
    try:
        out = fn()
    finally:
        Q.requant = orig
    return out, seen


def device_groups(fn, calls=3):
    """Device ms a call by kernel group (torch.profiler), and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    groups = {"K1 soft-argmax": 0.0, "K3 fused bottleneck": 0.0,
              "GEMM and convolution (cuBLAS, cuDNN)": 0.0,
              "other (im2col copies, elementwise, geometry)": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        ms = e.self_device_time_total / 1e3 / calls
        if "softargmax_fwd" in e.key:
            g = "K1 soft-argmax"
        elif "bottleneck_kernel" in e.key:
            g = "K3 fused bottleneck"
        elif any(s in e.key.lower() for s in CONV_KERNELS + ("imma", "i8")):
            g = "GEMM and convolution (cuBLAS, cuDNN)"
        else:
            g = "other (im2col copies, elementwise, geometry)"
        groups[g] += ms
    busy = sum(groups.values())
    require(busy > 0, "the profiler recorded no device time")
    return {"device_ms": busy, "launches": launches / calls,
            "groups": groups}


def run_int8(inf, cfg, dev, work):
    """a. int8 serving: calibrate a pack on S6_CALIB batches, serve 3
    requests of S6_PAIRS pairs (1 K1, no K2, no K3 each), one request's
    first rows against the CPU's int8 path on the same pack, the request
    against the bf16 fused one, and both timed."""
    import os
    from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    from fast3dhpe_tpu_torch.models import quantized as qz
    sd = {k: v.detach() for k, v in inf.model.state_dict().items()}
    pack_path = os.path.join(work, "cdrnet101_int8.npz")
    t = time.perf_counter()
    inf8 = CDRNetInferencer(cfg, state_dict=sd, device=dev, int8=True,
                            calib_stream=CalibFrames(SEED + 11, S6_CALIB),
                            calib_batches=S6_CALIB, int8_pack=pack_path)
    sync()
    calib_s = time.perf_counter() - t
    rng = np.random.RandomState(SEED + 12)
    requests = [stereo_request(rng, S6_PAIRS) for _ in range(REQUESTS)]
    counters = reset_counts()
    outs = [inf8.predict_batch(*r) for r in requests]
    n = read_counts(counters)
    require_counts(n, REQUESTS, 1, 0, 0, "int8 serving")
    for kp, p3 in outs:
        require(kp.shape == (S6_PAIRS, 2, 19, 2)
                and p3.shape == (S6_PAIRS, 19, 3)
                and bool(torch.isfinite(kp).all() and torch.isfinite(p3)
                         .all()), "int8 serving: bad outputs")

    # the first rows of request 0 on the card and on the CPU, same pack
    cpu8 = CDRNetInferencer(cfg, device="cpu", int8=True,
                            int8_pack=pack_path)
    il, ir, pj = (a[:S6_CPU_PAIRS] for a in requests[0])
    with torch.inference_mode():
        (gkp, gp3, ghm), gcodes = requant_codes(lambda: inf8.model(
            normalized(il, ir, dev), torch.as_tensor(pj, device=dev),
            return_heatmaps=True))
        (ckp, cp3, chm), ccodes = requant_codes(lambda: cpu8.model(
            normalized(il, ir, "cpu"), torch.as_tensor(pj),
            return_heatmaps=True))
        cf = len(ccodes) - 4              # cf_out, then the three deconvs
        rt = inf8.model.rt
        dec = qz._decoder_walk(qz._Int8Ctx(rt), (ccodes[cf].to(dev),
                                                 rt.scale("cf_out")))
        proj_j = torch.as_tensor(pj)[:, None].expand(S6_CPU_PAIRS, 19, 2,
                                                     3, 4)
        ref3 = dlt_triangulate(proj_j, gkp.cpu().transpose(1, 2))
    require(len(gcodes) == len(ccodes), "int8: requant points differ")
    enc_flips = sum(int((g != c).sum()) for g, c in zip(gcodes[:cf],
                                                        ccodes[:cf]))
    flips = [int((g != c).sum()) for g, c in zip(gcodes, ccodes)]
    cf_d = (gcodes[cf].int() - ccodes[cf].int()).abs()
    dec_exact = torch.equal(dec.cpu().reshape(chm.shape), chm)
    hm_scale = float(chm.abs().max())
    hm_err = float((ghm.cpu() - chm).abs().max()) / hm_scale
    kp_err = float((gkp.cpu() - ckp).abs().max())
    p3_rel = float(((gp3.cpu() - ref3).norm(dim=-1)
                    / ref3.norm(dim=-1)).max())
    vs_cpu = {"requant_points": len(ccodes), "encoder_flips": enc_flips,
              "flips_by_point": flips, "cf_out_codes": cf_d.numel(),
              "cf_out_flips": int((cf_d > 0).sum()),
              "cf_out_max_code_diff": int(cf_d.max()),
              "decoder_on_cpu_codes_exact": dec_exact,
              "hm_max": hm_err, "kp_px": kp_err, "p3_rel": p3_rel}
    print(f"# slice 6 a, int8 vs the CPU's int8 on the same pack "
          f"({S6_CPU_PAIRS} pairs): {len(ccodes)} requant points, encoder "
          f"flips {enc_flips}, cf_out {vs_cpu['cf_out_flips']} of "
          f"{cf_d.numel()} (max {vs_cpu['cf_out_max_code_diff']} code), "
          f"flips by point after it {flips[cf:]}; decoder on the CPU's "
          f"cf_out codes exact: {dec_exact}; heatmaps {hm_err:.3g} of max, "
          f"pred_2d {kp_err:.3g} px, pred_3d vs the CPU DLT of the card's "
          f"pred_2d {p3_rel:.3g}")
    require(enc_flips == 0, f"int8: {enc_flips} int8 codes before cf_out "
                            f"differ from the CPU's (exact arithmetic)")
    require(int((cf_d > 0).sum()) <= CF_FLIPS * cf_d.numel()
            and int(cf_d.max()) <= 1,
            f"int8: cf_out flips {vs_cpu['cf_out_flips']} (bound "
            f"{CF_FLIPS} of {cf_d.numel()}, one code each)")
    require(dec_exact, "int8: the decoder on the CPU's cf_out codes is not "
                       "bit-equal to the CPU's")
    require(hm_err < HM_MAX_TOL and kp_err < 2.0 and p3_rel < 1e-3,
            f"int8 vs CPU: heatmaps {hm_err}, pred_2d {kp_err} px, pred_3d "
            f"{p3_rel}")

    # against the bf16 fused request on the same frames
    il, ir, pj = requests[0]
    with torch.inference_mode():
        imgs = normalized(il, ir, dev)
        pjt = torch.as_tensor(pj, device=dev)
        _, _, h16 = inf.model(imgs, pjt, return_heatmaps=True)
        _, _, h8 = inf8.model(imgs, pjt, return_heatmaps=True)
    a, b = h16.float().cpu().numpy().ravel(), h8.cpu().numpy().ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    max_err = float(np.abs(a - b).max() / np.abs(a).max())
    print(f"# slice 6 a, int8 vs the bf16 fused request ({S6_PAIRS} "
          f"pairs): heatmap correlation {corr:.6f} (bound > {INT8_CORR}), "
          f"max error {max_err:.4f} of max (bound < {INT8_MAX_ERR})")
    require(corr > INT8_CORR and max_err < INT8_MAX_ERR,
            f"int8 vs bf16: correlation {corr}, max error {max_err}")

    # timing at S6_PAIRS pairs, inputs on the card
    args = [torch.as_tensor(x, device=dev) for x in requests[1]]
    times = {}
    for name, fn in (("int8", lambda: inf8.predict_batch(*args)),
                     ("bf16 fused", lambda: inf.predict_batch(*args))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        sync()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = device_groups(fn)
        times[name] = dict(prof, wall_ms=host_ms(fn), peak_gib=peak)
        print(f"# slice 6 a, {name} request at {S6_PAIRS} pairs: wall "
              f"{times[name]['wall_ms']:.2f} ms, device busy "
              f"{prof['device_ms']:.3f} ms in {prof['launches']:.0f} "
              f"launches, peak {peak:.2f} GiB; "
              + ", ".join(f"{k} {v:.3f}" for k, v in prof["groups"].items()))
    return inf8, sd, requests, {
        "launches": n, "calib_s": calib_s, "vs_cpu": vs_cpu,
        "vs_bf16": {"corr": corr, "max_err": max_err}, "times": times,
        "pack_bytes": os.path.getsize(pack_path)}


def run_int8_apps(sd, cfg, mads, work, dev):
    """b. `inference --int8 --int8_pack` on the tree (calibrating and
    writing the pack, then loading it with no fp checkpoint), beside
    `inference --bf16 --fused_inference` on the same weights."""
    import contextlib
    import io
    import os
    from fast3dhpe_tpu_torch.apps import inference
    weights = os.path.join(work, "s6_weights")
    os.makedirs(os.path.join(weights, cfg.MODEL.NAME))
    torch.save({k: v.cpu() for k, v in sd.items()},
               os.path.join(weights, cfg.MODEL.NAME, "best.pth"))
    cfg_path = app_config("configs/mads_3d.yaml",
                          os.path.join(work, "s6.yaml"), mads,
                          MODEL={"PRETRAINED": ""})
    B = cfg.TEST.BATCH_SIZE
    batches = -(-TREE_VALID_FRAMES // B)
    argv = ["--config_path", cfg_path, "--movement", "all", "--data_path",
            os.path.join(mads, "valid"), "--batch_size", str(B), "--device",
            dev.type]
    pack = os.path.join(work, "app_int8.npz")
    runs = {}
    for name, extra in (
            ("bf16 fused", ["--weights_root", weights, "--bf16",
                            "--fused_inference"]),
            ("int8, calibrating", ["--weights_root", weights, "--int8",
                                   "--int8_pack", pack]),
            ("int8, from the pack", ["--weights_root",
                                     os.path.join(work, "no_weights"),
                                     "--int8", "--int8_pack", pack])):
        with contextlib.redirect_stdout(io.StringIO()):
            res, n, wall = counted(inference.main, argv + extra)
        e2, e3 = res[EVAL_MOVEMENT]
        require(np.isfinite([e2, e3]).all(), f"{name} app: MPJPE {e2}, {e3}")
        require_counts(n, batches, 1, 0, 4 if name == "bf16 fused" else 0,
                       f"the {name} inference app")
        runs[name] = {"mpjpe": [e2, e3], "launches": n, "wall_s": wall}
    i8, i8b = runs["int8, calibrating"], runs["int8, from the pack"]
    ratio = (i8["mpjpe"][0] + 1e-6) / (runs["bf16 fused"]["mpjpe"][0] + 1e-6)
    print("# slice 6 b, inference apps on valid/HipHop: " + "; ".join(
        f"{k} MPJPE2D {v['mpjpe'][0]:.6g} px, MPJPE3D {v['mpjpe'][1]:.6g} "
        f"mm, {v['wall_s']:.1f} s" for k, v in runs.items())
        + f"; int8/bf16 MPJPE2D {ratio:.4f}")
    require(np.allclose(i8b["mpjpe"], i8["mpjpe"], rtol=1e-6),
            "the int8 app from its pack differs from the calibrating run")
    require(0.3 < ratio < 3.0, f"int8 app MPJPE2D / bf16 {ratio}")
    return dict(runs, pack_bytes=os.path.getsize(pack))


EXPORT_CHILD = r"""
import json, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False       # as the parent's fp32 run
torch.backends.cuda.matmul.allow_tf32 = False
from fast3dhpe_tpu_torch.export import load_serving
d = np.load(sys.argv[1])
out = {}
for kind, path in json.loads(sys.argv[2]).items():
    t = time.perf_counter()
    serve = load_serving(path, "cuda")
    load_s = time.perf_counter() - t
    ops = [sys.modules[m] for m in ("fast3dhpe_tpu_torch.ops.softargmax",
                                    "fast3dhpe_tpu_torch.ops.bottleneck")]
    counters = {"soft_argmax": ops[0].soft_argmax_fused,
                "soft_argmax_bwd": ops[0].soft_argmax_bwd_fused,
                "fused_bottleneck": ops[1].fused_bottleneck}
    for c in counters.values():
        c.launches = 0
    kp, p3 = serve(d["img_l"], d["img_r"], d["proj"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    np.save(sys.argv[3] + kind + "_kp.npy", kp.cpu().numpy())
    np.save(sys.argv[3] + kind + "_p3.npy", p3.cpu().numpy())
    raised = []
    for bad in ((d["img_l"].astype(np.float32), d["img_r"], d["proj"]),
                (d["img_l"][:1], d["img_r"][:1], d["proj"][:1])):
        try:
            serve(*bad)
            raised.append(None)
        except (TypeError, ValueError) as err:
            raised.append(type(err).__name__)
    out[kind] = {"load_s": load_s, "launches": launches, "raised": raised}
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "fast3dhpe_tpu"))
print(json.dumps(out))
"""


def start_export(sd, pack, request, cfg, dev, work):
    """c. export fp32 and int8 at S6_PAIRS and save them; then start a new
    process that imports only fast3dhpe_tpu_torch.export, loads each and
    serves `request` (it runs while phase b's apps run; finish_export
    waits for it)."""
    import json
    import os
    from fast3dhpe_tpu_torch import export as E
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    paths = {"fp32": os.path.join(work, "cdrnet101.pt2"),
             "int8": os.path.join(work, "cdrnet101_int8.pt2")}
    info = {}
    for kind in ("fp32", "int8"):
        t = time.perf_counter()
        if kind == "fp32":
            ep = E.export_cdrnet(CDRNet.from_config(cfg), sd, S6_PAIRS, size,
                                 device=dev)
        else:
            ep = E.export_cdrnet_int8(pack, S6_PAIRS, size,
                                      dlt_method=cfg.MODEL.EXTRA.DLT_METHOD,
                                      device=dev)
        export_s = time.perf_counter() - t
        info[kind] = {"export_s": export_s,
                      "bytes": E.save_exported(ep, paths[kind]),
                      "graph_nodes": len(ep.graph.nodes)}
        del ep
    torch.cuda.empty_cache()
    frames = os.path.join(work, "frames.npz")
    np.savez(frames, **dict(zip(("img_l", "img_r", "proj"), request)))
    prefix = os.path.join(work, "served_")
    # run from the checkout's root, which `-c` puts on the child's path
    child = subprocess.Popen(
        [sys.executable, "-c", EXPORT_CHILD, frames, json.dumps(paths),
         prefix], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return child, prefix, info, time.perf_counter()


def finish_export(started, inf8, request, sd, cfg, dev):
    """c, continued: wait for the child and hold what it served: pred_2d
    against predict_batch on the same frames (EXPORT_RTOL, EXPORT_ATOL),
    and pred_3d against the port's DLT on the card of the served pred_2d,
    within EXPORT_ATOL of the scene's scale (the larger of the points'
    extent and converging_rig's 3 m camera distance), or CPU_NOISE_X times
    the DLT's own change under pred_2d x (1 +- 1e-7) if that is larger, as
    train_vs_cpu holds the DLT's gradient (two near-equal smallest singular
    values make the DLT's solution sensitive to rounding). pred_3d against
    predict_batch's is reported, not held: the fp32 Jacobi DLT of an
    untrained net's keypoints turns the two runs' 4.6e-5 px of fp32 noise
    in pred_2d into 2.6-6 mm (converging_rig) or 1.2e-3 of the largest
    coordinate at the w floor (bench.py's rig), in one run each."""
    import json
    from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    child, prefix, info, t0 = started
    try:
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t0
    require(child.returncode == 0, f"the export child failed:\n"
                                   f"{stderr[-4000:]}")
    loaded = json.loads(stdout.strip().splitlines()[-1])
    require(loaded["modules"] == [], f"the child loaded {loaded['modules']}")
    il, ir, pj = request
    fp32 = CDRNetInferencer(cfg, state_dict=sd, device=dev)
    refs = {"fp32": fp32.predict_batch(il, ir, pj),
            "int8": inf8.predict_batch(il, ir, pj)}
    del fp32
    for kind in ("fp32", "int8"):
        kp = np.load(prefix + kind + "_kp.npy")
        p3 = np.load(prefix + kind + "_p3.npy")
        rkp, rp3 = (x.cpu().numpy() for x in refs[kind])
        with torch.inference_mode():
            proj_j = torch.as_tensor(pj, device=dev)[:, None].expand(
                S6_PAIRS, kp.shape[2], 2, 3, 4)
            kp_t = torch.as_tensor(kp, device=dev).transpose(1, 2)
            dlt, up, down = (dlt_triangulate(proj_j, kp_t * f).cpu().numpy()
                             for f in (1.0, 1.0 + 1e-7, 1.0 - 1e-7))
        kp_err = float(np.abs(kp - rkp).max())
        scale = max(float(np.abs(dlt).max()), RIG_DISTANCE_MM)
        p3_err = float(np.abs(p3 - dlt).max()) / scale
        noise = max(float(np.abs(d - dlt).max()) for d in (up, down)) / scale
        p3_vs_eager = float(np.abs(p3 - rp3).max()) / scale
        row = dict(info[kind], **loaded[kind], kp_err=kp_err, p3_err=p3_err,
                   dlt_noise=noise, p3_vs_predict_batch=p3_vs_eager)
        info[kind] = row
        print(f"# slice 6 c, export {kind} at {S6_PAIRS} pairs: traced in "
              f"{row['export_s']:.1f} s, {row['graph_nodes']} graph nodes, "
              f"{row['bytes']} bytes; a new process (export only) loads it "
              f"in {row['load_s']:.1f} s (beside phase b), launches "
              f"{row['launches']}; pred_2d vs predict_batch {kp_err:.3g} px;"
              f" pred_3d vs the DLT of its pred_2d {p3_err:.3g} (the DLT's"
              f" own change under pred_2d x (1 +- 1e-7): {noise:.3g}), vs "
              f"predict_batch {p3_vs_eager:.3g} of the scene's scale; a "
              f"float frame and a wrong batch raise {row['raised']}")
        require(np.allclose(kp, rkp, rtol=EXPORT_RTOL, atol=EXPORT_ATOL)
                and p3_err <= max(EXPORT_ATOL, CPU_NOISE_X * noise),
                f"export {kind}: pred_2d {kp_err}, pred_3d {p3_err} (DLT "
                f"noise {noise})")
        require(row["launches"] == {"soft_argmax": 1, "soft_argmax_bwd": 0,
                                    "fused_bottleneck": 0},
                f"export {kind}: the loaded call launched {row['launches']}")
        require(row["raised"] == ["TypeError", "ValueError"],
                f"export {kind}: bad inputs raised {row['raised']}")
    info["child_s"] = child_s
    return info


def _grads_and_stats(model):
    return ({n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()
             if "running" in n})


def _global_rel(got, ref):
    num = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref)
    den = sum(float((ref[n] ** 2).sum()) for n in ref)
    return (num / den) ** 0.5


def s6_model(cfg, start_sd, dtype, dev, remat=False, policy=None):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    model = CDRNet(num_joints=cfg.MODEL.NUM_JOINTS,
                   num_layers=cfg.MODEL.NUM_LAYERS,
                   dlt_method=cfg.MODEL.EXTRA.DLT_METHOD, dtype=dtype,
                   remat=remat, remat_policy=policy)
    model.load_state_dict(start_sd, strict=True)
    return model.to(dev)


def sgd0_step(cfg, start_sd, dtype, dev, batch, use_3d, bn1=None, **remat):
    """One train step at lr 0 from start_sd: (metrics, grads, BN stats)
    on the CPU, and encoder.bn1's output when bn1 is a list."""
    from fast3dhpe_tpu_torch.train.state import TrainState
    model = s6_model(cfg, start_sd, dtype, dev, **remat)
    if bn1 is not None:
        model.encoder.bn1.register_forward_hook(
            lambda m, a, out: bn1.append(out.detach().float().cpu()))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    m = train_step_fn(cfg)(state, on_device(batch, dev), use_3d)
    return ({k: v.item() for k, v in m.items()},) + _grads_and_stats(model)


def check_bf16_bn(dev):
    """The train-mode BN layer on one bf16 input (layer1's shape at 32
    pairs), card against CPU: y and dx within one bf16 rounding of their
    largest value, the running statistics 1e-5, the parameters'
    gradients 1e-4."""
    from fast3dhpe_tpu_torch.models.layers import BatchNorm2d, bn_row_mask
    gen = torch.Generator().manual_seed(SEED + 21)
    x = (torch.randn((2 * S6_PAIRS, 64, 64, 64), generator=gen) * 2 + 0.5
         ).bfloat16().contiguous(memory_format=torch.channels_last)
    cot = torch.randn(x.shape, generator=gen).bfloat16()
    rv = torch.ones(2 * S6_PAIRS)
    rv[-8:] = 0
    res = {}
    for d in ("cpu", dev):
        bn = BatchNorm2d(64).train().to(d)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 64))
            bn.bias.copy_(torch.linspace(-1, 1, 64))
        xd = x.to(d).detach().clone().requires_grad_(True)
        y = bn(xd, bn_row_mask(rv.to(d)))
        (y.float() * cot.to(d).float()).sum().backward()
        res[str(d)] = [t.detach().float().cpu() for t in (
            y, xd.grad, bn.running_mean, bn.running_var, bn.weight.grad,
            bn.bias.grad)]
    errs = [float((g - c).abs().max() / c.abs().max())
            for g, c in zip(res[str(dev)], res["cpu"])]
    print(f"# slice 6 d, bf16 train BN card vs CPU: y {errs[0]:.3g}, dx "
          f"{errs[1]:.3g} (bound {BF16_ULP:.3g}), running mean / var "
          f"{errs[2]:.3g} / {errs[3]:.3g} (1e-5), dweight / dbias "
          f"{errs[4]:.3g} / {errs[5]:.3g} (1e-4)")
    require(errs[0] <= BF16_ULP and errs[1] <= BF16_ULP
            and max(errs[2:4]) <= 1e-5 and max(errs[4:]) <= 1e-4,
            f"bf16 train BN card vs CPU: {errs}")
    return errs


def check_bf16_train(cfg, start_sd, dev):
    """d. bf16 training, checked: the BN layer against the CPU; the step
    at S6_PAIRS pairs (TRAIN_PAD padded) against the card's fp32 step, and
    at 2 pairs against the CPU's bf16 step. Nothing here is timed, so it
    runs while c's new process loads its artifacts."""
    out = {"bn_vs_cpu": check_bf16_bn(dev)}
    batch = train_batch(np.random.RandomState(SEED + 2), S6_PAIRS, TRAIN_PAD,
                        cfg.MODEL.IMAGE_SIZE[0])
    runs, bn1 = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        bn1[dt] = []
        runs[dt] = sgd0_step(cfg, start_sd, dt, dev, batch, True, bn1[dt])
    (m32, g32, s32), (m16, g16, s16) = runs[torch.float32], \
        runs[torch.bfloat16]
    a, b = bn1[torch.float32][0], bn1[torch.bfloat16][0]
    bn1_max = float((a - b).abs().max() / a.abs().max())
    bn1_mean = float((a - b).abs().mean() / a.abs().max())
    loss_rel = max(abs(m16[k] - m32[k]) / abs(m32[k])
                   for k in ("loss", "loss_2d", "loss_3d"))
    vs32 = {"loss": loss_rel, "bn1_max": bn1_max, "bn1_mean": bn1_mean,
            "grads": _global_rel(g16, g32), "bn_stats": _global_rel(s16, s32)}
    print(f"# slice 6 d, bf16 step vs fp32 at {S6_PAIRS} pairs: losses "
          f"{loss_rel:.3g} (bound {BF16_LOSS_TOL}), encoder.bn1 max "
          f"{bn1_max:.3g} / mean {bn1_mean:.3g} of max (bounds "
          f"{HM_MAX_TOL} / {HM_MEAN_TOL}); gradients {vs32['grads']:.3g} and "
          f"BN statistics {vs32['bn_stats']:.3g} of their norms (not held)")
    require(loss_rel <= BF16_LOSS_TOL and bn1_max < HM_MAX_TOL
            and bn1_mean < HM_MEAN_TOL, f"bf16 vs fp32 step: {vs32}")
    out["vs_fp32"] = vs32

    # 2 pairs, card against the CPU, warmup (see BF16_NOISE_X)
    b2 = train_batch(np.random.RandomState(SEED + 3), 2, 1,
                     cfg.MODEL.IMAGE_SIZE[0])
    card, cpu16, cpu32 = (sgd0_step(cfg, start_sd, dt, d, b2, False)
                          for dt, d in ((torch.bfloat16, dev),
                                        (torch.bfloat16, "cpu"),
                                        (torch.float32, "cpu")))
    vs_cpu = {"loss": max(abs(card[0][k] - cpu16[0][k]) / abs(cpu16[0][k])
                          for k in ("loss", "loss_2d")),
              "grads": _global_rel(card[1], cpu16[1]),
              "grads_cpu_noise": _global_rel(cpu16[1], cpu32[1]),
              "bn_stats": _global_rel(card[2], cpu16[2]),
              "bn_stats_cpu_noise": _global_rel(cpu16[2], cpu32[2])}
    print(f"# slice 6 d, bf16 step card vs CPU at 2 pairs (warmup): losses "
          f"{vs_cpu['loss']:.3g}, gradients {vs_cpu['grads']:.3g} (CPU bf16 "
          f"vs fp32 {vs_cpu['grads_cpu_noise']:.3g}), BN statistics "
          f"{vs_cpu['bn_stats']:.3g} (CPU {vs_cpu['bn_stats_cpu_noise']:.3g})")
    require(vs_cpu["loss"] <= 1e-2
            and vs_cpu["grads"] <= BF16_NOISE_X * vs_cpu["grads_cpu_noise"]
            and vs_cpu["bn_stats"] <= BF16_NOISE_X
            * vs_cpu["bn_stats_cpu_noise"], f"bf16 card vs CPU: {vs_cpu}")
    out["vs_cpu"] = vs_cpu
    return out


def time_bf16_train(cfg, start_sd, dev, mads, work):
    """d, timed: the bf16 step at S6_PAIRS pairs with the config's Adam,
    its time, device busy, peak memory, launches and K2's dtype; one
    `train_cdr --bf16` epoch on the tree."""
    import os
    from fast3dhpe_tpu_torch.apps import train_cdr
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.ops import softargmax as sa
    from fast3dhpe_tpu_torch.train.state import TrainState
    out = {}
    batch = train_batch(np.random.RandomState(SEED + 2), S6_PAIRS, TRAIN_PAD,
                        cfg.MODEL.IMAGE_SIZE[0])
    db = on_device(batch, dev)
    torch.cuda.empty_cache()
    model = s6_model(cfg, start_sd, torch.bfloat16, dev)
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    step = train_step_fn(cfg)
    k2_dtypes, bwd = [], sa._bwd_cuda

    def recorded(heatmaps, *args):
        k2_dtypes.append(str(heatmaps.dtype).replace("torch.", ""))
        return bwd(heatmaps, *args)

    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    sa._bwd_cuda = recorded
    try:
        step(state, db, True)
    finally:
        sa._bwd_cuda = bwd
    n = read_counts(counters)
    require_counts(n, 1, 1, 1, 0, "the bf16 train step")
    require(k2_dtypes == ["bfloat16"], f"K2 ran on {k2_dtypes}")
    times = []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        step(state, db, True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_calls(lambda: step(state, db, True), calls=2)
    out["step"] = {"step_ms": statistics.median(times), "times_ms": times,
                   "peak_gib": peak, "launches": n, "k2_dtype": k2_dtypes,
                   "device_ms": prof["device_ms"],
                   "device_activities": prof["launches"]}
    print(f"# slice 6 d, bf16 train step at {S6_PAIRS} pairs: median "
          f"{out['step']['step_ms']:.1f} ms ({times}), device busy "
          f"{prof['device_ms']:.1f} ms in {prof['launches']:.0f} launches, "
          f"peak {peak:.2f} GiB, launches {n}, K2 on {k2_dtypes}")
    del model, state
    torch.cuda.empty_cache()

    # one `train_cdr --bf16` epoch on the tree, stacked from the card
    n_pairs = len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES
    cfg_path = app_config(
        "configs/mads_3d.yaml", os.path.join(work, "bf16.yaml"), mads,
        MODEL={"PRETRAINED": "", "NAME": "cdrnet_bf16"},
        DATASET={"DEVICE_CACHE_BYTES": 2 * n_pairs * RAW_H * RAW_W * 3},
        TRAIN={"EPOCH": 1, "WARMUP": 0})
    with EpochTimes() as et:
        h, n, wall = counted(train_cdr.main, [
            "--config_path", cfg_path, "--overwrite", "--bf16", "--device",
            dev.type, "--weights_root", os.path.join(work, "s6_bf16")])
    app_cfg = load_config(cfg_path)
    steps = -(-n_pairs // app_cfg.TRAIN.BATCH_SIZE)
    evals = -(-TREE_VALID_FRAMES // app_cfg.TEST.BATCH_SIZE)
    want = {"soft_argmax": steps + evals, "soft_argmax_bwd": steps,
            "fused_bottleneck": 0}
    require(n == want, f"train_cdr --bf16 launched {n}, not {want}")
    _finite_history(h, "train_cdr --bf16")
    out["app"] = {"epoch_s": et.seconds, "wall_s": wall, "launches": n,
                  "history": h}
    print(f"# slice 6 d, train_cdr --bf16, one epoch: {et.seconds} s "
          f"(wall {wall:.1f} s), launches {n}, history {h}")
    return out


def run_remat(cfg, start_sd, dev):
    """e. remat: fp32 steps with remat None and "convs" against the plain
    step (cuDNN deterministic): loss, gradients and BN statistics equal;
    then peak memory and step ms at S6_REMAT_PAIRS."""
    from fast3dhpe_tpu_torch.train.state import TrainState
    variants = {"plain": {}, "remat": {"remat": True},
                "remat convs": {"remat": True, "policy": "convs"}}
    batch = train_batch(np.random.RandomState(SEED + 2), S6_PAIRS, TRAIN_PAD,
                        cfg.MODEL.IMAGE_SIZE[0])
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    launches = {}
    try:
        runs = {}
        for name, kw in variants.items():
            counters = reset_counts()
            runs[name] = sgd0_step(cfg, start_sd, torch.float32, dev, batch,
                                   False, **kw)
            launches[name] = read_counts(counters)
            require_counts(launches[name], 1, 1, 1, 0, f"the {name} step")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    m0, g0, s0 = runs["plain"]
    eq = {}
    for name in ("remat", "remat convs"):
        m, g, s = runs[name]
        eq[name] = {
            "loss_rel": abs(m["loss"] - m0["loss"]) / abs(m0["loss"]),
            "grads_rel": _global_rel(g, g0),
            "bn_rel": max(float((s[k] - s0[k]).abs().max()
                              / s0[k].abs().max().clamp_min(1e-30))
                          for k in s0),
            "bit_equal": all(torch.equal(g[k], g0[k]) for k in g0)
            and all(torch.equal(s[k], s0[k]) for k in s0)}
        require(eq[name]["loss_rel"] <= 1e-6 and eq[name]["grads_rel"] <= 1e-5
                and eq[name]["bn_rel"] <= 1e-6,
                f"{name} step differs from the plain one: {eq[name]}")
    print(f"# slice 6 e, remat vs plain step at {S6_PAIRS} pairs (fp32, "
          f"cuDNN deterministic): {eq}")
    db = on_device(batch, dev)
    step = train_step_fn(cfg)
    mem = {}
    for pairs in S6_REMAT_PAIRS:
        b = {k: v[:pairs] for k, v in db.items()} if pairs <= S6_PAIRS \
            else on_device(train_batch(np.random.RandomState(SEED + 4),
                                       pairs, TRAIN_PAD,
                                       cfg.MODEL.IMAGE_SIZE[0]), dev)
        for name, kw in variants.items():
            model = s6_model(cfg, start_sd, torch.float32, dev, **kw)
            state = TrainState.create(model, cfg, steps_per_epoch=1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step(state, b, True)
            times = []
            for _ in range(2):
                t = time.perf_counter()
                step(state, b, True)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            mem[f"{name}, {pairs} pairs"] = {
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "step_ms": statistics.median(times)}
            del model, state
    torch.cuda.empty_cache()
    print("# slice 6 e, fp32 train step peak memory and ms: " + "; ".join(
        f"{k} {v['peak_gib']:.2f} GiB {v['step_ms']:.1f} ms"
        for k, v in mem.items()))
    return {"vs_plain": eq, "launches": launches["remat convs"],
            "memory": mem}


def run_slice6(inf, cfg, start_sd, mads, dev, smi):
    """Phase 11: int8 serving, the int8 apps, the export, bf16 training
    and remat of CDRNet-101 at 256 px (a-e)."""
    t0 = time.perf_counter()
    out, parts = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        parts[name] = time.perf_counter() - t
        return res

    with tempfile.TemporaryDirectory() as work:
        inf8, sd, requests, out["int8"] = part("a int8", run_int8, inf, cfg,
                                               dev, work)
        request = requests[2][:2] + (converging_rig(S6_PAIRS),)
        started = part("c export", start_export, sd, inf8.pack, request,
                       cfg, dev, work)
        try:
            out["int8_apps"] = part("b apps", run_int8_apps, sd, cfg, mads,
                                    work, dev)
            bf16 = part("d bf16 checks", check_bf16_train, cfg, start_sd,
                        dev)
        except BaseException:
            started[0].kill()
            started[0].wait()
            raise
        out["export"] = part("c loaded", finish_export, started, inf8,
                             request, sd, cfg, dev)
        del inf8
        torch.cuda.empty_cache()
        bf16.update(part("d bf16 timed", time_bf16_train, cfg, start_sd,
                         dev, mads, work))
        out["bf16"] = bf16
    torch.cuda.empty_cache()
    out["remat"] = part("e remat", run_remat, cfg, start_sd, dev)
    out["launches"] = {
        "int8 serving": out["int8"]["launches"],
        **{f"{k} app": v["launches"] for k, v in out["int8_apps"].items()
           if isinstance(v, dict)},
        **{f"export {k}, loaded": out["export"][k]["launches"]
           for k in ("fp32", "int8")},
        "bf16 train step": out["bf16"]["step"]["launches"],
        "train_cdr --bf16 app": out["bf16"]["app"]["launches"],
        "remat convs step": out["remat"]["launches"]}
    out["seconds"] = parts
    print(f"# slice 6 ({smi}): {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
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
    if args not in ([], ["--kernels"], ["--slice6"]):
        sys.exit("usage: python3 chip_smoke.py [--kernels | --slice6]")
    kernels_only = args == ["--kernels"]
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs a CUDA device")
    check_apis()
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
    inf, serve_launches, cpu_inf = phase("serving path", run_path, cfg, dev)
    if args == ["--slice6"]:
        start_sd = phase("training path", run_train, cfg, dev)["start_sd"]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            mads, _, _ = phase("trees", write_trees, tmp)
            s6 = phase("slice 6", run_slice6, inf, cfg, start_sd, mads, dev,
                       smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"slice6": s6}))
        return
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
    del train
    torch.cuda.empty_cache()

    cache, cache_info = phase("frame cache", build_cache, dev)
    pipe_checks = phase("pipeline checks", check_pipeline, cache, cfg, dev)
    pipe = phase("pipeline training", run_pipeline_train, cfg, dev, cache,
                 train_summary["step_ms"])
    raw = phase("raw serving", run_raw_serving, inf, cpu_inf.model, cache,
                cfg, dev)
    del cache
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        mads, mpii, trees = phase("trees", write_trees, tmp)
        loader_train = phase("loader training", run_loader_train, mads, dev)
        torch.cuda.empty_cache()
        loader_2d = phase("2D loaders", run_loader_2d, mads, mpii, dev)
        torch.cuda.empty_cache()
        movement = phase("movement eval", run_movement_eval, inf, cpu_inf,
                         mads, cfg, dev)
        torch.cuda.empty_cache()
        apps = phase("apps", run_apps, mads, dev, smi)
        torch.cuda.empty_cache()
        s6 = phase("slice 6", run_slice6, inf, cfg, start_sd, mads, dev, smi)
    del inf, cpu_inf
    torch.cuda.empty_cache()
    vs_cpu = phase("train card vs CPU", train_vs_cpu, cfg, start_sd, dev)

    def launch_counts(key):
        by_path = {"serving": serve_launches[key],
                   "training": train_launches[key],
                   "pipeline training": pipe["launches"][key],
                   "raw serving": raw["launches"][key],
                   "loader training, full cache":
                       loader_train["full"]["launches"][key],
                   "loader training, partial cache":
                       loader_train["partial"]["launches"][key],
                   "2D loaders": loader_2d["launches"][key]}
        by_path.update({f"movement eval, {mode}": n[key]
                        for mode, n in movement["launches"].items()})
        by_path.update({f"{app} app": apps[app]["launches"][key]
                        for app in ("train", "train_cdr", "inference",
                                    "baseline")})
        by_path.update({f"slice 6, {k}": n[key]
                        for k, n in s6["launches"].items()})
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
    print(json.dumps({"cache": cache_info, "pipeline_checks": pipe_checks,
                      "pipeline_training": pipe,
                      "raw_serving": {k: v for k, v in raw.items()
                                      if k != "launches"}}))
    print(json.dumps({"host_data": {
        "trees": trees, "loader_training": loader_train,
        "loaders_2d": loader_2d, "movement_eval": movement}}))
    print(json.dumps({"apps": apps}))
    print(json.dumps({"slice6": s6}))
    print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in phases.items()))
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
