"""Drive the PyTorch/CUDA port (fast3dhpe_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the kernels (nvcc for the
   CUDA sources, Triton's JIT for the Triton kernel), timing the build.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it and at batch 32 pairs.
3. Path phase: serves three requests of four uint8 stereo pairs through
   `CDRNetInferencer.predict_batch` at the width of configs/mads_3d.yaml
   (CDRNet-101, 256 px, 19 joints), bf16 with fused_inference=True, from
   seeded random weights. Checks shapes, finite values, that each request
   launched the soft-argmax kernel once and the fused bottleneck once per
   fused block, and one request against the same module on the CPU.
4. Times each kernel beside its bound, its plain version and its library
   comparison, the geometry's share, and predict_batch at batch 1-64, and
   splits predict_batch's device time by kernel group (torch.profiler).
5. Prints a {"kernels": [...]} line and, last, {"ok": true, ...}.

It needs one CUDA device. Without one, or when any phase fails, it exits
non-zero and prints no result.
"""

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
REQUESTS, PAIRS = 3, 4            # the path phase: 3 requests of 4 pairs
TIMING_PAIRS = 32                 # kernel timings at batch 32 pairs


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of fn() in ms, by CUDA events around each call."""
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

def check_softargmax(dev, gen):
    """K1 against its plain version on the decoder's output layout: NCHW
    channels_last (N, J, 64, 64) viewed as (N, 64, 64, J)."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
    from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused
    # tests/test_pallas_kernels.py:28 holds the Pallas kernel to 1e-3 px of
    # its jnp version; fp32 sums in another order stay well inside that
    tol_px = 1e-3
    err = 0.0
    for n in (2 * PAIRS, 2 * TIMING_PAIRS):
        for dt in (torch.float32, torch.bfloat16):
            h = (torch.randn((n, 19, 64, 64), generator=gen) * 3).to(dt)
            h = h.to(dev).contiguous(memory_format=torch.channels_last)
            hm = h.permute(0, 2, 3, 1)
            got = soft_argmax_fused(hm)
            ref = soft_argmax(hm)
            torch.cuda.synchronize()
            e = (got - ref).abs().max().item()
            require(got.shape == (n, 19, 2) and e <= tol_px,
                    f"soft-argmax kernel differs from its plain version by "
                    f"{e} px (n={n}, {dt}; tolerance {tol_px} px)")
            err = max(err, e)
    # peak recovery (tests/test_pallas_kernels.py:52-58)
    peak = torch.zeros((1, 32, 32, 2), device=dev)
    peak[0, 7, 21, 0] = 40.0
    peak[0, 30, 3, 1] = 40.0
    kp = soft_argmax_fused(peak).cpu()
    require(torch.allclose(kp, torch.tensor([[[21.0, 7.0], [3.0, 30.0]]]),
                           atol=tol_px), f"soft-argmax peak recovery: {kp}")
    print(f"# K1 soft-argmax: max |kernel - plain| = {err:.3g} px "
          f"(tolerance {tol_px} px)")
    return err


def bottleneck_case(gen, dev, n, cin, planes, downsample, hw):
    """Random bf16 block inputs with b1 > 0, so that a halo taken from
    relu(b1) instead of 0 shows at the image border."""
    cout = 4 * planes

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def pos(c, lo, hi):
        return torch.rand(c, generator=gen) * (hi - lo) + lo

    x = rnd(n, cin, hw, hw)
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


def check_bottleneck(dev, gen):
    """K3 against its plain version (same rounding points) at the two block
    shapes that fuse at 256 px."""
    from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain,
                                                    fused_bottleneck)
    # both sum in fp32 in different orders, so a value next to a bf16
    # rounding boundary can round to the other neighbour in h1, h2, h3 or
    # the output: a few elements differ by a few bf16 ulps (2^-7 relative),
    # the mean barely moves. A wrong halo moves every border pixel by
    # ~relu(b1)-sized terms and fails the mean bound.
    max_rel, mean_rel = 2.0 ** -5, 2.0 ** -11
    err = 0.0
    for name, (cin, planes, ds, hw) in BLOCK_SHAPES.items():
        for n in (2 * PAIRS, 2 * TIMING_PAIRS):
            x, args = bottleneck_case(gen, dev, n, cin, planes, ds, hw)
            got = fused_bottleneck(x, *args).float()
            ref = bottleneck_plain(x, *args).float()
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            d = (got - ref).abs()
            border = torch.cat([d[:, :, 0], d[:, :, -1], d[:, :, :, 0],
                                d[:, :, :, -1]], dim=-1)
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
    from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused

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
    fused_bottleneck.launches = 0
    outs = [inf.predict_batch(*req) for req in requests]
    torch.cuda.synchronize()
    launches = {"soft_argmax": soft_argmax_fused.launches,
                "fused_bottleneck": fused_bottleneck.launches}
    print(f"# path: {REQUESTS} requests x {PAIRS} pairs, launches "
          f"{launches}")
    require(launches["soft_argmax"] == REQUESTS,
            f"soft-argmax kernel launched {launches['soft_argmax']} times "
            f"for {REQUESTS} requests")
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


# ------------------------------------------------------------------ timing

def time_softargmax(dev, gen):
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
    from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused
    n = 2 * TIMING_PAIRS
    h = (torch.randn((n, 19, 64, 64), generator=gen) * 3).to(torch.bfloat16)
    hm = h.to(dev).contiguous(memory_format=torch.channels_last).permute(
        0, 2, 3, 1)
    ms = cuda_ms(lambda: soft_argmax_fused(hm))
    plain = cuda_ms(lambda: soft_argmax(hm))
    nbytes = hm.numel() * hm.element_size() + n * 19 * 2 * 4
    bound, by = bound_ms(nbytes, 6 * hm.numel(), FP32_FLOPS)
    print(f"# K1 at {n} images (bf16 64x64x19, channels_last): kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def time_bottleneck(dev, gen):
    from fast3dhpe_tpu_torch.models.resnet import Bottleneck
    from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain,
                                                    fused_bottleneck)
    n = 2 * TIMING_PAIRS
    per_forward = {"layer1.0": 1, "layer2.x": 3}
    parts, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": 0.0}
    bytes_t = ops_t = 0.0
    for name, (cin, planes, ds, hw) in BLOCK_SHAPES.items():
        x, args = bottleneck_case(gen, dev, n, cin, planes, ds, hw)
        cout = 4 * planes
        ms = cuda_ms(lambda: fused_bottleneck(x, *args))
        plain = cuda_ms(lambda: bottleneck_plain(x, *args), iters=5)
        # the unfused block as cuDNN runs it without the kernel: the port's
        # Bottleneck module, bf16, BN in eval mode
        blk = Bottleneck(cin, planes, 1, ds).to(dev).eval()
        with torch.inference_mode():
            lib = cuda_ms(lambda: blk(x))
        flops = 2 * n * hw * hw * planes * (
            cin + 9 * planes + cout + (cin * cout // planes if ds else 0))
        wbytes = 2 * (cin * planes + 9 * planes * planes + planes * cout
                      + (cin * cout if ds else 0))
        nbytes = 2 * n * hw * hw * (cin + cout) + wbytes
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        k = per_forward[name]
        bytes_t += k * nbytes / HBM_BPS * 1e3
        ops_t += k * flops / BF16_FLOPS * 1e3
        for key, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                         ("library_ms", lib)):
            total[key] += k * val
        parts.append({"block": name, "per_forward": k, "ms": ms,
                      "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                      "library_ms": lib, "gflop": flops / 1e9,
                      "mbytes": nbytes / 1e6})
        print(f"# K3 {name} at {n} images: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, unfused cuDNN block {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
    total["bound_by"] = "bytes" if bytes_t >= ops_t else "operations"
    total["parts"] = parts
    return total


def time_serving(inf, dev):
    from fast3dhpe_tpu_torch.geometry.triangulation import (dlt_triangulate,
                                                            pinv_projection)
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
    print(f"# peak device memory {peak:.2f} GiB")
    return serving


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel's name)
    ("K3 fused bottleneck", ("bottleneck_kernel",)),
    ("K1 soft-argmax", ("softargmax_fwd",)),
    ("cuDNN/cuBLAS conv and matmul", ("xmma", "cutlass", "nvjet", "cudnn",
                                      "gemm", "conv")),
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
    print(f"# profile predict_batch batch {pairs}: device busy {busy:.3f} ms "
          f"of {wall_ms:.3f} ms wall (idle {100 * (1 - busy / wall_ms):.0f}%)"
          f", {launches // calls} kernel launches a call")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"#   {name}: {ms:.3f} ms ({100 * ms / busy:.0f}%)")
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "launches": launches // calls, "groups": groups}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs a CUDA device")
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.ops._build import build
    from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # fp32 references run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build(["fused_bottleneck"])
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"# nvcc {name}: {line.strip()}")
    t0 = time.perf_counter()
    soft_argmax_fused(torch.zeros((1, 64, 64, 19), device=dev))
    torch.cuda.synchronize()
    print(f"# build: nvcc {t_nvcc:.1f} s, Triton JIT "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(SEED)
    err_k1 = check_softargmax(dev, gen)
    err_k3 = check_bottleneck(dev, gen)

    cfg = load_config("configs/mads_3d.yaml")
    inf, launches, _ = run_path(cfg, dev)

    k1 = time_softargmax(dev, gen)
    k3 = time_bottleneck(dev, gen)
    serving = time_serving(inf, dev)
    prof = profile_serving(inf, dev, TIMING_PAIRS,
                           serving[TIMING_PAIRS]["ms"])

    kernels = [
        dict(name="soft_argmax_fwd", route="triton",
             source="fast3dhpe_tpu_torch/ops/softargmax.py",
             replaces="fast3dhpe_tpu/ops/pallas_softargmax.py:64",
             launches=launches["soft_argmax"], max_abs_err=err_k1,
             shape=f"({2 * TIMING_PAIRS}, 64, 64, 19) bf16", **k1),
        dict(name="fused_bottleneck", route="cuda",
             source="fast3dhpe_tpu_torch/csrc/fused_bottleneck.cu",
             replaces="fast3dhpe_tpu/ops/pallas_bottleneck.py:191",
             launches=launches["fused_bottleneck"], max_abs_err=err_k3,
             shape=(f"one forward's launches at {2 * TIMING_PAIRS} images: "
                    f"layer1.0 + 3 x layer2.x"), **k3),
    ]
    print(json.dumps({"serving": {str(k): v for k, v in serving.items()},
                      "profile": prof}))
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
