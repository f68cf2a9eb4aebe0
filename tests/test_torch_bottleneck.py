"""Fused bottleneck of the PyTorch port (fast3dhpe_tpu_torch/ops/
bottleneck.py, models/resnet.py) against the JAX package's Pallas kernel in
interpret mode, on the CPU: the plain version at the kernel's rounding
points, BN folding, the wrapper's CPU path, the fusion gate, the packed
weights and their cache, and the kernel's launch rules."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast3dhpe_tpu.ops.pallas_bottleneck import fold_bn as jax_fold_bn
from fast3dhpe_tpu.ops.pallas_bottleneck import fused_bottleneck as jax_fused
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.models.resnet import Bottleneck, ResNetEncoder
from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain,
                                                check_launch, fold_bn,
                                                fused_bottleneck,
                                                fused_bottleneck_packed,
                                                launch_plan, pack_weights,
                                                smem_bytes, weight_layout)

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


def _jax_block_variables(ds, seed, P=16):
    """One JAX Bottleneck's variables ("layer1_0" of an encoder) in its own
    layouts: HWIO kernels, BN scale/bias and mean/var."""
    x, w, bns = _block(ds, seed, P=P)
    names = {"1": "bn1", "2": "bn2", "3": "bn3", "d": "downsample_bn"}
    params = {"conv1": {"kernel": w["w1"][None, None]},
              "conv2": {"kernel": w["w2"]},
              "conv3": {"kernel": w["w3"][None, None]}}
    stats = {}
    if ds:
        params["downsample_conv"] = {"kernel": w["wd"][None, None]}
    for k, (scale, bias, mean, var) in bns.items():
        params[names[k]] = {"scale": scale, "bias": bias}
        stats[names[k]] = {"mean": mean, "var": var}
    v = {"params": {"encoder": {"layer1_0": params}},
         "batch_stats": {"encoder": {"layer1_0": stats}}}
    return x, w, bns, v


def _port_block(v, ds, P=16):
    prefix = "encoder.layer1.0."
    sd = {k[len(prefix):]: t for k, t in jax_variables_to_state_dict(v).items()}
    cin = 64 if ds else 4 * P
    blk = Bottleneck(cin, P, 1, ds, fused_inference=True)
    blk.load_state_dict(sd, strict=True)
    return blk.eval()


@pytest.mark.parametrize("ds", [True, False])
def test_packed_layout_reads_back_the_jax_layouts(ds):
    """The module's packed weights, read back through the index map, are
    the JAX kernel's operands: w1/w3/wd as conv kernel[0, 0], w2 HWIO (the
    kernel's (9P, P) rows ordered (ky, kx, cin)), bf16; and fold_bn of each
    BN, as the JAX model's `_fused` hands them to the Pallas kernel."""
    P = 16
    x, w, bns, v = _jax_block_variables(ds, seed=4, P=P)
    packed = _port_block(v, ds, P).packed_weights("cpu")
    assert packed.w.dtype == torch.bfloat16
    assert packed.sb.dtype == torch.float32
    got = packed.unpack()
    assert set(got) == ({"w1", "w2", "w3", "s1", "b1", "s2", "b2", "s3",
                         "b3"} | ({"wd", "sd", "bd"} if ds else set()))
    for name in ("w1", "w2", "w3") + (("wd",) if ds else ()):
        want = np.asarray(jnp.asarray(w[name], jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(got[name].float().numpy(), want)
    for k in bns:
        js, jb = jax_fold_bn(*map(jnp.asarray, bns[k]))
        np.testing.assert_allclose(got["s" + k].numpy(), np.asarray(js),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b" + k].numpy(), np.asarray(jb),
                                   rtol=1e-6, atol=1e-7)
    # the flat buffer through the index map, K-major: w2 is the kernel's
    # (P, 9 P), row cout, column (ky * 3 + kx) * P + cin; w1 is (P, Cin)
    weights, vectors = weight_layout(packed.cin, P, packed.cout, ds)
    off = weights["w2"][0]
    flat = packed.w.float().numpy()
    r = np.random.RandomState(0)
    for ky, kx, ci, co in r.randint(0, [3, 3, P, P], (20, 4)):
        assert flat[off + co * 9 * P + (ky * 3 + kx) * P + ci] == \
            got["w2"][ky, kx, ci, co].float().item()
    for ci, co in r.randint(0, [packed.cin, P], (20, 2)):
        assert flat[weights["w1"][0] + co * packed.cin + ci] == \
            got["w1"][ci, co].float().item()
    assert packed.w.numel() == sum(int(np.prod(s)) for _, s in
                                   weights.values())
    assert packed.sb.numel() == sum(n for _, n in vectors.values())


@pytest.mark.parametrize("ds", [True, False])
def test_module_fused_path_matches_pallas_interpret(ds):
    """The module's fused path (packed weights, the kernel's plain version
    on the CPU) against the Pallas kernel in interpret mode, bf16."""
    x, w, bns, v = _jax_block_variables(ds, seed=5)
    blk = _port_block(v, ds)
    _, ref = _run_both(x, w, bns, jnp.bfloat16, torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    before = fused_bottleneck.launches
    with torch.inference_mode():
        got = blk._fused(xt).float().permute(0, 2, 3, 1).numpy()
    assert fused_bottleneck.launches == before
    denom = max(np.abs(ref).max(), 1e-3)
    assert np.abs(got - ref).max() / denom < 0.05
    assert np.abs(got - ref).mean() / denom < 0.005


def test_packed_weights_are_rebuilt_per_weight_version():
    x, w, bns, v = _jax_block_variables(True, seed=6)
    blk = _port_block(v, True)
    p1 = blk.packed_weights("cpu")
    assert blk.packed_weights("cpu") is p1          # packed once
    with torch.no_grad():                            # an in-place edit
        blk.conv2.weight[3, 5, 1, 2] += 1.0
    p2 = blk.packed_weights("cpu")
    assert p2 is not p1
    assert p2.unpack()["w2"][1, 2, 5, 3].float().item() == pytest.approx(
        float(torch.tensor(w["w2"][1, 2, 5, 3] + 1.0).bfloat16().float()))
    with torch.no_grad():                            # a BN statistic
        blk.downsample[1].running_var.mul_(4.0)
    p3 = blk.packed_weights("cpu")
    assert p3 is not p2
    torch.testing.assert_close(p3.unpack()["sd"], p2.unpack()["sd"] / 2,
                               rtol=1e-2, atol=0)
    blk.load_state_dict(_port_block(v, True).state_dict())   # load
    p4 = blk.packed_weights("cpu")
    assert p4 is not p3
    torch.testing.assert_close(p4.w, p1.w, rtol=0, atol=0)
    torch.testing.assert_close(p4.sb, p1.sb, rtol=0, atol=0)
    blk.to(torch.float64)                            # .to() makes new tensors
    p5 = blk.packed_weights("cpu")
    assert p5 is not p4
    torch.testing.assert_close(p5.w, p1.w, rtol=0, atol=0)
    # a dtype round trip: the new tensors' version counters start again and
    # the allocator may hand them freed addresses, which the cache holds on to
    blk.half().float()
    p6 = blk.packed_weights("cpu")
    assert p6 is not p5
    torch.testing.assert_close(
        p6.unpack()["w2"], blk.conv2.weight.permute(2, 3, 1, 0).bfloat16(),
        rtol=0, atol=0)
    assert blk.packed_weights("cpu") is p6


def test_python_tiling_matches_the_kernel_source():
    """ops/bottleneck.py's launch check and shared-memory formula use the
    kernel's tiling constants: evaluate csrc/fused_bottleneck.cu's
    `constexpr int` lines and hold the Python copies against them."""
    import re
    from pathlib import Path

    import fast3dhpe_tpu_torch.ops.bottleneck as bn
    src = (Path(bn.__file__).parent.parent / "csrc" /
           "fused_bottleneck.cu").read_text()
    ns = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        ns[name] = eval(expr.replace("/", "//"), {}, dict(ns))
    assert (ns["kTH"], ns["kTWBig"], ns["kTWSmall"], ns["kKC"], ns["kN3"],
            ns["kCluster"], ns["kXStages"], ns["kWStages"], ns["kAlign"],
            ns["kHaloBig"], ns["kTilePixBig"], ns["kXStage"], ns["kOutTile"],
            ns["kSMs"], ns["kSmallCtas"], ns["kClusters"],
            ns["kSmemLimit"]) == (
        bn._TH, bn._TW_BIG, bn._TW_SMALL, bn._KC, bn._N3, bn._CLUSTER,
        bn._X_STAGES, bn._W_STAGES, bn._ALIGN, bn._HALO_BIG,
        bn._TILE_PIX_BIG, bn._X_STAGE, bn._OUT_TILE, bn._SMS, bn._SMALL_CTAS,
        bn._CLUSTERS, bn._SMEM_LIMIT)
    # the C entry's rules name the same constants
    assert "Cin % kKC != 0" in src and "Cout % kN3 != 0" in src
    assert "!(P == 64 || P == 128)" in src


def test_packed_cpu_path_is_plain_on_the_packed_weights():
    x, w, bns = _block(False, seed=7)
    tf = {k: fold_bn(*map(torch.from_numpy, v)) for k, v in bns.items()}
    args = [torch.from_numpy(w["w1"]), *tf["1"], torch.from_numpy(w["w2"]),
            *tf["2"], torch.from_numpy(w["w3"]), *tf["3"]]
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    packed = pack_weights(*args)
    assert packed.args()[9:] == (None, None, None)
    torch.testing.assert_close(fused_bottleneck_packed(xt, packed),
                               bottleneck_plain(xt, *args), rtol=0, atol=0)


# (Cin, P, Cout, downsample) -> dynamic shared memory: the main path's two
# shapes, layer1.1, and P = 128 with a downsample, which the kernel takes
# though no stride-1 encoder block has one
LAUNCHES = {(64, 64, 256, True): 190464, (512, 128, 512, False): 220160,
            (256, 64, 256, False): 190464, (512, 128, 512, True): 220160}


@pytest.mark.parametrize("shape", sorted(LAUNCHES))
def test_check_launch_takes_the_encoder_blocks(shape):
    cin, planes, cout, ds = shape
    assert check_launch(64, cin, planes, cout, ds) == LAUNCHES[shape]
    assert smem_bytes(planes, ds) == LAUNCHES[shape]
    # one CTA an SM: it fits the SM's 228 KB (1 KB reserved a CTA)
    assert LAUNCHES[shape] + 1024 <= 228 * 1024


_ALL_RULES = ("Cin % 64 == 0", "P == 64 or P == 128", "Cout % 128 == 0",
              "Cin == Cout without a downsample", "1 <= B <= 65535",
              "shared memory <= 232448 bytes")


@pytest.mark.parametrize("case,broken", [
    ((8, 48, 64, 256, True), "Cin % 64 == 0"),
    ((8, 64, 96, 384, True), "P == 64 or P == 128"),
    ((8, 64, 64, 192, True), "Cout % 128 == 0"),
    ((8, 64, 64, 256, False), "Cin == Cout without a downsample"),
    ((0, 256, 64, 256, False), "1 <= B <= 65535"),
    ((70000, 256, 64, 256, False), "1 <= B <= 65535"),
    ((8, 2048, 512, 2048, False),
     "P == 64 or P == 128, shared memory <= 232448 bytes"),
    # stage 3's widths, which no gate fuses (see check_launch)
    ((8, 1024, 256, 1024, False),
     "P == 64 or P == 128, shared memory <= 232448 bytes"),
    # channel counts that TMA cannot stride (72 and 520 bytes a pixel):
    # the channel rules refuse them
    ((8, 36, 64, 256, True), "Cin % 64 == 0"),
    ((8, 64, 64, 260, True), "Cout % 128 == 0"),
    # a weight box of P / 2 = 512 rows, past TMA's 256: the P rule
    ((8, 1024, 1024, 4096, True),
     "P == 64 or P == 128, shared memory <= 232448 bytes"),
])
def test_check_launch_names_every_rule(case, broken):
    with pytest.raises(ValueError) as err:
        check_launch(*case)
    msg = str(err.value)
    for rule in _ALL_RULES:
        assert rule in msg
    assert msg.split("broken: ")[1] == broken


@pytest.mark.parametrize("depth", [50, 101, 152])
def test_check_launch_takes_every_block_the_gate_fuses(depth):
    """Every block that `Bottleneck.fusable` admits, at any input size, is
    one the kernel takes: P is 64 or 128 and Cin a multiple of 64."""
    enc = ResNetEncoder(depth, fused_inference=True).eval()
    blocks = dict(enc.blocks())
    seen = set()
    for size in range(64, 769, 32):
        for name in enc.fused_blocks((size, size), torch.bfloat16):
            blk = blocks[name]
            shape = (blk.conv1.in_channels, blk.planes, 4 * blk.planes,
                     blk.downsample is not None)
            check_launch(64, *shape)
            seen.add(shape)
    assert seen == {(64, 64, 256, True), (256, 64, 256, False),
                    (512, 128, 512, False)}


# planes the kernel runs at: the main path at 256 px (64x64, 32x32), a
# ragged plane, the split ranks' haloed tiles (chip_smoke.py HALOED) and
# stage 1 at 192 px
PLANES = [(64, 64), (32, 32), (36, 44), (33, 64), (17, 64), (18, 64),
          (13, 48), (14, 48), (48, 48), (17, 32), (9, 32), (10, 32)]


def _tiles_of(plan, cta, height, width):
    """(image, first row, first column) of each tile CTA `cta` takes, by
    the kernel's walk (csrc/fused_bottleneck.cu `tile_of`)."""
    th, tw = plan.tile
    tiles_x = -(-width // tw)
    tiles_img = -(-(-(-height // th) * tiles_x) // plan.cluster) * plan.cluster
    out = []
    for item in range(cta // plan.cluster, plan.items,
                      plan.ctas // plan.cluster):
        t = item * plan.cluster + cta % plan.cluster
        i = t % tiles_img
        out.append((t // tiles_img, i // tiles_x * th, i % tiles_x * tw))
    return out


@pytest.mark.parametrize("hw", PLANES)
@pytest.mark.parametrize("batch", [2, 8, 64])
def test_launch_plan_covers_every_pixel_once(hw, batch):
    """The tiles the CTAs walk cover each output pixel of each image
    exactly once; a tile past the image is only an image's last, padding
    its tiles to a whole cluster; both CTAs of a cluster walk as many
    tiles; at most one cluster for every two SMs."""
    H, W = hw
    plan = launch_plan(batch, H, W)
    th, tw = plan.tile
    real = -(-H // th) * -(-W // tw)
    assert plan.ctas % plan.cluster == 0 and plan.ctas <= 132
    assert plan.items * plan.cluster == batch * (real + real % plan.cluster)
    count = np.zeros((batch, H, W), np.int64)
    walked = [_tiles_of(plan, c, H, W) for c in range(plan.ctas)]
    for c, tiles in enumerate(walked):
        assert len(tiles) == len(walked[c - c % plan.cluster])
        for img, y0, x0 in tiles:
            if y0 >= H:
                assert (y0 // th) * -(-W // tw) + x0 // tw == real
                continue
            count[img, y0:y0 + th, x0:x0 + tw] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("batch,hw,ctas,items,variant", [
    (64, (64, 64), 132, 1024, "8x16"), (64, (32, 32), 132, 256, "8x16"),
    (8, (64, 64), 132, 128, "8x16"), (8, (32, 32), 128, 64, "8x8"),
    (2, (64, 64), 128, 64, "8x8"), (2, (32, 32), 32, 16, "8x8"),
    (2, (36, 44), 60, 30, "8x8"), (1, (36, 44), 30, 15, "8x8"),
    (8, (33, 64), 132, 80, "8x16"), (2, (33, 64), 80, 40, "8x8"),
    (8, (9, 32), 64, 32, "8x8"), (16, (17, 32), 96, 48, "8x16"),
])
def test_launch_plan_picks_the_tile_by_shape(batch, hw, ctas, items,
                                             variant):
    """8x16 tiles unless they would fill at most half the H100's 132 SMs
    (66 CTAs); then 8x8. At most 66 clusters of 2, one CTA an SM."""
    plan = launch_plan(batch, *hw)
    assert (plan.ctas, plan.items, plan.variant) == (ctas, items, variant)
    assert plan.tile == (8, int(variant.split("x")[1]))
