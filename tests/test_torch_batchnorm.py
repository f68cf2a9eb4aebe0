"""Train-mode BatchNorm of the port (fast3dhpe_tpu_torch/ops/batchnorm.py and
csrc/batchnorm.cu, through models/layers.py `_MaskedBatchNorm`).

On the CPU: the wrapper's CPU path against the masked BN as the port
computed it before the kernels (`_Before`, kept verbatim here), bit for
bit; the launch plans against the kernel source's constants and by
simulating which elements each block and thread visits; the layout rules
and the kernel names. The `card` tests compare the kernels with the plain
version on an NVIDIA GPU and skip here. This file imports no JAX; on the
card (whose host has no JAX, which tests/conftest.py imports):

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_batchnorm.py -m card
"""

import re
from pathlib import Path

import pytest
import torch

from fast3dhpe_tpu_torch.models import layers
from fast3dhpe_tpu_torch.ops import batchnorm as bn

torch.set_num_threads(2)

CU = Path(bn.__file__).resolve().parents[1] / "csrc" / "batchnorm.cu"


# ------------------------------------------------------------------ before

def _axes(x):
    lead = (1,) * (x.dim() - 2)
    return ((0,) + tuple(range(2, x.dim())), (1, x.shape[1]) + lead,
            (x.shape[0], 1) + lead)


class _Before(torch.autograd.Function):
    """models/layers.py `_MaskedBatchNorm` before the kernels, without a
    process group (the wrapper's CPU path must give its bits)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mask, eps):
        B, C = x.shape[:2]
        dims, ch, rows = _axes(x)
        xf = x.float()
        if mask is None:
            count = x.numel() // C
            s1, s2 = xf.sum(dims), (xf * xf).sum(dims)
        else:
            xm = xf * mask.view(rows)
            count = mask.sum() * (x.numel() // (B * C))
            s1, s2 = xm.sum(dims), (xm * xf).sum(dims)
        mean = s1 / count
        mu2 = s2 / count
        var_raw = mu2 - mean * mean
        var = var_raw.clamp_min(0.0)
        r = torch.rsqrt(var + eps)
        y = ((xf - mean.view(ch)) * (r * weight).view(ch) + bias.view(ch))
        ctx.save_for_backward(x, weight, mean, r, var_raw > 0, mask)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, r, var_pos, mask = ctx.saved_tensors
        dims, shape, rows = _axes(x)
        xf, dy = x.float(), dy.float()

        def ch(v):
            return v.view(shape)

        s = (dy * (xf - ch(mean))).sum(dims)
        dbias = dy.sum(dims)
        dweight = s * r
        g = weight * r
        dvar = torch.where(var_pos, -0.5 * s * weight * r * r * r, 0.0)
        dmean = -dbias * g - 2.0 * mean * dvar
        stat = ch(dmean / ctx.count) + xf * ch(2.0 * dvar / ctx.count)
        if mask is not None:
            stat = stat * mask.view(rows)
        direct = dy * ch(g)
        if x.dtype == torch.float32:
            dx = direct + stat
        else:
            dx = direct.to(x.dtype) + stat.to(x.dtype)
        return dx, dweight, dbias, None, None


# -------------------------------------------------------------- the inputs

def _inputs(shape, dtype, seed, channels_last, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dtype)
    if channels_last:
        fmt = (torch.channels_last if len(shape) == 4
               else torch.channels_last_3d)
        x = x.contiguous(memory_format=fmt)
    w = 1.0 + 0.2 * torch.randn(c, generator=gen)
    b = 0.1 * torch.randn(c, generator=gen)
    dy = torch.randn(shape, generator=gen).to(dtype)
    dy = torch.empty_like(x).copy_(dy)
    return [t.to(device) for t in (x, w, b, dy)]


def _mask(kind, n, device="cpu"):
    if kind is None:
        return None
    if kind == "zero_rows":
        valid = torch.ones(n)
        valid[1::3] = 0
    else:                                   # every row is filler
        valid = torch.zeros(n)
    return layers.bn_row_mask(valid).to(device)


def _run(fn, x, w, b, dy, mask, eps=1e-5):
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    y, mean, var = fn(x, w, b, mask, eps)
    y.backward(dy)
    return y, mean, var, x.grad, w.grad, b.grad


def _after(x, w, b, mask, eps):
    return layers._MaskedBatchNorm.apply(x, w, b, mask, eps, None)


# (shape, channels_last): a CDRNet layer (channels_last NCHW) and a V2V
# level (contiguous NCDHW)
CPU_CASES = [((4, 64, 8, 8), True), ((2, 256, 4, 4), True),
             ((2, 32, 8, 8, 8), False), ((3, 16, 4, 4, 4), False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [None, "zero_rows", "filler"])
@pytest.mark.parametrize("shape,channels_last", CPU_CASES)
def test_cpu_path_is_the_plain_arithmetic_bit_for_bit(shape, channels_last,
                                                      mask, dtype):
    x, w, b, dy = _inputs(shape, dtype, seed=sum(shape), channels_last=
                          channels_last)
    m = _mask(mask, shape[0])
    before = bn.train_bn_forward.launches, bn.train_bn_backward.launches
    got = _run(_after, x, w, b, dy, m)
    ref = _run(lambda *a: _Before.apply(*a), x, w, b, dy, m)
    for g, r, name in zip(got, ref, ("y", "mean", "var", "dx", "dweight",
                                     "dbias")):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.equal(g, r), name
    assert got[0].stride() == x.stride()
    assert (bn.train_bn_forward.launches,
            bn.train_bn_backward.launches) == before   # no kernel here


def test_batchnorm_modules_take_the_wrapper_in_train_mode():
    """BatchNorm2d and BatchNorm3d in train mode: the wrapper's outputs and
    the running statistics from its mean and biased variance."""
    for mod, shape, cl in ((layers.BatchNorm2d(64), (4, 64, 8, 8), True),
                           (layers.BatchNorm3d(16), (3, 16, 4, 4, 4),
                            False)):
        x, w, b, _ = _inputs(shape, torch.float32, 3, cl)
        with torch.no_grad():
            mod.weight.copy_(w)
            mod.bias.copy_(b)
        m = _mask("zero_rows", shape[0])
        y = mod.train()(x, m)
        ry, rmean, rvar = _Before.apply(x, w, b, m, mod.eps)
        assert torch.equal(y, ry)
        torch.testing.assert_close(mod.running_mean, 0.1 * rmean,
                                   rtol=0, atol=0)
        torch.testing.assert_close(mod.running_var, 0.9 + 0.1 * rvar,
                                   rtol=1e-7, atol=1e-7)


# ------------------------------------------------------------- launch plan

def _cu_constants():
    src = CU.read_text()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        consts[name] = eval(expr, {}, dict(consts))
    return consts


def test_python_constants_match_the_kernel_source():
    """ops/batchnorm.py plans with csrc/batchnorm.cu's constants."""
    k = _cu_constants()
    assert (bn._THREADS, bn._VEC_BYTES, bn._MAX_TILE_VEC, bn._UNROLL,
            bn._BLOCKS_PER_SM, bn._MAX_GRID_Y) == (
        k["kThreads"], k["kVecBytes"], k["kMaxTileVec"], k["kUnroll"],
        k["kBlocksPerSm"], k["kMaxGridY"])
    assert k["kFinishLanes"] * k["kFinishCols"] == k["kThreads"]
    src = CU.read_text()
    # the layout codes the wrapper passes
    assert "enum Layout { kRows = 0, kPlanes = 1 };" in src
    assert bn._LAYOUTS == {"rows": 0, "planes": 1}


def test_kernel_names_are_counted_and_caught_by_no_other_reader():
    """Every kernel is named train_bn_* (the benchmark's
    bn_kernels_per_step.train counts that prefix); no name holds a
    substring by which the convolution or soft-argmax readers pick their
    kernels."""
    src = CU.read_text()
    kernels = sorted(set(re.findall(
        r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)))
    assert kernels == ["train_bn_finish", "train_bn_grad",
                       "train_bn_grad_reduce", "train_bn_norm",
                       "train_bn_stats"], kernels
    for name in kernels:
        for other in ("conv", "cudnn", "gemm", "xmma", "cutlass", "nvjet",
                      "softargmax_fwd", "softargmax_bwd",
                      "bottleneck_kernel"):
            assert other not in name


# (layout, n, c, s, bytes, aligned) -> (vec, tile, lanes, blocks, grid)
PLANS = {
    # CDRNet-101's stem BN at 64 images: 1 M rows x 64 channels, fp32
    ("rows", 64, 64, 128 * 128, 4, True): (4, 16, 16, 264, (264, 1)),
    # layer4 at 64 images: 4,096 rows x 2,048 channels
    ("rows", 64, 2048, 64, 4, True): (4, 32, 8, 16, (16, 16)),
    ("rows", 64, 2048, 64, 2, True): (8, 32, 8, 33, (33, 8)),
    # 19 and 300 channels: no whole 16-byte vector a row in bf16
    ("rows", 4, 19, 36, 4, True): (1, 19, 13, 3, (3, 1)),
    ("rows", 4, 300, 36, 2, True): (1, 32, 8, 5, (5, 10)),
    ("rows", 4, 300, 36, 4, True): (4, 32, 8, 5, (5, 3)),
    ("rows", 64, 64, 16384, 4, False): (1, 32, 8, 132, (132, 2)),
    # the V2V's first level: 10 volumes of 64^3, 32 channels; its deepest
    ("planes", 10, 32, 64 ** 3, 4, True): (4, 1, 256, 8, (8, 32)),
    ("planes", 10, 128, 2 ** 3, 4, True): (4, 1, 256, 1, (1, 128)),
    ("planes", 2, 8, 5 * 7, 2, True): (1, 1, 256, 1, (1, 8)),
}


@pytest.mark.parametrize("key", list(PLANS))
def test_launch_plans_at_the_steps_shapes(key):
    layout, n, c, s, elt, aligned = key
    plan = bn.launch_plan(layout, n, c, s, elt, aligned)
    assert (plan.vec, plan.tile, plan.lanes, plan.blocks, plan.grid) == \
        PLANS[key]
    assert plan.partial_floats == 2 * plan.blocks * c
    assert plan.tile * plan.lanes <= bn._THREADS
    # one wave of _BLOCKS_PER_SM blocks an SM, unless the channel tiles
    # alone are more
    assert (plan.grid[0] * plan.grid[1] <= bn._TARGET_BLOCKS
            or plan.blocks == 1)


def _visits(plan, n, c, s):
    """How often the kernels' walk (csrc/batchnorm.cu `walk`) visits each
    element of an (n, c, s) tensor, by the element's (sample, channel,
    position), and the partial row each visit's sums go to."""
    seen = torch.zeros((n, c, s), dtype=torch.int64)
    rows_of = {}
    v = plan.vec
    gx, gy = plan.grid
    for bx in range(gx):
        for by in range(gy):
            for t in range(bn._THREADS):
                if plan.layout == "rows":
                    lane, col = divmod(t, plan.tile)
                    c0 = (by * plan.tile + col) * v
                    if lane >= plan.lanes or c0 >= c:
                        continue
                    r1 = min((bx + 1) * plan.span, n * s)
                    for r in range(bx * plan.span + lane, r1, plan.lanes):
                        smp, pos = divmod(r, s)
                        for i in range(v):
                            seen[smp, c0 + i, pos] += 1
                            rows_of[(smp, c0 + i, pos)] = bx
                else:
                    sv = s // v
                    v1 = min((bx + 1) * plan.span, n * sv)
                    for vv in range(bx * plan.span + t, v1, bn._THREADS):
                        smp, j = divmod(vv, sv)
                        for i in range(v):
                            seen[smp, by, j * v + i] += 1
                            rows_of[(smp, by, j * v + i)] = bx
    return seen, rows_of


@pytest.mark.parametrize("layout,n,c,s,elt,aligned", [
    ("rows", 3, 24, 20, 4, True), ("rows", 2, 19, 30, 4, True),
    ("rows", 5, 300, 6, 2, True), ("rows", 2, 40, 13, 2, False),
    ("rows", 40, 8, 64, 2, True),
    ("planes", 3, 5, 64, 4, True), ("planes", 2, 3, 36, 2, True),
    ("planes", 4, 2, 7, 4, True), ("planes", 3, 2, 2048, 2, True)])
def test_every_element_is_visited_once(layout, n, c, s, elt, aligned):
    """The plan's blocks and threads, walked as the kernels walk them,
    cover each element once, and the blocks' partial rows are < blocks."""
    plan = bn.launch_plan(layout, n, c, s, elt, aligned)
    seen, rows_of = _visits(plan, n, c, s)
    assert torch.equal(seen, torch.ones_like(seen))
    assert max(rows_of.values()) == plan.blocks - 1


def test_layout_of_reads_the_strides():
    x4 = torch.empty(2, 8, 4, 5)
    x5 = torch.empty(2, 8, 3, 4, 5)
    assert bn.layout_of(x4.shape, x4.stride()) == "planes"
    cl = x4.contiguous(memory_format=torch.channels_last)
    assert bn.layout_of(cl.shape, cl.stride()) == "rows"
    cl3 = x5.contiguous(memory_format=torch.channels_last_3d)
    assert bn.layout_of(cl3.shape, cl3.stride()) == "rows"
    assert bn.layout_of(x5.shape, x5.stride()) == "planes"
    one = torch.empty(4, 8, 1, 1)          # both: the rows plan
    assert bn.layout_of(one.shape, one.stride()) == "rows"
    odd = x4.permute(0, 2, 1, 3)           # (2, 4, 8, 5) with C strided
    assert bn.layout_of(odd.shape, odd.stride()) is None
    assert bn.layout_of(x4[:, :, ::2].shape, x4[:, :, ::2].stride()) is None


@pytest.mark.parametrize("case,broken", [
    (dict(shape=(2, 8, 4, 5), strides=(160, 5, 40, 1)),
     "channels innermost or contiguous"),
    (dict(shape=(2, 8, 4, 5), strides=(320, 40, 10, 2)),
     "channels innermost or contiguous"),
    (dict(shape=(2, 8), strides=(8, 1)), "at least 3 dims"),
    (dict(shape=(2, 8, 4, 5), strides=(160, 20, 5, 1),
          dtype=torch.float16), "float32 or bfloat16"),
    (dict(shape=(2, 70000, 1, 1), strides=(70000, 1, 70000, 70000)),
     "C <= 65535"),
    (dict(shape=(2 ** 12, 64, 2 ** 8, 2 ** 8),
          strides=(2 ** 22, 2 ** 16, 2 ** 8, 1)), "2**31 elements")])
def test_the_cuda_checks_refuse_what_the_kernels_do_not_take(case, broken):
    args = {"dtype": torch.float32, **case}
    with pytest.raises(ValueError, match=re.escape(broken)) as err:
        bn.check_launch(args["dtype"], args["shape"], args["strides"])
    tail = str(err.value).split("broken: ")[1]
    assert tail in bn._RULES and broken in tail      # that rule alone


# -------------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda:0")


def _plain(x, w, b, mask, eps):
    """The plain version on the same device, through autograd."""
    class _Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            y, mean, var, saved, count = bn.plain_forward(x, w, b, mask, eps,
                                                          None)
            ctx.save_for_backward(x, w, *saved)
            ctx.count = count
            return y, mean, var

        @staticmethod
        def backward(ctx, dy, _m, _v):
            x, w, *saved = ctx.saved_tensors
            return bn.plain_backward(dy, x, w, mask, saved, ctx.count, None)
    return _Plain.apply(x, w, b)


def _close(got, ref, dtype, what):
    """fp32: within 1e-4 of the reference's largest magnitude (the sums
    over up to 1 M rows run in another order); bf16: within 2 bf16 ulps of
    it (an output that rounds on either side of a bf16 step)."""
    tol = 1e-4 if dtype == torch.float32 or what in ("mean", "var",
                                                     "dweight", "dbias") \
        else 2 ** -7
    scale = ref.float().abs().max().clamp_min(1e-6)
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * scale, (what, float(err), float(scale))


CARD_CASES = [
    ((16, 64, 32, 32), True, None), ((16, 64, 32, 32), True, "zero_rows"),
    ((8, 256, 16, 16), True, "filler"),
    ((6, 19, 12, 12), True, "zero_rows"), ((6, 300, 6, 6), True, None),
    ((64, 2048, 8, 8), True, "zero_rows"),       # latency-bound
    ((64, 64, 128, 128), True, "zero_rows"),     # bandwidth-bound
    ((4, 32, 16, 16, 16), False, "zero_rows"),
    ((10, 128, 2, 2, 2), False, None), ((3, 8, 5, 7, 3), False, None)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,channels_last,mask", CARD_CASES)
def test_kernels_match_the_plain_version_on_the_card(card, shape,
                                                     channels_last, mask,
                                                     dtype):
    x, w, b, dy = _inputs(shape, dtype, sum(shape), channels_last, card)
    m = _mask(mask, shape[0], card)
    before = bn.train_bn_forward.launches, bn.train_bn_backward.launches
    got = _run(_after, x, w, b, dy, m)
    ref = _run(_plain, x, w, b, dy, m)
    torch.cuda.synchronize()
    assert (bn.train_bn_forward.launches - before[0],
            bn.train_bn_backward.launches - before[1]) == (3, 3)
    for g, r, what in zip(got, ref, ("y", "mean", "var", "dx", "dweight",
                                     "dbias")):
        assert g.dtype == r.dtype and g.shape == r.shape, what
        _close(g, r, dtype, what)
    assert got[0].stride() == x.stride() and got[3].stride() == x.stride()


@pytest.mark.card
@pytest.mark.parametrize("shape,channels_last", [((16, 64, 32, 32), True),
                                                 ((4, 32, 16, 16, 16),
                                                  False)])
def test_kernels_are_deterministic_and_graphs_bit_equal(card, shape,
                                                        channels_last):
    """Two eager runs bit-equal; a CUDA graph of forward and backward,
    replayed on new inputs, bit-equal to eager on those inputs."""
    x, w, b, dy = _inputs(shape, torch.float32, 7, channels_last, card)
    m = _mask("zero_rows", shape[0], card)
    a = _run(_after, x, w, b, dy, m)
    again = _run(_after, x, w, b, dy, m)
    assert all(torch.equal(p, q) for p, q in zip(a, again))

    sx, sdy = x.clone(), dy.clone()
    sw = w.detach().clone().requires_grad_(True)
    sb = b.detach().clone().requires_grad_(True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):       # warm up on the capture's stream
        _run(_after, sx, sw, sb, sdy, m)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        leaf = sx.detach().requires_grad_(True)
        sw.grad = sb.grad = None
        y, mean, var = _after(leaf, sw, sb, m, 1e-5)
        y.backward(sdy)
        outs = (y, mean, var, leaf.grad, sw.grad, sb.grad)
    x2, _, _, dy2 = _inputs(shape, torch.float32, 8, channels_last, card)
    sx.copy_(x2)
    sdy.copy_(dy2)
    graph.replay()
    torch.cuda.synchronize()
    eager = _run(_after, x2, w, b, dy2, m)
    for p, q in zip(outs, eager):
        assert torch.equal(p, q)
