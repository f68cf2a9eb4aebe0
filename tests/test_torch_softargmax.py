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


# ------------------------------------------- the CUDA kernels' launch rules

from fast3dhpe_tpu_torch.ops import softargmax as sa  # noqa: E402

DECODER = (64, 64, 64, 19)                 # (N, H, W, J), 64 images


def _strides(shape):
    return tuple(int(s) for s in torch.empty(shape).stride())


def test_check_launch_takes_the_decoder_layout():
    """The decoder's (N, J, H, W) channels_last output viewed as NHWC is a
    contiguous (N, H, W, J) tensor: the kernels take it as it is."""
    h = torch.empty((2, 19, 64, 64)).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    for dt in (torch.float32, torch.bfloat16):
        sa.check_launch("cuda", dt, tuple(h.shape), h.stride(), 256)
    sa.check_launch("cuda", torch.float32, DECODER, _strides(DECODER), 0)
    # the CPU runs the plain version: any strides, any J
    sa.check_launch("cpu", torch.float32, (1, 4, 4, 100), (1, 1, 1, 16), 3)


@pytest.mark.parametrize("case,broken", [
    (("cuda", torch.float32, DECODER,
      (64 * 64 * 19, 64, 1, 64 * 64), 0), "contiguous (N, H, W, J)"),
    (("cuda", torch.float32, DECODER, _strides(DECODER), 4),
     "16-byte aligned data_ptr"),
    (("cuda", torch.float32, (2, 8, 8, 65), _strides((2, 8, 8, 65)), 0),
     "1 <= J <= 64"),
    (("cuda", torch.float16, DECODER, _strides(DECODER), 0),
     "dtype float32 or bfloat16"),
    (("meta", torch.float32, DECODER, _strides(DECODER), 0),
     "device cpu or cuda"),
    (("cuda", torch.float32, (64, 4096, 19), (4096 * 19, 19, 1), 0),
     "4-d (N, H, W, J)"),
    (("cuda", torch.float32, (70000, 2, 2, 3), _strides((70000, 2, 2, 3)),
      0), "1 <= N <= 65535"),
], ids=["J strided", "misaligned", "J too large", "dtype", "device", "3-d",
        "N too large"])
def test_check_launch_names_each_rule_it_refuses(case, broken):
    with pytest.raises(ValueError) as err:
        sa.check_launch(*case)
    msg = str(err.value)
    assert broken in msg.split("; got")[0]
    assert msg.split("broken: ")[1] == broken


@pytest.mark.parametrize("n", [2, 64])
@pytest.mark.parametrize("elt", [2, 4])
def test_launch_plan_fills_the_card_in_aligned_tiles(n, elt):
    hw, j = 64 * 64, 19
    plan = sa.launch_plan(n, hw, j, elt)
    # K1: whole pixels, no empty chunk, every tile 16-byte aligned
    assert plan.chunk_pix % sa._PIX_ALIGN == 0
    assert sa.tile_pix(j) % sa._RUN == 0 and sa._PIX_ALIGN % sa._RUN == 0
    assert (plan.chunk_pix * j * elt) % 16 == 0
    assert (sa.tile_pix(j) * j * elt) % 16 == 0
    assert (plan.chunks - 1) * plan.chunk_pix < hw <= (plan.chunks
                                                        * plan.chunk_pix)
    # K2: its chunks cover the image's 16-byte vectors
    nvec = hw * j * elt // 16
    assert (plan.bwd_chunks - 1) * plan.bwd_chunk_vec < nvec <= (
        plan.bwd_chunks * plan.bwd_chunk_vec)
    # K1: one cluster of at most 8 CTAs an image, about two CTAs an SM at
    # 64 images (one cluster of 8 at 2 images); K2 fills the 132 SMs
    assert plan.chunks <= sa._MAX_CHUNKS
    if n == 64:
        assert 2 * sa._SMS >= n * plan.chunks >= sa._SMS
    else:
        assert plan.chunks == sa._MAX_CHUNKS
    assert n * plan.bwd_chunks >= sa._SMS
    assert plan.smem == sa.fwd_smem_bytes(j, elt) <= sa._SMEM_LIMIT


def test_python_constants_match_the_kernel_source():
    """ops/softargmax.py's plan and rules use the kernel's constants:
    evaluate csrc/softargmax.cu's `constexpr int` lines and hold the Python
    copies against them."""
    import re
    from pathlib import Path
    src = (Path(sa.__file__).parent.parent / "csrc" /
           "softargmax.cu").read_text()
    ns = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        ns[name] = eval(expr.replace("/", "//"), {}, dict(ns))
    assert (ns["kThreads"], ns["kMaxJ"], ns["kRun"], ns["kStages"],
            ns["kPixAlign"], ns["kMaxChunks"], ns["kBwdVec"],
            ns["kSmemLimit"]) == (
        sa._THREADS, sa._MAX_J, sa._RUN, sa._STAGES, sa._PIX_ALIGN,
        sa._MAX_CHUNKS, sa._BWD_VEC, sa._SMEM_LIMIT)
    # the C entries refuse what the plan never makes
    assert "chunk_pix % kPixAlign != 0" in src
    assert "chunks > kMaxChunks" in src
    assert "J <= kMaxJ" in src
    # the shared-memory formula: stages x (tile rounded to 16 bytes + 16),
    # a tile being one run for each group of threads that share a joint
    assert "round16((size_t)tile_pix(J) * J * elt) + 16" in src
    assert "return (kThreads / J) * kRun;" in src
    assert sa.fwd_smem_bytes(19, 4) == 3 * (13 * 16 * 19 * 4 + 16)
    assert max(sa.fwd_smem_bytes(j, 4) for j in range(1, 65)) == (
        3 * (256 * 16 * 4 + 16))


# ------------------------------------------- the kernels' algebra in torch

def _combine(a, b):
    """(m, s, sx, sy) of two sets of terms, each scaled to its own max."""
    m = torch.maximum(a[0], b[0])
    out = [m]
    fa = torch.where(m == -torch.inf, 0.0, torch.exp(a[0] - m))
    fb = torch.where(m == -torch.inf, 0.0, torch.exp(b[0] - m))
    for x, y in zip(a[1:], b[1:]):
        out.append(x * fa + y * fb)
    return tuple(out)


def _kernel_fwd(hm, plan):
    """K1's algorithm on (N, H, W, J) fp32: in each chunk of
    plan.chunk_pix pixels, thread group g of G = _THREADS // J takes run g
    (_RUN consecutive pixels) of each tile of G runs: one max and one
    rescale a run, then its exps; then the groups, then the chunks are
    combined. Returns (cx, cy) and (m, 1/S, cx, cy)."""
    N, H, W, J = hm.shape
    h = hm.reshape(N, H * W, J)
    G = sa._THREADS // J
    inf = torch.inf
    total = (torch.full((N, J), -inf),) + (torch.zeros(N, J),) * 3
    for c in range(plan.chunks):
        p0, p1 = c * plan.chunk_pix, min((c + 1) * plan.chunk_pix, H * W)
        m = torch.full((N, G, J), -inf)
        s, sx, sy = (torch.zeros(N, G, J) for _ in range(3))
        for t0 in range(p0, p1, sa.tile_pix(J)):
            # (G, _RUN): run g's pixels t0 + g*_RUN + i
            pix = (t0 + sa._RUN * torch.arange(G)[:, None]
                   + torch.arange(sa._RUN)[None, :])
            pc = pix.clamp(max=H * W - 1)
            v = torch.where((pix < p1)[None, :, :, None], h[:, pc], -inf)
            x = (pc % W).float()[None, :, :, None]
            y = (pc // W).float()[None, :, :, None]
            mn = torch.maximum(m, v.amax(dim=2))
            r = torch.where(mn == -inf, 1.0, torch.exp(m - mn))
            e = torch.where(v == -inf, 0.0,
                            torch.exp(v - mn[:, :, None]))
            s = s * r + e.sum(2)
            sx = sx * r + (e * x).sum(2)
            sy = sy * r + (e * y).sum(2)
            m = mn
        chunk = (torch.full((N, J), -inf),) + (torch.zeros(N, J),) * 3
        for grp in range(G):
            chunk = _combine(chunk, (m[:, grp], s[:, grp], sx[:, grp],
                                     sy[:, grp]))
        total = _combine(total, chunk)
    m, s, sx, sy = total
    cx, cy = sx / s, sy / s
    return torch.stack([cx, cy], -1), torch.stack([m, 1 / s, cx, cy], -1)


def _kernel_bwd(hm, stats, g):
    """K2's algebra: element e of an image's span is joint e mod J of pixel
    e div J; dh = e^{h-m} * (1/S) * (gx*(x - cx) + gy*(y - cy)) in fp32,
    rounded once to the logits' dtype."""
    N, H, W, J = hm.shape
    el = torch.arange(H * W * J)
    j, pix = el % J, el // J
    x, y = (pix % W).float(), (pix // W).float()
    st = stats[:, j]                                    # (N, HWJ, 4)
    gg = g.float()[:, j]                                # (N, HWJ, 2)
    h = hm.float().reshape(N, -1)
    dh = (torch.exp(h - st[..., 0]) * st[..., 1]
          * (gg[..., 0] * (x - st[..., 2]) + gg[..., 1] * (y - st[..., 3])))
    return dh.reshape(hm.shape).to(hm.dtype)


ALGEBRA_SHAPES = [(3, 64, 64, 19), (2, 36, 44, 17)]


def _algebra_logits(shape, low_chunk, plan):
    """Logits with, if low_chunk, the plan's first chunk lying 120 below the
    rest, so that its e^{m_c - M} underflows to 0 in fp32."""
    hm = _logits(shape, seed=sum(shape) + 21)
    if low_chunk:
        flat = hm.reshape(shape[0], -1, shape[3])
        flat[:, :plan.chunk_pix] -= 120.0
    return hm


@pytest.mark.parametrize("shape", ALGEBRA_SHAPES, ids=["3x64x64x19",
                                                       "ragged"])
@pytest.mark.parametrize("plan_images,low_chunk", [
    (None, False), (64, False), (None, True)],
    ids=["own plan", "64-image chunks", "chunk 120 below"])
def test_chunked_statistics_match_pallas_and_jnp(shape, plan_images,
                                                 low_chunk):
    n, hh, ww, j = shape
    plan = sa.launch_plan(plan_images or n, hh * ww, j, 4)
    if plan_images:
        assert plan.chunk_pix > sa.tile_pix(j)   # chunks of several tiles
    hm = _algebra_logits(shape, low_chunk, plan)
    got, stats = _kernel_fwd(torch.from_numpy(hm), plan)
    kern = np.asarray(_fwd_pallas(jnp.asarray(hm), interpret=True))
    ref = np.asarray(_jnp_soft_argmax(jnp.asarray(hm)))
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-4, atol=ATOL_PX)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=ATOL_PX)
    flat = hm.reshape(n, -1, j)
    m = flat.max(axis=1)
    s = np.exp(flat - m[:, None]).sum(axis=1)
    np.testing.assert_array_equal(stats[..., 0].numpy(), m)
    np.testing.assert_allclose(stats[..., 1].numpy() * s, 1.0, rtol=1e-5)


@pytest.mark.parametrize("shape", ALGEBRA_SHAPES, ids=["3x64x64x19",
                                                       "ragged"])
def test_backward_from_statistics_matches_pallas_and_closed_form(shape):
    """K2's algebra from K1's statistics: fp32 within 1e-5 of max|ref| of
    `_bwd_pallas` in interpret mode and `_fused_bwd`; bf16 logits give the
    fp32 gradient rounded once (a value next to a rounding boundary may
    round to the other neighbour: one bf16 ulp, rarely)."""
    n, hh, ww, j = shape
    hm = _logits(shape, seed=sum(shape) + 31)
    g = _logits((n, j, 2), seed=sum(shape) + 32, scale=1.0)
    plan = sa.launch_plan(n, hh * ww, j, 4)
    _, stats = _kernel_fwd(torch.from_numpy(hm), plan)
    got = _kernel_bwd(torch.from_numpy(hm), stats, torch.from_numpy(g))
    jh, jg = jnp.asarray(hm), jnp.asarray(g)
    for ref in (np.asarray(_bwd_pallas(jh, jg, interpret=True)),
                np.asarray(_fused_bwd(False, jh, jg)[0])):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=RTOL_GRAD * np.abs(ref).max())
    hb = torch.from_numpy(hm).bfloat16()
    _, sb = _kernel_fwd(hb.float(), plan)
    got_b = _kernel_bwd(hb, sb, torch.from_numpy(g))
    assert got_b.dtype == torch.bfloat16
    ref_b = soft_argmax_bwd(hb.float(), torch.from_numpy(g))
    d = (got_b.float() - ref_b.bfloat16().float()).abs()
    scale = float(ref_b.abs().max())
    assert float(d.max()) <= 2.0 ** -7 * scale
    assert float(d.mean()) <= 2.0 ** -17 * scale


def _k2_cover(n, hw, j, elt, chunk_vec, chunks):
    """How many times K2's grid writes each element: the index ranges of
    csrc/softargmax.cu softargmax_bwd_kernel, CTA by CTA."""
    epv = 16 // elt
    hits = np.zeros(n * hw * j, np.int64)
    for img in range(n):
        span, e0 = hw * j, img * hw * j
        v_lo, v_hi = -(-e0 // epv), (e0 + span) // epv
        v_hi = max(v_hi, v_lo)
        head_end = min(v_lo * epv, e0 + span)
        hits[e0:head_end] += 1
        hits[max(v_hi * epv, head_end):e0 + span] += 1
        for c in range(chunks):
            vb = v_lo + c * chunk_vec
            ve = min(vb + chunk_vec, v_hi)
            if ve > vb:
                hits[vb * epv:ve * epv] += 1
    return hits


@pytest.mark.parametrize("n,h,w,j", [(3, 5, 7, 3), (2, 36, 44, 17),
                                     (2, 64, 64, 19), (1, 1, 1, 1)])
@pytest.mark.parametrize("elt", [2, 4])
def test_k2_grid_writes_every_element_once(n, h, w, j, elt):
    plan = sa.launch_plan(n, h * w, j, elt)
    hits = _k2_cover(n, h * w, j, elt, plan.bwd_chunk_vec, plan.bwd_chunks)
    assert (hits == 1).all()


def test_cpu_path_launches_nothing():
    """On CPU tensors the wrappers run the plain versions: no statistics,
    no launch, no kernel library loaded."""
    hm = torch.from_numpy(_logits((2, 8, 8, 5), seed=41))
    g = torch.from_numpy(_logits((2, 5, 2), seed=42, scale=1.0))
    before = (soft_argmax_fused.launches, soft_argmax_bwd_fused.launches)
    out, stats = sa.soft_argmax_fwd_fused(hm)
    assert stats is None
    torch.testing.assert_close(out, soft_argmax(hm))
    torch.testing.assert_close(soft_argmax_bwd_fused(hm, g, stats),
                               soft_argmax_bwd(hm, g))
    h = hm.clone().requires_grad_(True)
    (soft_argmax_fused(h) * g).sum().backward()
    assert (soft_argmax_fused.launches,
            soft_argmax_bwd_fused.launches) == before
    assert sa._entries.cache_info().currsize == 0
