"""The PyTorch port's on-device input pipeline
(fast3dhpe_tpu_torch/data/device_pipeline.py, data/device_cache.py)
against the JAX package on the CPU, on the same numpy frames and metadata
from a seed. The two RNGs cannot agree, so where the JAX pipeline draws
occlusion, its keep-masks are replayed through the port's post-occlusion
step; the port's own draws are checked by their statistics."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.data import device_pipeline as jdp
from fast3dhpe_tpu.data.device_cache import DeviceFrameCache as JaxCache
from fast3dhpe_tpu_torch.data import device_pipeline as dp
from fast3dhpe_tpu_torch.data.device_cache import DeviceFrameCache
from fast3dhpe_tpu_torch.geometry.affine import get_affine_transform
from fast3dhpe_tpu_torch.ops.occlusion import fill_occluded
from fast3dhpe_tpu_torch.ops.warp import affine_warp, normalize_imagenet

from test_torch_pipeline_ops import WARP_MAX, _frames, _smooth_frames

torch.set_num_threads(2)

B, J, H0, W0 = 6, 19, 48, 64
OUT = (32, 32)                      # (W, H)
# normalised images: the warp's bound over the smallest ImageNet std
IMAGE_TOL = WARP_MAX / 255.0 / 0.224


def _rig(batch, h, w):
    """Two cameras 3 m from the origin at x = -+400 mm, turned toward it,
    f = 1100 px at 256 px scaled to the frame's height, centred: (B, 4, 4)
    each."""
    f = 1100.0 * h / 256
    K = np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])
    Ps = []
    for cx in (-400.0, 400.0):
        centre = np.array([cx, 0.0, -3000.0])
        z = -centre / np.linalg.norm(centre)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        P = np.eye(4)
        P[:3] = K @ np.hstack([R, -R @ centre[:, None]])
        Ps.append(np.broadcast_to(P, (batch, 4, 4)).astype(np.float32))
    return Ps


def _meta(seed, batch=B):
    """Per-sample train-time affines (scale and rotation drawn as
    data/loader.py draws them), the rig, poses within +-250 mm of the origin
    with every third sample spread to +-700 mm (joints outside the crop),
    and visibility with a few zeros."""
    r = np.random.RandomState(seed)
    trans = []
    for _ in range(batch):
        s = np.clip(r.randn() * 0.25 + 1, 0.75, 1.25)
        rot = np.clip(r.randn() * 30, -60, 60) if r.rand() <= 0.6 else 0.0
        trans.append(get_affine_transform((W0 / 2, H0 / 2), s, rot,
                                          min(H0, W0), OUT))
    pose = r.uniform(-250, 250, (batch, J, 3))
    pose[::3] *= 2.8
    vis = (r.rand(batch, J) > 0.1).astype(np.float32)
    P_l, P_r = _rig(batch, H0, W0)
    return (np.stack(trans).astype(np.float32), P_l, P_r,
            pose.astype(np.float32), vis)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# ----------------------------------------------------------- pieces

def test_compose_projection_matches_jax():
    """P <- T @ P: 1e-5 relative."""
    r = np.random.RandomState(0)
    P = r.randn(5, 4, 4).astype(np.float32) * 100
    trans = r.randn(5, 2, 3).astype(np.float32)
    ref = np.asarray(jdp.compose_projection_batched(_j(P), _j(trans)))
    got = dp.compose_projection_batched(_t(P), _t(trans))
    assert _rel(got, ref) <= 1e-5


def test_check_boundary_and_occlusion_match_jax():
    """Out-of-image joints become (-1, -1); the occlusion lookup truncates
    toward zero (-0.5 reads column 0), wraps -1 to the last pixel and
    clips. Exact."""
    pose = np.array([[[10.0, 20.0], [-5.0, 10.0], [100.0, 3.0],
                      [31.9, 31.9], [32.0, 1.0], [-0.5, -0.5],
                      [-1.0, -1.0], [-1.0, 5.0], [7.7, -1.0]]], np.float32)
    pose = np.repeat(pose, 2, axis=0)
    keep = np.random.RandomState(1).rand(2, 32, 32) > 0.5
    keep[:, 31, 31] = False
    ref_p, ref_v = (np.asarray(a) for a in jdp._check_boundary(_j(pose),
                                                               32, 32))
    got_p, got_v = dp._check_boundary(_t(pose), 32, 32)
    assert np.array_equal(got_p.numpy(), ref_p)
    assert np.array_equal(got_v.numpy(), ref_v)
    for p in (pose, ref_p):
        ref = np.asarray(jdp._check_occlusion(_j(p), _j(keep)))
        got = dp._check_occlusion(_t(p), _t(keep))
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
    # (-1, -1) reads keep[31, 31]
    assert not dp._check_occlusion(_t(pose[:, 6:7]), _t(keep)).any()


# ------------------------------------------------------------ stereo

def _jax_stereo(frames_l, frames_r, meta, **kw):
    key = jax.random.PRNGKey(kw.pop("seed", 0))
    out = jdp.preprocess_stereo_batch(key, _j(frames_l), _j(frames_r),
                                      *map(_j, meta), image_size=OUT, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _check_stereo(got, ref, keys=("proj", "target_2d", "target_weight")):
    assert set(got) == set(ref)
    d = np.abs(got["image"].numpy() - ref["image"])
    assert d.max() <= IMAGE_TOL, d.max()
    np.testing.assert_array_equal(got["target_3d"].numpy(), ref["target_3d"])
    for k in keys:
        if k == "target_weight":
            assert np.array_equal(got[k].numpy(), ref[k]), k
        else:
            g, r = got[k].numpy(), ref[k]
            assert np.array_equal(np.isnan(g), np.isnan(r))
            assert _rel(np.nan_to_num(g), np.nan_to_num(r)) <= 1e-5, k


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stereo_core_matches_jax(train):
    """Occlusion off: image within the warp's bound, proj and target_2d
    1e-5 relative, target_weight exact (train: the boundary check zeroes
    the joints outside either crop)."""
    fl, fr = _smooth_frames(10, B), _smooth_frames(11, B)
    meta = _meta(12)
    ref = _jax_stereo(fl, fr, meta, train=train)
    got = dp.preprocess_stereo_batch(None, _t(fl), _t(fr), *map(_t, meta),
                                     image_size=OUT, train=train)
    assert got["image"].shape == (B, 2, 32, 32, 3)
    _check_stereo(got, ref)
    if train:
        assert 0 < ref["target_weight"].sum() < meta[4].sum()
        assert (ref["target_2d"] == -1).any()


@pytest.mark.parametrize("occl", ["CUTOUT", "HNS"])
def test_stereo_occlusion_replay_matches_jax(occl):
    """JAX's keep-masks (return_masks=True, train, occl_prob 0.6) replayed
    through the port's post-occlusion step: target_weight exact, masks
    returned as given, images within the warp's bound."""
    fl, fr = _smooth_frames(13, B), _smooth_frames(14, B)
    meta = _meta(15)
    ref = _jax_stereo(fl, fr, meta, train=True, occlusion=occl,
                      occl_prob=0.6, return_masks=True, seed=3)
    keep = torch.from_numpy(ref["keep_mask"])
    assert (~keep).any() and keep.all(dim=(1, 2, 3)).any()
    warped = torch.stack([affine_warp(_t(f), _t(meta[0]), OUT)
                          for f in (fl, fr)], dim=1)
    got = dp.finish_stereo(fill_occluded(warped, keep), keep,
                           *map(_t, meta), occlusion=occl, train=True,
                           return_masks=True)
    _check_stereo(got, ref, ("proj", "target_2d", "target_weight",
                             "keep_mask"))
    assert torch.equal(got["keep_mask"], keep)
    # the occlusion term removed some joints the boundary check kept
    no_occl = _jax_stereo(fl, fr, meta, train=True)
    assert (ref["target_weight"] < no_occl["target_weight"]).any()


def test_stereo_occlusion_draws_and_gating():
    """The port's own draws (CPU generator), 2048 samples at occl_prob 0.3:
    one gate a sample for both views, the gated share within 4 sigma of
    0.3, gated pixels gray 128, the rest untouched, and the same seed gives
    the same batch."""
    n = 2048
    imgs = torch.full((n, 2, 32, 32, 3), 7.0)
    gen = torch.Generator().manual_seed(5)
    out, keep = dp.occlude_stereo(gen, imgs, "CUTOUT")
    gated = (~keep).flatten(2).any(2)                      # (n, 2)
    assert torch.equal(gated[:, 0], gated[:, 1])
    share = gated[:, 0].float().mean().item()
    assert abs(share - 0.3) <= 4 * (0.3 * 0.7 / n) ** 0.5, share
    assert (out[~keep] == 128.0).all() and (out[keep] == 7.0).all()
    again = dp.occlude_stereo(torch.Generator().manual_seed(5), imgs,
                              "CUTOUT")
    assert torch.equal(again[1], keep)
    _, hk = dp.occlude_stereo(gen, imgs, "HNS", occl_prob=1.0)
    cells = (~hk).reshape(n, 2, 4, 8, 4, 8).all(dim=5).all(dim=3)
    assert cells.sum(dim=(2, 3)).eq(6).all()
    assert not torch.equal(hk[:, 0], hk[:, 1])   # each view its own cells


def test_stereo_return_masks_invariants():
    """Where the keep-mask is False the image is normalize_imagenet(128);
    elsewhere it equals the eval output of the same batch; target_weight is
    joints_vis x both boundary checks x the keep-mask at each joint."""
    fl, fr = _frames(16, B, H0, W0), _frames(17, B, H0, W0)
    meta = _meta(18)
    gen = torch.Generator().manual_seed(1)
    out = dp.preprocess_stereo_batch(gen, _t(fl), _t(fr), *map(_t, meta),
                                     image_size=OUT, occlusion="CUTOUT",
                                     train=True, occl_prob=0.7,
                                     return_masks=True)
    ev = dp.preprocess_stereo_batch(None, _t(fl), _t(fr), *map(_t, meta),
                                    image_size=OUT, train=False)
    keep = out["keep_mask"]
    gray = normalize_imagenet(torch.tensor([128.0, 128.0, 128.0]))
    assert (~keep).any()
    assert torch.equal(out["image"][~keep], gray.expand(int((~keep).sum()),
                                                        3))
    assert torch.equal(out["image"][keep], ev["image"][keep])
    t2d = ev["target_2d"].numpy()
    inside = ((t2d[..., 0] >= 0) & (t2d[..., 0] < 32) & (t2d[..., 1] >= 0)
              & (t2d[..., 1] < 32))
    want = meta[4] * inside[:, 0] * inside[:, 1]
    k = keep.numpy()
    for v in (0, 1):
        xy = np.where(inside[:, v, :, None], t2d[:, v], -1.0).astype(
            np.int32)
        want = want * k[np.arange(B)[:, None], v, xy[..., 1], xy[..., 0]]
    assert np.array_equal(out["target_weight"].numpy(), want)


# ------------------------------------------------------------ cache

def _decoder(frames):
    def decode(paths):
        return [frames[p] for p in paths]
    return decode


def _stereo_paths(n_pairs):
    return [f"p{i:03d}_{v}" for i in range(n_pairs) for v in "lr"]


def _frame_set(n_pairs, h=H0, w=W0, seed=20):
    r = np.random.RandomState(seed)
    return {p: r.randint(0, 256, (h, w, 3), dtype=np.uint8)
            for p in _stereo_paths(n_pairs)}


FRAME = H0 * W0 * 3


@pytest.mark.parametrize("case", [
    dict(budget=1 << 20, chunk_frames=3),
    dict(budget=1 << 20, chunk_frames=64, pad_frames_to=8),
    dict(budget=15 * FRAME, chunk_frames=4, pad_frames_to=8),  # no room
    dict(budget=7 * FRAME + 100, allow_partial=True, pair_stride=2,
         chunk_frames=3),
    dict(budget=5 * FRAME, allow_partial=True, chunk_frames=2),
], ids=["full", "padded", "pad_over_budget", "partial_pairs",
        "partial_odd"])
def test_device_cache_build_matches_jax(case):
    """Rows, deduplication (every path given twice), the partial prefix,
    padding and the frames themselves, against JAX's build."""
    case = dict(case)
    budget = case.pop("budget")
    frames = _frame_set(7)
    paths = list(frames) + list(frames)[::-1]
    ref = JaxCache.build(paths, _decoder(frames), budget, **case)
    got = DeviceFrameCache.build(paths, _decoder(frames), budget,
                                 device="cpu", **case)
    assert got.frames.device.type == "cpu"
    assert got.frames.dtype == torch.uint8
    assert np.array_equal(got.frames.numpy(), np.asarray(ref.frames))
    assert got.partial == ref.partial and got.nbytes == ref.nbytes
    kept = [p for p in frames if ref.has(p)]
    assert [p for p in frames if got.has(p)] == kept
    assert np.array_equal(got.rows(kept), ref.rows(kept))
    assert got.rows(kept).dtype == np.int32
    if case.get("pair_stride") == 2:
        assert got.partial and got.frames.shape[0] == 6


def test_device_cache_none_cases_match_jax():
    """None (the JAX API's answer: the caller streams from the host) when
    over budget without allow_partial, when nothing fits, with no budget,
    and on mixed frame sizes in the first chunk or a later one."""
    frames = _frame_set(3)
    paths = list(frames)
    dec = _decoder(frames)
    for args, kw in (((5 * FRAME,), {}), ((FRAME,), dict(allow_partial=True,
                                                          pair_stride=2)),
                     ((0,), {})):
        assert JaxCache.build(paths, dec, *args, **kw) is None
        assert DeviceFrameCache.build(paths, dec, *args, device="cpu",
                                      **kw) is None
    for odd in ("p000_r", "p002_l"):
        bad = dict(frames)
        bad[odd] = np.zeros((H0 + 2, W0, 3), np.uint8)
        for build, kw in ((JaxCache.build, {}),
                          (DeviceFrameCache.build, dict(device="cpu"))):
            assert build(paths, _decoder(bad), 1 << 20, chunk_frames=3,
                         **kw) is None


def test_cached_and_partial_batches_bit_identical_to_uncached():
    """A batch gathered from the cache, and one split between the cache and
    the upload lane, equal the batch from the frames themselves, bit for
    bit, occlusion and all (same generator seed)."""
    frames = _frame_set(8)
    cache = DeviceFrameCache.build(list(frames), _decoder(frames), 1 << 20,
                                   device="cpu")
    pairs = [5, 1, 7, 2, 0, 3]
    left = [f"p{i:03d}_l" for i in pairs]
    right = [f"p{i:03d}_r" for i in pairs]
    meta = _meta(21)
    kw = dict(image_size=OUT, occlusion="HNS", train=True, occl_prob=0.5,
              return_masks=True)
    plain = dp.preprocess_stereo_batch(
        torch.Generator().manual_seed(9),
        _t(np.stack([frames[p] for p in left])),
        _t(np.stack([frames[p] for p in right])), *map(_t, meta), **kw)
    cached = dp.preprocess_stereo_batch_cached(
        torch.Generator().manual_seed(9), cache.frames,
        torch.from_numpy(cache.rows(left)), torch.from_numpy(cache.rows(right)),
        *map(_t, meta), **kw)
    part = dp.preprocess_stereo_batch_partial(
        torch.Generator().manual_seed(9), cache.frames, cache.rows(left[:4]),
        cache.rows(right[:4]), np.stack([frames[p] for p in left[4:]]),
        np.stack([frames[p] for p in right[4:]]), *map(_t, meta), **kw)
    for k in plain:
        assert torch.equal(cached[k], plain[k]), k
        assert torch.equal(part[k], plain[k]), k


def test_stereo_partial_matches_jax():
    """The partial form's lane order (cached rows first, then the upload
    lane) against JAX's, occlusion off, train mode."""
    frames = {p: f for p, f in zip(_stereo_paths(6),
                                   _smooth_frames(22, 12))}
    cache = DeviceFrameCache.build(list(frames), _decoder(frames), 1 << 20,
                                   device="cpu")
    jcache = JaxCache.build(list(frames), _decoder(frames), 1 << 20)
    left, right = ["p004_l", "p001_l"], ["p004_r", "p001_r"]
    up_l = np.stack([frames[p] for p in ("p000_l", "p003_l", "p005_l",
                                         "p002_l")])
    up_r = np.stack([frames[p] for p in ("p000_r", "p003_r", "p005_r",
                                         "p002_r")])
    meta = _meta(23)
    ref = jdp.preprocess_stereo_batch_partial(
        jax.random.PRNGKey(0), jcache.frames, _j(jcache.rows(left)),
        _j(jcache.rows(right)), _j(up_l), _j(up_r), *map(_j, meta),
        image_size=OUT, train=True)
    got = dp.preprocess_stereo_batch_partial(
        None, cache.frames, cache.rows(left), cache.rows(right), up_l, up_r,
        *map(_t, meta), image_size=OUT, train=True)
    _check_stereo(got, {k: np.asarray(v) for k, v in ref.items()})


# -------------------------------------------------------------- mono

@pytest.mark.parametrize("partial", [False, True], ids=["cached", "partial"])
def test_mono_cached_with_flips_matches_jax(partial):
    """The mono cached path mirrors the raw frame on the device where flip
    is set, warps, normalises and renders the targets: image within the
    warp's bound, targets within 1e-6, weights exact."""
    frames = {f"m{i}": f for i, f in enumerate(_smooth_frames(24, 8))}
    cache = DeviceFrameCache.build(list(frames), _decoder(frames), 1 << 20,
                                   device="cpu")
    jcache = JaxCache.build(list(frames), _decoder(frames), 1 << 20)
    names = ["m6", "m2", "m2", "m7", "m0"]
    flip = np.array([True, False, True, False, True])
    r = np.random.RandomState(25)
    trans = np.stack([get_affine_transform(
        (W0 / 2, H0 / 2), r.uniform(0.8, 1.2), r.uniform(-30, 30), H0, OUT)
        for _ in names]).astype(np.float32)
    joints = r.uniform(-4, 36, (5, J, 2)).astype(np.float32)
    vis = (r.rand(5, J) > 0.2).astype(np.float32)
    kw = dict(image_size=OUT, heatmap_size=(8, 8), sigma=1)
    if partial:
        up = np.stack([frames[n] for n in names[3:]])
        ref = jdp.preprocess_mono_batch_partial(
            jcache.frames, _j(jcache.rows(names[:3])), _j(up), _j(flip),
            _j(trans), _j(joints), _j(vis), **kw)
        got = dp.preprocess_mono_batch_partial(
            cache.frames, cache.rows(names[:3]), up, flip, trans, joints,
            vis, **kw)
    else:
        ref = jdp.preprocess_mono_batch_cached(
            jcache.frames, _j(jcache.rows(names)), _j(flip), _j(trans),
            _j(joints), _j(vis), **kw)
        got = dp.preprocess_mono_batch_cached(
            cache.frames, torch.from_numpy(cache.rows(names)),
            torch.from_numpy(flip), trans, joints, vis, **kw)
    assert got["image"].shape == (5, 32, 32, 3)
    assert np.abs(got["image"].numpy() - np.asarray(ref["image"])).max() \
        <= IMAGE_TOL
    assert np.abs(got["target"].numpy() - np.asarray(ref["target"])).max() \
        <= 1e-6
    assert np.array_equal(got["target_weight"].numpy(),
                          np.asarray(ref["target_weight"]))
    # the flipped copy of m2 differs from the unflipped one
    assert not torch.equal(got["image"][1], got["image"][2])
