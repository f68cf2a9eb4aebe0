"""The PyTorch port's input-pipeline ops (fast3dhpe_tpu_torch: config
DATASET, geometry/affine.py, geometry/camera.py, ops/warp.py,
ops/heatmap.py render_gaussian_heatmaps, ops/occlusion.py) against the
JAX package on the CPU, on the same numpy inputs from a seed."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.config import load_config as jax_load_config
from fast3dhpe_tpu.geometry import affine as jax_affine
from fast3dhpe_tpu.geometry import camera as jax_camera
from fast3dhpe_tpu.ops.heatmap import (
    render_gaussian_heatmaps as jax_render)
from fast3dhpe_tpu.ops.occlusion import cutout as jax_cutout
from fast3dhpe_tpu.ops.occlusion import hide_n_seek as jax_hide_n_seek
from fast3dhpe_tpu.ops.warp import affine_warp as jax_affine_warp
from fast3dhpe_tpu.ops.warp import normalize_imagenet as jax_normalize
from fast3dhpe_tpu_torch.config import config_from_dict, load_config
from fast3dhpe_tpu_torch.geometry import affine, camera
from fast3dhpe_tpu_torch.ops import occlusion
from fast3dhpe_tpu_torch.ops.heatmap import render_gaussian_heatmaps
from fast3dhpe_tpu_torch.ops.warp import (_mean_std, affine_warp,
                                          normalize_imagenet)

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("name", ["mads_3d.yaml", "mads_2d.yaml",
                                  "mpii.yaml"])
def test_config_dataset_section_matches_jax(name):
    path = os.path.join(CONFIGS, name)
    ours, ref = load_config(path), jax_load_config(path)
    for key in ("FLIP", "ROT_FACTOR", "SCALE_FACTOR", "OCCLUSION",
                "DEVICE_CACHE_BYTES"):
        assert getattr(ours.DATASET, key) == getattr(ref.DATASET, key), key
    assert ours.TEST.BATCH_SIZE == ref.TEST.BATCH_SIZE
    assert ours.MODEL.EXTRA.SIGMA == ref.MODEL.EXTRA.SIGMA


def test_config_occlusion_is_validated():
    for occl in (None, "None", "CUTOUT", "HNS"):
        cfg = config_from_dict({"DATASET": {"OCCLUSION": occl,
                                            "TYPE": "MADS_3d"}})
        assert cfg.DATASET.OCCLUSION == occl
    with pytest.raises(ValueError, match="OCCLUSION"):
        config_from_dict({"DATASET": {"OCCLUSION": "cutout"}})


# ------------------------------------------------------------------ affine

AFFINE_CASES = [  # center, scale, rot, origin_size, output_size, shift, inv
    ((32.0, 24.0), 1.0, 0.0, 48, (32, 32), (0.0, 0.0), False),
    ((30.5, 20.0), 1.2, 17.0, 48, (32, 32), (0.0, 0.0), False),
    ((512.0, 384.0), 0.8, -45.0, 768, (256, 256), (0.1, -0.05), False),
    ((100.0, 80.0), np.array([0.9, 1.1]), 30.0, 160, (64, 48), (0.0, 0.0),
     True),
]


@pytest.mark.parametrize("case", range(len(AFFINE_CASES)))
def test_affine_helpers_bit_equal(case):
    """The port's copy runs the same numpy arithmetic: bit-equal."""
    args = AFFINE_CASES[case]
    t = affine.get_affine_transform(*args[:5], shift=args[5], inv=args[6])
    ref = jax_affine.get_affine_transform(*args[:5], shift=args[5],
                                          inv=args[6])
    assert t.dtype == ref.dtype and np.array_equal(t, ref)
    r = np.random.RandomState(case)
    pts = r.uniform(-10, 70, (7, 2))
    assert np.array_equal(affine.affine_transform_points(pts, t),
                          jax_affine.affine_transform_points(pts, ref))
    P, K = r.randn(4, 4), r.randn(3, 3)
    assert np.array_equal(affine.compose_projection_with_affine(P, t),
                          jax_affine.compose_projection_with_affine(P, ref))
    assert np.array_equal(affine.update_intrinsics_with_affine(K, t),
                          jax_affine.update_intrinsics_with_affine(K, ref))
    vis = np.repeat((r.rand(7, 1) > 0.3).astype(np.float32), 2, axis=1)
    pairs = ((0, 1), (2, 5))
    for got, want in zip(affine.fliplr_joints(pts, vis, 64, pairs),
                         jax_affine.fliplr_joints(pts, vis, 64, pairs)):
        assert np.array_equal(got, want)


# ------------------------------------------------------------------ camera

def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rtol * scale


def test_camera_matches_jax():
    """project_points (3x4 and 4x4 P), the camera chain and the numpy twin:
    1e-5 of the largest magnitude."""
    r = np.random.RandomState(0)
    pts = r.uniform(-300, 300, (2, 5, 7, 3)).astype(np.float32)
    R = jax_camera.rodrigues(r.randn(2, 5, 3) * 0.3)
    R = np.asarray(R)
    T = (r.randn(2, 5, 3, 1) * 100 + np.array([[0], [0], [3000]])).astype(
        np.float32)
    K = np.array([[1100.0, 0, 128], [0, 1100.0, 128], [0, 0, 1]],
                 np.float32)
    K = np.broadcast_to(K, (2, 5, 3, 3)).copy()
    P = np.asarray(jax_camera.get_projection_matrix(K, R, T))
    _close(camera.get_projection_matrix(K, R, T), P)
    _close(camera.world_to_camera(pts, R, T),
           jax_camera.world_to_camera(pts, R, T))
    _close(camera.project_3d_to_2d(pts, K, R, T),
           jax_camera.project_3d_to_2d(pts, K, R, T))
    for PP in (P, P[..., :3, :]):
        ref = np.asarray(jax_camera.project_points(pts, PP))
        _close(camera.project_points(pts, PP), ref)
        _close(camera.project_points_np(pts, PP),
               jax_camera.project_points_np(pts, PP))
        _close(camera.project_points_np(pts, PP), ref)


def test_rodrigues_matches_jax():
    """Random vectors, a zero vector (the identity branch) and a tiny one:
    1e-5 of the largest magnitude."""
    r = np.random.RandomState(1)
    rv = np.concatenate([r.randn(6, 3), np.zeros((1, 3)),
                         np.full((1, 3), 1e-14)]).astype(np.float32)
    got = camera.rodrigues(rv)
    _close(got, jax_camera.rodrigues(rv))
    assert torch.equal(got[6], torch.eye(3))
    with pytest.raises(ValueError):
        camera.rodrigues(np.zeros((2, 4)))


# -------------------------------------------------------------------- warp

def _frames(seed, b=3, h=48, w=64):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3),
                                               dtype=np.uint8)


def _trans_cases():
    """Per-sample affines onto 32x32 from 48x64 frames: scale, rotation and
    translation, one reaching past the frame's edge."""
    return np.stack([
        affine.get_affine_transform((32, 24), 1.0, 0.0, 48, (32, 32)),
        affine.get_affine_transform((30.3, 21.7), 1.3, 23.0, 48, (32, 32)),
        affine.get_affine_transform((58.0, 40.0), 0.9, -61.0, 48, (32, 32)),
    ]).astype(np.float32)


def _smooth_frames(seed, b=3, h=48, w=64):
    """uint8 frames spanning 0-255 whose neighbours differ by at most ~13
    levels, falling to ~0 at the edges so that the zero border adds no
    step either."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    window = np.sin(np.pi * (x + 1) / (w + 1)) * np.sin(np.pi * (y + 1)
                                                        / (h + 1))
    f = [255 * window * (0.75 + 0.25 * np.sin(0.05 * x + r.uniform(0, 6))
                         * np.cos(0.04 * y + r.uniform(0, 6)))
         for _ in range(b * 3)]
    return np.round(np.stack(f, -1).reshape(h, w, b, 3).transpose(
        2, 0, 1, 3)).astype(np.uint8)


def _warp_f64(images, trans, size):
    """The warp's definition in float64, with the exact inverse."""
    Wo, Ho = size
    B, H, W, _ = images.shape
    t = np.broadcast_to(np.asarray(trans, np.float64), (B, 2, 3))
    inv = np.linalg.inv(np.concatenate(
        [t, np.broadcast_to([[[0.0, 0.0, 1.0]]], (B, 1, 3))], 1))[:, :2]
    gy, gx = np.mgrid[0:Ho, 0:Wo].astype(np.float64)
    sx, sy = (inv[:, i, 0, None, None] * gx + inv[:, i, 1, None, None] * gy
              + inv[:, i, 2, None, None] for i in (0, 1))
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    im = images.astype(np.float64)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = im[np.arange(B)[:, None, None], np.clip(yi, 0, H - 1).astype(int),
               np.clip(xi, 0, W - 1).astype(int)]
        return np.where(valid[..., None], v, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


# Both invert the affine by the closed form in fp32, where the translation
# term cancels (-(a b0 + c b1) from terms ~60 times larger on these
# frames), and form the source coordinates in fp32; JAX's CPU backend
# fuses some of those multiply-adds, the port does not. So the two agree
# only to a few ulps of a coordinate (3.8e-6 px each below 64). On uniform
# noise, or across the step from a bright edge to the zero border, one ulp
# moves a bilinear value by up to 255 x 3.8e-6 = 1e-3 levels, and each
# framework is itself 1.7e-3 levels from the float64 warp there. So generic
# affines are held on smooth frames (_smooth_frames), and noise frames go
# through affines whose inverses are exact in fp32 (dyadic scale, a quarter
# turn, a mirror, dyadic shifts). Both: max 1e-3 intensity levels on the
# 0-255 input and mean 3e-5; and on the generic cases the port is no
# further from the float64 warp than JAX is (x 1.5, + 1e-4 levels).
# Measured: max 1.1e-4 and mean 9.8e-6 at worst on the smooth frames, 0 on
# the noise frames.
WARP_MAX, WARP_MEAN = 1e-3, 3e-5
EXACT_INVERSE = np.array([
    [[2.0, 0.0, -10.0], [0.0, 2.0, 6.0]],         # scale 2, partly outside
    [[0.0, -0.5, 40.0], [0.5, 0.0, -3.0]],        # a quarter turn, scale 0.5
    [[-1.0, 0.0, 50.5], [0.0, 1.0, -8.25]],       # a mirror, sub-pixel shift
], np.float32)


@pytest.mark.parametrize("what", ["generic", "float_input", "shared_trans",
                                  "non_square_out", "noise_exact_inverse"])
def test_affine_warp_matches_jax(what):
    """Scale, rotation, translation, samples partly outside the frame."""
    imgs = _smooth_frames(2)
    trans = _trans_cases()
    size = (32, 32)
    if what == "float_input":
        imgs = imgs.astype(np.float32) * 0.5 + 0.25
    elif what == "shared_trans":
        trans = trans[1]
    elif what == "non_square_out":
        trans = np.stack([affine.get_affine_transform(
            (31, 25), 1.1, a, 48, (40, 24)) for a in (0.0, 13.0, 90.0)
        ]).astype(np.float32)
        size = (40, 24)
    elif what == "noise_exact_inverse":
        imgs, trans = _frames(2), EXACT_INVERSE
    ref = np.asarray(jax_affine_warp(jnp.asarray(imgs), jnp.asarray(trans),
                                     size))
    got = affine_warp(torch.from_numpy(imgs), torch.from_numpy(trans), size)
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (3, size[1], size[0], 3)
    d = np.abs(got.numpy() - ref)
    assert d.max() <= WARP_MAX and d.mean() <= WARP_MEAN, (d.max(),
                                                           d.mean())
    assert (ref == 0).any() and ref.max() > 100    # reaches past the frame
    if what != "noise_exact_inverse":
        exact = _warp_f64(imgs, trans, size)
        assert (np.abs(got.numpy() - exact).max()
                <= 1.5 * np.abs(ref - exact).max() + 1e-4)


def test_invert_affine_matches_jax():
    """The closed-form fp32 inverse, for 768x1024 frames onto 256x256: the
    2x2 part within 4 ulps of JAX's, the translation within 4 ulps of its
    larger term (it cancels); exact where the inverse is exact."""
    from fast3dhpe_tpu.ops.warp import _invert_affine as jax_invert
    from fast3dhpe_tpu_torch.ops.warp import invert_affine
    r = np.random.RandomState(9)
    trans = np.stack([affine.get_affine_transform(
        r.uniform(0, 1024, 2), r.uniform(0.7, 1.3), r.uniform(-60, 60), 768,
        (256, 256)) for _ in range(64)]).astype(np.float32)
    ref = np.asarray(jax.jit(jax_invert)(jnp.asarray(trans)))
    got = invert_affine(torch.from_numpy(trans)).numpy()
    assert np.all(np.abs(got - ref)[..., :2]
                  <= 4 * np.spacing(np.abs(ref[..., :2])))
    terms = np.abs(ref[..., :2] * trans[:, None, :, 2]).max(-1)
    assert np.all(np.abs(got - ref)[..., 2] <= 4 * np.spacing(terms))
    got = invert_affine(torch.from_numpy(EXACT_INVERSE)).numpy()
    assert np.array_equal(got, np.asarray(jax_invert(EXACT_INVERSE)))


def test_affine_warp_convention():
    """An identity affine returns the top-left crop exactly (no half-pixel
    offset; out_size is (W, H)); a half-pixel shift past the right edge
    averages the last column with the zero border."""
    imgs = _frames(3, b=1)
    eye = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    got = affine_warp(torch.from_numpy(imgs), torch.from_numpy(eye),
                      (40, 20))
    assert torch.equal(got, torch.from_numpy(imgs[:, :20, :40]).float())
    shift = np.array([[1, 0, -63.5], [0, 1, 0]], np.float32)  # x -> x-63.5
    got = affine_warp(torch.from_numpy(imgs), torch.from_numpy(shift),
                      (2, 4))
    last = imgs[0, :4, 63].astype(np.float32)
    np.testing.assert_allclose(got[0, :, 0].numpy(), 0.5 * last)
    assert torch.equal(got[0, :, 1], torch.zeros(4, 3))


def test_normalize_imagenet_matches_jax_and_builds_constants_once():
    imgs = _frames(4)
    ref = np.asarray(jax_normalize(jnp.asarray(imgs)))
    got = normalize_imagenet(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    hits = _mean_std.cache_info().hits
    normalize_imagenet(torch.from_numpy(imgs))
    assert _mean_std.cache_info().hits == hits + 1


# ----------------------------------------------------------------- heatmap

@pytest.mark.parametrize("vis_cols", [0, 2], ids=["vis_bj", "vis_bjc"])
def test_render_gaussian_heatmaps_matches_jax(vis_cols):
    """Targets within 1e-6, weights exactly. Joints include negative
    coordinates, where trunc and floor differ (-3.1 px at stride 4: mu is
    trunc(-0.275) = 0, floor would give -1), windows partly and wholly
    outside the heatmap, and an invisible joint."""
    r = np.random.RandomState(5)
    joints = r.uniform(-20, 90, (2, 3, 9, 2)).astype(np.float32)
    joints[0, 0, 0] = (-3.1, 17.0)
    joints[0, 0, 1] = (-40.0, 10.0)            # window wholly left
    joints[0, 0, 2] = (70.0, 200.0)            # wholly below
    joints[0, 0, 3] = (-1.0, -1.0)
    # mu_x = trunc(-7.25) = -7: the window's end br = 0 is not < 0, so the
    # weight stays 1 though nothing is drawn
    joints[0, 0, 4] = (-31.0, 5.0)
    vis = (r.rand(2, 3, 9) > 0.2).astype(np.float32)
    vis[0, 0, :5] = 1.0
    if vis_cols:
        vis = np.repeat(vis[..., None], vis_cols, -1)
        vis[..., 1] = 0.0                      # only the first column counts
    hm, img = (20, 16), (80, 64)               # width first, stride 4
    ref_t, ref_w = (np.asarray(a) for a in jax_render(joints, vis, hm, img,
                                                      sigma=2))
    got_t, got_w = render_gaussian_heatmaps(joints, vis, hm, img, sigma=2)
    assert got_t.shape == ref_t.shape == (2, 3, 16, 20, 9)
    assert np.array_equal(got_w.numpy(), ref_w)
    assert np.abs(got_t.numpy() - ref_t).max() <= 1e-6
    assert ref_w[0, 0, 1] == 0 and ref_w[0, 0, 2] == 0
    assert ref_w[0, 0, 0] == 1 and got_t[0, 0, :, 0, 0].max() > 0.5


# --------------------------------------------------------------- occlusion

def _jax_cutout_draws(key, b, h, w, n_holes=6):
    """The numbers ops/occlusion.py cutout draws from `key`."""
    ky, kx = jax.random.split(key)
    return (np.asarray(jax.random.randint(ky, (b, n_holes), 0, h)),
            np.asarray(jax.random.randint(kx, (b, n_holes), 0, w)))


@pytest.mark.parametrize("hw", [(32, 32), (48, 64), (70, 45)])
def test_cutout_mask_from_jax_draws_is_bit_equal(hw):
    """Fed the centres JAX drew for the same key, the mask builder gives
    JAX's keep-mask and image bit for bit (edges clipped, non-square)."""
    h, w = hw
    imgs = _frames(6, b=4, h=h, w=w).astype(np.float32)
    key = jax.random.PRNGKey(h * 100 + w)
    ref_img, ref_keep = (np.asarray(a) for a in jax_cutout(
        key, jnp.asarray(imgs), length=20))
    cy, cx = _jax_cutout_draws(key, 4, h, w)
    keep = occlusion.cutout_mask(torch.from_numpy(cy), torch.from_numpy(cx),
                                 h, w, length=20)
    assert np.array_equal(keep.numpy(), ref_keep)
    out = occlusion.fill_occluded(torch.from_numpy(imgs), keep)
    assert np.array_equal(out.numpy(), ref_img)
    assert (~ref_keep).any()


@pytest.mark.parametrize("hw,n", [((32, 32), 4), ((50, 70), 4),
                                  ((70, 50), 3), ((64, 64), 4)])
def test_hide_n_seek_mask_from_jax_draws_is_bit_equal(hw, n):
    """Fed JAX's scores, bit-equal masks and images. On a non-square image
    the cell length is H // n on both axes: 50x70 with n = 4 has 12-pixel
    cells, so columns 48-69 and rows 48-49 are never hidden; 70x50 with
    n = 3 has 23-pixel cells, which reach past the 50 columns."""
    h, w = hw
    imgs = _frames(7, b=5, h=h, w=w).astype(np.float32)
    key = jax.random.PRNGKey(h + w + n)
    ref_img, ref_keep = (np.asarray(a) for a in jax_hide_n_seek(
        key, jnp.asarray(imgs), n_patches=n))
    scores = np.asarray(jax.random.uniform(key, (5, n * n)))
    keep = occlusion.hide_n_seek_mask(torch.from_numpy(scores), h, w,
                                      n_patches=n)
    assert np.array_equal(keep.numpy(), ref_keep)
    out = occlusion.fill_occluded(torch.from_numpy(imgs), keep)
    assert np.array_equal(out.numpy(), ref_img)
    grid = n * (h // n)
    assert ref_keep[:, grid:, :].all() and ref_keep[:, :, grid:].all()


def test_occlusion_draws_and_counts():
    """The port's own draws: centres in range, exactly int(0.4 * 16) = 6
    of 16 cells hidden an image, gray 128 where hidden."""
    gen = torch.Generator().manual_seed(0)
    cy, cx = occlusion.cutout_draw(gen, 64, 30, 50)
    assert cy.shape == (64, 6) and 0 <= int(cy.min()) and int(cy.max()) < 30
    assert 0 <= int(cx.min()) and int(cx.max()) < 50
    assert int(cy.max()) > 25 and int(cx.max()) > 45
    imgs = torch.from_numpy(_frames(8, b=8, h=64, w=64)).float()
    out, keep = occlusion.hide_n_seek(gen, imgs)
    cells = (~keep).reshape(8, 4, 16, 4, 16)
    full = cells.all(dim=4).all(dim=2)
    assert torch.equal(full, cells.any(dim=4).any(dim=2))  # whole cells
    assert full.sum(dim=(1, 2)).tolist() == [6] * 8
    assert (out[~keep] == 128.0).all()
    assert torch.equal(out[keep], imgs[keep])
    out, keep = occlusion.cutout(gen, imgs)
    assert (out[~keep] == 128.0).all() and (~keep).any()
