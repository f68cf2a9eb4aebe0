"""The PyTorch port's loaders (fast3dhpe_tpu_torch/data/loader.py
Stereo3DLoader, Mono2DLoader, load_data) against the JAX package's, on the
CPU device, on small synthetic JPEG trees, and one CDR train epoch fed by
each package's loader.

Tolerances: the stacked epochs' host arrays are bit-equal to JAX's. A
batch of __iter__ (occlusion off) holds its targets and projections
within 1e-4 of their largest magnitude, its weights and row_valid
exactly, and its image within 4 ulps of the frame's largest coordinate
times a full 255-level step, normalised (IMAGE_TOL, 1.6e-2 levels for
128-wide frames): the two frameworks round the fp32 source coordinates
of a generic affine differently (JAX's CPU backend fuses multiply-adds),
and a bilinear tap moves by that rounding times the step between
neighbouring pixels, which these JPEGs' bright dots make large
(tests/test_torch_pipeline_ops.py holds 1e-3 levels on smooth frames).
A wrong affine or frame moves pixels by whole levels. The host warp,
truncated to uint8, within one level. The loader-fed epoch within the
bounds of tests/test_torch_train_epoch.py at lr 1e-7, with two
exceptions set from measurements on this tree (see LR and CF_VAR_TOL):
loss_3d within 5e-2, since the DLT of untrained keypoints through the
tree's parallel rig turns their rounding-level differences into 0.5-1%
of loss_3d (that file's rig converges on the origin), and a warmup
epoch's gradient has no 3D term; CF.out_layer's running variances
within 2e-3 of their range."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fast3dhpe_tpu.config import config_from_dict as jax_config_from_dict
from fast3dhpe_tpu.data import loader as jax_loader
from fast3dhpe_tpu.data.synthetic import (make_synthetic_mads,
                                          make_synthetic_mpii)
from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu.models import make_loss as jax_make_loss
from fast3dhpe_tpu.train import steps as jsteps
from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
from fast3dhpe_tpu.train.state import multistep_lr as jax_multistep_lr
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.data import loader
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.losses import make_loss
from fast3dhpe_tpu_torch.train import steps
from fast3dhpe_tpu_torch.train.state import TrainState

from test_torch_train_epoch import BN_TOL, _np

torch.set_num_threads(2)

IMG, HM = 64, 16
W0 = 128                          # the MADS tree's frame width
IMAGE_TOL = 4 * np.finfo(np.float32).eps * W0 / 0.224
META_TOL = 1e-4
FRAME = 96 * W0 * 3
PAIRS = 14                        # 2 movements x 7 frames
# The loader-fed epoch runs at lr 1e-7: on this tree the second step's
# batch statistics follow Adam's sign flips of the first update further
# than on test_torch_train_epoch.py's frames (the decoder's running means
# 3.2e-3 of their range at lr 1e-6, 3.5e-4 at 1e-7). CF.out_layer's
# running variances reach ~2.5e9 on this tree's rig, and the frameworks'
# fp32 batch variances of those activations differ by 1.4e-3 of their
# range at either lr.
LR, CF_VAR_TOL = 1e-7, 2e-3


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    make_synthetic_mads(str(root / "mads"), n_frames=7, img_w=128, img_h=96,
                        movements=("HipHop", "Jazz"), nan_joint_every=3)
    # MPII of one frame size (a device cache can hold it) and of mixed ones
    make_synthetic_mpii(str(root / "mpii_fixed"), n_train=10, n_valid=5,
                        base_hw=(96, 128), vary=0)
    make_synthetic_mpii(str(root / "mpii"), n_train=10, n_valid=5,
                        base_hw=(96, 128))
    return root


def _cfg(trees, dataset, train_batch=4, **extra):
    root = {"MADS_3d": "mads", "MADS_2d": "mads",
            "MPII": extra.pop("mpii", "mpii_fixed")}[dataset]
    d = {"DATASET": dict({"TYPE": dataset, "ROOT": str(trees / root),
                          "OCCLUSION": "None"}, **extra),
         "MODEL": {"NAME": "t", "NUM_LAYERS": 18, "IMAGE_SIZE": [IMG, IMG],
                   "NUM_JOINTS": 16 if dataset == "MPII" else 19,
                   "EXTRA": {"HEATMAP_SIZE": [HM, HM], "SIGMA": 1}},
         "TRAIN": {"BATCH_SIZE": train_batch, "LR": LR, "LR_STEP": [1],
                   "LR_FACTOR": 0.1},
         "TEST": {"BATCH_SIZE": 3},
         "LOSS": {"TYPE": "JointsMSESmooth", "USE_TARGET_WEIGHT": True}}
    return config_from_dict(d), jax_config_from_dict(d)


def _pair(trees, cls_name, dataset, image_set, seed=3, cfg_extra=None,
          **kwargs):
    """The port's and JAX's loader of one class on the same tree."""
    cfg, jcfg = _cfg(trees, dataset, **(cfg_extra or {}))
    return _loaders(cfg, jcfg, cls_name, image_set, seed, **kwargs)


def _loaders(cfg, jcfg, cls_name, image_set, seed=3, **kwargs):
    port = getattr(loader, cls_name)(cfg, image_set, seed=seed,
                                     device="cpu", **kwargs)
    jax_ = getattr(jax_loader, cls_name)(jcfg, image_set, seed=seed,
                                         **kwargs)
    return port, jax_


def _equal_xs(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("image_set", ["train", "valid"])
def test_stereo_stacked_epoch_matches_jax(trees, image_set):
    port, jax_ = _pair(trees, "Stereo3DLoader", "MADS_3d", image_set,
                       device_cache_bytes=1 << 30)
    for _ in range(2):
        cache, xs, e = port.stacked_epoch()
        jcache, jxs, je = jax_.stacked_epoch()
        assert e == je and not cache.partial
        _equal_xs(xs, jxs)
        np.testing.assert_array_equal(cache.frames.numpy(),
                                      np.asarray(jcache.frames))
    assert xs["row_valid"].sum() == PAIRS
    port.close()
    jax_.close()


@pytest.mark.parametrize("dataset,image_set", [
    ("MADS_2d", "train"), ("MADS_2d", "valid"), ("MPII", "train"),
    ("MPII", "valid")])
def test_mono_stacked_epoch_matches_jax(trees, dataset, image_set):
    port, jax_ = _pair(trees, "Mono2DLoader", dataset, image_set,
                       device_cache_bytes=1 << 30)
    for _ in range(2):
        cache, xs, e = port.stacked_epoch()
        jcache, jxs, je = jax_.stacked_epoch()
        assert e == je
        _equal_xs(xs, jxs)
        np.testing.assert_array_equal(cache.frames.numpy(),
                                      np.asarray(jcache.frames))
    if image_set == "train":
        assert xs["flip"].any() and not xs["flip"].all()


def _close_batches(got, ref):
    """One batch of the port (tensors) against JAX's (arrays)."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].cpu().numpy()
        r = np.asarray(r)
        assert g.shape == r.shape, k
        if k == "image":
            assert np.abs(g - r).max() <= IMAGE_TOL, k
        elif k in ("target_weight", "row_valid"):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            assert np.abs(g - r).max() <= META_TOL * max(
                np.abs(r).max(), 1e-6), k


@pytest.mark.parametrize("image_set", ["train", "valid"])
@pytest.mark.parametrize("budget", [1 << 30, 10 * FRAME, 0],
                         ids=["full", "partial", "none"])
def test_stereo_batches_match_jax(trees, image_set, budget):
    """Two epochs of __iter__ with the tree whole on the device, a partial
    cache of 5 pairs (the upload lane) and none."""
    port, jax_ = _pair(trees, "Stereo3DLoader", "MADS_3d", image_set,
                       device_cache_bytes=budget)
    for _ in range(2):
        got, ref = list(port), list(jax_)
        assert len(got) == len(ref) == len(port)
        for g, r in zip(got, ref):
            _close_batches(g, r)
    assert port.device_cached == bool(budget)
    if budget == 10 * FRAME:
        cache = port.ensure_device_cache()
        assert cache.partial and cache.frames.shape[0] == 10
        lanes = {(b["rows"], b["uploaded"]) for b in port.batch_log}
        assert len(lanes) == 1
        rows, uploaded = lanes.pop()
        assert rows + uploaded // 2 == port.batch_size and rows > 0


@pytest.mark.parametrize("dataset,budget,image_set", [
    ("MPII-mixed", 1 << 30, "train"), ("MPII-mixed", 0, "valid"),
    ("MADS_2d", 1 << 30, "train"), ("MADS_2d", 4 * FRAME, "train"),
    ("MADS_2d", 0, "valid")])
def test_mono_batches_match_jax(trees, dataset, budget, image_set):
    """Mixed-size MPII frames (no cache can hold them: zero-padded host
    batches), MADS_2d whole on the device, partly on it, and streamed."""
    extra = {"mpii": "mpii"} if dataset == "MPII-mixed" else None
    port, jax_ = _pair(trees, "Mono2DLoader", dataset.split("-")[0],
                       image_set, cfg_extra=extra,
                       device_cache_bytes=budget)
    got, ref = list(port), list(jax_)
    assert len(got) == len(ref) == len(port)
    for g, r in zip(got, ref):
        _close_batches(g, r)
    if dataset == "MPII-mixed":
        assert not port.device_cached
        assert all(s[0] % 128 == 0 and s[1] % 128 == 0
                   for s in (b["frame_shape"] for b in port.batch_log))
    else:
        assert port.device_cached == bool(budget)


def test_host_warp_matches_jax_without_cv2(trees, monkeypatch):
    """device_preprocess=False: the port warps on the host with
    affine_warp on CPU tensors, as the JAX loader does where cv2 is
    missing; truncated to uint8, within one level."""
    port, jax_ = _pair(trees, "Mono2DLoader", "MADS_2d", "train",
                       device_preprocess=False)
    got = list(port)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ref = list(jax_)
    for g, r in zip(got, ref):
        gi = g["image"].numpy() * 0.229 * 255     # levels, per the red std
        ri = np.asarray(r["image"]) * 0.229 * 255
        assert np.abs(gi - ri).max() <= 1.0 + 1e-3
        assert (np.abs(gi - ri) > 0.5).mean() < 0.01
        for k in ("target", "target_weight", "row_valid"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       atol=1e-6, err_msg=k)


def test_partial_epoch_covers_each_record_once_with_fixed_lanes(trees):
    cfg, _ = _cfg(trees, "MADS_3d")
    ld = loader.Stereo3DLoader(cfg, "train", device_cache_bytes=10 * FRAME,
                               device="cpu")
    everyone = sorted(r["image_left"] for r in ld.records)
    for _ in range(2):
        rows = sum(float(b["row_valid"].sum()) for b in ld)
        log = ld.batch_log
        assert len({(b["rows"], b["uploaded"]) for b in log}) == 1
        assert log[0]["uploaded"] > 0 and log[0]["rows"] > 0
        assert sorted(p for b in log for p in b["valid"]) == everyone
        assert rows == PAIRS
    with pytest.raises(RuntimeError, match="FULL device cache"):
        ld.stacked_epoch()


def test_ram_cache_gives_the_same_batches(trees):
    cfg, _ = _cfg(trees, "MADS_3d", OCCLUSION="CUTOUT")
    plain = loader.Stereo3DLoader(cfg, "train", device="cpu")
    cached = loader.Stereo3DLoader(cfg, "train", cache_bytes=1 << 30,
                                   device="cpu")
    for _ in range(2):
        for a, b in zip(plain, cached):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
    assert cached._cache_used == 2 * PAIRS * FRAME


def test_occlusion_draws_follow_the_epoch_seed(trees):
    """Batch b of epoch e draws from step_generator(seed * 10007 + e, b):
    two loaders of one seed give the same Cutout masks, another seed
    others."""
    cfg, _ = _cfg(trees, "MADS_3d", OCCLUSION="CUTOUT")
    masks = []
    for seed in (4, 4, 5):
        ld = loader.Stereo3DLoader(cfg, "train", seed=seed,
                                   return_masks=True,
                                   device_cache_bytes=1 << 30, device="cpu")
        masks.append(torch.stack([b["keep_mask"] for b in ld]))
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    assert not masks[0].all()


def test_load_data_dispatch(trees):
    cfg, _ = _cfg(trees, "MADS_3d", CACHE_BYTES=123, DEVICE_CACHE_BYTES=456)
    train, valid = loader.load_data(cfg, seed=7, device="cpu")
    assert isinstance(train, loader.Stereo3DLoader)
    assert (train.image_set, valid.image_set) == ("train", "valid")
    assert (train.seed, valid.seed) == (7, 8)
    assert train.train and not valid.train
    assert (train._cache_budget, train._device_cache_budget) == (123, 456)
    for dataset in ("MADS_2d", "MPII"):
        cfg, _ = _cfg(trees, dataset)
        train, valid = loader.load_data(cfg, device="cpu")
        assert isinstance(train, loader.Mono2DLoader)
        assert train.dataset_type == dataset
    cfg.DATASET.TYPE = "COCO"
    with pytest.raises(NotImplementedError, match="COCO"):
        loader.load_data(cfg, device="cpu")


def test_loaders_refuse_cuda_without_a_card(trees):
    """Without device="cpu" every loader and stream asks for CUDA and
    raises here; nothing runs on the CPU unasked."""
    from fast3dhpe_tpu_torch.data import LoadMADSData
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    cfg, _ = _cfg(trees, "MADS_3d")
    for make in (lambda: loader.Stereo3DLoader(cfg, "train"),
                 lambda: loader.Mono2DLoader(_cfg(trees, "MADS_2d")[0],
                                             "train"),
                 lambda: loader.load_data(cfg),
                 lambda: LoadMADSData(str(trees / "mads" / "valid"),
                                      (IMG, IMG))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_loader_fed_cdr_epoch_matches_jax(trees):
    """One warmup epoch of make_train_epoch_cdr from the port's loader
    (stacked_epoch) against JAX's scan epoch from JAX's loader, on the
    same weights, at LR: 2 steps of 8 pairs (the last 2 padded), as
    test_torch_train_epoch.py takes 2; summed losses within 1e-4
    relative, grad_norm within 1e-2, parameters within 2.5 lr, BN
    statistics within BN_TOL of each buffer's range, CF.out_layer's
    running variances within CF_VAR_TOL."""
    cfg, jcfg = _cfg(trees, "MADS_3d", train_batch=8)
    port, jax_ = _loaders(cfg, jcfg, "Stereo3DLoader", "train",
                          device_cache_bytes=1 << 30)
    cache, xs, e = port.stacked_epoch()
    jcache, jxs, _ = jax_.stacked_epoch()
    S = xs["idx_l"].shape[0]
    assert S == 2 and xs["row_valid"][-1].sum() == 6
    model = JaxCDRNet(num_layers=18)
    proj = jnp.asarray(np.stack([xs["P_l"][0, :1, :3], xs["P_r"][0, :1, :3]],
                                1))
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, IMG, IMG, 3)), proj,
        train=False))
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    jloss = jax_make_loss("JointsMSESmooth", True)
    tx = optax.adam(jax_multistep_lr(LR, [1], 0.1, 1))
    jstate, ref = jsteps.make_train_epoch_cdr(model, jloss, (IMG, IMG))(
        JaxTrainState.create(v, tx), jcache.frames,
        {k: jnp.asarray(a) for k, a in jxs.items()}, jax.random.PRNGKey(0),
        False)
    ref = _np(ref)
    ref_state = jax_variables_to_state_dict(_np(jstate.variables))

    net = CDRNet(num_layers=18)
    init = jax_variables_to_state_dict(v)
    net.load_state_dict(init, strict=True)
    state = TrainState.create(net, cfg, steps_per_epoch=1)
    got = steps.make_train_epoch_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT), (IMG, IMG))(
        state, cache.frames, xs, 0, False)
    got = {k: float(t) for k, t in got.items()}
    for key in ("loss", "loss_2d"):
        assert got[key] == pytest.approx(float(ref[key]), rel=1e-4), key
    assert got["loss"] == got["loss_2d"]                    # warmup
    assert got["loss_3d"] == pytest.approx(float(ref["loss_3d"]), rel=5e-2)
    assert got["grad_norm"] == pytest.approx(float(ref["grad_norm"]),
                                             rel=1e-2)
    assert state.step == S
    for name, t in net.state_dict().items():
        r = ref_state[name]
        if "running" in name:
            tol = CF_VAR_TOL if name.startswith("CF.out_layer") and \
                name.endswith("running_var") else BN_TOL
            assert float((t - r).abs().max()) <= tol * float(
                r.abs().max()), name
        elif "num_batches" not in name:
            assert float((t - r).abs().max()) <= 2.5 * LR, name
            assert not torch.equal(t, init[name]), name
