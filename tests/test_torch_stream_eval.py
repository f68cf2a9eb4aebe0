"""The PyTorch port's movement stream (fast3dhpe_tpu_torch/data/stream.py
LoadMADSData) and movement evaluation (apps/eval_loop.py,
CDRNetInferencer.evaluate_movement) against the JAX package's, on the CPU
device, on a small synthetic JPEG tree, depth 18 at 64 px, fp32.

Tolerances: metadata, projections, affines, indices and raw frames are
bit-equal to JAX's; host crops (the port's affine_warp truncated to uint8,
as the JAX stream crops without cv2) within one level; evaluate_movement's
MPJPE2D and MPJPE3D within 1e-4 relative of JAX's, with the movement whole
on the device, partly on it, and streamed."""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.apps.inference import CDRNetInferencer as JaxInferencer
from fast3dhpe_tpu.config import config_from_dict as jax_config_from_dict
from fast3dhpe_tpu.data.stream import LoadMADSData as JaxStream
from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu_torch.apps import eval_loop
from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.data import LoadMADSData

torch.set_num_threads(2)

IMG, B, FRAMES = 64, 4, 7
FRAME = 96 * 128 * 3
CFG = {"MODEL": {"NAME": "t", "NUM_LAYERS": 18, "IMAGE_SIZE": [IMG, IMG],
                 "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}}}
# (device cache budget, batch kinds): the 14 frames whole on the device
# (the stream pads the cache to 64 rows), 6 of them (3 pairs: one index
# batch, then the 4 other pairs streamed), none
MODES = {"full": (64 * FRAME, ["frames", "frames"]),
         "partial": (6 * FRAME, ["frames", "img_l"]),
         "streamed": (0, ["img_l", "img_l"])}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mads")
    make_synthetic_mads(str(root), n_frames=FRAMES, img_w=128, img_h=96,
                        splits=("valid",), nan_joint_every=3)
    return str(root / "valid")


def _streams(data):
    return (LoadMADSData(data, (IMG, IMG), "HipHop", device="cpu"),
            JaxStream(data, (IMG, IMG), "HipHop"))


def _arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_metadata_and_projections_match_jax(data):
    port, ref = _streams(data)
    assert len(port) == len(ref) == FRAMES
    assert json.dumps(port.metadata) == json.dumps(ref.metadata)
    assert any(np.isnan(np.array(m["pose_3d"], float)).any()
               for m in port.metadata)
    transes = [np.array([[0.5, 0.01, 3.0], [-0.02, 0.5, 4.0]])] * FRAMES
    got = port._batch_proj(port.metadata, transes)
    np.testing.assert_array_equal(got,
                                  ref._batch_proj(ref.metadata, transes))
    assert got.dtype == np.float32 and got.shape == (FRAMES, 2, 3, 4)


def test_frame_iterator_matches_jax_without_cv2(data, monkeypatch):
    port, ref = _streams(data)
    got = list(port)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for (gl, gr, gm), (rl, rr, rm) in zip(got, list(ref)):
        for g, r in ((gl, rl), (gr, rr)):
            assert g.shape == r.shape == (IMG, IMG, 3)
            assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
        for cam in ("cam_left", "cam_right"):
            np.testing.assert_array_equal(gm[cam]["intrinsics"],
                                          rm[cam]["intrinsics"])


def _batches_equal(got, ref, crop):
    assert len(got) == len(ref) == -(-FRAMES // B)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            a, b = _arr(g[k]), _arr(r[k])
            if crop and k in ("img_l", "img_r"):
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("device_warp", [True, False])
def test_streamed_batches_match_jax(data, device_warp, monkeypatch):
    port, ref = _streams(data)
    got = list(port.batches(B, device_warp=device_warp))
    assert all(b["img_l"].device.type == "cpu" for b in got)
    monkeypatch.setitem(sys.modules, "cv2", None)
    _batches_equal(got, list(ref.batches(B, device_warp=device_warp)),
                   crop=not device_warp)
    assert ("trans" in got[0]) == device_warp
    assert [b["n_valid"] for b in got] == [4, 3]


def test_cached_batches_match_jax(data):
    port, ref = _streams(data)
    cache = port.build_device_cache(64 * FRAME)
    jcache = ref.build_device_cache(64 * FRAME)
    assert not cache.partial and cache.frames.shape[0] == 64
    np.testing.assert_array_equal(cache.frames.numpy(),
                                  np.asarray(jcache.frames))
    _batches_equal(list(port.cached_batches(B, cache)),
                   list(ref.cached_batches(B, jcache)), crop=False)


@pytest.mark.parametrize("mode", list(MODES))
def test_batches_by_cache_budget(data, mode):
    """The kinds of batch a budget gives: index batches, then the rest
    streamed under a partial cache, as JAX's stream gives them."""
    budget, kinds = MODES[mode]
    port, ref = _streams(data)
    got = list(port.batches(B, device_warp=True, device_cache_bytes=budget))
    want = list(ref.batches(B, device_warp=True, device_cache_bytes=budget))
    assert [("frames" if "frames" in b else "img_l") for b in got] == kinds
    assert [b["n_valid"] for b in got] == [b["n_valid"] for b in want]
    for g, r in zip(got, want):
        for k in ("proj", "pose_3d", "trans"):
            np.testing.assert_array_equal(_arr(g[k]), _arr(r[k]), err_msg=k)


@pytest.fixture(scope="module")
def inferencers():
    model = JaxCDRNet(num_layers=18)
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(2), jnp.zeros((1, 2, IMG, IMG, 3)),
        jnp.tile(jnp.eye(3, 4)[None, None], (1, 2, 1, 1)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    # the N(0, 0.001) head decodes every view to the centre: scale it so
    # that the views decode apart (tests/test_torch_train_epoch.py)
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 300.0
    return (CDRNetInferencer(config_from_dict(CFG), device="cpu",
                             state_dict=jax_variables_to_state_dict(v)),
            JaxInferencer(jax_config_from_dict(CFG), variables=v))


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_movement_matches_jax(data, inferencers, mode):
    inf, jinf = inferencers
    budget = MODES[mode][0]
    port, ref = _streams(data)
    got = inf.evaluate_movement(port, B, device_cache_bytes=budget)
    want = jinf.evaluate_movement(ref, B, device_cache_bytes=budget)
    assert got == pytest.approx(want, rel=1e-4)
    assert got[0] > 1.0 and np.isfinite(got[1])


def test_evaluate_stream_is_one_masked_sum(data, inferencers):
    """The streamed loop against a per-frame mean computed batch by batch
    on the host: padded rows never count."""
    inf, _ = inferencers
    stream = LoadMADSData(data, (IMG, IMG), "HipHop", device="cpu")
    e2s, e3s = [], []
    for b in stream.batches(B, device_warp=True):
        pose, vis = eval_loop.ground_truth(b["pose_3d"])
        e2, e3 = inf.predict_eval(b["img_l"], b["img_r"], b["trans"],
                                  b["proj"], pose, vis)
        e2s += e2[:b["n_valid"]].tolist()
        e3s += e3[:b["n_valid"]].tolist()
    got = eval_loop.evaluate_stream(inf.predict_eval, None, stream, B)
    assert len(e2s) == FRAMES
    assert got == pytest.approx((np.mean(e2s), np.mean(e3s)), rel=1e-6)


def test_evaluate_movement_refuses_a_stream_elsewhere(data, inferencers):
    inf, _ = inferencers
    stream = LoadMADSData(data, (IMG, IMG), "HipHop", device="cpu")
    stream.device = torch.device("meta")
    with pytest.raises(ValueError, match="stream is on meta"):
        inf.evaluate_movement(stream, B)
