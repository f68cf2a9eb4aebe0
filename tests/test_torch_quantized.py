"""The port's int8 PTQ path (fast3dhpe_tpu_torch/models/quantized.py and
CDRNetInferencer(int8=True)) against the JAX package's
(fast3dhpe_tpu/models/quantized.py) on the CPU: depth 18, PoseResNet at 5
joints, 64 px, 2 pairs, random weights from a seed.

Tolerances:
- the BN-folded fp32 forward within 1e-4 of JAX's largest heatmap value
  (the fold reassociates; measured 4.7e-7);
- packs quantized from the same weights: int8 codes and the trunk's
  variables equal; per-channel scales and folded biases within 1e-6
  relative (XLA's fold rounds g = scale / sqrt(var + eps) 1 ulp apart on a
  few channels); activation scales within 1e-5 relative for PoseResNet
  (fp32 forwards, measured 7.7e-7) and 2e-3 for CDRNet, whose bf16 trunk
  rounds apart in the two frameworks (measured 2.8e-4);
- on JAX's own saved pack: the input's and the encoder's int8 codes
  bit-equal (int32 accumulators are exact; the epilogue and the division
  are the same fp32 operations); cf_out's, which follow the bf16 trunk,
  flip by one code in at most CF_FLIPS of them (measured 1 of 2,048: the
  two frameworks round a bf16 convolution apart); the decoder on JAX's
  cf_out codes bit-equal; end to end, that one flip moves the decoder's
  codes by at most 2 (2.6% of deconv3's), the heatmaps by 1.7% of their
  largest value (bound 0.05, the bf16 bound of
  tests/test_pallas_kernels.py:116-119), pred_2d by 8e-4 px (bound 1e-2)
  and pred_3d by 1.5e-3 of its largest coordinate (bound 1e-2);
- the int8 PoseResNet against its fp32 forward: correlation > 0.99 and
  max error < 0.12 of the max, as tests/test_quantized.py;
- the int8 inferencer's MPJPE2D within 1e-3 relative of the JAX int8
  inferencer's on the same movement (both calibrate on the same frames;
  measured 2e-6); its MPJPE3D within a factor 2 (measured 11%): the
  untrained model on the synthetic tree's parallel rig triangulates at the
  1e-9 floor of w (~1e8 mm), where the bf16 trunk's few flipped codes
  move a point by that much.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.apps.inference import CDRNetInferencer as JaxInferencer
from fast3dhpe_tpu.config import config_from_dict as jax_config_from_dict
from fast3dhpe_tpu.data.stream import LoadMADSData as JaxStream
from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
from fast3dhpe_tpu.models import quantized as jqz
from fast3dhpe_tpu.models.cdrnet import CDRNet as JaxCDRNet
from fast3dhpe_tpu.models.poseresnet import PoseResNet as JaxPoseResNet
from fast3dhpe_tpu.ops import quant as JQ
from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.data import LoadMADSData
from fast3dhpe_tpu_torch.models import quantized as qz
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.ops import quant as Q

torch.set_num_threads(2)

IMG, B = 64, 2
CF_FLIPS = 1e-3               # of cf_out's int8 codes, by one code each


def _rig(batch):
    """Two cameras 3 m from the origin at x = -+400 mm, turned toward it,
    bench.py's intrinsics at 64 px."""
    f, c = 1100.0 * IMG / 256, IMG / 2
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


def _randomize_batch_stats(v, seed=7):
    """Non-trivial running statistics, so the fold is exercised."""
    r = np.random.RandomState(seed)

    def mutate(path, leaf):
        name = path[-1].key
        if name == "mean":
            return (r.randn(*leaf.shape) * 0.3).astype(np.float32)
        if name == "var":
            return (0.25 + r.rand(*leaf.shape)).astype(np.float32)
        return leaf

    return {**v, "batch_stats": jax.tree_util.tree_map_with_path(
        mutate, v["batch_stats"])}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(pack):
    """A JAX pack's arrays as the port's CPU tensors."""
    return {k: (v if k == "depth" else jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), v)) for k, v in pack.items()}


@pytest.fixture(scope="module")
def pose():
    r = np.random.RandomState(0)
    x = r.randn(B, IMG, IMG, 3).astype(np.float32)
    model = JaxPoseResNet(num_joints=5, num_layers=18, dtype=jnp.float32)
    v = _np(_randomize_batch_stats(_np(jax.jit(
        model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))))
    return x, v, jax_variables_to_state_dict(v)


@pytest.fixture(scope="module")
def cdr(tmp_path_factory):
    """Init-default BN statistics, as tests/test_quantized.py (random
    statistics make the random-init heatmaps flat); JAX's pack, saved."""
    r = np.random.RandomState(0)
    imgs = r.randn(B, 2, IMG, IMG, 3).astype(np.float32)
    projs = _rig(B)
    model = JaxCDRNet(num_joints=5, num_layers=18, dtype=jnp.float32)
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(projs),
        train=False))
    jpack = _np(jqz.quantize_cdrnet(v, [(jnp.asarray(imgs),
                                         jnp.asarray(projs))]))
    path = str(tmp_path_factory.mktemp("packs") / "jax_pack.npz")
    jqz.save_pack(path, jpack)
    return {"imgs": imgs, "projs": projs, "v": v,
            "sd": jax_variables_to_state_dict(v), "jpack": jpack,
            "jpath": path}


def test_folded_fp_matches_jax(pose):
    x, v, sd = pose
    ref = np.asarray(jqz.poseresnet_fp_folded_apply(v, jnp.asarray(x)))
    got = qz.poseresnet_fp_folded_apply(sd, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (B, 16, 16, 5)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def _assert_pack_equal(pp, jp, scale_rtol):
    assert pp["depth"] == jp["depth"] == 18
    assert set(pp["layers"]) == set(jp["layers"])
    for name, jl in jp["layers"].items():
        pl = pp["layers"][name]
        assert pl["w"].dtype == torch.int8
        np.testing.assert_array_equal(pl["w"].numpy(), np.asarray(jl["w"]))
        for k in ("sw", "b"):
            np.testing.assert_allclose(pl[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-6, atol=1e-7)
    assert set(pp["scales"]) == set(jp["scales"])
    for k, s in jp["scales"].items():
        assert float(pp["scales"][k]) == pytest.approx(float(s),
                                                       rel=scale_rtol)


def test_pack_from_same_weights_equals_jax(pose, cdr):
    x, v, sd = pose
    _assert_pack_equal(qz.quantize_poseresnet(sd, [torch.from_numpy(x)]),
                       _np(jqz.quantize_poseresnet(v, [jnp.asarray(x)])),
                       1e-5)
    pp = qz.quantize_cdrnet(cdr["sd"], [(torch.from_numpy(cdr["imgs"]),
                                         torch.from_numpy(cdr["projs"]))])
    _assert_pack_equal(pp, cdr["jpack"], 2e-3)
    for coll in ("params", "batch_stats"):
        assert set(pp["cf"][coll]) == set(cdr["jpack"]["cf"][coll])
        for site, leaves in cdr["jpack"]["cf"][coll].items():
            for k, a in leaves.items():
                np.testing.assert_array_equal(pp["cf"][coll][site][k].numpy(),
                                              a)


def _recorded_requants(monkeypatch, module, fn):
    """fn() with every requant of `module` recorded, in call order."""
    seen, orig = [], module.requant

    def requant(y, s):
        out = orig(y, s)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "requant", requant)
    out = fn()
    monkeypatch.setattr(module, "requant", orig)
    return out, seen


def test_int8_on_jax_pack_matches_jax(cdr, monkeypatch):
    imgs, projs = cdr["imgs"], cdr["projs"]
    (jkp, jp3, jhm), jcodes = _recorded_requants(
        monkeypatch, JQ, lambda: jqz.cdrnet_int8_apply(
            cdr["jpack"], jnp.asarray(imgs), jnp.asarray(projs), depth=18,
            return_heatmaps=True))
    model = qz.cdrnet_int8(qz.load_pack(cdr["jpath"]), device="cpu")
    with torch.inference_mode():
        (kp, p3, hm), codes = _recorded_requants(
            monkeypatch, Q, lambda: model(torch.from_numpy(imgs),
                                          torch.from_numpy(projs),
                                          return_heatmaps=True))
    # requant points: input, the encoder's, cf_out, three deconvs
    assert len(codes) == len(jcodes) == 22
    cf = len(codes) - 4
    for a, b in zip(codes[:cf], jcodes[:cf]):
        np.testing.assert_array_equal(a, b)
    flips = codes[cf] != jcodes[cf]
    assert flips.sum() <= CF_FLIPS * flips.size, flips.sum()
    assert np.abs(codes[cf].astype(int) - jcodes[cf]).max() <= 1
    # the decoder on JAX's cf_out codes: exact
    rt = model.rt
    with torch.inference_mode():
        h = qz._decoder_walk(qz._Int8Ctx(rt), (
            torch.from_numpy(jcodes[cf].copy()), rt.scale("cf_out")))
    jhm = np.asarray(jhm)
    np.testing.assert_array_equal(h.numpy().reshape(jhm.shape), jhm)
    assert hm.shape == jhm.shape == (B, 2, 16, 16, 5)
    assert np.abs(hm.numpy() - jhm).max() <= 0.05 * np.abs(jhm).max()
    assert np.abs(kp.numpy() - np.asarray(jkp)).max() < 1e-2
    jp3 = np.asarray(jp3)
    assert np.abs(p3.numpy() - jp3).max() <= 1e-2 * np.abs(jp3).max()


def test_npz_packs_read_both_ways(cdr, tmp_path):
    """JAX's .npz loads in the port with every key, shape and dtype; the
    port's loads in JAX and serves the same heatmaps as in the port."""
    loaded = qz.load_pack(cdr["jpath"])
    _assert_pack_equal(loaded, cdr["jpack"], 0.0)
    pp = qz.quantize_cdrnet(cdr["sd"], [(torch.from_numpy(cdr["imgs"]),
                                         torch.from_numpy(cdr["projs"]))])
    path = str(tmp_path / "port_pack.npz")
    qz.save_pack(path, pp)
    with np.load(path) as a, np.load(cdr["jpath"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    jl = jqz.load_pack(path)
    _, _, jhm = jqz.cdrnet_int8_apply(
        jl, jnp.asarray(cdr["imgs"]), jnp.asarray(cdr["projs"]), depth=18,
        return_heatmaps=True)
    with torch.inference_mode():
        _, _, hm = qz.cdrnet_int8(pp, device="cpu")(
            torch.from_numpy(cdr["imgs"]), torch.from_numpy(cdr["projs"]),
            return_heatmaps=True)
    jhm = np.asarray(jhm)
    assert np.abs(hm.numpy() - jhm).max() <= 1e-6 * np.abs(jhm).max()


def test_poseresnet_int8_close_to_fp(pose):
    x, v, sd = pose
    model = PoseResNet(num_joints=5, num_layers=18)
    model.load_state_dict(sd)
    with torch.inference_mode():
        ref = model.eval()(torch.from_numpy(x)).numpy()
        rt = qz.Int8Pack(qz.quantize_poseresnet(sd, [torch.from_numpy(x)]))
        out = qz.poseresnet_int8_apply(rt, torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32
    assert np.corrcoef(ref.ravel(), out.ravel())[0, 1] > 0.99
    assert np.abs(out - ref).max() < 0.12 * np.abs(ref).max()
    # the JAX package's int8 forward on the same pack: equal
    jpack = jqz.quantize_poseresnet(v, [jnp.asarray(x)])
    jout = np.asarray(jqz.poseresnet_int8_apply(jpack, jnp.asarray(x), 18))
    got = qz.poseresnet_int8_apply(qz.Int8Pack(_to_torch(_np(jpack))),
                                   torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, jout)


def test_calibration_batches_merge():
    """Scales from two batches dominate each single batch's."""
    r = np.random.RandomState(1)
    model = PoseResNet(num_joints=3, num_layers=18)
    sd = model.state_dict()
    x1 = torch.from_numpy(r.randn(1, IMG, IMG, 3).astype(np.float32))
    x2 = x1 * 3
    p1 = qz.quantize_poseresnet(sd, [x1])
    p12 = qz.quantize_poseresnet(sd, [x1, x2])
    assert all(float(p12["scales"][k]) >= float(p1["scales"][k])
               for k in p1["scales"])
    p12p = qz.quantize_poseresnet(sd, [x1, x2], percentile=99.0)
    assert all(float(p12p["scales"][k]) <= float(p12["scales"][k])
               for k in p12["scales"])


def test_inferencer_int8_matches_jax(cdr, tmp_path):
    """CDRNetInferencer(int8=True) calibrated on one batch of a synthetic
    movement, beside JAX's on the same weights and movement; its pack
    written to int8_pack loads without the fp checkpoint and serves the
    same MPJPEs; no stream and no pack raises."""
    root = str(tmp_path / "mads")
    make_synthetic_mads(root, n_frames=8, img_w=128, img_h=96,
                        splits=("valid",), movements=("HipHop",))
    model = JaxCDRNet(num_joints=19, num_layers=18, dtype=jnp.float32)
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(1), jnp.asarray(cdr["imgs"]),
        jnp.asarray(cdr["projs"]), train=False))
    sd = jax_variables_to_state_dict(v)
    d = {"MODEL": {"NAME": "t", "NUM_JOINTS": 19, "NUM_LAYERS": 18,
                   "IMAGE_SIZE": [IMG, IMG],
                   "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}}}
    cfg, jcfg = config_from_dict(d), jax_config_from_dict(d)
    valid = os.path.join(root, "valid")
    jstream = JaxStream(valid, (IMG, IMG), "HipHop")
    jinf = JaxInferencer(jcfg, variables=v, int8=True,
                         calib_stream=jstream, calib_batches=1)
    ref = jinf.evaluate_movement(jstream, batch_size=4)
    stream = LoadMADSData(valid, (IMG, IMG), "HipHop", device="cpu")
    pack_path = str(tmp_path / "pack.npz")
    inf = CDRNetInferencer(cfg, state_dict=sd, device="cpu",
                           int8=True, calib_stream=stream, calib_batches=1,
                           int8_pack=pack_path)
    got = inf.evaluate_movement(stream, batch_size=4)
    assert np.isfinite(got).all()
    assert got[0] == pytest.approx(ref[0], rel=1e-3)
    assert 0.5 < got[1] / ref[1] < 2.0
    again = CDRNetInferencer(cfg, weights_root=str(tmp_path / "none"),
                             device="cpu", int8=True, int8_pack=pack_path)
    np.testing.assert_allclose(again.evaluate_movement(stream, 4), got,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="calib_stream"):
        CDRNetInferencer(cfg, state_dict=sd, device="cpu", int8=True)
