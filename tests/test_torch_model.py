"""The PyTorch port's CDRNet and inferencer (fast3dhpe_tpu_torch) against
the JAX package at depth 18, 64 px, fp32, on the same weights: JAX
variables cross over through fast3dhpe_tpu_torch/convert.py and load with
strict=True."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.apps.inference import CDRNetInferencer as JaxInferencer
from fast3dhpe_tpu.config import config_from_dict as jax_config_from_dict
from fast3dhpe_tpu.config import load_config as jax_load_config
from fast3dhpe_tpu.geometry.triangulation import dlt_triangulate as jax_dlt
from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu.train.checkpoint import flax_to_torch_state_dict
from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
from fast3dhpe_tpu_torch.config import config_from_dict, load_config
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.device import resolve_device
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet

torch.set_num_threads(2)

B, IMG = 2, 64
CFG = {"MODEL": {"NAME": "tiny_cdr", "NUM_JOINTS": 19, "NUM_LAYERS": 18,
                 "IMAGE_SIZE": [IMG, IMG],
                 "EXTRA": {"TARGET_TYPE": "gaussian", "SIGMA": 2,
                           "HEATMAP_SIZE": [16, 16]}}}


def _projs(batch, img):
    """bench.py's stereo rig with the intrinsics scaled to img pixels."""
    f, c = 1100.0 * img / 256, img / 2
    K = np.array([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]])
    Ps = [K @ np.hstack([np.eye(3), np.array([[dx], [0.0], [3000.0]])])
          for dx in (-400.0, 400.0)]
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_setup():
    r = np.random.RandomState(0)
    imgs = r.randn(B, 2, IMG, IMG, 3).astype(np.float32)
    projs = _projs(B, IMG)
    model = JaxCDRNet(num_layers=18)
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(projs),
        train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    # the N(0, 0.001) heatmap head decodes every view to the centre, where
    # triangulation is degenerate: scale it so the views decode apart
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    head["bias"] = head["bias"] + r.randn(19).astype(np.float32)
    return model, v, imgs, projs


def _port(v):
    model = CDRNet(num_layers=18)
    model.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    return model.eval()


def test_state_dict_matches_flax_to_torch(jax_setup):
    _, v, _, _ = jax_setup
    ours = jax_variables_to_state_dict(v)
    ref = flax_to_torch_state_dict(v)
    assert set(ours) == set(ref)
    for k, val in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), val, err_msg=k)
    # and it is the port's whole key space
    assert set(ours) == set(CDRNet(num_layers=18).state_dict())


def test_forward_fp32_matches_jax(jax_setup):
    model, v, imgs, projs = jax_setup
    jkp, _, jhm = model.apply(v, jnp.asarray(imgs), jnp.asarray(projs),
                              train=False, return_heatmaps=True)
    jkp, jhm = np.asarray(jkp), np.asarray(jhm)
    with torch.inference_mode():
        kp, p3d, hm = _port(v)(torch.from_numpy(imgs),
                               torch.from_numpy(projs), return_heatmaps=True)
    assert kp.shape == (B, 2, 19, 2) and p3d.shape == (B, 19, 3)
    assert hm.shape == jhm.shape == (B, 2, 16, 16, 19)
    assert np.abs(hm.numpy() - jhm).max() / np.abs(jhm).max() < 1e-4
    np.testing.assert_allclose(kp.numpy(), jkp, atol=1e-3)
    assert kp.numpy().std() > 1.0          # the views decode apart
    # pred_3d: the JAX DLT applied to the port's own pred_2d
    ref3 = np.asarray(jax_dlt(
        jnp.asarray(np.broadcast_to(projs[:, None], (B, 19, 2, 3, 4))),
        jnp.asarray(np.swapaxes(kp.numpy(), 1, 2))))
    assert np.abs(p3d.numpy() - ref3).max() / np.abs(ref3).max() < 1e-4


def test_inferencer_matches_jax_inferencer(jax_setup, tmp_path):
    """uint8 frames through normalisation and the model, weights read from
    a reference-format weights/<NAME>/best.pth."""
    _, v, _, projs = jax_setup
    r = np.random.RandomState(1)
    img_l = r.randint(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    img_r = r.randint(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    jinf = JaxInferencer(jax_config_from_dict(CFG), variables=v)
    jkp, _ = (np.asarray(t) for t in jinf.predict_batch(img_l, img_r, projs))
    os.makedirs(tmp_path / "tiny_cdr")
    torch.save(jax_variables_to_state_dict(v),
               tmp_path / "tiny_cdr" / "best.pth")
    inf = CDRNetInferencer(config_from_dict(CFG), weights_root=str(tmp_path),
                           device="cpu")
    kp, p3d = inf.predict_batch(img_l, img_r, projs)
    np.testing.assert_allclose(kp.numpy(), jkp, atol=1e-3)
    assert np.all(np.isfinite(p3d.numpy()))
    with pytest.raises(NotImplementedError):
        inf.predict_batch(img_l, img_r, projs,
                          trans=np.zeros((B, 2, 3), np.float32))
    with pytest.raises(NotImplementedError):
        inf.evaluate_movement(None)


def test_inferencer_errors(tmp_path):
    cfg = config_from_dict(CFG)
    with pytest.raises(FileNotFoundError):
        CDRNetInferencer(cfg, weights_root=str(tmp_path), device="cpu")
    os.makedirs(tmp_path / "tiny_cdr" / "best")           # an orbax dir
    with pytest.raises(NotImplementedError):
        CDRNetInferencer(cfg, weights_root=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError):
        CDRNetInferencer(cfg, state_dict={}, device="cpu", int8=True)


def test_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()                        # the default is the GPU
    with pytest.raises(RuntimeError):
        CDRNetInferencer(config_from_dict(CFG), state_dict={})
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_config_matches_jax_config():
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "mads_3d.yaml")
    ours, ref = load_config(path).MODEL, jax_load_config(path).MODEL
    assert (ours.NAME, ours.NUM_JOINTS, ours.NUM_LAYERS) == (
        ref.NAME, ref.NUM_JOINTS, ref.NUM_LAYERS)
    assert list(ours.IMAGE_SIZE) == list(ref.IMAGE_SIZE)
    assert list(ours.EXTRA.HEATMAP_SIZE) == list(ref.EXTRA.HEATMAP_SIZE)
    assert ours.EXTRA.DLT_METHOD == ref.EXTRA.DLT_METHOD == "jacobi"
    with pytest.raises(ValueError):
        config_from_dict({"MODEL": {"NUM_LAYERS": 20}})

