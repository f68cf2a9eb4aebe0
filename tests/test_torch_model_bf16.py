"""The PyTorch port's CDRNet in its serving configuration, bf16 with
fused_inference=True, against the JAX package's on the same weights: depth
50 at 128 px, where both fuse layer1.0-2 (the JAX blocks through the Pallas
kernel in interpret mode, the port's through the kernel's plain version)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet

torch.set_num_threads(2)


def _projs(batch, img):
    f, c = 1100.0 * img / 256, img / 2
    K = np.array([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]])
    Ps = [K @ np.hstack([np.eye(3), np.array([[dx], [0.0], [3000.0]])])
          for dx in (-400.0, 400.0)]
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


def test_bf16_fused_forward_matches_jax():
    r = np.random.RandomState(0)
    imgs = r.randn(1, 2, 128, 128, 3).astype(np.float32)
    projs = _projs(1, 128)
    jmodel = JaxCDRNet(num_layers=50, dtype=jnp.bfloat16,
                       fused_inference=True)
    v = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(projs),
        train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    head = v["params"]["decoder"]["final_layer"]
    # at this depth and on this rig the random init gives logits of std ~10,
    # which makes the soft-argmax an argmax that a bf16 rounding can flip
    # between near-equal peaks; std ~1 keeps the decode smooth
    head["kernel"] = head["kernel"] * 0.1
    jkp, _, jhm = jax.jit(
        lambda v, x, p: jmodel.apply(v, x, p, train=False,
                                     return_heatmaps=True))(
        v, jnp.asarray(imgs), jnp.asarray(projs))
    jkp, jhm = np.asarray(jkp), np.asarray(jhm, np.float32)

    model = CDRNet(num_layers=50, dtype=torch.bfloat16, fused_inference=True)
    model.load_state_dict(jax_variables_to_state_dict(v), strict=True)
    model.eval()
    assert model.encoder.fused_blocks((128, 128), torch.bfloat16) == [
        "layer1.0", "layer1.1", "layer1.2"]
    with torch.inference_mode():
        kp, p3d, hm = model(torch.from_numpy(imgs), torch.from_numpy(projs),
                            return_heatmaps=True)
    assert hm.dtype == torch.bfloat16 and kp.dtype == torch.float32
    hm = hm.float().numpy()
    # bf16 bounds of tests/test_pallas_kernels.py:116-119
    denom = max(np.abs(jhm).max(), 1e-3)
    assert np.abs(hm - jhm).max() / denom < 0.05
    assert np.abs(hm - jhm).mean() / denom < 0.005
    # keypoints in 128 px images: a bf16 logit error moves the centre of
    # mass by a fraction of a heatmap pixel (x4 in image pixels)
    assert np.abs(kp.numpy() - jkp).max() < 1.0
    assert np.all(np.isfinite(p3d.numpy()))
