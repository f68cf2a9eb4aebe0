"""The plain reference against fast3dhpe_tpu_torch on the CPU, at a small
depth and size: the input pipeline, the forwards, the losses and Adam.
And the reference's independence: it imports nothing of the port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import scene
from benchmark.harness.weights import seeded_state_dict
from benchmark.reference import model as ref
from benchmark.reference import pipeline, train
from benchmark.reference.geometry import dlt_triangulate

torch.set_num_threads(2)
SIZE, H0, W0 = 64, 96, 128


def _frames(n=8):
    return scene.frames("cpu", n, H0, W0, 5)


def _stereo_xs(rng, B):
    P = np.broadcast_to(scene.converging_rig(W0, H0), (B, 2, 4, 4))
    x = {"idx_l": np.arange(0, 2 * B, 2), "idx_r": np.arange(1, 2 * B, 2),
         "trans": scene.train_affines(rng, B, W0, H0, SIZE, 0.25, 30),
         "P_l": P[:, 0].copy(), "P_r": P[:, 1].copy(),
         "pose_3d": scene.poses(rng, B, 19, 250.0),
         "joints_vis": (rng.random((B, 19)) < 0.9).astype(np.float32)}
    return {k: torch.as_tensor(v) for k, v in x.items()}


def test_stereo_pipeline_matches_the_port():
    from fast3dhpe_tpu_torch.data.device_pipeline import \
        preprocess_stereo_batch_cached
    from fast3dhpe_tpu_torch.train.steps import step_generator
    frames, x = _frames(16), _stereo_xs(np.random.default_rng(1), 8)
    seed = 77
    got = preprocess_stereo_batch_cached(
        step_generator("cpu", seed, 0), frames, x["idx_l"], x["idx_r"],
        x["trans"], x["P_l"], x["P_r"], x["pose_3d"], x["joints_vis"],
        image_size=(SIZE, SIZE), occlusion="CUTOUT", train=True)
    want = pipeline.stereo_batch(frames, x, SIZE,
                                 pipeline.step_seed(seed, 0))
    img = got["image"].permute(0, 1, 4, 2, 3)
    assert (img - want["images"]).abs().max() < 1e-5
    assert torch.equal(got["proj"], want["proj"])
    assert torch.allclose(got["target_2d"], want["target_2d"])
    assert torch.equal(got["target_weight"], want["target_weight"])
    # the draws did occlude: gray pixels where a hole was cut
    gray = torch.tensor((128 / 255 - 0.456) / 0.224)
    assert torch.isclose(img[:, :, 1], gray).any()


def test_mono_pipeline_matches_the_port():
    from fast3dhpe_tpu_torch.data.device_pipeline import \
        preprocess_mono_batch_cached
    rng = np.random.default_rng(2)
    B = 4
    x = {"idx": torch.arange(B), "flip": torch.tensor([1, 0, 1, 0]).bool(),
         "trans": torch.as_tensor(scene.train_affines(rng, B, W0, H0, SIZE,
                                                      0.25, 30)),
         "joints": torch.as_tensor(rng.uniform(-10, SIZE + 10, (B, 19, 2)),
                                   dtype=torch.float32),
         "vis": torch.ones(B, 19)}
    frames = _frames()
    got = preprocess_mono_batch_cached(
        frames, x["idx"], x["flip"], x["trans"], x["joints"], x["vis"],
        image_size=(SIZE, SIZE), heatmap_size=(16, 16), sigma=3)
    want = pipeline.mono_batch(frames, x, SIZE, 16, 3)
    assert (got["image"].permute(0, 3, 1, 2) - want["images"]).abs().max() \
        < 1e-5
    assert (got["target"].permute(0, 3, 1, 2) - want["target"]).abs().max() \
        < 1e-6
    assert torch.equal(got["target_weight"], want["target_weight"])


def _seeded(model):
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = seeded_state_dict(shapes, "cpu", 3)
    sd["decoder.final_layer.weight"].mul_(300.0)
    model.load_state_dict(sd)
    return sd


def test_cdrnet_eval_forward_matches_the_port():
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    m = CDRNet(num_layers=50).eval()
    sd = _seeded(m)
    x = _stereo_xs(np.random.default_rng(3), 2)
    batch = pipeline.stereo_batch(_frames(), x, SIZE, 1)
    with torch.no_grad():
        kp, p3 = m(batch["images"].permute(0, 1, 3, 4, 2), batch["proj"])
        rk, r3, _ = ref.cdrnet(ref.Ops(sd, sd), batch["images"],
                               batch["proj"], 50)
    # fp32 on both sides; a random network in eval mode (identity BN)
    # carries rounding a few thousandths of a pixel far
    assert (kp - rk).abs().max() < 1e-2
    # the geometry alone: the port's fp32 Jacobi DLT of its own keypoints
    g = dlt_triangulate(batch["proj"], kp)
    assert ((p3 - g).norm(dim=-1) / g.norm(dim=-1).clamp_min(1.0)).max() \
        < 1e-3


def test_poseresnet_train_forward_matches_the_port():
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    m = PoseResNet(num_layers=50).train()
    sd = _seeded(m)
    img = torch.randn(2, SIZE, SIZE, 3)
    hm = m(img).permute(0, 3, 1, 2)
    want = ref.poseresnet(ref.Ops(sd, dict(sd), train=True, update=False),
                          img.permute(0, 3, 1, 2).contiguous(), 50)
    # train-mode BN over 2 images at 2 x 2 in layer4 carries rounding to a
    # few 1e-4 of the logits' range
    assert (hm - want).abs().max() < 1e-3 * want.abs().max()


def test_losses_match_the_port():
    from fast3dhpe_tpu_torch.models.losses import make_loss
    g = torch.Generator().manual_seed(0)
    B, J = 4, 19
    w = (torch.rand(B, J, generator=g) > 0.2).float()
    p2, t2 = (torch.rand(B, 2, J, 2, generator=g) * 256 for _ in range(2))
    p3, t3 = (torch.randn(B, J, 3, generator=g) * 300 for _ in range(2))
    smooth = make_loss("JointsMSESmooth", True)
    rel = [torch.where((torch.arange(J) != 1)[None, :, None],
                       a - a[:, 1:2], a) for a in (p3, t3)]
    port = (smooth(p2[:, 0], t2[:, 0], w) + smooth(p2[:, 1], t2[:, 1], w)
            + 4.0 * smooth(rel[0] * 0.1, rel[1] * 0.1, w))
    batch = {"target_2d": t2, "target_3d": t3, "target_weight": w}
    assert torch.allclose(train.cdr_loss(p2, p3, batch), port, rtol=1e-6)
    hm_p, hm_t = torch.rand(B, J, 16, 16), torch.rand(B, J, 16, 16)
    mse = make_loss("JointsMSE", True, layout="NHWC")
    assert torch.allclose(
        train.heatmap_mse(hm_p, hm_t, w),
        mse(hm_p.permute(0, 2, 3, 1), hm_t.permute(0, 2, 3, 1), w),
        rtol=1e-6)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(50, generator=g)
    mine, theirs = p0.clone(), p0.clone().requires_grad_(True)
    adam = train.Adam([mine], 1e-3)
    opt = torch.optim.Adam([theirs], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        adam.step([grad])
        theirs.grad = grad.clone()
        opt.step()
    assert torch.allclose(mine, theirs.detach(), atol=1e-7)


@pytest.mark.parametrize("path", sorted(
    (Path(__file__).resolve().parents[1] / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"fast3dhpe_tpu_torch", "fast3dhpe_tpu", "jax",
                        "jaxlib", "flax", "benchmark"}, names
