"""The volumetric model of the port (models/volumetric.py,
geometry/volume.py, the volumetric steps of train/steps.py) against the
plain reference benchmark/reference/volumetric.py, on the CPU, on seeded
random weights: ResNet-50 (the reference's smallest trunk) at 64 px, a
32^3 cuboid (the least that the V2V's five poolings allow) and 2 pairs.

The network is compared in eval mode, where BN reads its running
statistics: in train mode a 32^3 cuboid leaves the V2V's deepest blocks
one voxel, whose BN over 2 values has a gradient of rounding noise only
(at the cells' 64^3 and 10 pairs it takes 80 values). Train-mode 3D BN is
held to F.batch_norm on its own, and a train step of the epoch to the
plain step.

The steps under a mesh (world 2, gloo) are held to the same steps at
world 1 on the global batch, at ResNet-18: the two ranks are
subprocesses that run this file as a script (`python
tests/test_torch_volumetric.py <rank> <dir>`), meeting through a file://
store in the test's temporary directory.
"""

import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.drivers.train_vol import seeded_volume_leaves
from benchmark.harness import scene
from benchmark.harness.weights import seeded_state_dict
from benchmark.reference import volumetric as rv
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.geometry import volume
from fast3dhpe_tpu_torch.models.layers import BatchNorm3d
from fast3dhpe_tpu_torch.models.volumetric import VolumetricNet
from fast3dhpe_tpu_torch.train import steps
from fast3dhpe_tpu_torch.train.state import TrainState
from fast3dhpe_tpu_torch.train.steps import _vol_loss

torch.set_num_threads(2)
DEPTH, SIZE, VOL, SIDE, B = 50, 64, 32, 2500.0, 2


@pytest.fixture(scope="module")
def net():
    """The port's network and its seeded state dict."""
    m = VolumetricNet(num_layers=DEPTH, volume_size=VOL)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    sd = seeded_volume_leaves(seeded_state_dict(shapes, "cpu", 11), "cpu",
                              12)
    m.load_state_dict(sd)
    return m.eval(), sd


@pytest.fixture(scope="module")
def batch():
    g = torch.Generator().manual_seed(3)
    P = torch.as_tensor(scene.converging_rig(SIZE, SIZE))[:, :3]
    return {"image": torch.randn(B, 2, SIZE, SIZE, 3, generator=g),
            "proj": P[None].repeat(B, 1, 1, 1),
            "target_3d": torch.rand(B, 19, 3, generator=g) * 500 - 250,
            "target_weight": (torch.rand(B, 19, generator=g) < 0.9).float(),
            "theta": torch.rand(B, generator=g) * 2 * math.pi}


def _ref_forward(sd, batch, params=None):
    p = params if params is not None else sd
    ops = rv.Ops(p, sd, train=False)
    return rv.forward(ops, batch["image"].permute(0, 1, 4, 2, 3),
                      batch["proj"], batch["target_3d"][:, 1],
                      batch["theta"], DEPTH, VOL, SIDE)


def test_forward_joints_match_the_reference(net, batch):
    m, sd = net
    with torch.no_grad():
        got = m(batch["image"], batch["proj"], batch["target_3d"][:, 1],
                batch["theta"])
        want = _ref_forward(sd, batch)[0]
    assert got.shape == (B, 19, 3)
    # mm: E[h] = E[H d + h] - H E[d] cancels to ~1e-4 of a voxel (81 mm)
    assert (got - want).abs().max() < 2e-2


def test_loss_and_gradient_match_the_reference(net, batch):
    m, sd = net
    names = [k for k, _ in m.named_parameters()]
    loss, aux = _vol_loss(m, batch, batch["theta"], 0.1, 1, False)
    aux = {k: v.detach() for k, v in aux.items()}
    grads = torch.autograd.grad(loss, list(m.parameters()))
    params = {k: sd[k].clone().requires_grad_(True) for k in names}
    kp, p, coords = _ref_forward(sd, batch, {**sd, **params})
    w = batch["target_weight"]
    l1 = rv.mae(kp, batch["target_3d"], w)
    ce = rv.volumetric_ce(coords, p, batch["target_3d"], w)
    want = l1 + 0.01 * ce
    ref = torch.autograd.grad(want, [params[k] for k in names])
    l1, ce, want = float(l1), float(ce), float(want)
    assert abs(float(aux["loss_3d"]) - l1) < 1e-5 * l1
    assert abs(float(aux["loss_ce"]) - ce) < 1e-5 * ce
    assert abs(float(loss) - want) < 1e-5 * want
    norms = np.array([float(g.norm()) for g in ref])
    floor = np.maximum(norms, np.median(norms))
    gap = np.array([float((a - b).norm()) for a, b in zip(grads, ref)])
    # the output layer's bias shifts every voxel's logit of a joint alike,
    # which the softmax does not see: its gradient is rounding alone
    bias = names.index("volume_net.output_layer.bias")
    assert gap[bias] < 0.1 * np.median(norms)
    gap[bias] = 0.0
    assert (gap / floor).max() < 1e-3, names[int(np.argmax(gap / floor))]


def _bilinear(f, x, y):
    """f (C, h, w) at pixel (x, y), each tap outside 0."""
    C, h, w = f.shape
    x0, y0 = math.floor(x), math.floor(y)
    out = torch.zeros(C, dtype=torch.float64)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        if 0 <= xi < w and 0 <= yi < h:
            wt = (1 - abs(x - xi)) * (1 - abs(y - yi))
            out += wt * f[:, yi, xi].double()
    return out


def test_unprojection_against_a_voxel_by_voxel_sample():
    """Every voxel centre projected into both views and sampled
    bilinearly by hand, 0 behind a camera, the views merged by their
    softmax; a camera inside the cuboid leaves part of it behind."""
    g = torch.Generator().manual_seed(5)
    C, h, w, n, side = 3, 12, 12, 4, 2000.0
    feats = torch.randn(1, 2, C, h, w, generator=g)
    K = torch.tensor([[10.0, 0, 6], [0, 10.0, 6], [0, 0, 1]])
    Rt = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1)
    P = torch.stack([K @ Rt, K @ torch.cat([torch.eye(3), torch.tensor(
        [[0.0], [0.0], [3000.0]])], 1)])[None]
    root, theta = torch.zeros(1, 3), torch.tensor([0.4])
    coords = volume.coord_volume(root, theta, n, side)
    got = volume.unproject(feats, P, coords)[0]
    behind = 0
    for idx in np.ndindex(n, n, n):
        vals = []
        for v in range(2):
            uvw = P[0, v, :, :3].double() @ coords[0][idx].double() \
                + P[0, v, :, 3].double()
            if uvw[2] <= 0:
                behind += 1
                vals.append(torch.zeros(C, dtype=torch.float64))
                continue
            u, vv = float(uvw[0] / uvw[2]), float(uvw[1] / uvw[2])
            gx, gy = 2 * (u / h - 0.5), 2 * (vv / w - 0.5)
            vals.append(_bilinear(feats[0, v], (gx + 1) / 2 * (w - 1),
                                  (gy + 1) / 2 * (h - 1)))
        vals = torch.stack(vals)
        want = (vals * torch.softmax(vals, 0)).sum(0)
        assert torch.allclose(got[(slice(None),) + idx].double(), want,
                              atol=1e-5), idx
    assert 0 < behind < 2 * n ** 3


def test_two_view_soft_argmax_is_the_dense_expectation(monkeypatch):
    """soft_argmax_3d (two launches of the K1 entry on flat views) mapped
    to mm against sum(softmax * voxel centres) on random logits; its
    gradient against the dense sum's."""
    calls = []
    real = volume.soft_argmax_fused

    def spy(h):
        calls.append(tuple(h.shape))
        return real(h)
    monkeypatch.setattr(volume, "soft_argmax_fused", spy)
    g = torch.Generator().manual_seed(7)
    n, J = 16, 5
    logits = (3 * torch.randn(2, n, n, n, J, generator=g)) \
        .requires_grad_(True)
    root = torch.randn(2, 3, generator=g) * 100
    theta = torch.rand(2, generator=g) * 6
    got = volume.voxels_to_world(volume.soft_argmax_3d(logits), root, theta,
                                 n, SIDE)
    assert calls == [(2, n * n, n, J), (2, n, n * n, J)]
    p = torch.softmax(logits.reshape(2, -1, J), 1)
    coords = volume.coord_volume(root, theta, n, SIDE).reshape(2, -1, 3)
    want = torch.einsum("bsj,bsc->bjc", p, coords)
    # mm; voxels of 167 mm, E[h] cancelling to ~1e-5 of one
    assert (got - want).abs().max() < 1e-2
    r = torch.randn(2, J, 3, generator=g)
    ga, = torch.autograd.grad((got * r).sum(), logits)
    gb, = torch.autograd.grad((want * r).sum(), logits)
    assert (ga - gb).abs().max() < 1e-4 * gb.abs().max()


def test_nearest_voxel_is_the_argmin_of_the_distances():
    g = torch.Generator().manual_seed(9)
    n = 8
    root = torch.randn(3, 3, generator=g) * 100
    theta = torch.rand(3, generator=g) * 6
    pts = root[:, None] + torch.randn(3, 40, 3, generator=g) * 900
    coords = volume.coord_volume(root, theta, n, SIDE).reshape(3, -1, 3)
    want = torch.cdist(pts.double(), coords.double()).argmin(-1)
    got = volume.nearest_voxel(pts, root, theta, n, SIDE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_train_bn3d_matches_batch_norm(masked):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4, 6, 3, 4, 5, generator=g) * 2 + 1).requires_grad_()
    bn = BatchNorm3d(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0]) if masked else None
    y = bn.train()(x, mask)
    keep = slice(None) if mask is None else mask > 0
    xr = x.detach()[keep].clone().requires_grad_()
    w = bn.weight.detach().clone().requires_grad_()
    want = F.batch_norm(xr, None, None, w, bn.bias.detach(), True, 0.1,
                        1e-5)
    assert torch.allclose(y[keep], want, atol=1e-5)
    r = torch.randn(y.shape, generator=g)
    gx, gw = torch.autograd.grad((y[keep] * r[keep]).sum(), (x, bn.weight))
    rx, rw = torch.autograd.grad((want * r[keep]).sum(), (xr, w))
    assert torch.allclose(gx[keep], rx, atol=1e-4)
    assert torch.allclose(gw, rw, atol=1e-4)
    if masked:
        assert torch.equal(gx[1], torch.zeros_like(gx[1]))
    n = 3 if masked else 4
    mean = x.detach()[keep].mean((0, 2, 3, 4))
    var = x.detach()[keep].var((0, 2, 3, 4), unbiased=False)
    assert torch.allclose(bn.running_mean, 0.1 * mean, atol=1e-5)
    assert torch.allclose(bn.running_var, 0.9 + 0.1 * var, atol=1e-4)
    assert n


def test_param_groups_take_the_two_learning_rates(net):
    m, _ = net
    cfg = config_from_dict({"TRAIN": {"LR": 1e-4, "LR_STEP": [1],
                                      "LR_FACTOR": 0.1}})
    state = TrainState.create(m, cfg, steps_per_epoch=2)
    g0, g1 = state.optimizer.param_groups
    assert len(g0["params"]) + len(g1["params"]) == len(list(m.parameters()))
    assert all(p is q for p, q in zip(
        g1["params"][:2], m.process_features.parameters()))
    state.set_lr()
    assert (g0["lr"], g1["lr"]) == (1e-4, pytest.approx(1e-3))
    state.step = 2
    state.set_lr()
    assert (g0["lr"], g1["lr"]) == (pytest.approx(1e-5),
                                    pytest.approx(1e-4))
    sd = state.optimizer_state_dict()
    state.load_optimizer_state_dict(sd)
    assert state._lr == pytest.approx(1e-5)
    assert g1["lr"] == pytest.approx(1e-4)


def test_config_names_the_model():
    assert config_from_dict({}).MODEL.TYPE == "cdrnet"
    with pytest.raises(ValueError, match="MODEL.TYPE"):
        config_from_dict({"MODEL": {"TYPE": "voxels"}})


def test_the_reference_imports_nothing_of_the_port_or_jax():
    path = Path(rv.__file__)
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}, names


def _tiny_state(seed=0):
    from fast3dhpe_tpu_torch.models.layers import init_weights
    m = VolumetricNet(num_layers=18, volume_size=VOL)
    init_weights(m, torch.Generator().manual_seed(seed))
    cfg = config_from_dict({"TRAIN": {"LR": 1e-4}})
    return TrainState.create(m, cfg, steps_per_epoch=1)


def test_an_epoch_step_is_the_plain_step():
    """One step of make_train_epoch_vol (graphed; eager on the CPU) from
    the cache against make_train_step_vol on the same batch and the same
    generator: the occlusion's draws, then the cuboids' angles."""
    from fast3dhpe_tpu_torch.data.device_pipeline import \
        preprocess_stereo_batch_cached
    from fast3dhpe_tpu_torch.train.steps import (make_train_epoch_vol,
                                                 make_train_step_vol,
                                                 step_generator)
    rng = np.random.default_rng(2)
    H0, W0 = 96, 128
    frames = scene.frames("cpu", 4, H0, W0, 5)
    P = np.broadcast_to(scene.converging_rig(W0, H0), (B, 2, 4, 4))
    x = {"idx_l": np.array([0, 2]), "idx_r": np.array([1, 3]),
         "trans": scene.train_affines(rng, B, W0, H0, SIZE, 0.25, 30),
         "P_l": P[:, 0].copy(), "P_r": P[:, 1].copy(),
         "pose_3d": scene.poses(rng, B, 19, 250.0),
         "joints_vis": np.ones((B, 19), np.float32),
         "row_valid": np.ones(B, np.float32)}
    xs = {k: torch.as_tensor(v)[None] for k, v in x.items()}
    a, b = _tiny_state(), _tiny_state()
    epoch = make_train_epoch_vol((SIZE, SIZE), occlusion="CUTOUT")
    got = epoch(a, frames, xs, 41)
    gen = step_generator("cpu", 41, 0)
    batch = preprocess_stereo_batch_cached(
        gen, frames, *(xs[k][0] for k in ("idx_l", "idx_r", "trans", "P_l",
                                         "P_r", "pose_3d", "joints_vis")),
        image_size=(SIZE, SIZE), occlusion="CUTOUT", train=True)
    batch["row_valid"] = xs["row_valid"][0]
    want = make_train_step_vol()(b, batch, True, gen)
    for k in ("loss", "loss_3d", "loss_ce", "grad_norm"):
        assert torch.equal(got[k], want[k]), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert a.step == b.step == 1


@pytest.mark.parametrize("cache", [0, 1 << 30])
def test_train_cdr_trains_the_volumetric_model(tmp_path, cache):
    """apps/train_cdr.py with MODEL.TYPE volumetric, batch by batch and
    from the device cache (segments): finite losses and MPJPE, and
    checkpoints of the volumetric model's state dict."""
    import yaml

    from fast3dhpe_tpu_torch.apps import train_cdr
    from fast3dhpe_tpu_torch.data.synthetic import make_synthetic_mads
    make_synthetic_mads(str(tmp_path / "mads"), n_frames=4, img_w=128,
                        img_h=96, movements=("HipHop",))
    cfg = {"DATASET": {"TYPE": "MADS_3d", "ROOT": str(tmp_path / "mads"),
                       "OCCLUSION": "CUTOUT", "DEVICE_CACHE_BYTES": cache},
           "MODEL": {"NAME": "vol", "TYPE": "volumetric", "NUM_LAYERS": 18,
                     "IMAGE_SIZE": [SIZE, SIZE], "PRETRAINED": "",
                     "EXTRA": {"HEATMAP_SIZE": [16, 16],
                               "VOLUME_SIZE": VOL}},
           "TRAIN": {"BATCH_SIZE": 2, "EPOCH": 2, "WARMUP": 0, "LR": 1e-4,
                     "LR_STEP": []},
           "TEST": {"BATCH_SIZE": 2}}
    path = tmp_path / "vol.yaml"
    path.write_text(yaml.safe_dump(cfg))
    hist = train_cdr.main(["--config_path", str(path), "--device", "cpu",
                           "--weights_root", str(tmp_path / "w"),
                           "--overwrite"])
    assert len(hist["train_loss"]) == 2
    for k in ("train_loss", "val_loss", "val_mpjpe_3d", "val_mpjpe_2d"):
        assert all(np.isfinite(v) and v > 0 for v in hist[k]), k
    sd = torch.load(tmp_path / "w" / "vol" / "latest.pth",
                    map_location="cpu", weights_only=True)
    assert "volume_net.output_layer.weight" in sd
    assert "decoder.final_layer.weight" not in sd


# ------------------------------------------------------------- the mesh

WORLD, MESH_ROWS, CHILD_TIMEOUT = 2, 4, 300
REPO = Path(__file__).resolve().parents[1]


def _mesh_inputs():
    """Seeded ResNet-18 weights and a global batch of 4 pairs, the last
    padded (row_valid 0), so that rank 1 holds one valid row."""
    from fast3dhpe_tpu_torch.models.layers import init_weights
    m = VolumetricNet(num_layers=18, volume_size=VOL)
    init_weights(m, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(6)
    P = torch.as_tensor(scene.converging_rig(SIZE, SIZE))[:, :3]
    n = MESH_ROWS
    batch = {"image": torch.randn(n, 2, SIZE, SIZE, 3, generator=g),
             "proj": P[None].repeat(n, 1, 1, 1),
             "target_3d": torch.rand(n, 19, 3, generator=g) * 500 - 250,
             "target_2d": torch.rand(n, 2, 19, 2, generator=g) * SIZE,
             "target_weight": (torch.rand(n, 19, generator=g) < 0.9).float(),
             "row_valid": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    return m.state_dict(), batch


def _mesh_steps(sd, batch, mesh):
    """One train step (angles from seed 8) and one eval step of the
    volumetric model from sd: the metrics, the gradients and the state
    after the update."""
    from fast3dhpe_tpu_torch.parallel.mesh import replicate
    from fast3dhpe_tpu_torch.train.steps import (make_eval_step_vol,
                                                 make_train_step_vol)
    m = VolumetricNet(num_layers=18, volume_size=VOL)
    m.load_state_dict(sd)
    if mesh is not None:
        replicate(mesh, m, spatial=False)
    state = TrainState.create(m, config_from_dict({"TRAIN": {"LR": 1e-4}}),
                              steps_per_epoch=1)
    gen = torch.Generator().manual_seed(8)
    train = make_train_step_vol(mesh=mesh)(state, batch, True, gen)
    grads = {k: p.grad.clone() for k, p in m.named_parameters()}
    ev = make_eval_step_vol(mesh=mesh)(state, batch)
    return {"train": {k: float(v) for k, v in train.items()},
            "eval": {k: float(v) for k, v in ev.items()}, "grads": grads,
            "state": {k: v.clone() for k, v in m.state_dict().items()}}


def _rank_main(rank, work):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    assert init_distributed(backend="gloo", device="cpu",
                            init_method="file://" + os.path.join(
                                work, "store"), timeout=CHILD_TIMEOUT)
    try:
        sd, batch = torch.load(os.path.join(work, "in.pt"))
        per = MESH_ROWS // WORLD
        local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
        torch.save(_mesh_steps(sd, local, make_mesh()),
                   os.path.join(work, f"out_{rank}.pt"))
    finally:
        destroy_distributed()


def _close(a, b, rel, what):
    assert abs(a - b) <= rel * abs(b), (what, a, b)


def test_the_steps_under_a_mesh_are_the_global_batchs(tmp_path,
                                                      monkeypatch):
    """World 2 against world 1 on the same global batch: the losses, the
    eval metrics, the gradients leaf by leaf (the masked 3D BN's global
    statistics, the L1 and CE denominators over the global valid rows),
    the running statistics, and the two ranks' states bit for bit. Each
    rank draws its rows' angles from the seed, as it draws its occlusion,
    so world 1 takes those of two ranks.

    The bounds are those of rounding: world 1 with its rows reordered
    (ranks' halves swapped) reads the same gaps against world 1 as world
    2 does, up to 2.3e-6 in the train losses, 2.0e-5 in grad_norm,
    6.7e-5 in the eval metrics after the update, 8.5e-3 of a leaf's
    gradient (the V2V's deepest blocks, whose BN takes 3 values a
    channel) and 1.1e-4 of a BN buffer's largest value."""
    sd, batch = _mesh_inputs()
    torch.save((sd, batch), tmp_path / "in.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST") and k not in
           ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=os.pathsep.join(
        filter(None, (str(REPO), env.get("PYTHONPATH")))),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp_path)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    angles = steps._angles
    monkeypatch.setattr(steps, "_angles", lambda gen, rows, device: angles(
        gen, rows // WORLD, device).repeat(WORLD))
    want = _mesh_steps(sd, batch, None)
    logs = []
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    got, other = (torch.load(tmp_path / f"out_{r}.pt") for r in range(2))
    for k in ("loss", "loss_3d", "loss_ce"):
        _close(got["train"][k], want["train"][k], 2e-5, k)
    _close(got["train"]["grad_norm"], want["train"]["grad_norm"], 2e-4,
           "grad_norm")
    for k in ("loss", "mpjpe_2d", "mpjpe_3d"):
        _close(got["eval"][k], want["eval"][k], 1e-3, k)
    assert got["eval"]["n"] == want["eval"]["n"] == 3
    names = list(want["grads"])
    norms = np.array([float(want["grads"][k].norm()) for k in names])
    floor = np.maximum(norms, np.median(norms))
    gap = np.array([float((got["grads"][k] - want["grads"][k]).norm())
                    for k in names])
    # the output layer's bias moves every voxel of a joint alike, which
    # the softmax does not see: its gradient is rounding alone
    gap[names.index("volume_net.output_layer.bias")] = 0.0
    assert (gap / floor).max() < 0.05, names[int(np.argmax(gap / floor))]
    for k, v in want["state"].items():
        if "running" in k:
            gap = (got["state"][k] - v).abs().max()
            assert gap <= 1e-3 * v.abs().max(), k
    for k, v in got["state"].items():
        assert torch.equal(v, other["state"][k]), k


if __name__ == "__main__":
    torch.set_num_threads(1)
    _rank_main(int(sys.argv[1]), sys.argv[2])
