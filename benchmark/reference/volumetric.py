"""A plain PyTorch reference of Learnable Triangulation's volumetric model
(Iskakov et al., ICCV 2019, arXiv:1905.05754), written from the public
code: mvn/models/triangulation.py VolumetricTriangulationNet,
mvn/models/v2v.py V2VModel, mvn/utils/op.py unproject_heatmaps and
integrate_tensor_3d_with_coordinates, mvn/utils/volumetric.py
rotate_coord_volume, mvn/models/loss.py KeypointsMAELoss and
VolumetricCELoss, and the recipe of
experiments/human36m/train/human36m_vol_softmax.yaml.

Functional code over a dict of tensors keyed as the program's state dict
is (`encoder.*`, `decoder.deconv*`, `process_features.*`, `volume_net.*`
with the public code's module names), NCHW / NCDHW, fp32. The trunk is
model.py's ResNet encoder and the three deconvolutions of its decoder,
without the heatmap head, which the volumetric model never reads. The
unprojection is the public per-sample, per-view loop; the 3D soft-argmax
is the dense sum of the softmax volume times the voxel centres; the
cross-entropy finds each joint's voxel by the distance to every centre.
The cuboid turns about the scene's vertical axis, y.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import model as ref
from .pipeline import CUTOUT_HOLES, step_seed, stereo_batch
from .train import Adam

LEVELS = 5
CUBOID_SIDE, FEATURES = 2500.0, 32      # mm; channels lifted into it
CE_WEIGHT = 0.01        # the published volumetric_ce_loss_weight
HEAD_LR_SCALE = 10.0    # published: process_features_lr, volume_net_lr 1e-3
ENC = ((32, 64), (64, 128), (128, 128), (128, 128), (128, 128))


class Ops(ref.Ops):
    """model.Ops with the V2V's 3D layers: their FLOPs counted as the 2D
    convolutions' are, and BN over every dim but the channels."""

    def conv3d(self, x, name, pad=0):
        w = self.p[f"{name}.weight"]
        y = F.conv3d(x, w, self.p[f"{name}.bias"], 1, pad)
        self.flops += 2 * y.numel() * w[0].numel()
        return y

    def deconv3d(self, x, name):
        """ConvTranspose3d(k 2, s 2) with its bias; weight (I, O, 2, 2, 2)."""
        w = self.p[f"{name}.weight"]
        y = F.conv_transpose3d(x, w, self.p[f"{name}.bias"], 2)
        self.flops += 2 * x.numel() * w[0].numel()
        return y

    def bn3d(self, x, name):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        dims = (0, 2, 3, 4)
        if self.train:
            mean = x.mean(dim=dims)
            var = (x - mean[None, :, None, None, None]).square().mean(dim=dims)
            if self.update and self.buffers is not None:
                with torch.no_grad():
                    for key, v in (("running_mean", mean),
                                   ("running_var", var)):
                        r = self.buffers[f"{name}.{key}"]
                        r.mul_(1 - ref.BN_MOMENTUM).add_(
                            ref.BN_MOMENTUM * v.detach())
        else:
            mean = self.buffers[f"{name}.running_mean"]
            var = self.buffers[f"{name}.running_var"]
        inv = torch.rsqrt(var + ref.BN_EPS) * w

        def c(v):
            return v[None, :, None, None, None]
        return (x - c(mean)) * c(inv) + c(b)


# ------------------------------------------------------------------ V2V

def basic(ops, x, name, k):
    return torch.relu(ops.bn3d(ops.conv3d(x, f"{name}.block.0", (k - 1) // 2),
                               f"{name}.block.1"))


def res(ops, x, name, cin, cout):
    r = torch.relu(ops.bn3d(ops.conv3d(x, f"{name}.res_branch.0", 1),
                            f"{name}.res_branch.1"))
    r = ops.bn3d(ops.conv3d(r, f"{name}.res_branch.3", 1),
                 f"{name}.res_branch.4")
    if cin != cout:
        x = ops.bn3d(ops.conv3d(x, f"{name}.skip_con.0"),
                     f"{name}.skip_con.1")
    return torch.relu(r + x)


def upsample(ops, x, name):
    return torch.relu(ops.bn3d(ops.deconv3d(x, f"{name}.block.0"),
                               f"{name}.block.1"))


def v2v(ops, x):
    """(B, 32, D, H, W) -> (B, J, D, H, W)."""
    n = "volume_net"
    x = basic(ops, x, f"{n}.front_layers.0", 7)
    for i, (cin, cout) in enumerate(((16, 32), (32, 32), (32, 32)), 1):
        x = res(ops, x, f"{n}.front_layers.{i}", cin, cout)
    e = f"{n}.encoder_decoder"
    skips = []
    for i, (cin, cout) in enumerate(ENC, 1):
        skips.append(res(ops, x, f"{e}.skip_res{i}", cin, cin))
        x = res(ops, F.max_pool3d(x, 2, 2), f"{e}.encoder_res{i}", cin, cout)
    x = res(ops, x, f"{e}.mid_res", 128, 128)
    for i in range(LEVELS, 0, -1):
        cout = ENC[i - 1][1]
        x = res(ops, x, f"{e}.decoder_res{i}", cout, cout)
        x = upsample(ops, x, f"{e}.decoder_upsample{i}") + skips[i - 1]
    x = res(ops, x, f"{n}.back_layers.0", 32, 32)
    x = basic(ops, x, f"{n}.back_layers.1", 1)
    x = basic(ops, x, f"{n}.back_layers.2", 1)
    return ops.conv3d(x, f"{n}.output_layer")


# ------------------------------------------------------------- geometry

def rotation_matrix(axis, theta):
    """The public code's counter-clockwise rotation about `axis`, float64."""
    axis = np.asarray(axis, np.float64)
    axis = axis / math.sqrt(np.dot(axis, axis))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([[aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
                     [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
                     [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc]])


def coord_volumes(roots, thetas, size, side):
    """roots (B, 3), thetas (B,) -> (B, size, size, size, 3): the public
    code's per-sample cuboid, turned about the y axis."""
    out = []
    for root, theta in zip(roots, thetas.tolist()):
        g = torch.stack(torch.meshgrid(*[torch.arange(
            size, device=root.device)] * 3, indexing="ij"), -1).float()
        g = g.reshape(-1, 3)
        position = root - side / 2
        coord = position + (side / (size - 1)) * g
        rot = torch.from_numpy(rotation_matrix([0, 1, 0], theta)).float()
        coord = (rot.to(root.device) @ (coord - root).t()).t() + root
        out.append(coord.reshape(size, size, size, 3))
    return torch.stack(out)


def unproject_heatmaps(features, proj, coords):
    """features (B, V, C, h, w), proj (B, V, 3, 4) to the features'
    pixels, coords (B, D, H, W, 3) -> (B, C, D, H, W), the views merged by
    a softmax over them; the public code's loops."""
    B, V, C, h, w = features.shape
    shape = coords.shape[1:4]
    out = []
    for b in range(B):
        pts = coords[b].reshape(-1, 3)
        views = []
        for v in range(V):
            uvw = torch.cat([pts, torch.ones_like(pts[:, :1])], 1) \
                @ proj[b, v].t()
            invalid = uvw[:, 2] <= 0.0
            uvw[uvw[:, 2] == 0.0, 2] = 1.0
            uv = uvw[:, :2] / uvw[:, 2:]
            grid = torch.stack([2 * (uv[:, 0] / h - 0.5),
                                2 * (uv[:, 1] / w - 0.5)], -1)
            vol = F.grid_sample(features[b, v][None], grid[None, :, None],
                                align_corners=True).view(C, -1)
            vol = torch.where(invalid[None], 0.0, vol)
            views.append(vol.view(C, *shape))
        views = torch.stack(views)
        weight = torch.softmax(views.view(V, -1), 0).view(views.shape)
        out.append((views * weight).sum(0))
    return torch.stack(out)


def resize_projection(proj, image, feature):
    """Camera.update_after_resize: the x and y rows times feature / image."""
    proj = proj.clone()
    proj[..., :2, :] *= feature / image
    return proj


def forward(ops, images, proj, roots, thetas, depth, size, side):
    """images (B, V, 3, S, S) normalised, proj (B, V, 3, 4) to the crops'
    pixels, roots (B, 3), thetas (B,) -> (keypoints (B, J, 3) mm, the
    softmax volumes (B, J, D, H, W), the voxel centres)."""
    B, V = images.shape[:2]
    x = ref.encoder(ops, images.flatten(0, 1), depth)
    for i in (1, 2, 3):
        x = torch.relu(ops.bn(ops.deconv(x, f"decoder.deconv{i}.0"),
                              f"decoder.deconv{i}.1"))
    f = ops.conv(x, "process_features")
    f = f.view(B, V, *f.shape[1:])
    coords = coord_volumes(roots, thetas, size, side)
    vol = unproject_heatmaps(
        f, resize_projection(proj, images.shape[-1], f.shape[-1]), coords)
    logits = v2v(ops, vol)
    J = logits.shape[1]
    p = torch.softmax(logits.reshape(B, J, -1), -1).view(logits.shape)
    kp = torch.einsum("bjdhw,bdhwc->bjc", p, coords)
    return kp, p, coords


# ----------------------------------------------------------------- loss

def mae(pred, target, validity, scale=0.1):
    """KeypointsMAELoss on keypoints scaled by `scale`."""
    d = ((target * scale - pred * scale).abs() * validity[..., None]).sum()
    return d / (3 * max(1.0, float(validity.sum())))


def volumetric_ce(coords, volumes, target, validity):
    """VolumetricCELoss: -log(p + 1e-6) at the voxel nearest each joint,
    by the distance to every voxel centre, averaged over every joint."""
    B, J = target.shape[:2]
    loss = 0.0
    for b in range(B):
        d = (coords[b].reshape(1, -1, 3) - target[b][:, None]).square() \
            .sum(-1).sqrt()
        idx = d.argmin(-1)
        p = volumes[b].reshape(J, -1).gather(1, idx[:, None])[:, 0]
        loss = loss + (validity[b] * -torch.log(p + 1e-6)).sum()
    return loss / (B * J)


def angles(seed, B, H, W, device):
    """The cuboids' turns of a step: uniform in [0, 2 pi), drawn from the
    step's generator after its Cutout draws (pipeline.cutout's: B gates,
    then the holes' rows and columns)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.rand((B,), generator=gen, device=device)
    for n in (H, W):
        torch.randint(0, n, (2 * B, CUTOUT_HOLES), generator=gen,
                      device=device)
    return 2.0 * np.pi * torch.rand((B,), generator=gen, device=device)


def train_batch(frames, x, size, chunk_seed, step):
    """A training batch (pipeline.stereo_batch) and its cuboids' turns."""
    seed = step_seed(chunk_seed, step)
    batch = stereo_batch(frames, x, size, seed)
    B = batch["images"].shape[0]
    batch["theta"] = angles(seed, B, size, size, frames.device)
    return batch


class Trainer:
    """The reference's training state, as train.Trainer's: the trunk's
    leaves at lr, the feature reduction's and the V2V's at HEAD_LR_SCALE x
    lr (Adam each), the loss L1 + CE_WEIGHT x the cross-entropy, no
    clip."""

    def __init__(self, state_dict, names, lr, depth, size, side,
                 base_joint=1):
        self.names = names
        self.params = {k: state_dict[k].detach().clone().float()
                       .requires_grad_(True) for k in names}
        self.buffers = {k: v.detach().clone() for k, v in state_dict.items()
                        if k not in self.params}
        self.leaves = [self.params[k] for k in names]
        trunk = [k.startswith(("encoder.", "decoder.")) for k in names]
        self.adams = [Adam([p for p, t in zip(self.leaves, trunk) if t], lr),
                      Adam([p for p, t in zip(self.leaves, trunk) if not t],
                           HEAD_LR_SCALE * lr)]
        self.trunk = trunk
        self.depth, self.size, self.side = depth, size, side
        self.base_joint = base_joint

    def loss(self, batch):
        ops = Ops(self.params, self.buffers, train=True)
        target = batch["target_3d"]
        kp, p, coords = forward(
            ops, batch["images"], batch["proj"],
            target[:, self.base_joint], batch["theta"], self.depth,
            self.size, self.side)
        w = batch["target_weight"]
        l1 = mae(kp, target, w)
        self.loss_2d = l1.detach()
        return l1 + CE_WEIGHT * volumetric_ce(coords, p, target, w)

    def grads(self, batch):
        loss = self.loss(batch)
        grads = torch.autograd.grad(loss, self.leaves)
        return loss.detach(), [g.detach() for g in grads]

    def step(self, batch):
        loss, grads = self.grads(batch)
        for adam, keep in zip(self.adams, (True, False)):
            adam.step([g for g, t in zip(grads, self.trunk) if t == keep])
        return loss, grads


def forward_flops(state_shapes, depth, batch, size, volume,
                  features=FEATURES):
    """FLOPs of one forward at `batch` stereo pairs of size x size: the
    trunk's convolutions and deconvolutions, the feature reduction and the
    V2V's 3D convolutions, counted on the meta device (the unprojection
    and the soft-argmax do no convolution and are not counted)."""
    params = {k: torch.empty(s, device="meta")
              for k, s in state_shapes.items()}
    ops = Ops(params, params, train=False)
    x = ref.encoder(ops, torch.empty((2 * batch, 3, size, size),
                                     device="meta"), depth)
    for i in (1, 2, 3):
        x = ops.deconv(x, f"decoder.deconv{i}.0")
    ops.conv(x, "process_features")
    v2v(ops, torch.empty((batch, features) + (volume,) * 3, device="meta"))
    return ops.flops
