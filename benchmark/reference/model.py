"""Plain PyTorch references of CDRNet and PoseResNet (Simple Baselines),
written from the published architectures: Remelli et al. 2020,
"Lightweight Multi-View 3D Pose Estimation through Camera-Disentangled
Representation" (arXiv:2004.02186), and Xiao et al. 2018, "Simple Baselines
for Human Pose Estimation and Tracking" (arXiv:1804.06208).

Functional code over a dict of tensors keyed as the reference checkpoints
are (`encoder.*`, `CF.*`, `decoder.*`), NCHW, fp32, no kernels of the
program. Every convolution goes through `Ops`, which also counts the
FLOPs of the convolutions and matrix products (harness/flops.py runs the
forward on the meta device for that).

Train-mode BN normalises with the biased batch variance and moves the
running statistics by 0.1 toward the batch mean and biased variance; eval
BN reads the running statistics; eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import dlt_triangulate, pinv

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
CF_HIDDEN = (300, 400)
DECONV_FILTERS = 256
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


class Ops:
    """The layers' arithmetic. train: BN takes batch statistics; update:
    train-mode BN moves the running statistics in `buffers`; flops: the
    multiply-adds of convolutions and matrix products, counted twice.

    dtype: the activations' type. In bf16 every convolution takes bf16
    weights and rounds its output (its bias added in bf16), and BN
    computes in fp32 from its bf16 input and rounds once: the rounding
    points of a network served in bf16 (the reference's yardstick of what
    rounding to bf16 alone moves)."""

    def __init__(self, params, buffers=None, train=False, update=True,
                 dtype=torch.float32):
        self.p = params
        self.buffers = buffers
        self.train = train
        self.update = update
        self.dtype = dtype
        self.flops = 0

    def _param(self, name):
        t = self.p.get(name)
        return None if t is None else t.to(self.dtype)

    def conv(self, x, name, stride=1, pad=0):
        w = self._param(f"{name}.weight")
        y = F.conv2d(x, w, None, stride, pad)
        b = self._param(f"{name}.bias")
        if b is not None:
            y = y + b[None, :, None, None]
        self.flops += 2 * y.numel() * w[0].numel()
        return y

    def deconv(self, x, name):
        """ConvTranspose2d(k 4, s 2, p 1), no bias; weight (I, O, 4, 4)."""
        w = self._param(f"{name}.weight")
        y = F.conv_transpose2d(x, w, None, 2, 1)
        self.flops += 2 * x.numel() * w[0].numel()
        return y

    def bn(self, x, name):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        dtype, x = x.dtype, x.float()
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
            if self.update and self.buffers is not None:
                with torch.no_grad():
                    for key, v in (("running_mean", mean),
                                   ("running_var", var)):
                        r = self.buffers[f"{name}.{key}"]
                        r.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * v.detach())
        else:
            mean = self.buffers[f"{name}.running_mean"]
            var = self.buffers[f"{name}.running_var"]
        inv = torch.rsqrt(var + BN_EPS) * w
        return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
                + b[None, :, None, None]).to(dtype)

    def matmul(self, equation, a, b, k):
        """An einsum whose every output entry sums k products."""
        out = torch.einsum(equation, a, b)
        self.flops += 2 * out.numel() * k
        return out


def bottleneck(ops, x, name, stride, downsample):
    out = torch.relu(ops.bn(ops.conv(x, f"{name}.conv1"), f"{name}.bn1"))
    out = torch.relu(ops.bn(ops.conv(out, f"{name}.conv2", stride, 1),
                            f"{name}.bn2"))
    out = ops.bn(ops.conv(out, f"{name}.conv3"), f"{name}.bn3")
    if downsample:
        x = ops.bn(ops.conv(x, f"{name}.downsample.0", stride),
                   f"{name}.downsample.1")
    return torch.relu(out + x)


def encoder(ops, x, depth):
    """(N, 3, H, W) -> (N, 2048, H / 32, W / 32): ResNet-50/101/152, the
    stride on each block's 3x3 convolution."""
    x = torch.relu(ops.bn(ops.conv(x, "encoder.conv1", 2, 3), "encoder.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    inplanes = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 STAGES[depth]), start=1):
        for i in range(blocks):
            stride = 2 if (stage > 1 and i == 0) else 1
            ds = i == 0 and (stride != 1 or inplanes != 4 * planes)
            x = bottleneck(ops, x, f"encoder.layer{stage}.{i}", stride, ds)
            inplanes = 4 * planes
    return x


def decoder(ops, x):
    """3 x (deconv k4 s2 p1, BN, ReLU), then a 1x1 convolution to the
    joints: (N, 2048, h, w) -> (N, J, 8h, 8w)."""
    for i in (1, 2, 3):
        x = torch.relu(ops.bn(ops.deconv(x, f"decoder.deconv{i}.0"),
                              f"decoder.deconv{i}.1"))
    return ops.conv(x, "decoder.final_layer")


def ftl(ops, x, mat, groups):
    """Feature transform layer: the channels of x (N, n * groups, h, w) are
    `groups` n-vectors, vector i holding channels (k * groups + i) for
    k < n; mat (N, m, n) maps each to m entries -> (N, m * groups, h, w)."""
    n = mat.shape[-1]
    v = x.reshape(x.shape[0], n, groups, *x.shape[2:])
    out = ops.matmul("bmn,bnghw->bmghw", mat.to(x.dtype), v, n)
    return out.reshape(x.shape[0], -1, *x.shape[2:])


def _conv_bn_relu(ops, x, conv, bn):
    return torch.relu(ops.bn(ops.conv(x, conv), bn))


def canonical_fusion(ops, z, proj):
    """z (B * V, C, h, w), views of a sample adjacent; proj (B, V, 3, 4).
    1x1 to 300, FTL by pinv(P) into 400 per view, the views concatenated,
    two 1x1 to 400, FTL by P back to 300 per view, a 1x1 to C for each
    view with its own weights."""
    B, V = proj.shape[:2]
    h1, h2 = CF_HIDDEN
    x = _conv_bn_relu(ops, z, "CF.conv_layer1.0", "CF.conv_layer1.1")
    x = ftl(ops, x, pinv(proj).reshape(B * V, 4, 3), h1 // 3)
    x = x.reshape(B, V * h2, *x.shape[2:])
    x = _conv_bn_relu(ops, x, "CF.conv_layer2.0", "CF.conv_layer2.1")
    x = _conv_bn_relu(ops, x, "CF.conv_layer2.3", "CF.conv_layer2.4")
    x = ftl(ops, x.repeat_interleave(V, dim=0), proj.reshape(B * V, 3, 4),
            h2 // 4).reshape(B, V, h1, *x.shape[2:])
    outs = [_conv_bn_relu(ops, x[:, v], f"CF.out_layer.{v}.0",
                          f"CF.out_layer.{v}.1") for v in range(V)]
    return torch.stack(outs, dim=1).flatten(0, 1)


def soft_argmax(hm):
    """(N, J, h, w) logits -> (N, J, 2) expected (x, y) in heatmap pixels
    under the spatial softmax, in fp32."""
    N, J, h, w = hm.shape
    p = torch.softmax(hm.float().reshape(N, J, h * w), dim=-1).reshape(
        N, J, h, w)
    xs = torch.arange(w, dtype=p.dtype, device=p.device)
    ys = torch.arange(h, dtype=p.dtype, device=p.device)
    return torch.stack([(p.sum(2) * xs).sum(-1), (p.sum(3) * ys).sum(-1)],
                       dim=-1)


def cdrnet_heatmaps(ops, images, proj, depth):
    """images (B, V, 3, H, W) normalised; proj (B, V, 3, 4) -> heatmaps
    (B * V, J, h, w)."""
    B, V = images.shape[:2]
    z = encoder(ops, images.flatten(0, 1).to(ops.dtype), depth)
    return decoder(ops, canonical_fusion(ops, z, proj))


def cdrnet(ops, images, proj, depth, geometry=True):
    """-> pred_2d (B, V, J, 2) in image pixels, pred_3d (B, J, 3) by the
    DLT of both views; heatmaps (B * V, J, h, w) too."""
    B, V, _, H, _ = images.shape
    hm = cdrnet_heatmaps(ops, images, proj, depth)
    if not geometry:
        return None, None, hm
    kp = (soft_argmax(hm) * (H / hm.shape[-2])).reshape(B, V, -1, 2)
    return kp, dlt_triangulate(proj, kp), hm


def poseresnet(ops, images, depth):
    """images (B, 3, H, W) normalised -> heatmaps (B, J, H / 4, W / 4)."""
    return decoder(ops, encoder(ops, images, depth))
