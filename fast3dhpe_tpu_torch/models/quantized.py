"""Int8 post-training-quantized (PTQ) inference for PoseResNet and CDRNet.
Port of fast3dhpe_tpu/models/quantized.py.

One structural walk of the network (stem -> residual stages -> deconv
decoder) drives two executors: `_CalibCtx` runs the BN-folded fp32
forward and records |t| at every tensor that will live as int8, and
`_Int8Ctx` runs the quantized graph on (int8, scale) pairs, so the scale
bookkeeping cannot drift from the graph that runs.

- Weights: per-output-channel symmetric int8 (BN folded first).
- Activations: per-tensor symmetric int8; residual adds and the heatmap
  head's output stay in fp32.
- CDRNet: the encoder and decoder run int8; the CanonicalFusion trunk
  runs in bf16 (the port's own `CanonicalFusion`), the soft-argmax through
  `soft_argmax_fused` (K1 on the card) and the DLT in fp32 (Jacobi).

A pack is a plain nested dict: {"layers": {name: {"w" int8, "sw" (K,)
fp32, "b" (K,) fp32}}, "scales": {name: 0-d fp32}, "depth": int, and for
CDRNet "cf": the trunk's {"params", "batch_stats"} under flax's names}.
Its names, key layout and array layouts are the JAX package's (kernels
HWIO, transposed kernels (kh, kw, O, I)), so `save_pack` writes the .npz
that the JAX `load_pack` reads and `load_pack` reads the JAX package's.
`Int8Pack` converts a pack once into what the int8 executor multiplies
(ops/quant.py gemm_weight) and holds it as buffers of a module, so
`.to(device)` moves it and torch.export bakes it in.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import jax_variables_to_state_dict
from ..geometry.triangulation import dlt_triangulate, pinv_projection
from ..ops import quant as Q
from ..ops.softargmax import soft_argmax_fused
from .cdrnet import CanonicalFusion
from .resnet import EXPANSION, RESNET_SPEC

# ---------------------------------------------------------------------------
# BN-folded fp layers from a reference-format state dict
# ---------------------------------------------------------------------------


def _fold_module(sd, conv: str, bn: Optional[str], out_axis: int = 0):
    """One conv (+ optional BN) -> {"w": folded fp32 kernel in the port's
    layout, "b": (K,)}."""
    w = sd[f"{conv}.weight"]
    if bn is None:
        b = sd.get(f"{conv}.bias")
        if b is None:
            b = torch.zeros(w.shape[out_axis])
        return {"w": w.float(), "b": b.float()}
    wf, bf = Q.fold_bn(w, sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                       sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                       out_axis=out_axis)
    return {"w": wf, "b": bf}


def _extract_backbone(sd) -> Tuple[Dict[str, Any], int]:
    """The encoder and decoder of a state dict (`encoder.*`, `decoder.*`),
    folded, under the pack's layer names: encoder.conv1,
    encoder.layer{s}_{i}.conv{n} / .downsample, decoder.deconv{n},
    decoder.final_layer. The depth is read from the block structure."""
    layers: Dict[str, Any] = {
        "encoder.conv1": _fold_module(sd, "encoder.conv1", "encoder.bn1")}
    counts = tuple(len({k.split(".")[2] for k in sd
                        if k.startswith(f"encoder.layer{s}.")})
                   for s in (1, 2, 3, 4))
    is_bottleneck = "encoder.layer1.0.conv3.weight" in sd
    depth = next(k for k, (blk, c) in RESNET_SPEC.items()
                 if c == counts and (blk == "bottleneck") == is_bottleneck)
    block, sizes = RESNET_SPEC[depth]
    n_convs = 3 if block == "bottleneck" else 2
    for stage, blocks in enumerate(sizes, start=1):
        for i in range(blocks):
            src = f"encoder.layer{stage}.{i}"
            pre = f"encoder.layer{stage}_{i}"
            for n in range(1, n_convs + 1):
                layers[f"{pre}.conv{n}"] = _fold_module(
                    sd, f"{src}.conv{n}", f"{src}.bn{n}")
            if f"{src}.downsample.0.weight" in sd:
                layers[f"{pre}.downsample"] = _fold_module(
                    sd, f"{src}.downsample.0", f"{src}.downsample.1")
    for i in (1, 2, 3):
        layers[f"decoder.deconv{i}"] = _fold_module(
            sd, f"decoder.deconv{i}.0", f"decoder.deconv{i}.1", out_axis=1)
    layers["decoder.final_layer"] = _fold_module(sd, "decoder.final_layer",
                                                 None)
    return layers, depth


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


class _CalibCtx:
    """BN-folded fp32 executor (NCHW activations, channels_last memory)
    that records |t| at every point where the int8 executor holds int8."""

    def __init__(self, layers, percentile=None):
        self.layers = layers
        self.percentile = percentile
        self.stats: Dict[str, torch.Tensor] = {}

    def _rec(self, name, t):
        self.stats[name] = Q.abs_stat(t, self.percentile)
        return t

    def quant_input(self, x):
        """x: (N, H, W, 3) normalised images."""
        return self._rec("input", x.float()).permute(0, 3, 1, 2)

    def conv(self, name, x, stride, pad, relu, requant_out):
        l = self.layers[name]
        y = F.conv2d(x, l["w"], None, stride, pad) + l["b"].view(1, -1, 1, 1)
        if relu:
            y = torch.relu(y)
        if requant_out:
            y = self._rec(name, y)
        return y

    def deconv(self, name, x):
        l = self.layers[name]
        y = F.conv_transpose2d(x, l["w"], None, 2, 1)
        return self._rec(name, torch.relu(y + l["b"].view(1, -1, 1, 1)))

    def add_relu_requant(self, name, acc, residual):
        return self._rec(name, torch.relu(acc + residual))

    def dequant(self, x):
        return x

    def maxpool(self, x):
        # inputs are post-ReLU, so the -inf padding never wins
        return F.max_pool2d(x, 3, 2, 1)

    def requantize_external(self, name, x):
        """An fp tensor entering the int8 domain from outside (CF)."""
        return self._rec(name, x.float())


class _Int8Ctx:
    """Quantized executor: activations travel as (int8 NHWC, scale) pairs;
    residual sums and the head's output are fp32."""

    def __init__(self, rt: "Int8Pack"):
        self.rt = rt

    def quant_input(self, x):
        s = self.rt.scale("input")
        return Q.requant(x.float(), s), s

    def _epilogue(self, l, acc_i32, s_in):
        return acc_i32.float() * (l.sw * s_in) + l.b

    def conv(self, name, xs, stride, pad, relu, requant_out):
        x8, s_in = xs
        l = self.rt.layer(name)
        y = self._epilogue(l, Q.conv_i8(x8, l.w, l.cout, l.k, stride, pad),
                           s_in)
        if relu:
            y = torch.relu(y)
        if requant_out:
            s = self.rt.scale(name)
            return Q.requant(y, s), s
        return y                                   # fp32 epilogue space

    def deconv(self, name, xs):
        x8, s_in = xs
        l = self.rt.layer(name)
        y = self._epilogue(l, Q.conv_transpose_i8(x8, l.w, l.cout, l.k),
                           s_in)
        s = self.rt.scale(name)
        return Q.requant(torch.relu(y), s), s

    def add_relu_requant(self, name, acc, residual):
        s = self.rt.scale(name)
        return Q.requant(torch.relu(acc + residual), s), s

    def dequant(self, xs):
        x8, s = xs
        return Q.dequant(x8, s)

    def maxpool(self, xs):
        x8, s = xs
        return Q.max_pool_i8(x8), s

    def requantize_external(self, name, x):
        s = self.rt.scale(name)
        return Q.requant(x.float(), s), s


# ---------------------------------------------------------------------------
# The shared structural walk (quantized.py:234-287)
# ---------------------------------------------------------------------------


def _basic_block(ctx, pre, x, stride, downsample):
    h = ctx.conv(f"{pre}.conv1", x, stride, 1, relu=True, requant_out=True)
    acc = ctx.conv(f"{pre}.conv2", h, 1, 1, relu=False, requant_out=False)
    if downsample:
        res = ctx.conv(f"{pre}.downsample", x, stride, 0,
                       relu=False, requant_out=False)
    else:
        res = ctx.dequant(x)
    return ctx.add_relu_requant(pre, acc, res)


def _bottleneck_block(ctx, pre, x, stride, downsample):
    h = ctx.conv(f"{pre}.conv1", x, 1, 0, relu=True, requant_out=True)
    h = ctx.conv(f"{pre}.conv2", h, stride, 1, relu=True, requant_out=True)
    acc = ctx.conv(f"{pre}.conv3", h, 1, 0, relu=False, requant_out=False)
    if downsample:
        res = ctx.conv(f"{pre}.downsample", x, stride, 0,
                       relu=False, requant_out=False)
    else:
        res = ctx.dequant(x)
    return ctx.add_relu_requant(pre, acc, res)


def _encoder_walk(ctx, x, depth):
    """images (already through ctx.quant_input) -> encoder features."""
    x = ctx.conv("encoder.conv1", x, 2, 3, relu=True, requant_out=True)
    x = ctx.maxpool(x)
    block, sizes = RESNET_SPEC[depth]
    fn = _bottleneck_block if block == "bottleneck" else _basic_block
    expansion = EXPANSION[block]
    inplanes = 64
    for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), sizes), start=1):
        stride = 1 if stage == 1 else 2
        for i in range(blocks):
            s = stride if i == 0 else 1
            downsample = (i == 0 and
                          (s != 1 or inplanes != planes * expansion))
            x = fn(ctx, f"encoder.layer{stage}_{i}", x, s, downsample)
            inplanes = planes * expansion
    return x


def _decoder_walk(ctx, x):
    for i in (1, 2, 3):
        x = ctx.deconv(f"decoder.deconv{i}", x)
    # final 1x1 conv: int8 in, fp32 heatmaps out, never requantized
    return ctx.conv("decoder.final_layer", x, 1, 0,
                    relu=False, requant_out=False)


# ---------------------------------------------------------------------------
# Calibration and conversion
# ---------------------------------------------------------------------------


def _max_merge(acc, new):
    if acc is None:
        return new
    return {k: torch.maximum(acc[k], new[k]) for k in new}


def _act_scales(stats):
    """max-abs statistics -> per-tensor scales; a floor keeps a dead
    (all-zero) calibration tensor from a division by zero."""
    return {k: torch.clamp_min(v.cpu() / Q.INT8_MAX, 1e-12).float()
            for k, v in stats.items()}


def _quantize_layers(fp_layers):
    """Per-channel int8 kernels, stored in the JAX layouts: OIHW -> HWIO
    and (I, O, kh, kw) -> (kh, kw, O, I) are both permute(2, 3, 1, 0)."""
    out = {}
    for name, l in fp_layers.items():
        q, sw = Q.quantize_kernel(l["w"], 1 if ".deconv" in name else 0)
        out[name] = {"w": q.permute(2, 3, 1, 0).contiguous().cpu(),
                     "sw": sw.cpu(), "b": l["b"].cpu()}
    return out


def _on(layers, device):
    return {n: {k: v.to(device) for k, v in l.items()}
            for n, l in layers.items()}


def poseresnet_fp_folded_apply(state_dict, imgs):
    """BN-folded fp32 forward (a test reference): (B, H, W, 3) -> (B, h,
    w, J), equal to the model's eval forward in fp32 up to the fold's
    reassociation."""
    layers, depth = _extract_backbone(state_dict)
    ctx = _CalibCtx(_on(layers, imgs.device))
    with torch.inference_mode():
        x = ctx.quant_input(imgs)
        return _decoder_walk(ctx, _encoder_walk(ctx, x, depth)).permute(
            0, 2, 3, 1)


def quantize_poseresnet(state_dict, calib_images: List[Any],
                        percentile: Optional[float] = None):
    """PTQ a trained PoseResNet from its state dict. calib_images: a list
    of (B, H, W, 3) normalised image batches, on the device to calibrate
    on (a handful is enough for max-abs)."""
    fp_layers, depth = _extract_backbone(state_dict)
    stats = layers = None
    with torch.inference_mode():
        for imgs in calib_images:
            imgs = torch.as_tensor(imgs)
            layers = layers or _on(fp_layers, imgs.device)
            ctx = _CalibCtx(layers, percentile)
            _decoder_walk(ctx, _encoder_walk(ctx, ctx.quant_input(imgs),
                                             depth))
            stats = _max_merge(stats, ctx.stats)
    return {"layers": _quantize_layers(fp_layers),
            "scales": _act_scales(stats), "depth": depth}


_CF_SITES = {"conv_layer1.0": "conv_layer1", "conv_layer1.1": "conv_layer1_bn",
             "conv_layer2.0": "conv_layer2_0", "conv_layer2.1":
             "conv_layer2_0_bn", "conv_layer2.3": "conv_layer2_1",
             "conv_layer2.4": "conv_layer2_1_bn", "out_layer.0.0":
             "out_layer0", "out_layer.0.1": "out_layer0_bn",
             "out_layer.1.0": "out_layer1", "out_layer.1.1": "out_layer1_bn"}
_CF_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _cf_variables(state_dict):
    """The state dict's CF.* -> the CanonicalFusion's flax variables, as
    the JAX pack holds them (kernels (1, 1, I, O))."""
    cf = {"params": {}, "batch_stats": {}}
    for key, v in state_dict.items():
        if not key.startswith("CF.") or key.endswith("num_batches_tracked"):
            continue
        site, leaf = key[3:].rsplit(".", 1)
        flax = _CF_SITES[site]
        if flax.endswith("_bn"):
            coll, name = _CF_LEAVES[leaf]
        else:
            coll, name = "params", "kernel" if leaf == "weight" else "bias"
            if leaf == "weight":
                v = v.permute(2, 3, 1, 0)
        cf[coll].setdefault(flax, {})[name] = v.detach().float().cpu() \
            .contiguous()
    return cf


def _cf_module(cf_vars) -> CanonicalFusion:
    """A CanonicalFusion (fp32 parameters, eval mode) from flax variables."""
    sd = jax_variables_to_state_dict({
        "params": {"CF": cf_vars["params"]},
        "batch_stats": {"CF": cf_vars["batch_stats"]}})
    sd = {k[3:]: v for k, v in sd.items()}
    cf = CanonicalFusion(in_dim=sd["conv_layer1.0.weight"].shape[1])
    cf.load_state_dict(sd, strict=True)
    return cf.eval()


def _cf_apply(cf, z_nchw, projs, proj_inv):
    """The bf16 CanonicalFusion trunk on (B*V, C, h, w) fp features; the
    result is bf16, as the JAX trunk's."""
    return cf(z_nchw.to(torch.bfloat16), projs, proj_inv)


def quantize_cdrnet(state_dict, calib_batches: List[Tuple[Any, Any]],
                    percentile: Optional[float] = None):
    """PTQ a trained CDRNet from its state dict. calib_batches: a list of
    (imgs (B, V, H, W, 3) normalised, projs (B, V, 3, 4)), on the device
    to calibrate on."""
    fp_layers, depth = _extract_backbone(state_dict)
    cf_vars = _cf_variables(state_dict)
    stats = layers = cf = None
    with torch.inference_mode():
        for imgs, projs in calib_batches:
            imgs = torch.as_tensor(imgs)
            dev = imgs.device
            if layers is None:
                layers = _on(fp_layers, dev)
                cf = _cf_module(cf_vars).to(dev)
            projs = torch.as_tensor(projs).to(dev).float()
            B, V = imgs.shape[:2]
            ctx = _CalibCtx(layers, percentile)
            x = ctx.quant_input(imgs.reshape((B * V,) + imgs.shape[2:]))
            z = _encoder_walk(ctx, x, depth)
            fused = _cf_apply(cf, z, projs, pinv_projection(projs))
            f = ctx.requantize_external("cf_out", fused)
            _decoder_walk(ctx, f)
            stats = _max_merge(stats, ctx.stats)
    return {"layers": _quantize_layers(fp_layers),
            "scales": _act_scales(stats), "cf": cf_vars, "depth": depth}


# ---------------------------------------------------------------------------
# The prepared pack and the int8 forwards
# ---------------------------------------------------------------------------


def _key(name: str) -> str:
    return name.replace(".", "__")


class _QLayer(nn.Module):
    """One int8 layer as the executor reads it: the (N, K) int8 matrix of
    ops/quant.py gemm_weight, the per-channel weight scales and the fp32
    bias, and the kernel's size k and output channels."""

    def __init__(self, name, l):
        super().__init__()
        w = torch.as_tensor(l["w"])
        transposed = ".deconv" in name
        self.k = int(w.shape[0])
        self.cout = int(w.shape[2] if transposed else w.shape[3])
        self.register_buffer("w", (Q.gemm_weight_transposed if transposed
                                   else Q.gemm_weight)(w))
        self.register_buffer("sw", torch.as_tensor(l["sw"]).float().clone())
        self.register_buffer("b", torch.as_tensor(l["b"]).float().clone())


class Int8Pack(nn.Module):
    """A pack converted once for the int8 executor: every kernel as its
    GEMM matrix, the activation scales as 0-d buffers, and for CDRNet the
    bf16 trunk as a CanonicalFusion module. `.to(device)` moves it all."""

    def __init__(self, pack):
        super().__init__()
        self.depth = int(pack["depth"])
        self.layers = nn.ModuleDict({_key(n): _QLayer(n, l)
                                     for n, l in pack["layers"].items()})
        self.scales = nn.Module()
        for n, s in pack["scales"].items():
            self.scales.register_buffer(
                _key(n), torch.as_tensor(s).float().reshape(()).clone())
        self.cf = _cf_module(pack["cf"]) if "cf" in pack else None

    def layer(self, name) -> _QLayer:
        return self.layers[_key(name)]

    def scale(self, name) -> torch.Tensor:
        return getattr(self.scales, _key(name))


def poseresnet_int8_apply(rt: Int8Pack, imgs):
    """Quantized PoseResNet forward: (B, H, W, 3) normalised -> (B, h, w,
    J) fp32 heatmaps."""
    ctx = _Int8Ctx(rt)
    return _decoder_walk(ctx, _encoder_walk(ctx, ctx.quant_input(imgs),
                                            rt.depth))


def cdrnet_int8_apply(rt: Int8Pack, imgs, projs, dlt_method: str = "jacobi",
                      return_heatmaps: bool = False):
    """Quantized CDRNet forward, CDRNet's contract: imgs (B, V, H, W, 3)
    normalised, projs (B, V, 3, 4) -> pred_2d (B, V, J, 2), pred_3d
    (B, J, 3)[, heatmaps (B, V, h, w, J) fp32]."""
    B, V, H, W, _ = imgs.shape
    ctx = _Int8Ctx(rt)
    projs = projs.float()
    x = ctx.quant_input(imgs.reshape(B * V, H, W, 3))
    z = _encoder_walk(ctx, x, rt.depth)
    fused = _cf_apply(rt.cf, ctx.dequant(z).permute(0, 3, 1, 2), projs,
                      pinv_projection(projs))
    f = ctx.requantize_external("cf_out", fused.permute(0, 2, 3, 1))
    h = _decoder_walk(ctx, f).contiguous()         # (B*V, hh, hw, J) fp32
    hh, J = h.shape[1], h.shape[-1]
    kp = soft_argmax_fused(h) * (H / hh)
    kp = kp.reshape(B, V, J, 2)
    proj_j = projs[:, None].expand(B, J, V, 3, 4)
    pred_3d = dlt_triangulate(proj_j, kp.transpose(1, 2), method=dlt_method)
    if return_heatmaps:
        return kp, pred_3d, h.reshape(B, V, hh, h.shape[2], J)
    return kp, pred_3d


class Int8CDRNet(nn.Module):
    """CDRNet's forward on an int8 pack: (imgs, projs) -> (pred_2d,
    pred_3d), the port's counterpart of jit_cdrnet_int8's closure."""

    def __init__(self, pack, dlt_method: str = "jacobi"):
        super().__init__()
        self.rt = pack if isinstance(pack, Int8Pack) else Int8Pack(pack)
        self.dlt_method = dlt_method

    def forward(self, imgs, projs, return_heatmaps: bool = False):
        return cdrnet_int8_apply(self.rt, imgs, projs, self.dlt_method,
                                 return_heatmaps)


def cdrnet_int8(pack, dlt_method: str = "jacobi", device="cuda"):
    """The int8 CDRNet of a pack on `device`, in eval mode (the JAX
    package's jit_cdrnet_int8)."""
    from ..device import resolve_device
    return Int8CDRNet(pack, dlt_method).to(resolve_device(device)).eval()


# ---------------------------------------------------------------------------
# .npz packs, key for key the JAX package's
# ---------------------------------------------------------------------------


def save_pack(path: str, pack) -> None:
    """Write a pack as one .npz: its nested keys joined by '/', every leaf
    a numpy array (quantized.py:429-446)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = (node.detach().cpu().numpy()
                            if isinstance(node, torch.Tensor)
                            else np.asarray(node))

    walk("", pack)
    np.savez(path, **flat)


def load_pack(path: str):
    """Inverse of save_pack, for a pack that either package wrote: CPU
    tensors, and the depth an int."""
    with np.load(path) as z:
        pack: dict = {}
        for key in z.files:
            parts = key.split("/")
            node = pack
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            leaf = z[key]
            node[parts[-1]] = (int(leaf) if parts[-1] == "depth"
                               else torch.from_numpy(np.array(leaf)))
    return pack
