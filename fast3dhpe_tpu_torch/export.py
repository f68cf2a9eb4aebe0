"""Ahead-of-time export of the serving function (torch.export). Port of
fast3dhpe_tpu/export.py.

One file carries preprocessing and forward (ImageNet normalise -> CDRNet,
fp or int8 -> soft-argmax -> DLT) with the weights in it, at a fixed batch
size:

  ep = export_cdrnet(model, state_dict, batch_size=64)
  save_exported(ep, "cdrnet101.pt2")
  ...
  serve = load_serving("cdrnet101.pt2")
  pred_2d, pred_3d = serve(img_l, img_r, proj)      # uint8 frames in

Differences from the JAX artifact, by design:
- A StableHLO artifact needs no model code. A PyTorch one needs the
  port's operators registered, since the graph calls K1
  (fast3dhpe::soft_argmax): `load_serving` imports fast3dhpe_tpu_torch.ops,
  and nothing else of the package.
- JAX's `platforms=` becomes `device=`: the graph holds no call that is
  bound to a device, because the operators dispatch on their tensors'
  device (the plain version on the CPU, the kernel on the card), so one
  artifact serves either; `load_serving` moves its weights and constants
  with torch.export.passes.move_to_device_pass.
- The eager Jacobi SVD of the DLT unrolls into the graph.
Exports run unfused (no K3), as the JAX package exports.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
from torch import nn

from .ops.warp import normalize_imagenet


class ServingModule(nn.Module):
    """(img_l, img_r) uint8 [0, 255] (B, H, W, 3) + proj (B, 2, 3, 4) ->
    (pred_2d (B, 2, J, 2), pred_3d (B, J, 3)) through `net`, a CDRNet or
    an Int8CDRNet in eval mode."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, img_l, img_r, proj):
        imgs = torch.stack([normalize_imagenet(img_l),
                            normalize_imagenet(img_r)], dim=1)
        return self.net(imgs, proj)


def make_serving_fn(model: nn.Module, state_dict) -> ServingModule:
    """The serving function of a CDRNet with these weights (export.py:27-43):
    the traced module takes any [0, 255] dtype, but export_cdrnet pins the
    signature to uint8 and load_serving refuses float frames."""
    model.load_state_dict(state_dict, strict=True)
    return ServingModule(model.eval())


def make_serving_fn_int8(pack, dlt_method: str = "jacobi") -> ServingModule:
    """The serving function of an int8 PTQ pack (models/quantized.py); its
    int8 kernels go into the artifact, ~4x smaller than an fp32 one."""
    from .models.quantized import Int8CDRNet
    return ServingModule(Int8CDRNet(pack, dlt_method).eval())


def _export(serve: ServingModule, batch_size: int, image_size, n_views: int,
            device) -> "torch.export.ExportedProgram":
    from .device import resolve_device
    dev = resolve_device(device)
    if n_views != 2:
        raise ValueError(f"CDRNet serves 2 views, got n_views={n_views}")
    H, W = int(image_size[1]), int(image_size[0])
    img = torch.zeros((batch_size, H, W, 3), dtype=torch.uint8, device=dev)
    proj = torch.zeros((batch_size, n_views, 3, 4), device=dev)
    with torch.no_grad():
        return torch.export.export(serve.to(dev), (img, img.clone(), proj))


def export_cdrnet(model: nn.Module, state_dict, batch_size: int,
                  image_size: Tuple[int, int] = (256, 256),
                  n_views: int = 2, device="cuda"):
    """Export a CDRNet's serving function at a fixed batch size, traced on
    `device` (export.py:84-99)."""
    return _export(make_serving_fn(model, state_dict), batch_size,
                   image_size, n_views, device)


def export_cdrnet_int8(pack, batch_size: int,
                       image_size: Tuple[int, int] = (256, 256),
                       n_views: int = 2, dlt_method: str = "jacobi",
                       device="cuda"):
    """export_cdrnet for an int8 pack (export.py:65-81)."""
    return _export(make_serving_fn_int8(pack, dlt_method), batch_size,
                   image_size, n_views, device)


def save_exported(exported, path: str) -> int:
    """Write the artifact (torch.export.save); returns its size in bytes."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_serving(path: str, device="cuda"):
    """Load an artifact onto `device`; returns serve(img_l, img_r, proj).

    Frames must be uint8 (the exported signature, 4x cheaper on the wire
    than fp32; a silent cast would truncate float frames) and of the
    exported batch size; both are checked before the call.
    """
    from torch.export.passes import move_to_device_pass
    from . import ops  # noqa: F401  (registers the kernels' operators)
    from .device import resolve_device
    dev = resolve_device(device)
    ep = move_to_device_pass(torch.export.load(path), dev)
    img_spec = next(s for s in ep.graph_signature.input_specs
                    if s.kind.name == "USER_INPUT")
    batch = ep.graph_module.graph.find_nodes(
        op="placeholder", target=img_spec.arg.name)[0].meta["val"].shape[0]
    fn = ep.module()

    def _as_frames(x, name):
        x = torch.as_tensor(x)
        if x.dtype != torch.uint8:
            raise TypeError(
                f"{name} must be uint8 [0,255] frames (exported "
                f"signature), got {x.dtype}; convert explicitly with "
                f"np.round(img).astype(np.uint8) if your frames are "
                f"float [0,255]")
        if x.shape[0] != batch:
            raise ValueError(f"{name} holds {x.shape[0]} frames; the "
                             f"artifact was exported at batch {batch}")
        return x.to(dev)

    def serve(img_l, img_r, proj):
        with torch.no_grad():
            return fn(_as_frames(img_l, "img_l"), _as_frames(img_r, "img_r"),
                      torch.as_tensor(proj, dtype=torch.float32).to(dev))

    serve.exported = ep
    serve.batch_size = batch
    return serve
