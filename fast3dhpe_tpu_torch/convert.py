"""Weights into the port from JAX variable trees (reference .pth files
load through train/checkpoint.py load_variables).

`jax_variables_to_state_dict` is the port's copy of
fast3dhpe_tpu/train/checkpoint.py `flax_to_torch_state_dict` (:161-251): it
maps the JAX package's {'params', 'batch_stats'} tree onto the reference's
key space (`encoder.*`, `decoder.*`, `CF.*`), which is the port's module
tree, so the result loads with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _module_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax module path -> (state-dict prefix, kind in conv/deconv/bn)."""
    root, rest = path[0], list(path[1:])
    name = rest[-1]
    if root == "encoder":
        if len(rest) == 1 and name in ("conv1", "bn1"):
            return f"encoder.{name}", "conv" if name == "conv1" else "bn"
        m = re.fullmatch(r"layer(\d)_(\d+)", rest[0])
        if m:
            block = f"encoder.layer{m.group(1)}.{m.group(2)}"
            sub = rest[1]
            if sub == "downsample_conv":
                return f"{block}.downsample.0", "conv"
            if sub == "downsample_bn":
                return f"{block}.downsample.1", "bn"
            return f"{block}.{sub}", "conv" if sub.startswith("conv") else "bn"
    elif root == "decoder":
        m = re.fullmatch(r"deconv(\d)(_bn)?", name)
        if m:
            return (f"decoder.deconv{m.group(1)}.{1 if m.group(2) else 0}",
                    "bn" if m.group(2) else "deconv")
        if name == "final_layer":
            return "decoder.final_layer", "conv"
    elif root == "CF":
        if name in ("conv_layer1", "conv_layer1_bn"):
            return (f"CF.conv_layer1.{1 if name.endswith('_bn') else 0}",
                    "bn" if name.endswith("_bn") else "conv")
        m = re.fullmatch(r"conv_layer2_(\d)(_bn)?", name)
        if m:
            idx = int(m.group(1)) * 3 + (1 if m.group(2) else 0)
            return f"CF.conv_layer2.{idx}", "bn" if m.group(2) else "conv"
        m = re.fullmatch(r"out_layer(\d)(_bn)?", name)
        if m:
            return (f"CF.out_layer.{m.group(1)}.{1 if m.group(2) else 0}",
                    "bn" if m.group(2) else "conv")
    raise KeyError(f"Unrecognized flax module path: {path}")


_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def jax_variables_to_state_dict(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} (nested dicts of arrays) -> state dict.

    Conv kernels go HWIO -> OIHW, transposed-conv kernels (kh, kw, O, I) ->
    (I, O, kh, kw); every BN gets num_batches_tracked = 0.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            arr = np.asarray(v)
            prefix, kind = _module_key(path)
            if kind == "bn":
                out[f"{prefix}.{_BN_LEAF[k]}"] = torch.tensor(arr)
            elif k == "kernel":
                out[f"{prefix}.weight"] = torch.tensor(
                    arr.transpose(3, 2, 0, 1).copy())
            elif k == "bias":
                out[f"{prefix}.bias"] = torch.tensor(arr)
            else:
                raise KeyError(path + (k,))

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    for key in [k for k in out if k.endswith("running_mean")]:
        out[key.replace("running_mean", "num_batches_tracked")] = \
            torch.tensor(0, dtype=torch.int64)
    return out

