"""Seeded weights and inputs, made on the device in a few large calls.

The weights follow the initialisers of the reference checkpoints' JAX
training code: He-normal (fan-in) convolutions, N(0, 0.001) transposed
convolutions and heatmap head, zero biases, identity BN (weight 1, bias 0,
running mean 0, running variance 1). All normal draws come from one call
of a generator on the device, scaled leaf by leaf in one multiply.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence((seed,) + path).generate_state(
        1, np.uint64)[0] >> 1)


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _std(name: str, shape) -> float:
    if len(shape) != 4:
        return 0.0
    if ".deconv" in name or name.startswith("decoder.final_layer"):
        return 0.001
    return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))


def seeded_state_dict(shapes, device, seed: int):
    """{name: shape} as a module's state dict lists them -> the seeded
    state dict on `device`, fp32 (the running statistics fp32, the BN
    counters int64)."""
    names = [k for k, s in shapes.items() if len(s) == 4]
    sizes = [int(np.prod(shapes[k])) for k in names]
    stds = torch.tensor([_std(k, shapes[k]) for k in names], device=device)
    flat = torch.randn(sum(sizes), generator=generator(device, seed),
                       device=device)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(sizes,
                                                         device=device)))
    out = dict(zip(names, (t.view(shapes[k]) for k, t in
                           zip(names, flat.split(sizes)))))
    for k, s in shapes.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
        elif k.endswith(("running_var",)) or (k.endswith(".weight")
                                             and len(s) == 1):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def calibrate_head(state_dict, logits):
    """Scale the heatmap head so that `logits`, which it produced, have
    unit spread: the N(0, 0.001) head decodes every view to the heatmap
    centre, where the stereo rays are parallel and the DLT degenerates."""
    scale = 1.0 / float(logits.float().std())
    state_dict["decoder.final_layer.weight"].mul_(scale)
    return scale
