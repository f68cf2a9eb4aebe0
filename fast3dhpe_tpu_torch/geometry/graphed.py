"""CUDA graphs of CDRNet's geometry in inference: the projections'
pseudo-inverse and the Jacobi DLT.

Each of the two calls is ~900 and ~1,850 small kernels on 64 x 19 tiny
systems, a couple of microseconds of device time each against ~10-25 of
the host's, and the DLT ends the request with no device work left to
hide it behind. A `GraphedGeometry` belongs to one model instance and
runs each call (`run(name, fn, args, capturable)`) in one of two ways:

- eagerly, `fn(*args)` as it stands, unless every condition of
  `engages` holds: the caller's own rule (`capturable`: CDRNet in eval
  mode, and for the DLT the Jacobi method, whose kernels make no host
  sync), tensors on CUDA, autograd off (`no_grad` or `inference_mode`),
  no torch.compile or torch.export tracing, and no capture in progress
  on the current stream (a step graph of train/graphs.py);
- otherwise by shape. The key is the call's name, whether inference mode
  is on, and each input's shape, strides, dtype and device. A key's
  first call runs eagerly, which is also the warm-up a capture needs; its
  second is captured into a CUDA graph (cuda_graphs.py) from static
  copies of the inputs, then replayed; every later call copies its
  inputs into those buffers, replays, and returns a clone of the static
  output, made before any other graph of the device's pool replays. A
  shape seen once, such as a movement's last partial batch, is never
  captured. A capture that fails raises GraphCaptureError; it does not
  fall back.

`fn` is what the eager call would run, resolved by the caller when it
calls, so a capture holds whatever the geometry's modules held then: a
function replaced before a model's first calls of a shape is the one its
graphs replay. A replay runs the captured kernels on the same layouts,
so its output is bit-equal to the eager call's.

`COUNTS` counts, for the whole process as the kernels' launch counters
do: "captures", "replays", and "eager", the calls that ran eagerly on
CUDA while a graph could have engaged (each key's first call).
"""

from __future__ import annotations

from collections import Counter

import torch

from .. import cuda_graphs

COUNTS = Counter()


def _on_cuda(tensors) -> bool:
    return all(t.is_cuda for t in tensors)


def engages(capturable: bool, tensors) -> bool:
    """Whether a call may go through a graph (module docstring)."""
    return (capturable and _on_cuda(tensors)
            and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


class GraphedGeometry:
    """One model instance's geometry graphs (module docstring). `capture`
    stands in for the CUDA capture in tests (cuda_graphs.capture's
    `record`)."""

    def __init__(self, capture=None):
        self._capture = capture
        self._seen = set()
        self._graphs = {}

    def run(self, name: str, fn, args, capturable: bool = True):
        """fn(*args), eagerly or through the graph of the call's key; fn
        returns one tensor."""
        if not engages(capturable, args):
            return fn(*args)
        key = (name, torch.is_inference_mode_enabled()) + tuple(
            (tuple(a.shape), a.stride(), a.dtype, a.device) for a in args)
        g = self._graphs.get(key)
        if g is None:
            if key not in self._seen:
                self._seen.add(key)
                COUNTS["eager"] += 1
                return fn(*args)
            ins = [a.clone() for a in args]
            g = self._graphs[key] = (ins, *cuda_graphs.capture(
                fn, ins, f"the geometry's {name}", record=self._capture))
            COUNTS["captures"] += 1
        ins, replay, out = g
        for buf, a in zip(ins, args):
            buf.copy_(a)
        replay()
        COUNTS["replays"] += 1
        return out.clone()
