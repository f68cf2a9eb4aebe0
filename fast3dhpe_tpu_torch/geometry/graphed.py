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
  second is captured into a CUDA graph on a side stream from static
  copies of the inputs, then replayed; every later call copies its
  inputs into those buffers, replays, and returns a clone of the static
  output, which the next call overwrites. A shape seen once, such as a
  movement's last partial batch, is never captured.

`fn` is what the eager call would run, resolved by the caller when it
calls, so a capture holds whatever the geometry's modules held then: a
function replaced before a model's first calls of a shape is the one its
graphs replay. A replay runs the captured kernels on the same layouts,
so its output is bit-equal to the eager call's.

The graphs of one instance share one memory pool. A graph's output is
cloned right after its replay, before any other graph of the pool
replays, since their temporaries may share memory. A capture that fails
raises GraphCaptureError (train/graphs.py); it does not fall back.

`COUNTS` counts, for the whole process as the kernels' launch counters
do: "captures", "replays", and "eager", the calls that ran eagerly on
CUDA while a graph could have engaged (each key's first call).
"""

from __future__ import annotations

from collections import Counter

import torch

from ..train.graphs import GraphCaptureError

COUNTS = Counter()


def _on_cuda(tensors) -> bool:
    return all(t.is_cuda for t in tensors)


def engages(capturable: bool, tensors) -> bool:
    """Whether a call may go through a graph (module docstring)."""
    return (capturable and _on_cuda(tensors)
            and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


class _Graph:
    def __init__(self, ins, replay, out):
        self.ins, self.replay, self.out = ins, replay, out

    def __call__(self, args):
        for buf, a in zip(self.ins, args):
            buf.copy_(a)
        self.replay()
        COUNTS["replays"] += 1
        return self.out.clone()


class GraphedGeometry:
    """One model instance's geometry graphs (module docstring). `capture`
    stands in for the CUDA capture in tests: capture(fn, static_inputs)
    returns (replay, static output), where replay() recomputes the
    output in place."""

    def __init__(self, capture=None):
        self._capture = capture or self._cuda_capture
        self._seen = set()
        self._graphs = {}
        self._pool = None
        self._streams = {}

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
            g = self._graphs[key] = self._make(name, fn, args)
        return g(args)

    def _make(self, name, fn, args):
        ins = [a.clone() for a in args]
        try:
            replay, out = self._capture(fn, ins)
        except Exception as e:
            raise GraphCaptureError(
                f"capturing the geometry's {name} into a CUDA graph failed: "
                f"{type(e).__name__}: {e}") from e
        COUNTS["captures"] += 1
        return _Graph(ins, replay, out)

    def _cuda_capture(self, fn, ins):
        dev = ins[0].device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (NCCL's watchdog under
        # a mesh) do not break this thread's capture
        with torch.cuda.device(dev), torch.cuda.graph(
                graph, pool=self._pool, stream=self._streams[dev],
                capture_error_mode="thread_local"):
            out = fn(*ins)
        return graph.replay, out
