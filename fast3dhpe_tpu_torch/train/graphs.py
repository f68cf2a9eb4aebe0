"""CUDA graphs of the train and eval steps: the port's form of the JAX
package's jitted step inside a lax.scan (fast3dhpe_tpu/train/steps.py
:257-266), which train/steps.py's stacked epochs and segments run.

An epoch of S steps calls `fn(x, gen, update)` on each row x of its
stacked (S, ...) device tensors: gen is the step's occlusion generator
(or None), update the optimizer update (None in eval). On the CPU, and
on CUDA with graphed=False, every step runs eagerly, with a fresh
generator seeded with the step's seed and update =
TrainState.apply_gradients. On CUDA by default a variant (the caller's
key: train or eval, use_3d, the frames) goes through three stages:

1. its first step runs eagerly on the device's capture side stream
   (cuda_graphs.warm_up). It is a real step of the epoch, and it warms
   the variant up: K1, K2 and the train BN kernels are built
   (ops/_build.py), K1 and K2 set their shared-memory attributes, the
   optimizer's state exists, cuDNN has chosen its algorithms;
2. its next step is captured into a CUDA graph (cuda_graphs.capture),
   which the capture does not run;
3. that step and every later one of the variant is a replay.

What the capture holds, and what the host does around a replay:
- inputs: a static copy of the epoch's stacked tensors on the device and
  a device step counter (`_Feed`). The graph reads row `counter`
  (index_select) and adds one to it. The host copies an epoch in, and
  sets the counter, once an epoch.
- occlusion: one generator registered with the graph
  (CUDAGraph.register_generator_state) and seeded with the step's seed
  before each replay; a replay then draws what a fresh generator with
  that seed draws, which is what steps.step_generator gives the eager
  step.
- the update: only `optimizer.step()` is captured. The host writes the
  LR of the update's index before the replay (TrainState.set_lr: Adam is
  capturable on CUDA, its LR a device tensor) and counts the update
  after, as TrainState.apply_gradients does eagerly.
- outputs: the step's metrics, static tensors, added into the epoch's
  sums after each replay (one foreach launch), before the next replay,
  as the graphs of the device's one memory pool must be read.

Under a process group (`mesh=`, parallel/mesh.py) the choice is the
backend's, made once when the epoch function is built and exposed as
`graphed`: under NCCL the steps are captured with their collectives (the
row counts, every BN's forward and backward reduction, the gradient and
the metrics), which each replay runs; under gloo, which runs its
collectives through the host (ranks sharing a card, or the CPU), a step
cannot be captured and every step runs eagerly. The eager first step
forms the communicators of the groups the step uses, which a capture
needs (parallel/mesh.py refuses a captured collective on a group that
ran none eagerly). After each capture every rank reports its outcome in
one eager collective over the world, so that a capture that failed on
one rank raises GraphCaptureError on all of them, naming it, instead of
leaving the others to replay into a wait.

A variant is captured anew for another TrainState, after its optimizer
state was loaded (TrainState.version), or for stacked tensors of other
shapes.
"""

from __future__ import annotations

import time
from collections import namedtuple

import torch
import torch.distributed as dist

from .. import cuda_graphs
from ..cuda_graphs import GraphCaptureError
from ..device import resolve_device
from ..parallel import mesh as pmesh


def _eager_step(xs, fn, state, seeds, i):
    """Step i of the epoch, eagerly (module docstring)."""
    gen = None
    if seeds is not None:
        dev = next(iter(xs.values())).device
        gen = torch.Generator(device=dev).manual_seed(seeds[i])
    return fn({k: v[i] for k, v in xs.items()}, gen,
              None if state is None else state.apply_gradients)


class _Feed:
    """Static device copies of an epoch's stacked tensors and a step
    counter, which a graph reads."""

    def __init__(self, xs):
        self.bufs = {k: torch.empty_like(v) for k, v in xs.items()}
        dev = next(iter(xs.values())).device
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)

    def load(self, xs, first: int):
        for k, b in self.bufs.items():
            b.copy_(xs[k])
        self.counter.fill_(first)

    def row(self):
        return {k: b.index_select(0, self.counter)[0]
                for k, b in self.bufs.items()}


def _ids(owner):
    return tuple(map(id, owner)) if isinstance(owner, tuple) else id(owner)


def _same(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(x is y for x, y in zip(a, b))
    return a is b


_Graph = namedtuple("_Graph", "replay outs feed gen owner")


class StepGraphs:
    """The captured variants of one epoch function (module docstring).
    graphed=False runs every step eagerly on CUDA too; under a mesh
    whose backend is not NCCL the steps run eagerly whatever graphed
    says (`graphed` then reads False, and `backend` names it)."""

    def __init__(self, graphed: bool = True, mesh=None):
        self.mesh = mesh
        self.backend = None if mesh is None else dist.get_backend(mesh.group)
        self.graphed = graphed and self.backend in (None, "nccl")
        self._graphs = {}
        self._warmed = {}          # variant -> the owner it warmed up for
        self.capture_s = 0.0       # seconds spent capturing, all variants
        # called with each step's metrics (device tensors, valid until the
        # next step) where set: a measurement's hook, None in the loops
        self.on_step = None

    def epoch(self, key, owner, xs, fn, state=None, seeds=None,
              sum_keys=None):
        """Run one step a row of xs, a dict of (S, ...) device tensors, and
        return the steps' metrics summed on the device (sum_keys, or all
        of them). owner: what the step reads and writes besides xs (a
        TrainState, or a tuple of objects), which a graph holds and is
        replayed only for; state: the TrainState of a train epoch (its LR
        before each update and its count after), None in eval; seeds: the
        steps' occlusion seeds, or None for no generator."""
        first = next(iter(xs.values()))
        dev = first.device
        n = first.shape[0]
        if dev.type != "cuda" or not self.graphed or n == 0:
            return self._eager(xs, fn, state, seeds, sum_keys, n)
        resolve_device(dev)
        full = (key, _ids(owner), getattr(owner, "version", 0),
                tuple((k, tuple(v.shape), v.dtype) for k, v in xs.items()))
        g = self._graphs.get(full)
        if g is not None and not _same(g.owner, owner):
            g = None
        sums, i = None, 0
        if g is None and not _same(self._warmed.get(full), owner):
            m = cuda_graphs.warm_up(
                lambda: _eager_step(xs, fn, state, seeds, 0), dev)
            self._seen(m)
            sums = {k: m[k].clone() for k in sum_keys or m}
            self._warmed[full] = owner
            i = 1
        if i == n:
            return sums
        if g is None:
            g = self._capture(full, owner, xs, fn, state, seeds is not None,
                              dev)
            self._graphs[full] = g
        keys = list(sum_keys or g.outs)
        g.feed.load(xs, i)
        for j in range(i, n):
            if g.gen is not None:
                g.gen.manual_seed(seeds[j])
            if state is not None:
                state.set_lr()
            g.replay()
            if state is not None:
                state.step += 1
            self._seen(g.outs)
            if sums is None:
                sums = {k: g.outs[k].clone() for k in keys}
            else:
                torch._foreach_add_([sums[k] for k in keys],
                                    [g.outs[k] for k in keys])
        return sums

    def _seen(self, m):
        if self.on_step is not None:
            self.on_step(m)

    def _eager(self, xs, fn, state, seeds, sum_keys, n):
        sums = {}
        for i in range(n):
            m = _eager_step(xs, fn, state, seeds, i)
            self._seen(m)
            for k in sum_keys or m:
                sums[k] = sums[k] + m[k] if k in sums else m[k]
        return sums

    def _capture(self, full, owner, xs, fn, state, with_gen, dev):
        t0 = time.perf_counter()
        feed = _Feed(xs)
        gen = torch.Generator(device=dev) if with_gen else None
        update = None if state is None else state.optimizer.step

        def step(counter):
            m = fn(feed.row(), gen, update)
            counter.add_(1)
            return m
        err = None
        try:
            replay, m = cuda_graphs.capture(step, (feed.counter,),
                                            f"the step {full[0]}", gen)
        except GraphCaptureError as e:
            err = e
        if self.mesh is not None:
            rows = pmesh.world_rows(self.mesh, [err is not None], "capture")
            failed = [r for r, (f,) in enumerate(rows.tolist()) if f]
            if failed:
                cause = err and err.__cause__
                said = "" if err is None else \
                    f": {type(cause).__name__}: {cause}"
                raise GraphCaptureError(
                    f"capturing the step {full[0]} into a CUDA graph failed"
                    f" on rank(s) {failed}{said}") from cause
        if err is not None:
            raise err
        self.capture_s += time.perf_counter() - t0
        return _Graph(replay, dict(m), feed, gen, owner)
