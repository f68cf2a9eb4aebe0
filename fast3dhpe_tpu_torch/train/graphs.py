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

1. its first step runs eagerly on a side stream. It is a real step of
   the epoch, and it warms the variant up: K1, K2 and the train BN
   kernels are built (ops/_build.py), K1 and K2 set their shared-memory
   attributes, the
   optimizer's state exists, cuDNN has chosen its algorithms;
2. its next step is captured into a CUDA graph (torch.cuda.graph on the
   same side stream), which the capture does not run;
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
- launch counters: the kernels' wrappers count in Python, which a replay
  does not run. A graph keeps the counts that its capture added (and
  takes them back, since a capture launches nothing) and adds them at
  each replay.
- outputs: the step's metrics, static tensors, added into the epoch's
  sums after each replay (one foreach launch).

Under a process group (`mesh=`, parallel/mesh.py) the choice is the
backend's, made once when the epoch function is built and exposed as
`graphed`: under NCCL the steps are captured with their collectives (the
row counts, every BN's forward and backward reduction, the gradient and
the metrics), which each replay runs; under gloo, which runs its
collectives through the host (ranks sharing a card, or the CPU), a step
cannot be captured and every step runs eagerly. The eager first step
forms the communicators of the groups the step uses, which a capture
needs (parallel/mesh.py refuses a captured collective on a group that
ran none eagerly). The collective counters (mesh.COUNTS, COUNTS_BYTES)
are treated as the launch counters are. After each capture every rank
reports its outcome in one eager collective over the world, so that a
capture that failed on one rank raises GraphCaptureError on all of
them, naming it, instead of leaving the others to replay into a wait.

All graphs of a device share one memory pool. A graph's outputs are read
right after its replay, before any other graph of the pool replays,
since their temporaries may share memory. A variant is captured anew for
another TrainState, after its optimizer state was loaded
(TrainState.version), or for stacked tensors of other shapes.

A capture that fails raises GraphCaptureError, which
train/resilience.py does not retry.
"""

from __future__ import annotations

import time
from collections import Counter

import torch
import torch.distributed as dist

from ..parallel import mesh as pmesh


class GraphCaptureError(RuntimeError):
    """A step that could not be captured into a CUDA graph."""


def _counters():
    from ..ops.batchnorm import train_bn_backward, train_bn_forward
    from ..ops.bottleneck import fused_bottleneck
    from ..ops.softargmax import soft_argmax_bwd_fused, soft_argmax_fused
    return (soft_argmax_fused, soft_argmax_bwd_fused, fused_bottleneck,
            train_bn_forward, train_bn_backward)


_POOLS = {}


def _pool(device: torch.device):
    """The memory pool that every graph on `device` captures into."""
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _POOLS[device]


def check_device(device) -> torch.device:
    """The device as a torch.device; a CUDA device raises where CUDA is
    not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"graphs: {device} asked for, but "
                           f"torch.cuda.is_available() is False")
    return device


def _signature(xs):
    return tuple((k, tuple(v.shape), v.dtype) for k, v in xs.items())


def _accumulate(sums, metrics, keys):
    for k in keys:
        sums[k] = sums[k] + metrics[k] if k in sums else metrics[k]
    return sums


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


class _Graph:
    def __init__(self, graph, outs, feed, gen, counts, collectives, owner):
        self.graph, self.outs, self.feed, self.gen = graph, outs, feed, gen
        self.counts, self.owner = counts, owner
        # the collectives (by kind) and their bytes that a replay runs
        self.collectives = collectives

    def replay(self):
        self.graph.replay()
        for c, n in zip(_counters(), self.counts):
            c.launches += n
        for total, n in zip((pmesh.COUNTS, pmesh.COUNTS_BYTES),
                            self.collectives):
            total.update(n)


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
        self._stream = None
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
        check_device(dev)
        full = (key, _ids(owner), getattr(owner, "version", 0),
                 _signature(xs))
        g = self._graphs.get(full)
        if g is not None and not _same(g.owner, owner):
            g = None
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        sums, i = None, 0
        if g is None and not _same(self._warmed.get(full), owner):
            m = self._warm_up(xs, fn, state, seeds, dev)
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
            x = {k: v[i] for k, v in xs.items()}
            gen = None
            if seeds is not None:
                dev = next(iter(xs.values())).device
                gen = torch.Generator(device=dev).manual_seed(seeds[i])
            m = fn(x, gen, None if state is None else state.apply_gradients)
            self._seen(m)
            _accumulate(sums, m, sum_keys or m)
        return sums

    def _warm_up(self, xs, fn, state, seeds, dev):
        """Step 0 of the epoch, eagerly on the capture's side stream."""
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            gen = None
            if seeds is not None:
                gen = torch.Generator(device=dev).manual_seed(seeds[0])
            m = fn({k: v[0] for k, v in xs.items()}, gen,
                   None if state is None else state.apply_gradients)
        cur.wait_stream(self._stream)
        return m

    def _capture(self, full, owner, xs, fn, state, with_gen, dev):
        t0 = time.perf_counter()
        feed = _Feed(xs)
        gen = torch.Generator(device=dev) if with_gen else None
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        counters = _counters()
        before = [c.launches for c in counters]
        totals = (pmesh.COUNTS, pmesh.COUNTS_BYTES)
        kept = [Counter(t) for t in totals]
        err = None
        try:
            # thread_local: NCCL's watchdog thread queries its events
            # while this thread captures
            with torch.cuda.graph(graph, pool=_pool(dev), stream=self._stream,
                                  capture_error_mode="thread_local"):
                m = fn(feed.row(), gen,
                       None if state is None else state.optimizer.step)
                feed.counter.add_(1)
        except Exception as e:
            err = e
        finally:
            counts = [c.launches - b for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.launches = b
            collectives = [t - k for t, k in zip(totals, kept)]
            for t, k in zip(totals, kept):
                t.clear()
                t.update(k)
        failed = [0] if err is not None else []
        if self.mesh is not None:
            rows = pmesh.world_rows(self.mesh, [err is not None], "capture")
            failed = [r for r, (f,) in enumerate(rows.tolist()) if f]
        if failed:
            where = "" if self.mesh is None else f" on rank(s) {failed}"
            said = "" if err is None else f": {type(err).__name__}: {err}"
            raise GraphCaptureError(
                f"capturing the step {full[0]} into a CUDA graph failed"
                f"{where}{said}") from err
        self.capture_s += time.perf_counter() - t0
        return _Graph(graph, dict(m), feed, gen, counts, collectives, owner)
