"""The port's one CUDA-graph capture: the step graphs (train/graphs.py),
the serving geometry's graphs (geometry/graphed.py) and the replay floor
(utils/profiling.py) capture through `capture`, on the device's one side
stream and into its one memory pool. A graph's outputs are read right
after its replay, before any other graph of the pool replays, since
their temporaries may share memory. A replay runs no Python, so the
counters of the kernels' wrappers (ops/) and of parallel/mesh.py, each
in CARRIED, get back from it what its capture counted.
"""

from __future__ import annotations

import functools
import weakref
from collections import Counter

import torch


class GraphCaptureError(RuntimeError):
    """A call that could not be captured into a CUDA graph."""


#: name -> a counter that a replay carries: a kernel wrapper, whose
#: `launches` attribute counts its launches, or a Counter by kind
CARRIED: dict = {}

_POOLS: dict = {}          # device -> (its memory pool, its graphs alive)


def carry(name: str, counter):
    """Add `counter` to CARRIED under `name` and return it; a kernel
    wrapper's `launches` starts at 0."""
    if not isinstance(counter, Counter):
        counter.launches = 0
    CARRIED[name] = counter
    return counter


def _get(c):
    return Counter(c) if isinstance(c, Counter) else c.launches


def _set(c, value):
    if isinstance(c, Counter):
        c.clear()
        c.update(value)
    else:
        c.launches = value


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def _pool(device: torch.device, graph):
    """The device's memory pool, which `graph` joins until it is freed.
    Once a pool's graphs are all freed, PyTorch refuses a capture into it
    while any block of it lives on (a library's workspace made during a
    capture does), so the next graph starts a new pool."""
    pool, graphs = _POOLS.get(device, (None, ()))
    if not graphs:
        pool, graphs = _POOLS[device] = (torch.cuda.graph_pool_handle(),
                                         weakref.WeakSet())
    graphs.add(graph)
    return pool


def warm_up(fn, device: torch.device):
    """fn() eagerly on the side stream of `device` (a tensor's device),
    ordered after the current stream's work and before its next."""
    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def _record(fn, args, generator):
    device = args[0].device
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # thread_local: NCCL's watchdog thread does not break the capture
    with torch.cuda.device(device), torch.cuda.graph(
            graph, pool=_pool(device, graph), stream=_side_stream(device),
            capture_error_mode="thread_local"):
        out = fn(*args)
    return graph.replay, out


def capture(fn, args, what: str, generator=None, record=None):
    """fn(*args), warmed up before (`warm_up`, or an eager call), captured
    into a CUDA graph on args[0]'s device, with `generator` (or None)
    registered: (replay, out), out fn's static result. A failure raises
    GraphCaptureError naming `what`, the counters as before. `record`
    stands in for the CUDA capture in tests: record(fn, args, generator)
    returns (replay, out), where replay() recomputes out in place."""
    before = [(c, _get(c)) for c in CARRIED.values()]
    try:
        replay, out = (record or _record)(fn, args, generator)
    except Exception as e:
        raise GraphCaptureError(
            f"capturing {what} into a CUDA graph failed: "
            f"{type(e).__name__}: {e}") from e
    finally:
        added = [(c, _get(c) - was) for c, was in before if _get(c) != was]
        for c, was in before:
            _set(c, was)

    def counted():
        replay()
        for c, n in added:
            _set(c, _get(c) + n)
    return counted, out
