"""The reader of graph_launches_per_request.serve: cudaGraphLaunch calls
a request, and 0.0 (never None) on a trace that has none."""

from benchmark.harness.core import ROOT, load_module
from benchmark.harness.trace import Trace

INFO = {"flops_per_step": 1e9, "precision": "bf16", "chips": 1,
        "heatmap": (128, 64, 64, 19, 2)}


def _read():
    return load_module(ROOT / "benchmark" / "metrics"
                       / "graph_launches_per_request.serve.py").read


def test_graph_launches_a_request():
    tr = Trace([], [], {"cudaGraphLaunch": 8, "cudaLaunchKernel": 3600,
                        "cudaMemcpyAsync": 12}, 4, 1e-3, INFO)
    assert _read()(tr) == 2.0


def test_no_graph_launch_reads_zero():
    tr = Trace([], [], {"cudaLaunchKernel": 14800}, 4, 1e-3, INFO)
    got = _read()(tr)
    assert got == 0.0 and got is not None
