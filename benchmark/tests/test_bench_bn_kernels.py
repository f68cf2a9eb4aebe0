"""The train BN engagement counter (metrics/bn_kernels_per_step.train.py) on
synthetic traces: n / steps where the kernels ran, 0 where train BN ran as
eager ATen kernels; and the kernels' names, as the profiler gives them,
caught by no convolution or soft-argmax reader."""

import json

import pytest

from benchmark.harness.core import ROOT, load_module
from benchmark.harness.trace import Op, Trace

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "bn_kernels_per_step.train"
TRAINING = [w["name"] for w in SPEC["workloads"]
            if w["traffic"].startswith("train")]
# the profiler's names of one layer's launches, forward and backward
LAYER = ["void (anonymous namespace)::train_bn_stats<float, 4, 0>"
         "(float const*, float const*, (anonymous namespace)::Plan, float*)",
         "void (anonymous namespace)::train_bn_finish(float const*, int, "
         "int, float const*, int, int, float const*, float*, float*, "
         "float*)",
         "void (anonymous namespace)::train_bn_norm<float, 4, 0>"
         "(float const*, float const*, float const*, float const*, float, "
         "(anonymous namespace)::Plan, float*, float*, float*, float*, "
         "unsigned char*)",
         "void (anonymous namespace)::train_bn_grad_reduce<float, 4, 1>"
         "(float const*, float const*, float const*, "
         "(anonymous namespace)::Plan, float*)",
         "void (anonymous namespace)::train_bn_finish(float const*, int, "
         "int, float const*, int, int, float const*, float*, float*, "
         "float*)",
         "void (anonymous namespace)::train_bn_grad<__nv_bfloat16, 8, 0>"
         "(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
         "float const*, float const*, float const*, float const*, "
         "float const*, unsigned char const*, (anonymous namespace)::Plan, "
         "__nv_bfloat16*)"]
EAGER = ["void at::native::elementwise_kernel<128, 2>(int, F)",
         "void at::native::reduce_kernel<128, 4>(R)",
         "void at::native::vectorized_elementwise_kernel<4>(int, F, A)"]


def read(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read


def _trace(names, steps):
    kernels = [Op(n, 10 * i, 10 * i + 5) for i, n in enumerate(names)]
    return Trace(kernels, [], {"cudaGraphLaunch": steps}, steps, 1e-3,
                 {"heatmap": (64, 64, 64, 19, 4)})


@pytest.mark.parametrize("layers,steps", [(1, 1), (112, 8), (3, 4)])
def test_counts_the_kernels_a_step(layers, steps):
    tr = _trace(LAYER * layers * steps + EAGER * steps, steps)
    assert read(NAME)(tr) == pytest.approx(6 * layers)


def test_reads_zero_where_train_bn_runs_eagerly():
    assert read(NAME)(_trace(EAGER * 40, 8)) == 0


def test_no_other_reader_takes_the_kernels():
    """Neither the convolutions' reader nor K1's or K2's reads a train_bn_
    kernel: the time they report does not move with this layer."""
    tr = _trace(LAYER * 10, 2)
    assert read("conv_ms_per_step.train")(tr) == 0
    assert read("k1_roofline.train")(tr) is None
    assert read("k2_roofline.train")(tr) is None


def test_the_metric_is_declared_for_the_training_cells():
    entry = [m for m in SPEC["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1
    assert entry[0]["layer"] == "Train BN"
    assert entry[0]["moves"] == "train_images_per_s"
    assert entry[0]["workloads"] == TRAINING
    assert len(TRAINING) == 5
