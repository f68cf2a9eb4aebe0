"""Each per-layer metric's reader on a synthetic trace, and the trace's
reduction (busy union, breakdown)."""

import json

import pytest

from benchmark.harness import flops
from benchmark.harness.core import ROOT, load_module
from benchmark.harness.trace import Op, Trace, breakdown

K1_64 = flops.softargmax_fwd_bound_s(64, 64, 64, 19, 4)
K2_64 = flops.softargmax_bwd_bound_s(64, 64, 64, 19, 4)


def _trace():
    """Two steps over a 1 ms window (times in us): a conv kernel on each,
    NCCL overlapping the second, K1 and K2 once each, two K3 launches
    with their operators."""
    kernels = [
        Op("sm90_xmma_fprop_implicit_gemm", 0, 200),
        Op("softargmax_fwd_kernel", 200, 210),
        Op("ncclDevKernel_AllReduce", 250, 400),
        Op("cudnn::bn_fw", 300, 450),
        Op("softargmax_bwd_kernel", 500, 520),
        Op("bottleneck_kernel<8, 16>", 600, 700),
        Op("bottleneck_kernel<8, 16>", 700, 750),
    ]
    cpu = [Op("fast3dhpe::fused_bottleneck", 590, 600, [[64, 64, 64, 64]]),
           Op("fast3dhpe::fused_bottleneck", 690, 700, [[64, 512, 32, 32]]),
           Op("aten::conv2d", 0, 10), Op("python_step", 450, 600)]
    info = {"flops_per_step": 1e9, "precision": "fp32", "chips": 1,
            "heatmap": (64, 64, 64, 19, 4)}
    return Trace(kernels, cpu, {"cudaGraphLaunch": 2, "cudaLaunchKernel": 4},
                 2, 1e-3, info)


def read(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read


def test_busy_is_the_union_of_spans():
    tr = _trace()
    assert tr.busy_intervals() == [(0, 210), (250, 450), (500, 520),
                                   (600, 750)]
    assert tr.busy_s() == pytest.approx(580e-6)


@pytest.mark.parametrize("name", ["device_idle_pct.train",
                                  "device_idle_pct.serve"])
def test_idle(name):
    assert read(name)(_trace()) == pytest.approx(42.0)


@pytest.mark.parametrize("name", ["mfu_pct.train", "mfu_pct.serve"])
def test_mfu(name):
    assert read(name)(_trace()) == pytest.approx(100 * 2e9 / (1e-3 * 67e12))


@pytest.mark.parametrize("name", ["host_launches_per_step.train",
                                  "host_launches_per_request.serve"])
def test_launches(name):
    assert read(name)(_trace()) == 3.0


@pytest.mark.parametrize("name", ["conv_ms_per_step.train",
                                  "conv_ms_per_request.serve"])
def test_conv_ms(name):
    # the xmma kernel and cuDNN's: 200 + 150 us over 2 steps
    assert read(name)(_trace()) == pytest.approx(0.175)


@pytest.mark.parametrize("name", ["k1_roofline.train", "k1_roofline.serve"])
def test_k1_roofline(name):
    assert read(name)(_trace()) == pytest.approx(100 * K1_64 / 10e-6)


def test_k2_roofline():
    assert read("k2_roofline.train")(_trace()) == pytest.approx(
        100 * K2_64 / 20e-6)


def test_k3_roofline_takes_each_launch_shape():
    want = (flops.bottleneck_bound_s(64, 64, 64, True, 64, 64)
            + flops.bottleneck_bound_s(64, 512, 128, False, 32, 32))
    assert read("k3_roofline.serve")(_trace()) == pytest.approx(
        100 * want / 150e-6)


def test_readers_find_nothing_and_say_so():
    """No launch of the kernel, or a K3 launch whose operator the trace
    lacks (a graph replay): None, never 0."""
    tr = _trace()
    bare = Trace([k for k in tr.kernels if "softargmax" not in k.name],
                 [], tr.launches, 2, 1e-3, tr.info)
    for name in ("k1_roofline.train", "k2_roofline.train",
                 "k3_roofline.serve"):
        assert read(name)(bare) is None


def test_breakdown_names_ops_and_gaps():
    b = breakdown(_trace())
    assert b["device_ops"][0] == ["sm90_xmma_fprop_implicit_gemm", 200e-6]
    assert len(b["device_ops"]) == 6
    gaps = dict(b["idle_gaps"])
    # 210-250 under no host op; 450-500 and 520-600 under python_step
    assert gaps["python_step"] == pytest.approx(130e-6)
    assert gaps["no host operation"] == pytest.approx(40e-6)


def test_every_per_layer_metric_has_a_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert callable(read(m["name"]))
