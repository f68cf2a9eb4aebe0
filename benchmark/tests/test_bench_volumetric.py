"""The volumetric cell's driver (drivers/train_vol.py), its reference's
FLOP count and the unprojection's reader, on the CPU.

The driver runs at ResNet-50, 64 px, a 32^3 cuboid and 2 pairs. There the
V2V's deepest blocks hold one voxel, whose train-mode BN over 2 values
passes a gradient of rounding noise (tests/test_torch_volumetric.py), so
these runs hold the losses, which that BN does not blur, and the change,
against a fault; the gradients are held at the cell's own size, where the
deepest BN takes 80 values (and by the harness's tiny run at 64^3)."""

import json

import pytest
import torch

from benchmark.harness import core
from benchmark.harness.core import ROOT, load_module
from benchmark.harness.trace import Op, Trace
from benchmark.reference import volumetric as rv
from benchmark.tests import faults
from benchmark.tests.tiny import make_root

torch.set_num_threads(2)
CELL = "ltvol152.train-fp32-b10"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("vol"))
    f = root / "benchmark" / "configs" / "ltvol152-mads3d-384.json"
    c = json.loads(f.read_text())
    c["MODEL"]["EXTRA"]["VOLUME_SIZE"] = 32
    f.write_text(json.dumps(c))
    return root


def _readings(root, seed=2 ** 32 + 5):
    drv = core.Cell(CELL, root).driver(seed, torch.device("cpu"))
    drv.setup()
    drv.run_for(0.1)
    drv.release()
    return drv, drv.readings()


def test_the_driver_follows_the_reference(root):
    drv, r = _readings(root)
    assert r["loss_gap"] < 1e-3 and r["replay_loss_gap"] < 1e-3, r
    assert r["change_gap"] < 0.5, r
    info = drv.trace_info("fp32")
    assert info["heatmap"] == (2, 32 * 32, 32, 19, 4)
    assert info["flops_per_step"] > 0


def test_a_state_left_unchanged_is_caught(root, monkeypatch):
    faults.state_unchanged(monkeypatch.setattr)
    _, r = _readings(root)
    assert r["change_gap"] > 0.9, r


def test_the_cells_forward_flops():
    """ResNet-152 at 384 px on 20 crops, its deconvolutions, the 1x1 to 32
    and the V2V at 64^3 on 10 pairs: 4.49 TFLOP, the V2V 296 GFLOP a pair
    and its 7^3 convolution 92."""
    from fast3dhpe_tpu_torch.models.volumetric import VolumetricNet
    with torch.device("meta"):
        m = VolumetricNet(num_layers=152)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert rv.forward_flops(shapes, 152, 10, 384, 64) == pytest.approx(
        4.488e12, rel=1e-3)
    params = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    ops = rv.Ops(params, params)
    rv.v2v(ops, torch.empty((1, 32, 64, 64, 64), device="meta"))
    assert ops.flops == pytest.approx(296.3e9, rel=1e-3)
    ops = rv.Ops(params, params)
    ops.conv3d(torch.empty((1, 32, 64, 64, 64), device="meta"),
               "volume_net.front_layers.0.block.0", 3)
    assert ops.flops == 2 * 16 * 64 ** 3 * 32 * 7 ** 3


def _trace(names):
    kernels = [Op(n, 100 * i, 100 * i + 50) for i, n in enumerate(names)]
    return Trace(kernels, [], {}, 2, 1e-3, {})


def test_the_unprojection_reader_on_recorded_kernel_names():
    read = load_module(ROOT / "benchmark" / "metrics" /
                       "unproject_ms_per_step.train.py").read
    # the names of a traced step of the cell on an H100 (cuDNN's sampler)
    card = _trace([
        "void cudnn::bilinear_sampler_fw_4d<float, float>(cudnnTensorStruct,"
        " float const*, float const*, cudnnTensorStruct, float",
        "void cudnn::bilinear_sampler_bw_4d<float, float>(cudnnTensorStruct,"
        " float const*, cudnnTensorStruct, float*, cudnnTensorStruct",
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"])
    assert read(card) == pytest.approx(0.05)      # 2 x 50 us over 2 steps
    aten = _trace(["void at::native::grid_sampler_2d_kernel<float, int>",
                   "void at::native::grid_sampler_2d_backward_kernel<float>"])
    assert read(aten) == pytest.approx(0.05)
    # a 2D cell's step has no sampler: nothing to read
    assert read(_trace([
        "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>",
        "softargmax_fwd_kernel"])) is None
