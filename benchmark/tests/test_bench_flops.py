"""The benchmark's yardstick of work: the FLOP counter against a count by
hand, and the kernels' roofline bounds against the kernel table's."""

import pytest
import torch

from benchmark.harness import flops


def _shapes(kind):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    with torch.device("meta"):
        m = CDRNet(num_layers=101) if kind == "cdr" else \
            PoseResNet(num_layers=101)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def _hand_macs_encoder(size):
    """ResNet-101's multiply-adds for one image, layer by layer."""
    s = size // 2
    macs = s * s * 64 * 3 * 49                     # stem 7x7 s2
    s //= 2                                        # max-pool
    cin = 64
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 23, 2),
                                   (512, 3, 2)):
        for i in range(blocks):
            st = stride if i == 0 else 1
            macs += s * s * planes * cin           # 1x1 at the input size
            o = s // st
            macs += o * o * planes * planes * 9    # 3x3, strided
            macs += o * o * 4 * planes * planes    # 1x1 up
            if i == 0:
                macs += o * o * 4 * planes * cin   # downsample
            s, cin = o, 4 * planes
    return macs, s


def _hand_macs_decoder(s):
    macs, cin = 0, 2048
    for _ in range(3):
        macs += s * s * cin * 256 * 16             # k4 s2 deconv, per input
        s, cin = 2 * s, 256
    return macs + s * s * 19 * 256


@pytest.mark.parametrize("batch", [1, 32, 64])
def test_cdrnet_forward_flops_match_a_hand_count(batch):
    enc, s = _hand_macs_encoder(256)
    px = s * s
    cf = (2 * px * 300 * 2048           # conv_layer1 a view
          + 2 * px * 400 * 3            # FTL by pinv(P) a view
          + px * 400 * 800 + px * 400 * 400   # conv_layer2 a sample
          + 2 * px * 300 * 4            # FTL by P a view
          + 2 * px * 2048 * 300)        # out_layer a view
    macs = batch * (2 * enc + cf + 2 * _hand_macs_decoder(s))
    assert flops.forward_flops("cdr", _shapes("cdr"), 101, batch, 256) \
        == 2 * macs


def test_poseresnet_forward_flops_match_a_hand_count():
    enc, s = _hand_macs_encoder(256)
    macs = 32 * (enc + _hand_macs_decoder(s))
    assert flops.forward_flops("2d", _shapes("2d"), 101, 32, 256) == 2 * macs


def test_resnet101_is_the_published_size():
    """7.8 GMACs at 224 px (He et al. 2016, table 1)."""
    macs, _ = _hand_macs_encoder(224)
    assert 7.5e9 < macs < 8.0e9


@pytest.mark.parametrize("fn, args, ms", [
    # the kernel table's bounds (PERF.md), ms at 64 images
    (flops.softargmax_fwd_bound_s, (64, 64, 64, 19, 2), 0.0030),
    (flops.softargmax_fwd_bound_s, (64, 64, 64, 19, 4), 0.0060),
    (flops.softargmax_bwd_bound_s, (64, 64, 64, 19, 4), 0.0119),
    (flops.softargmax_bwd_bound_s, (64, 64, 64, 19, 2), 0.0060),
    (flops.bottleneck_bound_s, (64, 64, 64, True, 64, 64), 0.0501),
    (flops.bottleneck_bound_s, (64, 512, 128, False, 32, 32), 0.0402),
    (flops.bottleneck_bound_s, (2, 64, 64, True, 64, 64), 0.0016),
    (flops.bottleneck_bound_s, (2, 512, 128, False, 32, 32), 0.0014),
])
def test_roofline_bounds_match_the_kernel_table(fn, args, ms):
    assert round(fn(*args) * 1e3, 4) == ms


def test_bottleneck_shape_follows_resnet():
    assert flops.bottleneck_shape(64) == (64, True)
    assert flops.bottleneck_shape(256) == (64, False)
    assert flops.bottleneck_shape(512) == (128, False)
