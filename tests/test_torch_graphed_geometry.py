"""CDRNet's geometry through CUDA graphs (geometry/graphed.py).

On the CPU: where the rule keeps a call eager (CPU tensors, autograd on,
train mode or a method that syncs, a capture in progress), it equals
pinv_projection / dlt_triangulate and nothing is counted; the per-shape
rule (first call eager, second captured, then replays; a new shape starts
over) through a stand-in for the capture, since no CPU test can hold a
graph; and CDRNet's wiring of its own rule.

On the card (`card`, skips without one): the graphed pinv and pred_3d
bit-equal to the eager geometry at 1, 32 and 64 pairs, new inputs after
a capture giving new answers, two calls' outputs not aliasing, and a
geometry fault planted before a new model's first call reaching its
graphs. This file imports no JAX; on the card:

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_graphed_geometry.py
"""

import pytest
import torch

from benchmark.harness.scene import converging_rig
from fast3dhpe_tpu_torch.geometry import graphed
from fast3dhpe_tpu_torch.geometry.graphed import COUNTS, GraphedGeometry
from fast3dhpe_tpu_torch.geometry.triangulation import (dlt_triangulate,
                                                        pinv_projection)
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet

torch.set_num_threads(2)

J, SIZE = 19, 64


def _projs(pairs, device="cpu", shift=0.0):
    P = torch.as_tensor(converging_rig(SIZE, SIZE)[:, :3], dtype=torch.float32)
    P = P + shift * torch.linspace(0.0, 1.0, 12).reshape(3, 4)
    return P.expand(pairs, 2, 3, 4).contiguous().to(device)


def _kp(pairs, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((pairs, 2, J, 2), generator=g) * SIZE).to(device)


def _dlt(projs, kp):
    B = kp.shape[0]
    return dlt_triangulate(projs[:, None].expand(B, J, 2, 3, 4),
                           kp.transpose(1, 2))


def _stand_in(log):
    """A capture that records itself and recomputes on replay."""
    def capture(fn, ins):
        log.append(tuple(tuple(x.shape) for x in ins))
        out = fn(*ins)
        return (lambda: out.copy_(fn(*ins))), out
    return capture


def _as_if_cuda(monkeypatch, capturing=False):
    """The tensors read as CUDA tensors, and the stream as capturing or
    not: this host has no CUDA to ask."""
    monkeypatch.setattr(graphed, "_on_cuda", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)


def _counts():
    return {k: COUNTS[k] for k in ("captures", "replays", "eager")}


def _diff(before):
    return {k: v - before[k] for k, v in _counts().items()}


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("case", ["cpu", "grad", "not_capturable",
                                  "capturing"])
def test_eager_where_the_rule_says_so(monkeypatch, case):
    """Every call runs the eager function, whatever the number of calls:
    on CPU tensors; with CUDA tensors (mocked) under autograd, for a
    caller that is not capturable (train mode), or while a capture is in
    progress (mocked)."""
    if case != "cpu":
        _as_if_cuda(monkeypatch, capturing=case == "capturing")
    log = []
    geo = GraphedGeometry(capture=_stand_in(log))
    before = _counts()
    with torch.set_grad_enabled(case == "grad"):
        for i in range(3):
            projs, kp = _projs(4, shift=float(i)), _kp(4, i)
            ok = case != "not_capturable"
            got = geo.run("pinv", pinv_projection, (projs,), ok)
            assert torch.equal(got, pinv_projection(projs))
            got = geo.run("dlt", _dlt, (projs, kp), ok)
            assert torch.equal(got, _dlt(projs, kp))
    assert log == [] and _diff(before) == {"captures": 0, "replays": 0,
                                           "eager": 0}


def test_per_shape_rule(monkeypatch):
    """A key's first call is eager, its second captures and replays, its
    third replays; every call answers its own inputs, in a tensor of its
    own; another shape, or inference mode, is another key."""
    _as_if_cuda(monkeypatch)
    log = []
    geo = GraphedGeometry(capture=_stand_in(log))
    before = _counts()
    outs = []
    with torch.no_grad():
        for i, want in enumerate([
                {"captures": 0, "replays": 0, "eager": 1},
                {"captures": 1, "replays": 1, "eager": 1},
                {"captures": 1, "replays": 2, "eager": 1}]):
            projs, kp = _projs(4, shift=float(i)), _kp(4, i)
            out = geo.run("dlt", _dlt, (projs, kp))
            assert torch.equal(out, _dlt(projs, kp))
            assert _diff(before) == want
            outs.append(out)
        assert log == [((4, 2, 3, 4), (4, 2, J, 2))]
        # the replays' outputs are the callers' own: the third call left
        # the second's answer as it was
        assert outs[1].data_ptr() != outs[2].data_ptr()
        assert torch.equal(outs[1], _dlt(_projs(4, shift=1.0), _kp(4, 1)))
        assert not torch.equal(outs[1], outs[2])
        # a new shape starts over
        projs, kp = _projs(2), _kp(2, 7)
        assert torch.equal(geo.run("dlt", _dlt, (projs, kp)),
                           _dlt(projs, kp))
        assert _diff(before)["eager"] == 2 and len(log) == 1
    with torch.inference_mode():
        projs = _projs(4)
        for _ in range(2):
            assert torch.equal(geo.run("pinv", pinv_projection, (projs,)),
                               pinv_projection(projs))
        assert _diff(before) == {"captures": 2, "replays": 3, "eager": 3}
    assert log[-1] == ((4, 2, 3, 4),)


def test_a_failed_capture_raises(monkeypatch):
    """A capture that fails raises GraphCaptureError naming the call; the
    next call of the key tries again, and nothing falls back."""
    from fast3dhpe_tpu_torch.train.graphs import GraphCaptureError
    _as_if_cuda(monkeypatch)

    def refuse(fn, ins):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    geo = GraphedGeometry(capture=refuse)
    projs = _projs(4)
    with torch.no_grad():
        geo.run("pinv", pinv_projection, (projs,))
        for _ in range(2):
            with pytest.raises(GraphCaptureError, match="pinv.*capturing"):
                geo.run("pinv", pinv_projection, (projs,))


def _tiny_cdrnet(dlt_method="jacobi"):
    torch.manual_seed(0)
    return CDRNet(num_joints=J, num_layers=18, dlt_method=dlt_method)


def _images(pairs, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((pairs, 2, SIZE, SIZE, 3), generator=g).to(device)


@pytest.mark.parametrize("case", ["eval", "train", "svd"])
def test_cdrnet_wires_its_rule(monkeypatch, case):
    """CDRNet in eval mode without autograd sends both calls through its
    geometry; in train mode neither; with the svd DLT, which syncs with
    the host, the pinv alone. The answers are the eager forward's."""
    _as_if_cuda(monkeypatch)
    model = _tiny_cdrnet("svd" if case == "svd" else "jacobi")
    model.train(case == "train")
    log = []
    model.geometry = GraphedGeometry(capture=_stand_in(log))
    imgs, projs = _images(2, 0), _projs(2)
    before = _counts()
    with torch.no_grad():
        outs = [model(imgs, projs) for _ in range(3)]
    kp = outs[0][0]
    want = dlt_triangulate(projs[:, None].expand(2, J, 2, 3, 4),
                           kp.transpose(1, 2), method=model.dlt_method)
    for kp_i, p3 in outs:
        assert torch.equal(kp_i, kp) and torch.equal(p3, want)
    graphs = {"eval": 2, "train": 0, "svd": 1}[case]
    assert len(log) == graphs
    assert _diff(before) == {"captures": graphs, "replays": 2 * graphs,
                             "eager": graphs}


# ------------------------------------------------------------------ card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda:0")


def _card_model(dev):
    return _tiny_cdrnet().to(dev).eval()


@pytest.mark.card
@pytest.mark.parametrize("pairs", [1, 32, 64])
def test_graphed_geometry_is_bit_equal_on_the_card(card, pairs):
    """Three requests of other inputs: the first eager, the second
    captured, the third replayed. Each pred_3d bit-equal to the eager DLT
    of its own keypoints, each pinv to the eager pinv of its projections."""
    model = _card_model(card)
    before = _counts()
    with torch.inference_mode():
        for i in range(3):
            imgs = _images(pairs, i, card)
            projs = _projs(pairs, card, shift=float(i))
            kp, p3 = model(imgs, projs)
            assert torch.equal(p3, _dlt(projs, kp)), i
        assert _diff(before) == {"captures": 2, "replays": 4, "eager": 2}
        geo = GraphedGeometry()
        for i in range(3):
            projs = _projs(pairs, card, shift=float(i))
            got = geo.run("pinv", pinv_projection, (projs,))
            assert torch.equal(got, pinv_projection(projs)), i


@pytest.mark.card
def test_graphed_outputs_do_not_alias_on_the_card(card):
    """Two replays in a row: the first answer stays as it was."""
    model = _card_model(card)
    with torch.inference_mode():
        outs = [model(_images(8, i, card),
                      _projs(8, card, shift=float(i)))
                for i in range(4)]
        first = outs[2][1].clone()
        assert outs[2][1].data_ptr() != outs[3][1].data_ptr()
        assert torch.equal(outs[2][1], first)
        assert not torch.equal(outs[2][1], outs[3][1])


@pytest.mark.card
def test_a_fault_planted_first_reaches_the_graphs(card, monkeypatch):
    """faults.jacobi_one_sweep planted before a new model's first call:
    its replayed pred_3d is the one-sweep DLT's, not the sound one's."""
    from benchmark.tests import faults
    imgs, projs = _images(16, 5, card), _projs(16, card)
    with torch.inference_mode():
        sound = _card_model(card)(imgs, projs)
        faults.jacobi_one_sweep(monkeypatch.setattr)
        model = _card_model(card)
        before = _counts()
        for _ in range(3):
            kp, p3 = model(imgs, projs)
        assert _diff(before)["replays"] == 4
        assert torch.equal(kp, sound[0])
        assert torch.equal(p3, _dlt(projs, kp))
        assert not torch.equal(p3, sound[1])
