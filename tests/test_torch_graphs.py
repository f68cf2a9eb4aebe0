"""The pieces around the port's one-dispatch training, on the CPU:
train/graphs.py (its eager form here; CUDA refused without CUDA), the
one capture's carried counters (cuda_graphs.py, through a stand-in for
the CUDA capture), the optimizer's checkpoint forms (train/state.py),
measure_scan_floor (utils/profiling.py), run_with_retries' degrade
ladder against the JAX package's (train/resilience.py), and the
training CLIs' --no_segments, --segment_epochs and --per_batch
(apps/_train_cli.py) against the JAX CLIs' mapping."""

import os
from collections import Counter

import pytest
import torch

from fast3dhpe_tpu.train import resilience as jax_resilience
from fast3dhpe_tpu_torch import cuda_graphs
from fast3dhpe_tpu_torch.apps import _train_cli
from fast3dhpe_tpu_torch.device import resolve_device
from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused
from fast3dhpe_tpu_torch.parallel import mesh as pmesh
from fast3dhpe_tpu_torch.train import resilience
from fast3dhpe_tpu_torch.train.graphs import GraphCaptureError, StepGraphs
from fast3dhpe_tpu_torch.train.state import TrainState, multistep_lr
from fast3dhpe_tpu_torch.utils.profiling import measure_scan_floor

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- graphs.py

def test_step_graphs_run_eagerly_on_the_cpu():
    """On the CPU every step runs eagerly: fn sees each row of xs, a fresh
    generator seeded with the step's seed, and TrainState.apply_gradients
    as its update; the sums are the steps' metrics added in order; nothing
    is captured; on_step sees every step."""
    xs = {"a": torch.arange(12.0).reshape(4, 3),
          "b": torch.arange(4) * 10}
    seen, rows = [], []
    model = torch.nn.Linear(1, 1)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))

    def fn(x, gen, update):
        rows.append((x["a"].tolist(), int(x["b"])))
        update()
        return {"s": x["a"].sum(), "r": torch.rand((), generator=gen)}

    g = StepGraphs()
    g.on_step = lambda m: seen.append(float(m["s"]))
    seeds = [7, 8, 9, 10]
    sums = g.epoch(("k",), state, xs, fn, state=state, seeds=seeds)
    assert rows == [(xs["a"][i].tolist(), 10 * i) for i in range(4)]
    assert seen == [3.0, 12.0, 21.0, 30.0]
    assert float(sums["s"]) == 66.0
    want = sum(torch.rand((), generator=torch.Generator().manual_seed(s))
               for s in seeds)
    assert torch.equal(sums["r"], want)
    assert state.step == 4 and g._graphs == {} and g.capture_s == 0.0
    g.on_step = None
    ev = g.epoch(("e",), state, xs, lambda x, gen, update: {
        "n": x["b"].float(), "gone": x["b"]}, sum_keys=("n",))
    assert set(ev) == {"n"} and float(ev["n"]) == 60.0
    assert state.step == 4


def test_graphs_refuse_cuda_without_cuda():
    """A CUDA device where CUDA is missing raises, naming it; the CPU
    passes."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        measure_scan_floor(5, "cuda")


def _counted():
    return (soft_argmax_fused.launches, Counter(pmesh.COUNTS),
            Counter(pmesh.COUNTS_BYTES))


@pytest.mark.parametrize("case", ["replays", "fails"])
def test_one_capture_carries_the_counters(case):
    """cuda_graphs.capture through a stand-in for the CUDA capture, of a
    step that counts a K1 launch and a halo exchange of 8 bytes: the
    capture leaves the counters as they were and each replay adds the
    step's counts again; a capture that raises gives GraphCaptureError
    naming the call, the counters as before it."""
    x = torch.zeros(3)
    gen = torch.Generator()
    seen = []

    def step(x):
        soft_argmax_fused.launches += 1
        pmesh.COUNTS["halo"] += 1
        pmesh.COUNTS_BYTES["halo"] += 8
        if case == "fails":
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1

    def record(fn, args, generator):
        seen.append(generator)
        out = fn(*args)
        return (lambda: out.add_(1)), out

    before = _counted()
    if case == "fails":
        with pytest.raises(GraphCaptureError,
                           match="the halo step.*RuntimeError.*capturing"):
            cuda_graphs.capture(step, (x,), "the halo step", gen, record)
        assert _counted() == before
        return
    replay, out = cuda_graphs.capture(step, (x,), "the halo step", gen,
                                      record)
    assert seen == [gen] and _counted() == before
    for i in (1, 2):
        replay()
        k1, counts, nbytes = _counted()
        assert k1 == before[0] + i
        assert torch.equal(out, torch.full((3,), 1.0 + i))
        assert counts - before[1] == Counter(halo=i)
        assert nbytes - before[2] == Counter(halo=8 * i)


def test_a_device_pool_is_renewed_once_its_graphs_are_freed(monkeypatch):
    """The graphs of a device share its pool while any of them lives; the
    graph after the last one is freed starts a new pool, which PyTorch
    needs when a block of the old one outlives its graphs."""
    handles = iter(range(10))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    monkeypatch.setattr(cuda_graphs, "_POOLS", {})
    dev = torch.device("cuda", 0)

    class Graph:                        # stands in for torch.cuda.CUDAGraph
        pass

    a, b = Graph(), Graph()
    assert cuda_graphs._pool(dev, a) == cuda_graphs._pool(dev, b) == 0
    del a
    c = Graph()
    assert cuda_graphs._pool(dev, c) == 0
    del b, c
    assert cuda_graphs._pool(dev, Graph()) == 1


def test_measure_scan_floor_on_the_cpu():
    """The CPU's floor: the fixed cost an iteration of a trivial loop,
    positive, well under a millisecond."""
    t = measure_scan_floor(20, "cpu")
    assert 0.0 < t < 1e-3


# --------------------------------------------------- optimizer's forms

def _states(lr=1e-3):
    """A plain TrainState (CPU Adam, float LR) that has stepped twice and a
    capturable one of the same shape (Adam capturable, its LR a tensor, as
    make_optimizer builds it on CUDA)."""
    torch.manual_seed(0)
    plain_model = torch.nn.Linear(4, 3)
    sched = multistep_lr(lr, [1], 0.1, 1)
    plain = TrainState(plain_model, torch.optim.Adam(
        plain_model.parameters(), lr=sched(0)), sched)
    for _ in range(2):
        plain.optimizer.zero_grad()
        plain_model(torch.randn(5, 4)).sum().backward()
        plain.apply_gradients()
    cap_model = torch.nn.Linear(4, 3)
    lr_t = torch.tensor(sched(0))
    cap = TrainState(cap_model, torch.optim.Adam(
        cap_model.parameters(), lr=lr_t, capturable=True), sched)
    return plain, cap, lr_t


def _same(a, b):
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, s in a["state"].items():
        for k, v in s.items():
            assert torch.equal(v.cpu(), b["state"][i][k].cpu()), (i, k)
        assert b["state"][i]["step"].device.type == "cpu"


def test_optimizer_state_round_trip_between_forms():
    """latest.opt.pt's optimizer state loads across the two forms: the
    capturable optimizer keeps its own form (its LR tensor, the object a
    graph captured, takes the loaded value; capturable stays on) and writes
    back what it loaded, in the plain form (float LR, capturable off,
    Adam's step counts on the host); the plain one loads that unchanged."""
    plain, cap, lr_t = _states()
    saved = plain.optimizer_state_dict()
    cap.load_optimizer_state_dict(saved)
    g = cap.optimizer.param_groups[0]
    assert g["lr"] is lr_t and g["capturable"]
    assert float(lr_t) == float(torch.tensor(saved["param_groups"][0]["lr"]))
    assert cap.version == 1
    back = cap.optimizer_state_dict()
    assert back["param_groups"][0]["capturable"] is False
    assert isinstance(back["param_groups"][0]["lr"], float)
    _same(saved, back)
    plain2, _, _ = _states()
    plain2.load_optimizer_state_dict(back)
    _same(saved, plain2.optimizer_state_dict())
    assert plain2.optimizer.param_groups[0]["capturable"] is False


def test_capturable_lr_written_in_place_by_the_schedule():
    """set_lr writes the schedule's LR into the tensor in place, only when
    it changes, and the plain form records it as the float written."""
    _, cap, lr_t = _states(lr=1e-3)
    cap.set_lr()
    assert cap.optimizer.param_groups[0]["lr"] is lr_t
    assert float(lr_t) == float(torch.tensor(1e-3))
    cap.step = 1
    cap.set_lr()
    assert float(lr_t) == float(torch.tensor(1e-4))
    assert cap.optimizer_state_dict()["param_groups"][0]["lr"] == 1e-3 * 0.1


# ----------------------------------------------------- resilience ladder

def _ladder(run_with_retries, exc, **extra):
    calls = []

    def run(config, **kw):
        calls.append((kw.get("segments"), kw.get("scan_epochs")))
        if len(calls) <= 3:
            raise exc
        return {"ok": True}

    cfg = type("C", (), {"MODEL": type("M", (), {"NAME": "x"})})()
    out = run_with_retries(run, cfg, retries=3, retry_backoff_s=0.0,
                           _sleep=lambda s: None, _probe=lambda: None,
                           weights_root="/nonexistent", **extra)
    assert out == {"ok": True}
    return calls


def test_retry_ladder_degrades_as_the_jax_package_does():
    """Three retryable failures: the first retry repeats the call, the
    second sets segments=False, the third scan_epochs=False, as the JAX
    package's run_with_retries does (resilience.py:181-194)."""
    got = _ladder(resilience.run_with_retries,
                  OSError(5, "Input/output error"))
    ref = _ladder(jax_resilience.run_with_retries,
                  RuntimeError("UNAVAILABLE: worker process crashed"),
                  backend_wait_s=0)
    assert got == ref == [(None, None), (None, None), (False, None),
                          (False, False)]


def test_capture_error_is_not_retryable():
    """A failed capture is the work's own fault: never retried, whatever
    its message holds."""
    err = GraphCaptureError("capturing the step train failed: CUDA error: "
                            "CUDA-capable device(s) is/are busy or "
                            "unavailable")
    assert not resilience.is_retryable(err)
    assert resilience.is_retryable(RuntimeError(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"))


# ------------------------------------------------------------ the CLIs

@pytest.mark.parametrize("argv,want", [
    ([], (None, None, None)),
    (["--no_segments"], (None, False, None)),
    (["--per_batch"], (False, False, None)),
    (["--segment_epochs", "3"], (None, None, 3)),
    (["--no_segments", "--segment_epochs", "2"], (None, False, 2)),
])
def test_cli_segment_flags(monkeypatch, argv, want):
    """--no_segments, --per_batch and --segment_epochs reach the loop as
    the JAX CLIs pass them (apps/train_cdr.py:70-79): scan_epochs,
    segments, segment_epochs."""
    got = {}

    def fake(run_fn, config, **kw):
        got.update(kw)

    monkeypatch.setattr(_train_cli, "run_with_retries", fake)
    _train_cli.parse_and_run(lambda *a, **k: None,
                             os.path.join(ROOT, "configs", "mads_3d.yaml"),
                             "test", argv + ["--device", "cpu"])
    assert (got["scan_epochs"], got["segments"],
            got["segment_epochs"]) == want


def test_cli_help_names_segments(capsys):
    """The help text describes what the flags do; none says the port runs
    no segments."""
    with pytest.raises(SystemExit):
        _train_cli.parse_and_run(lambda *a, **k: None, "x.yaml", "test",
                                 ["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "runs no segments" not in text
    for flag in ("--no_segments", "--segment_epochs", "--per_batch"):
        assert flag in text
    assert "segment" in text.rsplit("--segment_epochs", 1)[1][:200]
