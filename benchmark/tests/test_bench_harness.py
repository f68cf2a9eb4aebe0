"""The harness on the CPU: BENCHMARK.json against the contract, the
import guard, no result without a card, cells and metrics added by new
files only, and the check: sound tiny runs come out correct, runs with
the timed path broken underneath come out not correct."""

import json
import re
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness import core, guard
from benchmark.harness.core import ROOT
from benchmark.tests import faults
from benchmark.tests.tiny import make_root

torch.set_num_threads(2)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    assert all(_line(w) for w in SPEC["command"])
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") \
            and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert SPEC["end_to_end"][-1]["name"] == "setup_s"
    for m in SPEC["per_layer"]:
        assert _line(m["layer"]) and "bound" not in m
        moves = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves["workloads"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_has_its_files_and_metrics(name):
    cell = core.Cell(name)
    assert (cell.bench / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_guard_compares_whole_top_level_names():
    loaded = ["jax.numpy", "fast3dhpe_tpu.models", "fast3dhpe_tpu_torch.ops",
              "flaxen", "optax", "torch"]
    assert guard.forbidden_modules(loaded) == ["fast3dhpe_tpu", "jax",
                                               "optax"]


def test_guard_raises_naming_the_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    with pytest.raises(ImportError, match="jaxlib"):
        guard.check()


def test_the_port_loads_no_jax():
    code = ("import sys; import fast3dhpe_tpu_torch.apps.inference, "
            "fast3dhpe_tpu_torch.train.steps, fast3dhpe_tpu_torch.models."
            "quantized; from benchmark.harness import guard; "
            "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints nothing."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(2 ** 33 + 1),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no result" in out.stderr


def _run(root, name, trace=False, seed=2 ** 32 + 9):
    return core.run(core.Cell(name, root), seed, 0.2, trace, 0.0,
                    device="cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_sound_runs_are_correct(root, name):
    res = _run(root, name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in
                                   core.Cell(name, root).end_to_end}


def test_a_cell_and_a_metric_added_by_new_files_only(tmp_path):
    """A new serving cell (a traffic file, a limits file and an entry) and
    a new per-layer metric (a reader and an entry): the harness finds both
    by name, with no file of the benchmark edited."""
    root = make_root(tmp_path)
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / "serve-bf16-b64.json")
                         .read_text())
    traffic["batch"] = 3
    (bench / "traffic" / "serve-bf16-b3.json").write_text(json.dumps(traffic))
    (bench / "limits" / "cdrnet101.serve-bf16-b3.json").write_text(
        (bench / "limits" / "cdrnet101.serve-bf16-b64.json").read_text())
    (bench / "metrics" / "requests_traced.serve.py").write_text(
        "def read(trace):\n    return float(trace.steps)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "cdrnet101.serve-bf16-b3",
                              "config": "cdrnet101-mads3d-256",
                              "traffic": "serve-bf16-b3", "chips": 1,
                              "why": "three pairs a request"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "cdrnet101.serve-bf16-b64" in m.get("workloads", []):
            m["workloads"].append("cdrnet101.serve-bf16-b3")
    spec["per_layer"].append({"name": "requests_traced.serve", "unit": "req",
                              "better": "higher", "source": "program_counter",
                              "layer": "Request", "moves":
                              "serve_pairs_per_s", "workloads":
                              ["cdrnet101.serve-bf16-b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = _run(root, "cdrnet101.serve-bf16-b3")
    assert res["correct"] and res["metrics"]["serve_pairs_per_s"]["value"] > 0
    traced = _run(root, "cdrnet101.serve-bf16-b3", trace=True)
    assert traced["metrics"]["requests_traced.serve"]["value"] == 1.0
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


# ------------------------------------------------------------------ faults

TRAIN = ["cdrnet101.train-fp32-b32", "cdrnet101.train-warmup-fp32-b32",
         "poseresnet101.train2d-fp32-b32"]
SERVE = ["cdrnet101.serve-bf16-b64"]


@pytest.mark.parametrize("name, fault", [
    *[(n, faults.state_unchanged) for n in TRAIN],
    *[(n, faults.half_batch) for n in TRAIN],
    *[(n, faults.serve_half_batch) for n in SERVE],
    *[(n, faults.answer_altered) for n in SERVE],
    *[(n, faults.pred3d_moved) for n in SERVE],
    *[(n, faults.jacobi_one_sweep) for n in SERVE],
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch.setattr)
    res = _run(root, name)
    assert not res["correct"], res["checks"]
