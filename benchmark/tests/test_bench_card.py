"""On the card, at each cell's own size: a sound run's readings pass the
cell's limits, and the control's fail one of them (the control: the
reference with TF32 on in the training cells, the program's int8 path in
the serving cell); so do runs with a fault planted where only the card
runs it (in the training step's CUDA graph) or where the CPU tests'
faults do not reach (the geometry). Skips without a card; on one:

    python3 -m pytest benchmark/tests/test_bench_card.py -m card
"""

import json

import pytest
import torch

from benchmark.harness import core
from benchmark.harness.core import ROOT
from benchmark.probe import probe

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]
                                  if w["chips"] == 1])
def test_control_fails_and_the_program_passes(card, name):
    cell = core.Cell(name)
    out = probe(cell, 2 ** 31 + 17, 1.0, True)
    lim = cell.limits
    assert all(out["readings"][k] <= v for k, v in lim.items()), out
    assert any(not out["control"][k] <= v for k, v in lim.items()), out


CARD_FAULTS = {"train": ("tf32_captured", "half_batch_captured"),
               "serve": ("pred3d_moved", "jacobi_one_sweep")}


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]
                                  if w["chips"] == 1])
def test_faults_on_the_card_fail(card, name):
    cell = core.Cell(name)
    kind = "serve" if cell.traffic["driver"].startswith("serve") else "train"
    out = probe(cell, 2 ** 31 + 29, 1.0, False, faults=CARD_FAULTS[kind])
    lim = cell.limits
    for fault, got in out["faults"].items():
        assert any(not got[k] <= lim[k] for k in lim), (fault, got)
