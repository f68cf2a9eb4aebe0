"""The four-card cell's check (drivers/train_dp.py) against ranks that
each step on their own rows, on the CPU: four gloo ranks at tiny.py's
size, every rank with the gradients' all_reduce left out
(rank_faults.ranks_step_alone, planted in rank 0 here and in ranks 1-3
through the driver's `plant`).

Step 0 cannot see that fault: its losses are all_reduced metrics, and
Adam's first move has the same norm whichever rows gave the gradient,
so change_gap barely moves (0.045 sound, 0.061 faulted). Step 1's 2D
loss, which each rank takes with its own weights, parts from the
reference's, taken from rank 0's weights. So both runs are held to the
cell's own limits (limits/cdrnet101.train-dp4-fp32-b32.json), which the
sound tiny run passes too (loss2d_gap 2.4e-6, replay_loss2d_gap 1.2e-6),
and not to tiny.py's looser ones, under which the faulted
replay_loss2d_gap (0.018) would pass."""

import pytest
import torch

from benchmark.harness import core
from benchmark.tests import rank_faults
from benchmark.tests.tiny import make_root

torch.set_num_threads(2)
CELL = "cdrnet101.train-dp4-fp32-b32"


@pytest.mark.parametrize("faulted", [False, True], ids=["sound", "alone"])
def test_ranks_that_step_alone_are_not_correct(tmp_path, monkeypatch,
                                               faulted):
    root = make_root(tmp_path)
    drv = core.Cell(CELL, root).driver(2 ** 32 + 9, torch.device("cpu"))
    if faulted:
        rank_faults.ranks_step_alone(monkeypatch.setattr)
        drv.plant = [(rank_faults.__file__, "ranks_step_alone")]
    drv.setup()
    drv.run_for(0.1)
    drv.release()
    r = drv.readings()
    lim = core.Cell(CELL).limits
    passed = {k: r[k] <= v for k, v in lim.items()}
    assert all(passed.values()) != faulted, r
    if faulted:
        assert not passed["replay_loss2d_gap"], r
