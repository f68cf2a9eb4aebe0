"""A copy of the benchmark at a size the CPU runs in seconds, for tests:
ResNet-50 at 64 px (96 x 128 frames), two pairs a step, and limits set
for the CPU's readings at that size."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness.core import ROOT

# the CPU's readings at the tiny size are larger than the card's at the
# cells' own (a random network at 64 px, batches of 2, where a BN's sums
# over 16 values cancel): limits that sound tiny runs pass and the faults
# fail (the first loss and the change catch the training faults there)
TINY_LIMITS = {"loss_gap": 0.02, "grad_gap": 0.3, "change_gap": 0.5,
               "loss2d_gap": 0.02, "replay_loss_gap": 0.02,
               "replay_loss2d_gap": 0.02, "replay_grad_gap": 0.3,
               "pred2d_vs_bf16": 1.8, "pred2d_over_2bf16": 0.3,
               "geometry_gap": 1e-6}


def make_root(tmp: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder under tmp, cut to the
    tiny size."""
    tmp = Path(tmp)
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for f in (tmp / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["MODEL"].update(NUM_LAYERS=50, IMAGE_SIZE=[64, 64])
        c["MODEL"]["EXTRA"]["HEATMAP_SIZE"] = [16, 16]
        f.write_text(json.dumps(c))
    for f in (tmp / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["batch"] = 2
        if "cache_frames" in t:
            t.update(cache_frames=2 * 3 * t["batch"], frame_height=96,
                     frame_width=128, steps_per_chunk=3, chunks=2)
        else:
            t.update(pool=2, warm_requests=1, trace_requests=1,
                     check_requests=2, control_calib=1)
        f.write_text(json.dumps(t))
    for f in (tmp / "benchmark" / "limits").glob("*.json"):
        f.write_text(json.dumps({k: TINY_LIMITS[k]
                                 for k in json.loads(f.read_text())}))
    return tmp
