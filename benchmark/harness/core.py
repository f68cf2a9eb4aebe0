"""One run of one cell: set-up, a measured or a traced window, the check
against the reference, and the result line.

Everything a cell needs is found by name under the benchmark's folder:
`BENCHMARK.json` names the cell's configuration (its file) and traffic;
`traffic/<traffic>.json` holds the mix's parameters and names its driver,
`drivers/<driver>.py`; `limits/<cell>.json` holds the limit of each number
compared; `metrics/<metric>.py` reads one per-layer metric from a trace.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import guard, trace as tracing

ROOT = Path(__file__).resolve().parents[2]


class NoDevice(RuntimeError):
    """The cell asks for more cards than the process sees."""


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_file_{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric, workload, reported):
    """A metric with a workloads list applies to those cells; one without
    to every cell, or a per-layer one to every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


class Cell:
    """A cell's files: its entry, configuration, traffic and limits."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.entry = _named(self.spec["workloads"], name, "workload")
        self.name = name
        self.chips = self.entry["chips"]
        conf = _named(self.spec["configs"], self.entry["config"], "config")
        self.config = json.loads((self.root / conf["file"]).read_text())
        self.traffic = json.loads(
            (self.bench / "traffic" / f"{self.entry['traffic']}.json")
            .read_text())
        self.limits = json.loads(
            (self.bench / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in self.spec["end_to_end"]
                           if _applies(m, name, ())]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.spec["per_layer"]
                          if _applies(m, name, names)]

    def driver(self, seed: int, device):
        path = self.bench / "drivers" / f"{self.traffic['driver']}.py"
        return load_module(path).Cell(self.config, self.traffic, seed, device)

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py").read


def check_device(chips: int):
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device=None, err=sys.stderr):
    """The result of one run, as a dict in the order it is printed."""
    device = torch.device(device or "cuda:0")
    if device.type == "cuda":
        # the host's work is one thread's: keep idle workers off its cores
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cell.driver(seed, device)
    drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - t0
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips}
    breakdown = None
    if trace:
        fn, steps = drv.traced()
        tr = tracing.record(fn, steps, drv.trace_info(
            cell.traffic["precision"]), device)
        attempted, failed = steps, 0
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = tracing.breakdown(tr)
    else:
        res = drv.run_for(seconds)
        attempted, failed = res["attempted"], res["failed"]
        metrics = {}
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else \
                res["metrics"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else 0)
    guard.check()
    drv.release()
    # the numbers that the cell's limits file names; one that the driver
    # did not read is NaN, and not correct
    readings = drv.readings()
    checks = {k: {"value": readings.get(k, math.nan), "limit": lim}
              for k, lim in cell.limits.items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    if device.type == "cuda":
        dev_info["power_limit_w"] = power_limit_w()
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=err)
    return out
