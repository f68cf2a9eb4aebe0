"""Read a cell's compared numbers over several seeds in one process, for
the program and for the control, to set the cell's limits from
(benchmark/README.md, "Limits"). Runs on the card:

    python3 benchmark/probe.py --workload <name> --seeds 1,2,3 \
        --seconds 2 --control 3 [--fault <name>] [--traffic <name>] \
        [--witness 3] [--faults a,b --fault-seeds 3]

One JSON line a seed: set-up seconds, the window's end-to-end metrics,
the program's readings, the control's on the first --control seeds (and
the witness's, the reference with its DLT in fp32, on the first
--witness seeds of a training cell), and what lies behind them.
--faults names faults of benchmark/tests/faults.py, each read in a run of
its own, with the fault planted under the program, on the first
--fault-seeds seeds; --traffic runs the cell with another traffic file.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _plant(name):
    """Plant faults.<name> and return what takes it out again."""
    from benchmark.tests import faults
    saved = []

    def put(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    getattr(faults, name)(put)
    return lambda: [setattr(*s) for s in reversed(saved)]


def _faulted(cell, seed, seconds, device, name, sound):
    """The readings of a run with a fault planted under the program, on
    the sound run's seed; a training cell's against the sound run's
    reference over its first steps, which is the same, and the
    reference's step 1 from the faulted run's own weights after step 0."""
    undo = _plant(name)
    try:
        drv = cell.driver(seed, device)
        drv.setup()
        drv.run_for(seconds)
        drv.release()
        if getattr(sound, "kind", None) is not None:
            drv.ref = {**sound.ref, **drv.replay_reference()}
            return drv.gaps(drv.prog, drv.ref)
        return drv.readings()
    finally:
        undo()


def probe(cell, seed, seconds, control, device="cuda:0", t0=None,
          witness=False, faults=()):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter() if t0 is None else t0
    drv = cell.driver(seed, device)
    drv.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out = {"seed": seed, "setup_s": time.perf_counter() - t0}
    res = drv.run_for(seconds)
    out["window"] = {k: res[k] for k in ("attempted", "failed", "elapsed")}
    out["metrics"] = res["metrics"]
    drv.release()
    out["readings"] = drv.readings()
    out["diagnostics"] = drv.diagnostics()
    if control:
        out["control"] = drv.control_readings()
        out["control_diagnostics"] = drv.diagnostics(drv.low)
    if witness:
        out["witness"] = drv.witness_readings()
        out["witness_diagnostics"] = drv.diagnostics(drv.wit)
    for name in faults:
        out.setdefault("faults", {})[name] = _faulted(
            cell, seed, seconds, device, name, drv)
    del drv
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=3,
                   help="the number of seeds, from the first, that also "
                        "read the control")
    p.add_argument("--witness", type=int, default=0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--traffic", default=None)
    args = p.parse_args(argv)
    from benchmark.harness import core
    cell = core.Cell(args.workload)
    core.check_device(cell.chips)
    if args.traffic:
        cell.traffic = json.loads((cell.bench / "traffic" /
                                   f"{args.traffic}.json").read_text())
    faults = [f for f in args.faults.split(",") if f]
    t0 = T0
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(probe(cell, seed, args.seconds, n < args.control,
                               t0=t0, witness=n < args.witness,
                               faults=faults if n < args.fault_seeds
                               else ())),
              flush=True)
        t0 = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
