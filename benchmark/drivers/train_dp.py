"""CDRNet's 3D phase by data parallelism over the cell's cards: one process
a card, each stepping its rows of the global batch through the program's
graphed stacked epochs under a mesh (`train/steps.py make_train_epoch_cdr`
with `mesh=`), whose step graphs capture the row, BN, gradient and metric
all_reduces (NCCL; gloo and eager steps on the CPU).

The harness's process is rank 0. It starts ranks 1.. as processes of this
file, each logging to chiprun_out/train_dp/rank<r>.log in the checkout,
and leads them through a command broadcast on a gloo group before each
chunk: run chunk k, or stop. The process group's set-up, every
collective and every wait (a command, a chunk's end, a rank's exit) gives
up after WAIT_S seconds, and rank 0 then stops the others and exits
instead of hanging. Every rank runs chunk 0 in set-up, before the window.

The check is the one-card 3D cell's, on rank 0's records, against the
one-card reference on the global batch. Every rank draws its Cutout from
the step's seed alike, so the reference builds each rank's rows with the
same seed (pipeline.stereo_batch a rank) and steps their concatenation.

Traffic parameters: those of train_cdr, with `batch` the pairs of one
rank, and `ranks`.

`Cell.plant`, empty in the benchmark's runs, lists faults as (file,
function) pairs that ranks 1.. plant before their set-up, each function
taking a setter as benchmark/tests/faults.py's do: the check's tests of
this cell plant a fault in every rank (the caller plants it in rank 0).
"""

from __future__ import annotations

import gc
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.drivers.train_cdr import Cell as CdrCell  # noqa: E402
from benchmark.harness import scene  # noqa: E402
from benchmark.harness.weights import (calibrate_head,  # noqa: E402
                                       seeded_state_dict, sub_seed)

WAIT_S = 300.0
ROOT = Path(__file__).resolve().parents[2]
STOP = -1


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Cell(CdrCell):
    def __init__(self, config, traffic, seed, device, rank=0, port=None):
        super().__init__(config, traffic, seed, device)
        self.ranks = traffic["ranks"]
        self.local = self.B
        self.B = self.local * self.ranks        # the global batch
        self.rank, self.port = rank, port
        self.procs, self.logs = [], []
        self.plant = []
        if self.device.type == "cuda":
            self.device = torch.device("cuda", rank)

    # ------------------------------------------------------------ ranks
    def _spawn(self):
        """Start ranks 1.. as processes of this file."""
        import fast3dhpe_tpu_torch
        log_dir = ROOT / "chiprun_out" / "train_dp"
        log_dir.mkdir(parents=True, exist_ok=True)
        # the ranks import the program from where this process did
        port = str(Path(fast3dhpe_tpu_torch.__file__).resolve().parents[1])
        path = os.pathsep.join(filter(None, (port,
                                             os.environ.get("PYTHONPATH"))))
        env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=path)
        for r in range(1, self.ranks):
            arg = json.dumps({"config": self.config, "traffic": self.traffic,
                              "seed": self.seed, "device": self.device.type,
                              "rank": r, "port": self.port,
                              "plant": self.plant})
            log = open(log_dir / f"rank{r}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), arg],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=env))

    def _join(self):
        """This process into the group: the world (NCCL on the cards,
        gloo on the CPU), the mesh over it, and a gloo group for the
        commands."""
        import datetime

        import torch.distributed as dist

        from fast3dhpe_tpu_torch.parallel.distributed import init_distributed
        from fast3dhpe_tpu_torch.parallel.mesh import make_mesh
        os.environ.update(WORLD_SIZE=str(self.ranks), RANK=str(self.rank),
                          LOCAL_RANK=str(self.rank))
        init_distributed(device=str(self.device),
                         init_method=f"tcp://localhost:{self.port}",
                         timeout=WAIT_S)
        self.mesh = make_mesh()
        self.commands = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=WAIT_S))

    def _command(self, value=None):
        """Rank 0 sends `value`; every other rank returns what it sent."""
        import torch.distributed as dist
        t = torch.tensor([0 if value is None else value], dtype=torch.long)
        dist.broadcast(t, 0, group=self.commands)
        return int(t[0])

    def _check_ranks(self):
        for r, p in enumerate(self.procs, start=1):
            if p.poll() is not None and p.returncode != 0:
                raise RuntimeError(f"rank {r} exited with {p.returncode}: "
                                   f"see chiprun_out/train_dp/rank{r}.log")

    def _wait(self, metrics):
        """The chunk's loss, waited for up to WAIT_S seconds while the
        other ranks are watched."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            t0 = time.monotonic()
            while not done.query():
                self._check_ranks()
                if time.monotonic() - t0 > WAIT_S:
                    raise TimeoutError(f"a chunk did not end within "
                                       f"{WAIT_S} s")
                time.sleep(0.002)
        return float(metrics["loss"])

    def _fail(self, err):
        """Stop every rank and exit: a collective that waits for a lost
        rank cannot be cancelled."""
        for p in self.procs:
            p.kill()
        print(f"train_dp: {type(err).__name__}: {err}", file=sys.stderr,
              flush=True)
        os._exit(1)

    # ------------------------------------------------------------ set-up
    def setup(self):
        if self.rank == 0:
            self.port = _free_port()
            self._spawn()
        try:
            self._setup_rank()
        except Exception as e:      # noqa: BLE001
            if self.rank != 0:
                raise
            self._fail(e)
        if self.rank == 0:
            print(f"train_dp: {self.ranks} ranks set up, chunk 0 run",
                  file=sys.stderr, flush=True)

    def _setup_rank(self):
        from fast3dhpe_tpu_torch.parallel.mesh import replicate
        from fast3dhpe_tpu_torch.train.state import TrainState
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._join()
        t, dev = self.traffic, self.device
        self.frames = scene.frames(dev, t["cache_frames"], t["frame_height"],
                                   t["frame_width"], sub_seed(self.seed, 1))
        rng = np.random.default_rng(sub_seed(self.seed, 2))
        self.chunks = [self.on_device(self.chunk(rng, k))
                       for k in range(t["chunks"])]
        self.chunk_seeds = [sub_seed(self.seed, 3, k)
                            for k in range(t["chunks"])]
        rows = slice(self.rank * self.local, (self.rank + 1) * self.local)
        self.shards = [{k: v[:, rows] for k, v in c.items()}
                       for c in self.chunks]
        with torch.device(dev):
            model = self.build()
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.sd0 = seeded_state_dict(shapes, dev, sub_seed(self.seed, 4))
        if self.rank == 0:
            with torch.no_grad():
                calibrate_head(self.sd0, self.reference_logits())
        model.load_state_dict(self.sd0)
        replicate(self.mesh, model, spatial=False)    # rank 0's weights
        self.names = [k for k, _ in model.named_parameters()]
        self.state = TrainState.create(model, self.cfg, self.S)
        self.epoch = self.epoch_fn()
        self.record = {"loss": [], "loss_2d": [], "moments": [],
                       "start": None, "params": None}
        self.epoch.graphs.on_step = self._on_step
        self._wait(self.run_chunk(self.shards[0], 0))
        self.epoch.graphs.on_step = None
        self.next_chunk = 1

    def chunk(self, rng, k):
        """train_cdr's chunk, of the global batch: its pairs distinct
        while the cache holds enough of them, then repeated."""
        t, S, B = self.traffic, self.S, self.B
        n = S * B
        pairs = np.resize(rng.permutation(t["cache_frames"] // 2), n)
        H0, W0 = t["frame_height"], t["frame_width"]
        ds = self.cfg.DATASET
        P = np.broadcast_to(scene.converging_rig(W0, H0), (n, 2, 4, 4))
        xs = {"idx_l": 2 * pairs, "idx_r": 2 * pairs + 1,
              "trans": scene.train_affines(rng, n, W0, H0, self.size,
                                           ds.SCALE_FACTOR, ds.ROT_FACTOR),
              "P_l": P[:, 0], "P_r": P[:, 1],
              "pose_3d": scene.poses(rng, n, self.cfg.MODEL.NUM_JOINTS,
                                     t["pose_range_mm"]),
              "joints_vis": (rng.random((n, self.cfg.MODEL.NUM_JOINTS))
                             < t["joint_visible"]).astype(np.float32),
              "row_valid": np.ones(n, np.float32)}
        return {k: np.ascontiguousarray(v).reshape((S, B) + v.shape[1:])
                for k, v in xs.items()}

    def epoch_fn(self):
        from fast3dhpe_tpu_torch.models.losses import make_loss
        from fast3dhpe_tpu_torch.train.steps import make_train_epoch_cdr
        cfg = self.cfg
        return make_train_epoch_cdr(
            make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
            tuple(cfg.MODEL.IMAGE_SIZE), occlusion=self.traffic["occlusion"],
            graphed=True, loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
            num_joints=cfg.MODEL.NUM_JOINTS, mesh=self.mesh)

    # ------------------------------------------------------------ window
    def _chunk(self):
        k = self.next_chunk % len(self.chunks)
        try:
            self._command(k)
            loss = self._wait(self.run_chunk(self.shards[k], k))
        except Exception as e:      # noqa: BLE001
            self._fail(e)
        self.next_chunk += 1
        return {"loss": torch.tensor(loss)}

    def follow(self):
        """Ranks 1..: run the chunks rank 0 names until it says stop."""
        while True:
            k = self._command()
            if k == STOP:
                return
            self._wait(self.run_chunk(self.shards[k], k))
            print(f"rank {self.rank}: chunk {k}", flush=True)

    def trace_info(self, precision):
        info = super().trace_info(precision)
        info["chips"] = self.ranks
        return info

    def heatmap_shape(self):
        h = self.cfg.MODEL.EXTRA.HEATMAP_SIZE
        return (2 * self.local, h[1], h[0], self.cfg.MODEL.NUM_JOINTS, 4)

    # ------------------------------------------------------------- check
    def release(self):
        """Stop the other ranks, free rank 0's state (TrainCell.release:
        the step graphs with it, whose NCCL kernels would hold the group),
        leave the group with the other ranks and wait for them to exit."""
        try:
            self._command(STOP)
            super().release()
            leave()
            for r, p in enumerate(self.procs, start=1):
                if p.wait(timeout=WAIT_S) != 0:
                    raise RuntimeError(f"rank {r} exited with "
                                       f"{p.returncode}")
        except Exception as e:      # noqa: BLE001
            self._fail(e)
        for log in self.logs:
            log.close()

    def reference_batch(self, xs, k, i, rows=None):
        """The global batch: each rank's rows built with the step's seed,
        as each rank draws its Cutout."""
        from benchmark.reference.pipeline import stereo_batch, step_seed
        seed = step_seed(self.chunk_seeds[k], i)
        parts = []
        for r in range(self.ranks):
            sl = slice(r * self.local, (r + 1) * self.local)
            parts.append(stereo_batch(self.frames,
                                      {key: v[i][sl] for key, v in
                                       xs.items()}, self.size, seed))
        return {key: torch.cat([p[key] for p in parts])[:rows]
                for key in parts[0]}


def leave():
    """Destroy the process group, as every rank does at once: NCCL's
    shutdown can wait for the other ranks' (torch.distributed's
    destroy_process_group says so). Raises TimeoutError after WAIT_S
    seconds."""
    import threading

    import torch.distributed as dist
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t = threading.Thread(target=dist.destroy_process_group, daemon=True)
    t.start()
    t.join(WAIT_S)
    if t.is_alive():
        raise TimeoutError(f"leaving the process group took over {WAIT_S} s")


def main(arg):
    a = json.loads(arg)
    for path, name in a["plant"]:
        from benchmark.harness.core import load_module
        getattr(load_module(Path(path)), name)(setattr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a["device"] == "cuda":
        torch.set_num_threads(1)
    rank = a["rank"]
    cell = Cell(a["config"], a["traffic"], a["seed"], a["device"],
                rank=rank, port=a["port"])
    cell.setup()
    print(f"rank {rank}: set up, chunk 0 run", flush=True)
    cell.follow()
    print(f"rank {rank}: told to stop", flush=True)
    del cell.state, cell.epoch          # the step graphs, before leaving
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    leave()
    print(f"rank {rank}: left the group", flush=True)
    return 0


if __name__ == "__main__":
    sys.stdout.flush()
    # no teardown after the group is gone: nothing is left to release
    os._exit(main(sys.argv[1]))
