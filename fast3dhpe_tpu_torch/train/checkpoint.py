"""Checkpoints. Port of fast3dhpe_tpu/train/checkpoint.py.

The weights are plain state dicts in the reference's key space
(`encoder.*`, `decoder.*`, `CF.*`), written as `<dir>/best.pth` and
`<dir>/latest.pth`, so that three readers load them unchanged: the port
(`load_variables`, which `CDRNetInferencer` uses), the reference repo,
and the JAX package's `load_torch_checkpoint`. What a resume needs besides
the weights sits beside them in `<dir>/latest.opt.pt`: the optimizer's
state dict, the train state's step (the LR schedule's index, apart from
Adam's own per-parameter step) and the best metric. `latest.pth` records
the same step in the state dict's own metadata
(`_metadata[""]["train_step"]`, which `load_state_dict` ignores), so a
resume can tell that the two files were written together. Every file is written under a temporary name
and moved into place by `os.replace`.

The JAX package's native checkpoints are orbax directories, which the
port cannot read without JAX; `load_variables` names the conversion.
"""

from __future__ import annotations

import copy
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import torch

from ..parallel.distributed import process_index

OPT_FILE = "latest.opt.pt"


def orbax_error(path: str) -> NotImplementedError:
    """The error for an orbax checkpoint directory, naming the conversion
    to a .pth where JAX runs."""
    return NotImplementedError(
        f"{path} is an orbax checkpoint directory of the JAX package, which "
        f"the PyTorch port cannot read. Convert it where JAX runs: "
        f"`from fast3dhpe_tpu.train.checkpoint import load_variables, "
        f"save_torch_checkpoint; save_torch_checkpoint('{path}.pth', "
        f"load_variables('{path}'))` (fast3dhpe_tpu/train/checkpoint.py:254), "
        f"then pass the .pth")


def _is_orbax(path: str) -> bool:
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "d")))


def load_variables(path: str) -> "OrderedDict[str, torch.Tensor]":
    """A state dict, on the CPU, from a reference or port .pth file, or
    from a directory that holds best.pth or latest.pth (best first). An
    orbax directory, or one holding best/ or latest/ as orbax, raises the
    conversion error."""
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    if _is_orbax(path):
        raise orbax_error(path)
    if os.path.isdir(path):
        for cand in ("best", "latest"):
            sub = os.path.join(path, cand)
            if os.path.isfile(sub + ".pth"):
                return load_variables(sub + ".pth")
            if os.path.isdir(sub):
                raise orbax_error(sub)
    raise FileNotFoundError(f"No checkpoint found at {path}")


def merge_encoder_only(state_dict: Mapping[str, torch.Tensor],
                       pretrained: Mapping[str, torch.Tensor]
                       ) -> "OrderedDict[str, torch.Tensor]":
    """A copy of `state_dict` whose `encoder.*` entries, BN statistics
    included, come from `pretrained`; the fusion and decoder keep theirs
    (merge_encoder_only, checkpoint.py:145, the reference's encoder
    handoff). The two encoders must have the same keys."""
    mine = {k for k in state_dict if k.startswith("encoder.")}
    theirs = {k for k in pretrained if k.startswith("encoder.")}
    if mine != theirs:
        raise KeyError(f"the pretrained encoder differs: missing "
                       f"{sorted(mine - theirs)[:5]}, unexpected "
                       f"{sorted(theirs - mine)[:5]}")
    out = OrderedDict(state_dict)
    for k in mine:
        out[k] = pretrained[k]
    if hasattr(state_dict, "_metadata"):
        out._metadata = copy.deepcopy(state_dict._metadata)
    return out


def _map_tensors(obj, fn):
    """obj with fn applied to every tensor of its dicts, lists and tuples
    (an OrderedDict keeps its `_metadata`)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        out = type(obj)((k, _map_tensors(v, fn)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = copy.deepcopy(obj._metadata)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return copy.deepcopy(obj)


def to_host(obj):
    """A copy of obj with every tensor copied to the CPU: what is written
    no longer changes when training updates the tensors in place."""
    return _map_tensors(obj, lambda t: t.detach().to("cpu", copy=True))


def snapshot(obj):
    """A copy of obj with every tensor cloned where it lies (on the card, a
    device-to-device copy in the current stream)."""
    return _map_tensors(obj, lambda t: t.detach().clone())


def weights_with_step(model: torch.nn.Module, step: int):
    """model.state_dict() tagged with the train state's step in its root
    metadata (read back by `weights_step`)."""
    sd = model.state_dict()
    sd._metadata = copy.deepcopy(sd._metadata)
    sd._metadata[""] = dict(sd._metadata.get("", {}), train_step=int(step))
    return sd


def weights_step(state_dict) -> Optional[int]:
    return getattr(state_dict, "_metadata", {}).get("", {}).get("train_step")


def save_file(path: str, obj) -> None:
    """torch.save to a temporary name in the same directory, then
    os.replace, so a reader never sees half a file."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def resume_payload(state, best_metric: float) -> Dict[str, Any]:
    """What latest.opt.pt holds for a TrainState (train/state.py)."""
    return {"optimizer": state.optimizer_state_dict(), "step": state.step,
            "best_metric": float(best_metric)}


def load_resume(model_dir: str):
    """(weights, payload) of <model_dir>/latest.pth and latest.opt.pt, or
    None when there is no latest.pth. Raises when latest.opt.pt is
    missing or belongs to another step than latest.pth."""
    wpath = os.path.join(model_dir, "latest.pth")
    opath = os.path.join(model_dir, OPT_FILE)
    if os.path.isdir(os.path.join(model_dir, "latest")):
        raise orbax_error(os.path.join(model_dir, "latest"))
    if not os.path.isfile(wpath):
        return None
    if not os.path.isfile(opath):
        raise FileNotFoundError(f"{wpath} has no {OPT_FILE} beside it: "
                                f"nothing to resume the optimizer from")
    weights = torch.load(wpath, map_location="cpu", weights_only=True)
    payload = torch.load(opath, map_location="cpu", weights_only=True)
    if weights_step(weights) != payload["step"]:
        raise RuntimeError(
            f"{wpath} is of step {weights_step(weights)} but {opath} of step "
            f"{payload['step']}: the pair was not written together")
    return weights, payload


class AsyncCheckpointWriter:
    """Checkpoint writes off the training loop's path (checkpoint.py:
    313-404).

    save() clones every tensor where it lies before it returns (a
    device-to-device copy on the card, ordered in the current stream), so
    the optimizer's in-place updates after it cannot reach what is
    written; one daemon thread copies the clone to the host and writes
    it. A save() to a path whose last save is still queued, not started,
    replaces it, so at most one write in flight and one queued are held a
    path. wait() drains the queue and re-raises the worker's first error;
    the loops call it when they end and on interrupt.
    """

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._queue: Dict[str, Any] = {}     # path -> snapshot, in order
        self._busy = 0
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._work, name="ckpt-writer", daemon=True)
        self._thread.start()

    def save(self, path: str, obj) -> None:
        clone = snapshot(obj)
        with self._cv:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._closed:
                raise RuntimeError("writer already closed")
            self._queue.pop(path, None)
            self._queue[path] = clone
            self._cv.notify()

    def _work(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                path = next(iter(self._queue))
                obj = self._queue.pop(path)
                self._busy += 1
            try:
                save_file(path, to_host(obj))
            except BaseException as e:   # surfaced by save() or wait()
                with self._cv:
                    self._error = self._error or e
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def wait(self) -> None:
        """Block until every queued save is written; re-raise the first
        error of the worker, if any."""
        with self._cv:
            while self._queue or self._busy:
                self._cv.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def close(self) -> None:
        """Drain and stop the worker (the writer is single-use)."""
        self.wait()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60)


class SyncCheckpointWriter:
    """AsyncCheckpointWriter's surface, writing inline."""

    def save(self, path: str, obj) -> None:
        save_file(path, to_host(obj))

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


class NullCheckpointWriter:
    """The writer of every rank but 0 under a process group: rank 0 owns
    the checkpoint directory, so saves here do nothing. Without the gate N
    writers would race on the same files. The state is the same on every
    rank (parallel/mesh.py replicate and the global-batch step), so what
    rank 0 writes is what any rank would."""

    def save(self, path: str, obj) -> None:
        pass

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


def make_checkpoint_writer(async_: bool):
    """The loops' writer, gated on the process: rank 0 writes, every other
    rank gets a NullCheckpointWriter. Assumes the usual checkpoint
    directory that every host shares."""
    if process_index() != 0:
        return NullCheckpointWriter()
    return AsyncCheckpointWriter() if async_ else SyncCheckpointWriter()
