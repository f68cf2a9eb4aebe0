"""Process-group initialisation and per-host record shards. Port of
fast3dhpe_tpu/parallel/distributed.py.

PyTorch runs one process per GPU, so the JAX package's multi-process form
is the port's only form: `torchrun --nproc_per_node N` starts N processes,
each drives the card `cuda:LOCAL_RANK`, and every collective goes through
one process group. `init_distributed` reads torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and is a no-op
without WORLD_SIZE, as the JAX one is without JAX_COORDINATOR_ADDRESS. It
initialises from WORLD_SIZE=1 up, so `torchrun --nproc_per_node 1` runs
the collectives too.

Across cards every rank is NCCL on its own card, `cuda:LOCAL_RANK`:
`torch.cuda.set_device` first, then `init_process_group(device_id=...)`,
which makes the communicators at init (and the model and data groups by
splitting them), so a rank that cannot reach the others fails there and
not in its first collective. NCCL refuses two ranks on one card
("Duplicate GPU detected"); ranks that share a card take gloo, which the
caller asks for (`backend="gloo", device="cuda:0"`): gloo reduces CUDA
tensors by way of the host, and has no point-to-point send of them, so
parallel/mesh.py gives such a mesh the all_reduce ("slots") form of the
spatial exchanges and an NCCL mesh the neighbour form. Nothing here falls
back from one backend or device to another; a failed initialisation
raises. `timeout` bounds every collective, so a rank whose peers are gone
fails after it rather than after NCCL's default of ten minutes.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# The device this process drives, recorded by init_distributed for
# make_mesh: a process belongs to one group and one device, as
# torch.distributed's own default group is process-wide.
_RANK_DEVICE: Optional[torch.device] = None


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the ranks on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank device {dev} does not exist: this host has "
            f"{torch.cuda.device_count()} CUDA device(s). NCCL needs one "
            f"card a rank; to share a card, pass backend='gloo' and the "
            f"card as device")
    return dev


def init_distributed(backend: Optional[str] = None, device=None,
                     init_method: str = "env://",
                     timeout: Optional[float] = None) -> bool:
    """Join the process group that torchrun's environment describes.

    Args:
      backend: "nccl" or "gloo"; None takes nccl for a CUDA device and gloo
        for the CPU.
      device: this rank's device; None or "cuda" is cuda:LOCAL_RANK.
      init_method: where the ranks meet; torchrun's MASTER_ADDR and
        MASTER_PORT ("env://") unless a file:// or tcp:// URL is given.
    Returns:
      True when this call created the group (its caller destroys it with
      destroy_distributed), False when WORLD_SIZE is unset or a group
      already exists.
    """
    global _RANK_DEVICE
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    _RANK_DEVICE = dev
    return True


def destroy_distributed() -> None:
    """Leave the process group and forget this rank's device."""
    global _RANK_DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None


def rank_device() -> Optional[torch.device]:
    """The device init_distributed gave this rank, or None."""
    return _RANK_DEVICE


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


# the shard's defaults, under names that its arguments do not hide
_process_index, _process_count = process_index, process_count


def shard_records_for_host(records: Sequence,
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None) -> List:
    """This host's records: records[pi::pc]. Each host decodes only its
    shard; the global batch is the ranks' local batches together."""
    pi = _process_index() if process_index is None else process_index
    pc = _process_count() if process_count is None else process_count
    return list(records)[pi::pc]
