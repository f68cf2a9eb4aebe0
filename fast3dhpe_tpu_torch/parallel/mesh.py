"""The data-parallel mesh and the collectives of a global-batch step. Port
of fast3dhpe_tpu/parallel/mesh.py.

The JAX package runs one program over the global batch: XLA shards the
batch over the mesh's "data" axis and inserts the reductions. PyTorch runs
a process per GPU (parallel/distributed.py), so here the mesh is the
process group, and each rank holds the local rows of the global batch.
The port computes what the JAX program computes by reducing, by hand,
exactly what the global program reduces:

  - train-mode BN: the masked sums, sums of squares and count in the
    forward, and the two sums of the backward (models/layers.py);
  - the valid and total row counts of the step, which the BN fallback,
    the loss normaliser and the metrics' denominators share;
  - the gradient (SUM of the ranks' gradients of their shares of the
    global loss), and the reported losses and metrics.

Every reduction is one `all_reduce` of one packed tensor (per dtype);
replication is a `broadcast`, and the loops order their writes by a
`barrier`. A collective may be captured into a CUDA graph
(train/graphs.py) only on a group that has already run one eagerly, so
that its NCCL communicator exists: a captured collective on any other
group raises. A spatial mesh exchanges rows between its model ranks in one
of two forms, recorded once, when make_mesh builds it, as
`Mesh.exchange` (parallel/spatial.py does the exchanges):

  - "neighbours", under NCCL (one rank a card, across cards): a halo is
    one batch_isend_irecv with the model ranks above and below, the
    edge rows only, and the gather and the keypoint statistics one
    `all_gather` (all_gather_into_tensor), XLA's collective-permute and
    all-gather;
  - "slots", under gloo (ranks sharing a card, or the CPU): every
    exchange is one all_reduce of M zeroed slots of int32 words, the
    collective that gloo runs on CUDA tensors, which have no
    point-to-point send over gloo.

The form follows the backend and never changes after a failure;
make_mesh(exchange=...) sets it explicitly (the CPU tests run the
neighbour form over gloo on CPU tensors). COUNTS counts the collectives
by kind and COUNTS_BYTES the bytes that this rank hands to them. The
explicit reduction in one place
(train/steps.py) takes the place of DistributedDataParallel: DDP would
average rather than sum, wrap the model (and its state-dict keys) and
broadcast the BN buffers, none of which the global-batch step wants.

JAX names and what they are here:
  make_mesh, replicate, shard_batch: below.
  batch_sharding, replicated_sharding, local_mesh_devices: no PyTorch
    counterpart. PyTorch has no sharding annotations: a rank's tensors are
    its shard by construction, replication is `replicate`, and a process
    drives one device (Mesh.device), not a list of them.
  shard_stacked: below. JAX places one global (S, B, ...) stack on the
    mesh with the batch axis sharded over "data"; here it cuts this
    rank's block of rows from such a stack. The loops need no cut: a
    rank's loader stacks its own record shard, which is that block
    (data/loader.py), so the stacked epochs and segments run under a
    mesh as they run alone (train/steps.py), each step's collectives
    captured in its CUDA graph under NCCL (train/graphs.py).
  make_mesh(model_parallel=M), spatial_sharding, shard_batch_spatial:
    spatial partitioning, the image height split over a "model" axis of M
    ranks (below, and parallel/spatial.py for the exchanges). The D*M
    ranks form D data groups of M model ranks: rank r has data index
    r // M and model index r % M, JAX's devices.reshape(n // M, M). The
    model group (the M ranks of a data index) runs the halo exchanges, the
    gather and the keypoint combine; the data group (the D ranks of a
    model index) the row counts, the metrics and, in training, the BN
    statistics and the gradient. A split model serves eval forwards
    (replicate installs the mesh on the networks); training on split
    images is not applicable (parallel/spatial.py). The loops, the loaders
    and the device cache take any (D, M) mesh with the JAX loops' meaning:
    whole images, the records sharded by the data index, the model
    replicated over the model axis (replicate(..., spatial=False)), so the
    M model ranks of a data group run the same steps on the same rows.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import distributed

#: collectives issued since a caller last cleared it, by kind ("bn
#: forward", "bn backward", "rows", "gradients", "metrics", "broadcast",
#: "barrier", "plan", "capture"; on a spatial mesh "halo", "keypoints",
#: "gather"), as the kernel wrappers count their launches; a CUDA graph
#: adds its step's at each replay (train/graphs.py)
COUNTS: Counter = Counter()
#: the bytes this rank hands to those collectives, by the same kinds: an
#: all_reduce's or broadcast's whole packed tensor, what a neighbour
#: exchange sends to the two neighbours, an all_gather's own part
COUNTS_BYTES: Counter = Counter()

#: Mesh.exchange: the spatial exchanges' form by the process group's
#: backend (parallel/spatial.py)
EXCHANGES = {"nccl": "neighbours", "gloo": "slots"}

# id -> group of every process group that has run a collective eagerly
# (the group is held, so that its id is not reused by another)
_FORMED: Dict[int, object] = {}


def _issue(group) -> None:
    """Record an eager collective on `group`; inside a CUDA graph capture
    refuse a group that has run none, whose NCCL communicator may not
    exist yet (forming one allocates and synchronises, which a capture
    cannot hold)."""
    g = dist.group.WORLD if group is None else group
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        if id(g) not in _FORMED:
            raise RuntimeError(
                "a collective captured into a CUDA graph on a process group "
                "that has run no collective eagerly: its communicator must "
                "be formed before the capture (run the step once eagerly)")
    else:
        _FORMED[id(g)] = g


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of processes, one device a rank. group, rank
    and size are the data group's (WORLD at model_size 1); model_group,
    model_rank and model_size the model group's (None, 0 and 1 without a
    spatial split); exchange the form of the spatial exchanges,
    "neighbours" or "slots" (EXCHANGES)."""
    group: object
    rank: int
    size: int
    device: torch.device
    model_group: object = None
    model_rank: int = 0
    model_size: int = 1
    exchange: str = "slots"


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1,
              exchange: Optional[str] = None) -> Mesh:
    """The mesh of the process group that init_distributed joined: D data
    groups of M = model_parallel model ranks.

    n_devices other than the world size raises: the JAX package puts N
    devices in one process, PyTorch runs one process a device, so an
    N-device mesh is N processes (torchrun --nproc_per_node N). So does a
    world size that M does not divide. At M > 1 every rank calls
    dist.new_group for every group, in the same order. exchange: the
    spatial exchanges' form, "neighbours" or "slots"; None takes the
    backend's (EXCHANGES: NCCL's point-to-point sends, gloo's all_reduce).
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with torchrun "
                           "and call init_distributed() first")
    device = distributed.rank_device()
    if device is None:
        raise RuntimeError("the process group was not made by "
                           "init_distributed, so this rank's device is "
                           "unknown")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {size} "
            f"ranks: PyTorch runs one process a device, so a mesh of N "
            f"devices is N processes (torchrun --nproc_per_node N)")
    if model_parallel < 1 or size % model_parallel:
        raise ValueError(f"{size} ranks (the world size) not divisible by "
                         f"model_parallel={model_parallel}")
    if exchange is None:
        backend = dist.get_backend()
        if backend not in EXCHANGES:
            raise ValueError(f"no spatial exchange for the backend "
                             f"{backend!r}: pass exchange='neighbours' or "
                             f"'slots'")
        exchange = EXCHANGES[backend]
    elif exchange not in EXCHANGES.values():
        raise ValueError(f"exchange={exchange!r}: expected one of "
                         f"{sorted(EXCHANGES.values())}")
    rank = dist.get_rank()
    if model_parallel == 1:
        return Mesh(dist.group.WORLD, rank, size, device, exchange=exchange)
    m, d = model_parallel, size // model_parallel
    model_group = data_group = None
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)])
        if i == rank // m:
            model_group = g
    for j in range(m):
        g = dist.new_group([i * m + j for i in range(d)])
        if j == rank % m:
            data_group = g
    return Mesh(data_group, rank // m, d, device, model_group, rank % m, m,
                exchange)


def mesh_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device a loop or loader runs on: the mesh's under a mesh (which
    init_distributed chose; `device` is then not read), else `device`.
    The loops, the loaders and the device cache call it."""
    if mesh is not None:
        return mesh.device
    from ..device import resolve_device
    return resolve_device(device)


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, o = [], 0
    for t in like:
        out.append(flat[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return out


def all_reduce(group, tensors: Sequence[torch.Tensor], kind: str
               ) -> List[torch.Tensor]:
    """The SUM over the ranks of each tensor, packed into one all_reduce:
    new tensors of the same shapes (one dtype; the inputs are untouched)."""
    flat = _pack(tensors)
    COUNTS[kind] += 1
    COUNTS_BYTES[kind] += flat.numel() * flat.element_size()
    _issue(group)
    dist.all_reduce(flat, group=group)
    return _unpack(flat, tensors)


# torch 2.13 renames all_gather_into_tensor; 2.11 has only the old name
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def all_gather(group, tensor: torch.Tensor, kind: str) -> torch.Tensor:
    """Every rank's `tensor` (one shape on every rank of the group) in rank
    order, (n, *tensor.shape), bit for bit: one all_gather_into_tensor of
    the tensor's bytes, XLA's all-gather. The input is untouched."""
    n = dist.get_world_size(group)
    mine = tensor.contiguous().view(-1).view(torch.uint8)
    out = torch.empty(n * mine.numel(), dtype=torch.uint8,
                      device=tensor.device)
    COUNTS[kind] += 1
    COUNTS_BYTES[kind] += mine.numel()
    _issue(group)
    _all_gather_single(out, mine, group=group)
    return out.view(tensor.dtype).view(n, *tensor.shape)


def broadcast_(group, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank src's values into every rank's tensors, one broadcast a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = _pack(ts)
        COUNTS["broadcast"] += 1
        COUNTS_BYTES["broadcast"] += flat.numel() * flat.element_size()
        _issue(group)
        dist.broadcast(flat, src=src, group=group)
        for t, s in zip(ts, _unpack(flat, ts)):
            t.copy_(s)


def world_rows(mesh: Mesh, values: Sequence[int], kind: str) -> np.ndarray:
    """Every rank's `values` (the same count of ints on every rank), as a
    (world size, k) int64 array in global rank order: one all_reduce of
    zeroed slots over the whole world, each rank's row its own. The loops
    agree a run's path and counts by it, the graphs a capture's outcome;
    the caller derives a MIN, a MAX or a SUM from the rows."""
    rows = torch.zeros((dist.get_world_size(), len(values)),
                       dtype=torch.int64, device=mesh.device)
    rows[dist.get_rank()] = torch.as_tensor(list(values), dtype=torch.int64)
    COUNTS[kind] += 1
    COUNTS_BYTES[kind] += rows.numel() * rows.element_size()
    _issue(None)
    dist.all_reduce(rows)
    return rows.cpu().numpy()


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the world, all data and model ranks
    (nothing without a mesh): the loops order global rank 0's writes of
    the model directory against every rank's reads with it, and the data
    group alone would leave the other model ranks out. Under NCCL it
    names the rank's card, which NCCL would otherwise guess."""
    if mesh is not None:
        COUNTS["barrier"] += 1
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


def replicate(mesh: Mesh, model: nn.Module, spatial: bool = True
              ) -> nn.Module:
    """Rank 0's parameters and buffers on every rank; the data group on
    every BatchNorm2d of the port (as SyncBatchNorm.convert_sync_batchnorm
    sets it), so that train-mode BN takes global batch statistics; and on
    a spatial mesh, with `spatial`, the mesh as `spatial` on every network
    whose class has that field (CDRNet, PoseResNet, Int8CDRNet), whose
    forward then takes this model rank's rows and hands the mesh to its
    layers while the split holds. The training loops pass spatial=False:
    they train whole images on every model rank, as the JAX loops do. The
    model must already lie on mesh.device. Returns the model."""
    from ..models.layers import BatchNorm2d
    with torch.no_grad():
        broadcast_(dist.group.WORLD, list(model.parameters())
                   + list(model.buffers()))
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = mesh.group
        if spatial and mesh.model_size > 1 and hasattr(type(m), "spatial"):
            m.spatial = mesh
    return model


def shard_batch(mesh: Mesh, batch) -> Dict[str, torch.Tensor]:
    """This rank's local rows of the global batch, on its device (the JAX
    package's multi-process meaning: each host supplies its own rows)."""
    return {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()}


def shard_stacked(mesh: Mesh, tree, lead: int = 1):
    """This rank's block of the batch axis of stacked-epoch arrays, on its
    device: JAX's shard_stacked, which shards axis `lead` (after `lead`
    scan axes: 1 for an epoch's (S, B, ...), 2 for a segment's
    (E, S, B, ...)) over "data", so that device i of D holds rows
    [i * B / D, (i + 1) * B / D). Here D is mesh.size and i the data index
    mesh.rank, so the M model ranks of a data group get the same rows.
    tree: a dict of arrays or tensors (nested dicts too). A batch axis
    that D does not divide raises ValueError, as JAX's device_put does."""

    def block(v):
        t = torch.as_tensor(v)
        n = t.shape[lead]
        if n % mesh.size:
            raise ValueError(f"shard_stacked: the batch axis (axis {lead}) "
                             f"holds {n} rows, which {mesh.size} data "
                             f"shards do not divide")
        per = n // mesh.size
        return t.narrow(lead, mesh.rank * per, per).contiguous().to(
            mesh.device)

    return {k: shard_stacked(mesh, v, lead) if isinstance(v, dict)
            else block(v) for k, v in tree.items()}


def row_counts(mesh: Optional[Mesh], row_valid, n_rows: int, device):
    """(valid rows, rows) of the global batch as 0-d fp32 tensors, one
    all_reduce; None without a mesh (the local batch is the global one)."""
    if mesh is None:
        return None
    # fills, not tensors from host data: a CUDA graph captures the step
    total = torch.full((), float(n_rows), dtype=torch.float32, device=device)
    valid = (torch.as_tensor(row_valid, device=device).float().sum()
             if row_valid is not None else total)
    counts = torch.stack([valid, total])
    valid, total = all_reduce(mesh.group, [counts], "rows")[0]
    return valid, total


def spatial_sharding(mesh: Mesh, ndim: int, height: int) -> Tuple:
    """The index that cuts this model rank's rows from an image batch of
    global height `height`: (B, V, H, W, 3) stereo -> [:, :, rows],
    (B, H, W, 3) mono -> [:, rows], the counterpart of JAX's
    P("data", None, "model") and P("data", "model") (the data axis is the
    rows a data group holds, as in shard_batch). Raises ValueError for
    another ndim or an H not divisible by M (parallel/spatial.py
    check_split)."""
    from .spatial import check_split
    if ndim not in (4, 5):
        raise ValueError(f"expected a 4-D/5-D image batch, got ndim={ndim}")
    check_split(height, mesh.model_size)
    h = height // mesh.model_size
    rows = slice(mesh.model_rank * h, (mesh.model_rank + 1) * h)
    return (slice(None),) * (ndim - 3) + (rows,)


def shard_batch_spatial(mesh: Mesh, batch) -> Dict[str, torch.Tensor]:
    """shard_batch with the height of every leaf named "image" split over
    the model axis: the data group's local rows of each leaf (every model
    rank of a data group passes the same rows) on this rank's device, the
    images cut to this model rank's rows (spatial_sharding)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k == "image":
            t = t[spatial_sharding(mesh, t.dim(), t.shape[t.dim() - 3])]
        out[k] = t.contiguous().to(mesh.device)
    return out
