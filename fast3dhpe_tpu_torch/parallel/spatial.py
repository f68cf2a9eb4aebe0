"""Spatial partitioning: the image height split over the mesh's "model"
axis. Port of what XLA gives fast3dhpe_tpu/parallel/mesh.py
`shard_batch_spatial` for free.

The JAX package runs one program over the global image and lets XLA
partition every convolution by rows and insert the halo exchanges. PyTorch
has no partitioner, so the port makes each step explicit. Model rank j of
M holds image rows [j*H/M, (j+1)*H/M) (`check_split`: H divisible by M,
as in JAX). The network's forward hands the mesh to each layer while the
split holds (`gather_point`: every rank's block at an op's input is a
whole multiple of the op's stride and holds the op's halo rows); at the
first op where it does not, it gathers the activation once
(`gather_height`) and runs the rest whole on every model rank, with no
mesh. While split:

  - a convolution, max-pool or transposed convolution fetches the rows its
    window reaches beyond the rank's block from the neighbours
    (`halo_rows`), fills them at the global edge with its own pad value
    (0 for a convolution, -inf for the max-pool), runs with H padding 0
    and crops what a transposed convolution makes on the halo. The rows
    each op needs are `conv_halo` and `deconv_halo`, derived below, and
    the layers take them through `window_rows` and `deconv_rows`;
  - eval-mode BN, the 1x1 convolutions and CanonicalFusion's FTL are per
    pixel, so they stay local;
  - the soft-argmax spans the whole heatmap: K1 runs on the rank's rows
    and the ranks' statistics combine exactly by log-sum-exp
    (`split_soft_argmax`), so every model rank decodes the same keypoints
    and the geometry after it runs replicated;
  - a heatmap-returning forward returns the rank's rows, and
    `gather_height` assembles the whole heatmap (`heatmap_split` says
    which of the two a forward returns).

The exchanges take the form that the mesh records (parallel/mesh.py
`Mesh.exchange`, chosen once by the process group's backend). Either way
the rows travel as raw bytes, so they arrive bit for bit, -0.0 and NaN
included, whatever their dtype (fp32, bf16, the int8 path's codes):

  - "neighbours" (NCCL, one rank a card, across cards): a halo is one
    `batch_isend_irecv` with the model ranks above and below, as XLA's
    collective-permute moves it: a rank sends its first `bottom` rows up
    and its last `top` rows down from contiguous staging buffers, and
    receives only the rows its window reaches; the ranks at the global
    edge post only the operations whose peer exists. The gather and the
    keypoint statistics are one `all_gather` over the model group
    (parallel/mesh.py), XLA's all-gather;
  - "slots" (gloo: ranks that share a card, whose CUDA tensors gloo
    cannot send point to point, and the CPU): every exchange is one
    `all_reduce` over the model group of a zeroed buffer with one slot a
    rank, in which each rank writes what its neighbours need, as int32
    words, so the sum of a word and zeros cannot round. Every rank sends
    and receives M slots where the neighbour form moves the edge rows.

Training on a spatial mesh (train-mode BN over data x model, the adjoint
of the halo exchange, K2 over a split heatmap) is not applicable and
raises: the JAX package trains no model on split images, and its docs call
the layout a serving layout. Its training loops on a (data, model) mesh
train whole images, replicated over the model axis (parallel/mesh.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.softargmax import soft_argmax_fused, soft_argmax_stats
from .mesh import COUNTS, COUNTS_BYTES, all_gather, all_reduce

NOT_APPLICABLE = (
    "not applicable: no caller of the JAX package trains on split images "
    "(shard_batch_spatial serves eval forwards; docs/SCALING.md calls it "
    "a serving layout), and its training loops on a (data, model) mesh "
    "train whole images, as the port's do")


def check_split(height: int, model_size: int) -> None:
    """The split rule, JAX's: the global image height divisible by M.
    Raises ValueError naming the rule."""
    if model_size > 1 and height % model_size:
        raise ValueError(
            f"spatial split: the image height {height} must be divisible by "
            f"model_parallel = {model_size}, so that every model rank holds "
            f"the same number of rows")


def gather_point(height: int, model_size: int,
                 ops: Sequence[Tuple[str, int, int, int]]) -> Optional[int]:
    """Where a forward split over M = model_size ranks gathers: the index
    into `ops` ((name, k, s, p) windows in order, models/resnet.py
    encoder_ops) of the first op at which a rank's block of n rows breaks
    the split, n % s != 0 (the block would not start where conv_halo
    assumes) or n < the op's halo (halo_rows reads the neighbours' rows
    only); None when the split holds through every op, or M = 1. The
    activation is gathered (gather_height) before that op, which and
    every op after it run whole. The height must pass check_split."""
    check_split(height, model_size)
    if model_size == 1:
        return None
    n = height // model_size
    for i, (_, k, s, p) in enumerate(ops):
        if n % s or n < max(conv_halo(k, s, p)):
            return i
        n //= s
    return None


def split_after(mesh, rows: int, ops) -> Optional[object]:
    """The mesh that what follows `ops` runs on, for a forward of `rows`
    image rows a rank: `mesh` while the split holds through every op
    (gather_point None), None once the forward has gathered, or without a
    mesh. The decoder's transposed convolutions need one row a rank, which
    every split block holds."""
    if mesh is None or gather_point(rows * mesh.model_size, mesh.model_size,
                                    ops) is not None:
        return None
    return mesh


def heatmap_split(model, rows: int) -> bool:
    """Whether `model`'s forward on `rows` image rows a rank returns this
    model rank's rows of the heatmap (the split held through the encoder)
    rather than the whole heatmap (no spatial mesh, or the forward
    gathered): the one question the eval steps ask before they gather."""
    mesh = getattr(model, "spatial", None)
    return split_after(mesh, rows, model.encoder.ops) is not None


def spatial_of(module) -> Optional[object]:
    """The spatial mesh that `replicate` installed on a network, or None.
    A network in training mode on a spatial mesh raises
    NotImplementedError: training on split images would need train-mode
    BN over data x model, the adjoint of the halo exchange and K2 over a
    split heatmap, and is not applicable."""
    mesh = getattr(module, "spatial", None)
    if mesh is not None and module.training:
        raise NotImplementedError(
            f"training on a spatial mesh (model_parallel="
            f"{mesh.model_size}) is {NOT_APPLICABLE}; call .eval() to "
            f"serve, or replicate(mesh, model, spatial=False) to train "
            f"whole images")
    return mesh


def conv_halo(k: int, s: int, p: int) -> Tuple[int, int]:
    """(top, bottom): the rows a k x k convolution or pool of stride s and
    padding p reads beyond a block of rows [a, b) with a and b multiples
    of s, to make its outputs [a/s, b/s). Output o reads input rows
    s*o - p .. s*o - p + k - 1: the first, o = a/s, reaches p rows above
    a; the last, o = b/s - 1, reaches k - p - s rows below b - 1. With
    H padding 0 the padded block of n + top + bottom rows gives n/s
    outputs. Stem (7, 2, 3): (3, 2); 3x3 stride 1: (1, 1); 3x3 stride 2
    and the max-pool: (1, 0); 1x1: (0, 0)."""
    return p, max(0, k - p - s)


def deconv_halo(k: int, s: int, p: int) -> Tuple[int, int, int, int]:
    """(top, bottom, crop_top, crop_bottom) of a transposed convolution of
    kernel k, stride s, padding p on a block of input rows [a, b), whose
    outputs are [s*a, s*b). Output o = s*i - p + kh reads input rows i
    with kh in [0, k): o = s*a reaches (k - 1 - p) // s rows above a, o =
    s*b - 1 reaches 1 + (p - 1) // s rows at and below b. Run with H
    padding 0 on the padded block, its output row o' is global row
    o' + s*(a - top) - p: crop s*top + p rows on top and the rest below.
    The decoder's (4, 2, 1): (1, 1, 3, 3)."""
    top, bottom = (k - 1 - p) // s, 1 + (p - 1) // s
    crop_top = s * top + p
    crop_bottom = s * bottom - s + k - p
    return top, bottom, crop_top, crop_bottom


def _exchange(parts: Sequence[torch.Tensor], mesh, kind: str
              ) -> List[List[torch.Tensor]]:
    """Every model rank's `parts` (one dtype; the same shapes on every
    rank), bit for bit: the slot form, one all_reduce over the model group
    of M zeroed slots of int32 words, this rank's slot holding the parts'
    bytes. Returns, for each model rank j, views of its parts."""
    dt = parts[0].dtype
    nbytes = [p.numel() * p.element_size() for p in parts]
    words = max(1, -(-sum(nbytes) // 4))
    buf = torch.zeros((mesh.model_size, words), dtype=torch.int32,
                      device=parts[0].device)
    slot = buf[mesh.model_rank].view(torch.uint8)
    o = 0
    for p, n in zip(parts, nbytes):
        if n:
            slot[o:o + n].copy_(p.contiguous().view(-1).view(torch.uint8))
        o += n
    buf = all_reduce(mesh.model_group, [buf], kind)[0]
    out = []
    for j in range(mesh.model_size):
        row, o, views = buf[j].view(torch.uint8), 0, []
        for p, n in zip(parts, nbytes):
            views.append(row[o:o + n].view(dt).view(p.shape))
            o += n
        out.append(views)
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes in a contiguous staging buffer: (numel * itemsize,)
    uint8."""
    return t.contiguous().view(-1).view(torch.uint8)


def _neighbours(first: torch.Tensor, last: torch.Tensor, mesh, kind: str
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The neighbour form of a halo, in one batch_isend_irecv over the
    model group: `first` (this rank's first `bottom` rows) to the model
    rank above and `last` (its last `top` rows) to the rank below, from
    contiguous staging buffers as raw bytes. Returns (the rank above's
    `last`, the rank below's `first`): None where there is no such rank,
    and nothing is sent or received where the rows are empty (a halo of
    0 on that side). Every rank posts its operations in one order, the
    rank above first and the send before the receive."""
    j, m = mesh.model_rank, mesh.model_size
    ops, got, sent = [], [None, None], 0
    for side, (near, out, back) in enumerate(((j - 1, first, last),
                                              (j + 1, last, first))):
        if not 0 <= near < m:
            continue
        peer = dist.get_global_rank(mesh.model_group, near)
        if out.numel():
            buf = _bytes(out)
            sent += buf.numel()
            ops.append(dist.P2POp(dist.isend, buf, peer, mesh.model_group))
        if back.numel():
            got[side] = torch.empty(back.numel() * back.element_size(),
                                    dtype=torch.uint8, device=back.device)
            ops.append(dist.P2POp(dist.irecv, got[side], peer,
                                  mesh.model_group))
    COUNTS[kind] += 1
    COUNTS_BYTES[kind] += sent
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(None if g is None else g.view(t.dtype).view(t.shape)
                 for g, t in zip(got, (last, first)))


def _channels_last(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The port's float activations are NCHW in channels_last memory (the
    height is dim 2); the int8 path's are NHWC (dim 1), contiguous."""
    if t.dim() == 4 and dim == 2:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def halo_rows(x: torch.Tensor, dim: int, top: int, bottom: int, mesh,
              pad_value) -> torch.Tensor:
    """x with `top` rows of the model rank above and `bottom` rows of the
    rank below around it along `dim` (the height: 2 for NCHW, 1 for the
    int8 path's NHWC), in one exchange over the model group in the mesh's
    form: a batch_isend_irecv with the two neighbours ("neighbours") or
    an all_reduce of M slots ("slots").

    At the global edge the missing rows are `pad_value` (the op's own
    padding: 0 for a convolution, -inf or -128 for the max-pool), or are
    left out when pad_value is None. A rank's first `bottom` rows are the
    upper neighbour's bottom halo and its last `top` rows the lower
    neighbour's top halo. Counts into COUNTS["halo"], and what this rank
    sends into COUNTS_BYTES["halo"]: the edge rows themselves in the
    neighbour form, the M slots in the slot form."""
    n = x.shape[dim]
    if n < max(top, bottom):
        raise ValueError(f"halo_rows: the rank's {n} rows cannot supply a "
                         f"halo of {max(top, bottom)}")
    if not (top or bottom):
        return x
    first, last = x.narrow(dim, 0, bottom), x.narrow(dim, n - top, top)
    j, m = mesh.model_rank, mesh.model_size
    if mesh.exchange == "neighbours":
        above, below = _neighbours(first, last, mesh, "halo")
    else:
        slots = _exchange([first, last], mesh, "halo")
        above = slots[j - 1][1] if j > 0 else None
        below = slots[j + 1][0] if j < m - 1 else None
    pieces = []
    if top:
        if above is not None:
            pieces.append(above)
        elif pad_value is not None:
            pieces.append(torch.full_like(last, pad_value))
    pieces.append(x)
    if bottom:
        if below is not None:
            pieces.append(below)
        elif pad_value is not None:
            pieces.append(torch.full_like(first, pad_value))
    return _channels_last(torch.cat(pieces, dim), dim)


def crop_rows(y: torch.Tensor, dim: int, top: int, bottom: int
              ) -> torch.Tensor:
    """y without `top` rows above and `bottom` rows below along `dim`, in
    the activations' memory layout."""
    return _channels_last(y.narrow(dim, top, y.shape[dim] - top - bottom),
                          dim)


def window_rows(x: torch.Tensor, dim: int, k: int, s: int, p: int, mesh,
                pad_value) -> Tuple[torch.Tensor, object]:
    """(input, padding) for a k x k convolution or pool of stride s and
    padding p along `dim`: x and p as they are without a spatial mesh; on
    one, x with its halo rows (conv_halo; `pad_value` at the global edge)
    and the padding (0, p), H padding 0 and the W padding kept."""
    if mesh is None:
        return x, p
    top, bottom = conv_halo(k, s, p)
    return halo_rows(x, dim, top, bottom, mesh, pad_value), (0, p)


def deconv_rows(fn, x: torch.Tensor, dim: int, k: int, s: int, p: int,
                mesh) -> torch.Tensor:
    """fn(input, padding), a transposed convolution of kernel k, stride s
    and padding p along `dim`: fn(x, p) without a spatial mesh; on one, fn
    on x with its halo rows (deconv_halo; zeros at the global edge) and
    the padding (0, p), cropped to the rank's output rows."""
    if mesh is None:
        return fn(x, p)
    top, bottom, c_top, c_bottom = deconv_halo(k, s, p)
    y = fn(halo_rows(x, dim, top, bottom, mesh, 0), (0, p))
    return crop_rows(y, dim, c_top, c_bottom)


def gather_height(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The whole tensor from the model ranks' row blocks along `dim`, bit
    for bit, in one exchange over the model group (COUNTS["gather"]): an
    all_gather in the neighbour form, an all_reduce of M slots in the
    slot form."""
    if mesh.exchange == "neighbours":
        blocks = list(all_gather(mesh.model_group, x, "gather"))
    else:
        blocks = [s[0] for s in _exchange([x], mesh, "gather")]
    return _channels_last(torch.cat(blocks, dim), dim)


def split_soft_argmax(hm_local: torch.Tensor, mesh) -> torch.Tensor:
    """The soft-argmax of a heatmap split by rows over the model ranks:
    (N, h, W, J) local logits -> (N, J, 2) fp32 (x, y) of the whole
    heatmap, in global heatmap pixels, the same on every model rank.
    Without a spatial mesh (mesh None) it is soft_argmax_fused.

    K1's statistics (m, 1/S, cx, cy) of the rank's rows (one launch on the
    card, the plain version on the CPU; ops/softargmax.py
    soft_argmax_stats), cy shifted by the rank's first row, gathered in one
    exchange (COUNTS["keypoints"]; an all_gather in the neighbour form,
    an all_reduce of M slots in the slot form), then combined in a fixed
    order on
    every rank: M* = max m_j, w_j = S_j exp(m_j - M*),
    c = sum w_j c_j / sum w_j, which is the softmax over all rows."""
    if mesh is None:
        return soft_argmax_fused(hm_local)
    stats = soft_argmax_stats(hm_local)
    row0 = float(mesh.model_rank * hm_local.shape[1])
    stats = torch.cat([stats[..., :3], stats[..., 3:] + row0], dim=-1)
    if mesh.exchange == "neighbours":
        allst = all_gather(mesh.model_group, stats, "keypoints")
    else:
        allst = torch.stack([s[0] for s in _exchange([stats], mesh,
                                                     "keypoints")])
    m, inv_s, c = allst[..., 0], allst[..., 1], allst[..., 2:]
    w = torch.exp(m - m.amax(dim=0)) / inv_s
    return (w[..., None] * c).sum(dim=0) / w.sum(dim=0)[..., None]
