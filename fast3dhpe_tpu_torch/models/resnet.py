"""ResNet encoder (18/34/50/101/152). Port of fast3dhpe_tpu/models/resnet.py.

BasicBlock keeps the JAX package's canonical form (stride on conv1 only).
Bottleneck keeps its opt-in fused inference path: with fused_inference=True,
eval-mode stride-1 bf16 blocks that pass `Bottleneck.fusable` run as one
launch of the fused-bottleneck kernel (ops/bottleneck.py).

With remat=True each residual block is rematerialised in the backward
(torch.utils.checkpoint, as the JAX encoder's nn.remat): remat_policy None
recomputes the whole block from its input; "convs" saves the convolution
outputs and recomputes only the BN and ReLU chains (selective
checkpointing, as save_only_these_names("conv_out")). A recomputed
train-mode BN leaves its running statistics alone, so they update once a
step.

On a spatial mesh (`mesh=`, parallel/spatial.py) the encoder hands the
mesh to the stem, the max-pool and every block while the split holds
(gather_point over `encoder_ops`), and they take their halo rows through
the layers' own spatial forms. At the first op where it does not hold,
the encoder gathers the activation (gather_height) and runs the rest
whole, with no mesh. A Bottleneck that the gate fuses at the GLOBAL height
(local rows times the model ranks, so that the port fuses exactly the
blocks that the JAX gate fuses at the global size) runs the fused kernel on
its rows with one row of each neighbour's block input around them, and
drops the output rows on that halo: the kernel's own zero padding of
conv1's output is right at the global edge, where no row is added.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.bottleneck import (PackedBottleneck, fold_bn,
                              fused_bottleneck_packed, pack_weights)
from ..parallel.spatial import (crop_rows, gather_height, gather_point,
                                halo_rows)
from .layers import BatchNorm2d, Conv2d, max_pool, run_seq

# depth -> (block type, blocks per stage)
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
EXPANSION = {"basic": 1, "bottleneck": 4}


REMAT_POLICIES = (None, "convs")


def encoder_ops(num_layers: int) -> List[Tuple[str, int, int, int]]:
    """The encoder's row windows in order, (name, k, s, p), as
    parallel/spatial.py gather_point reads them: the stem, the max-pool,
    then each block's 3x3 convolution at the block's stride. A strided
    block's 1x1 downsample has the same stride and no halo, and a
    BasicBlock's second 3x3 runs on the n / s >= 1 rows its halo of 1
    needs, so one window a block decides where the split holds."""
    ops = [("conv1", 7, 2, 3), ("maxpool", 3, 2, 1)]
    for stage, blocks in enumerate(RESNET_SPEC[num_layers][1], start=1):
        for i in range(blocks):
            ops.append((f"layer{stage}.{i}", 3,
                        2 if stage > 1 and i == 0 else 1, 1))
    return ops


def _save_convs(ctx, op, *args, **kwargs):
    """The "convs" policy: keep what a convolution returns, recompute the
    rest of the block."""
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.convolution.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recomputing(block: nn.Module, inner):
    """The recompute context: `inner` (selective checkpointing's, or
    none), and the block's BNs leave their running statistics alone (the
    forward already updated them)."""
    bns = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    with inner:
        for m in bns:
            m.recomputing = True
        try:
            yield
        finally:
            for m in bns:
                del m.recomputing


def _remat_contexts(block: nn.Module, policy: Optional[str]):
    """checkpoint's context_fn: (forward context, recompute context)."""
    def contexts():
        if policy == "convs":
            fwd, rec = create_selective_checkpoint_contexts(_save_convs)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _recomputing(block, rec)
    return contexts


def _downsample(cin, cout, stride):
    return nn.Sequential(Conv2d(cin, cout, 1, stride, 0, bias=False),
                         BatchNorm2d(cout))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block, stride on conv1 only."""

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x, mask=None, mesh=None):
        out = torch.relu(self.bn1(self.conv1(x, mesh), mask))
        out = self.bn2(self.conv2(out, mesh), mask)
        residual = (x if self.downsample is None
                    else run_seq(self.downsample, x, mask, mesh))
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) residual block."""

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 fused_inference=False):
        super().__init__()
        self.planes = planes
        self.stride = stride
        self.fused_inference = fused_inference
        self.conv1 = Conv2d(inplanes, planes, 1, 1, 0, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if downsample else None)
        self._k3_packed = None      # (key, storages, PackedBottleneck)

    def fusable(self, H: int, W: int, dtype) -> bool:
        """The fused-kernel gate: whether an input of this spatial size and
        dtype takes the kernel. It reproduces the JAX gate
        (models/resnet.py:107-118) exactly, VMEM estimate included, so both
        packages fuse the same blocks."""
        if (not self.fused_inference or self.training or self.stride != 1
                or dtype != torch.bfloat16):
            return False
        cin, P = self.conv1.in_channels, self.planes
        vmem = 2 * H * W * (2 * cin + 2 * 4 * P + 9 * P + P)
        return vmem < 13 * 2 ** 20 and H * W >= 1024

    def _k3_sources(self):
        mods = [self.conv1, self.bn1, self.conv2, self.bn2, self.conv3,
                self.bn3] + (list(self.downsample) if self.downsample
                             is not None else [])
        return [t for m in mods for t in (m.weight, getattr(m, "bias", None),
                                          getattr(m, "running_mean", None),
                                          getattr(m, "running_var", None))
                if t is not None]

    def packed_weights(self, device) -> PackedBottleneck:
        """The fused kernel's weights on `device`: BNs folded, weights in
        the JAX layouts, packed (ops/bottleneck.py pack_weights). Built once
        and kept while every source tensor keeps its (data_ptr, _version).
        The cache holds the sources' storages, so no new tensor can take
        one of their addresses while it lives: load_state_dict, an in-place
        edit, .to() or a dtype round trip rebuilds it. An edit made through
        `.data` has a version counter of its own and is not seen: edit the
        parameter itself, under torch.no_grad()."""
        sources = self._k3_sources()
        key = (torch.device(device),) + tuple(
            (t.data_ptr(), t._version) for t in sources)
        if self._k3_packed is not None and self._k3_packed[0] == key:
            return self._k3_packed[2]

        def folded(bn):
            return fold_bn(bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, bn.eps)

        with torch.no_grad():
            s1, b1 = folded(self.bn1)
            s2, b2 = folded(self.bn2)
            s3, b3 = folded(self.bn3)
            w1 = self.conv1.weight[:, :, 0, 0].t()          # (Cin, P)
            w2 = self.conv2.weight.permute(2, 3, 1, 0)      # (3, 3, P, P)
            w3 = self.conv3.weight[:, :, 0, 0].t()          # (P, 4P)
            wd = sd = bd = None
            if self.downsample is not None:
                wd = self.downsample[0].weight[:, :, 0, 0].t()  # (Cin, 4P)
                sd, bd = folded(self.downsample[1])
            packed = pack_weights(w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd,
                                  bd, device=device)
        self._k3_packed = (key, [t.untyped_storage() for t in sources],
                           packed)
        return packed

    def _fused(self, x):
        return fused_bottleneck_packed(x, self.packed_weights(x.device))

    def _fused_tile(self, x, mesh):
        """The fused kernel on this model rank's rows with one row of each
        neighbour's block input (none at the global edge), the output rows
        on the halo dropped."""
        top = int(mesh.model_rank > 0)
        bottom = int(mesh.model_rank < mesh.model_size - 1)
        y = self._fused(halo_rows(x, 2, 1, 1, mesh, None))
        return crop_rows(y, 2, top, bottom)

    def forward(self, x, mask=None, mesh=None):
        """mesh: the spatial mesh while the split holds (x is then this
        model rank's rows), else None."""
        m = 1 if mesh is None else mesh.model_size
        if self.fusable(x.shape[2] * m, x.shape[3], x.dtype):
            return (self._fused(x) if mesh is None
                    else self._fused_tile(x, mesh))
        out = torch.relu(self.bn1(self.conv1(x, mesh), mask))
        out = torch.relu(self.bn2(self.conv2(out, mesh), mask))
        out = self.bn3(self.conv3(out, mesh), mask)
        residual = (x if self.downsample is None
                    else run_seq(self.downsample, x, mask, mesh))
        return torch.relu(out + residual)


def _conv_out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


class ResNetEncoder(nn.Module):
    """(B, 3, H, W) -> (B, 512 * expansion, H/32, W/32).

    remat / remat_policy: rematerialise each block in the backward (see
    the module's docstring); an unknown policy raises ValueError."""

    def __init__(self, num_layers=101, fused_inference=False, remat=False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                             f"expected one of {REMAT_POLICIES}")
        self.remat, self.remat_policy = remat, remat_policy
        block_name, stage_sizes = RESNET_SPEC[num_layers]
        expansion = EXPANSION[block_name]
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), stage_sizes), start=1):
            layer = []
            for i in range(blocks):
                s = (1 if stage == 1 else 2) if i == 0 else 1
                downsample = i == 0 and (s != 1
                                         or inplanes != planes * expansion)
                if block_name == "bottleneck":
                    layer.append(Bottleneck(inplanes, planes, s, downsample,
                                            fused_inference))
                else:
                    layer.append(BasicBlock(inplanes, planes, s, downsample))
                inplanes = planes * expansion
            setattr(self, f"layer{stage}", nn.Sequential(*layer))
        self.out_channels = inplanes
        self.ops = encoder_ops(num_layers)

    def blocks(self):
        for stage in range(1, 5):
            for i, blk in enumerate(getattr(self, f"layer{stage}")):
                yield f"layer{stage}.{i}", blk

    def fused_blocks(self, image_hw: Tuple[int, int], dtype) -> List[str]:
        """Names of the blocks that take the fused kernel for an input of
        this size and dtype, from shapes alone (no forward pass)."""
        H, W = (_conv_out(_conv_out(d, 7, 2, 3), 3, 2, 1) for d in image_hw)
        names = []
        for name, blk in self.blocks():
            if isinstance(blk, Bottleneck) and blk.fusable(H, W, dtype):
                names.append(name)
            H, W = (_conv_out(d, 3, blk.stride, 1) for d in (H, W))
        return names

    def forward(self, x, mask=None, mesh=None):
        """mask: the (B,) BN row mask (layers.bn_row_mask) of x's rows.
        mesh: a spatial mesh, x then holding this model rank's rows; the
        output is its rows while the split holds through every op
        (parallel/spatial.py split_after), else whole."""
        g = (None if mesh is None else
             gather_point(x.shape[2] * mesh.model_size, mesh.model_size,
                          self.ops))
        remat = self.remat and torch.is_grad_enabled()
        steps = [lambda x, mesh: torch.relu(self.bn1(self.conv1(x, mesh),
                                                     mask)),
                 max_pool]
        for _, blk in self.blocks():
            if remat:
                steps.append(lambda x, mesh, blk=blk: checkpoint(
                    blk, x, mask, mesh, use_reentrant=False,
                    context_fn=_remat_contexts(blk, self.remat_policy)))
            else:
                steps.append(lambda x, mesh, blk=blk: blk(x, mask, mesh))
        for i, step in enumerate(steps):
            if i == g:
                x, mesh = gather_height(x, mesh, 2), None
            x = step(x, mesh)
        return x
