"""Decoded frames resident on the device, addressed by row. Port of
fast3dhpe_tpu/data/device_cache.py (:41-175).

Frames are decoded once on the host and copied once, in chunks, into one
preallocated (N, H, W, 3) uint8 tensor on the device; a batch is then
gathered there by row index, and per step only the indices and the
per-sample affines cross to the device. The cache holds raw (pre-warp)
frames, so a cached batch is bit-identical to an uncached one.

Under a mesh (parallel/mesh.py, any (data, model) shape) the cache lives
on the rank's device: the JAX build replicates the frames over its mesh,
and a PyTorch rank holds its own copy, on its own card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import mesh_device


class DeviceFrameCache:
    """Uniform-size uint8 frames resident on one device. `frames` is the
    (N, H, W, 3) tensor; gather with `frames.index_select(0, rows)`."""

    def __init__(self, frames: torch.Tensor, row_of: Dict[str, int],
                 partial: bool = False):
        self.frames = frames
        self._row_of = row_of
        #: True when only a prefix of the paths is resident (a budget-capped
        #: build); callers send the misses through their upload lane
        self.partial = partial

    @property
    def nbytes(self) -> int:
        return self.frames.numel() * self.frames.element_size()

    def has(self, path: str) -> bool:
        return path in self._row_of

    def rows(self, paths: Sequence[str]) -> np.ndarray:
        """int32 row indices of a batch of frame paths."""
        return np.asarray([self._row_of[p] for p in paths], np.int32)

    @classmethod
    def build(cls, paths: Sequence[str], decode_batch, budget_bytes: int,
              chunk_frames: int = 64, allow_partial: bool = False,
              pair_stride: int = 1, pad_frames_to: int = 1,
              device="cuda", mesh=None) -> Optional["DeviceFrameCache"]:
        """Decode `paths` (duplicates collapse, order kept) and copy them to
        `device`.

        Args:
          paths: frame paths.
          decode_batch: callable(list[str]) -> list of uint8 (H, W, 3).
          budget_bytes: cap on the resident bytes; 0 or None: no cache.
          chunk_frames: frames decoded and copied at a time (bounds the
            host memory a build holds).
          allow_partial: over budget, keep the largest prefix of the paths
            that fits (partial is then True) instead of returning None.
          pair_stride: round that prefix down to a multiple of this many
            paths, so a stereo pair (adjacent paths) is resident whole or
            not at all.
          pad_frames_to: round the row count of a full cache up to this
            multiple with zero frames, within the budget.
          device: where the frames live; the GPU unless "cpu" is asked for.
          mesh: a parallel.mesh.Mesh: the frames live on its device, in
            place of `device`, whole: a partial cache's upload lanes are a
            single-process schedule, so allow_partial must be False (the
            JAX loaders pass allow_partial=mesh is None).
        Returns:
          The cache, or None: over budget without allow_partial, frames of
          mixed sizes, or nothing fits. None is the JAX API's answer, for
          which callers stream from the host; it is not a device fallback.
        """
        if mesh is not None and allow_partial:
            raise ValueError("a partial cache is single-process: pass "
                             "allow_partial=False with a mesh")
        dev = mesh_device(mesh, device)
        if not budget_bytes:
            return None
        unique: List[str] = list(dict.fromkeys(paths))
        if not unique:
            return None
        probe = decode_batch(unique[:1])[0]
        h, w, c = probe.shape
        frame_bytes = h * w * c
        partial = len(unique) * frame_bytes > budget_bytes
        if partial:
            if not allow_partial:
                return None
            n_fit = budget_bytes // frame_bytes
            n_fit -= n_fit % max(pair_stride, 1)
            if n_fit <= 0:
                return None
            unique = unique[:n_fit]

        pad_rows = 0
        if pad_frames_to > 1 and not partial:
            pad_rows = (-len(unique)) % pad_frames_to
            if (len(unique) + pad_rows) * frame_bytes > budget_bytes:
                pad_rows = 0        # bucketing never breaks the budget
        # one allocation, written chunk by chunk: concatenating chunks
        # would hold the frames twice
        frames = torch.empty((len(unique) + pad_rows, h, w, c),
                             dtype=torch.uint8, device=dev)
        for start in range(0, len(unique), chunk_frames):
            batch_paths = unique[start:start + chunk_frames]
            if start == 0:
                decoded = [probe] + (decode_batch(batch_paths[1:])
                                     if len(batch_paths) > 1 else [])
            else:
                decoded = decode_batch(batch_paths)
            if any(d.shape != (h, w, c) for d in decoded):
                return None
            frames[start:start + len(decoded)].copy_(
                torch.from_numpy(np.stack(decoded).astype(np.uint8,
                                                          copy=False)))
        if pad_rows:
            frames[len(unique):].zero_()
        return cls(frames, {p: i for i, p in enumerate(unique)},
                   partial=partial)
