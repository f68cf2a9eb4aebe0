"""A movement's frames for evaluation and serving. Port of
fast3dhpe_tpu/data/stream.py `LoadMADSData` (:30-313).

Iterates one movement's stereo frames: each view is centre-cropped to the
model's input size, and the intrinsics are rewritten K <- [[trans @ K];
[0, 0, 1]] so that projections live in the cropped image.

`batches()` yields stereo batches for evaluation, decoded by the shared
batch decoder and prefetched in a background thread, in one of three
forms: index batches over a movement held on the device
(`build_device_cache`), raw frames uploaded with their crop affines
(device_warp=True), or frames cropped on the host. A movement over the
cache's budget keeps a partial cache: its resident frames come first as
index batches, the rest are streamed.
"""

from __future__ import annotations

import copy
import glob
import json
import os
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.affine import (get_affine_transform,
                               update_intrinsics_with_affine)
from ..ops.warp import affine_warp
from .device_cache import DeviceFrameCache
from .loader import _BatchDecoder, _imread, _prefetch, shared_decode_pool


def _centre_crop(h, w, image_size):
    """The eval crop: the frame's centre, scale 1, no rotation."""
    return get_affine_transform(np.array([w / 2, h / 2]), 1, 0, min(h, w),
                                image_size)


class LoadMADSData:
    """A movement's frames, one at a time (iteration) or in batches.

    Args:
      data_path: a split of an extracted tree (<root>/<set>).
      image_size: the model's (W, H).
      movement: the movement's directory under data_path.
      device: where the frame cache and the batches' frames live; the GPU
        unless "cpu" is asked for.
    Decode threads come from the process's shared pool; `close()` owns
    nothing."""

    def __init__(self, data_path: str, image_size, movement: str = "HipHop",
                 device="cuda"):
        self.device = resolve_device(device)
        self.metadata = self._gen_metadata(data_path, movement)
        self.image_size = tuple(image_size)
        self._decoder = _BatchDecoder(shared_decode_pool())
        # whether the movement's frames share one size: probed once, on the
        # first streamed batch, so that the batch shapes stay fixed
        self._uniform_size = None
        self._device_cache = None
        self._device_cache_failed = False

    @property
    def decoder_name(self) -> str:
        return self._decoder.name

    def close(self):
        """Nothing to release: the decode threads are the shared pool's."""

    def build_device_cache(self, budget_bytes: int):
        """Decode the whole movement once onto the device, left and right of
        a frame adjacent (a budget cut keeps pairs whole), the row count
        padded to a multiple of 64. A movement over the budget keeps a
        partial cache. Returns the cache, or None (frames of mixed sizes,
        or nothing fits), for which batches stream."""
        if self._device_cache is None and not self._device_cache_failed:
            paths = [p for m in self.metadata
                     for p in (m["left_img_path"], m["right_img_path"])]
            cache = DeviceFrameCache.build(paths, self._decoder,
                                           budget_bytes, allow_partial=True,
                                           pair_stride=2, pad_frames_to=64,
                                           device=self.device)
            self._device_cache_failed = cache is None
            self._device_cache = cache
        return self._device_cache

    def __len__(self):
        return len(self.metadata)

    def __iter__(self):
        self._count = 0
        return self

    def __next__(self):
        """(left crop, right crop, metadata with cropped intrinsics), host
        uint8 arrays."""
        if self._count >= len(self.metadata):
            raise StopIteration
        meta = copy.deepcopy(self.metadata[self._count])
        self._count += 1
        left_img = _imread(meta["left_img_path"])
        right_img = _imread(meta["right_img_path"])
        trans = _centre_crop(*left_img.shape[:2], self.image_size)
        for cam in ("cam_left", "cam_right"):
            meta[cam]["intrinsics"] = update_intrinsics_with_affine(
                np.array(meta[cam]["intrinsics"]), trans)
        return (self._warp(left_img, trans), self._warp(right_img, trans),
                meta)

    def _warp(self, img, trans):
        """The crop on the host: affine_warp on CPU tensors, truncated to
        uint8, as the JAX stream crops on a host without cv2."""
        out = affine_warp(torch.from_numpy(np.ascontiguousarray(img))[None],
                          trans, self.image_size)
        return out[0].numpy().astype(np.uint8)

    def _batch_proj(self, metas, transes) -> np.ndarray:
        """Crop-corrected (B, 2, 3, 4) fp32 projections: each view's K
        rewritten by the frame's crop affine, times [R | T], in float64."""
        B = len(metas)
        K = np.empty((B, 2, 3, 3))
        Rt = np.empty((B, 2, 3, 4))
        for i, (meta, trans) in enumerate(zip(metas, transes)):
            for v, cam in enumerate(("cam_left", "cam_right")):
                K[i, v] = update_intrinsics_with_affine(
                    np.array(meta[cam]["intrinsics"]), trans)
                Rt[i, v, :, :3] = np.array(meta[cam]["rotation"])
                Rt[i, v, :, 3:] = np.array(
                    meta[cam]["translation"]).reshape(3, 1)
        return np.einsum("bvij,bvjk->bvik", K, Rt).astype(np.float32)

    def batches(self, batch_size: int, device_warp: bool = False,
                device_cache_bytes: int = 0) -> Iterator[Dict]:
        """Stereo batches of `batch_size` frames, the last padded by its
        last frame; each has proj (B, 2, 3, 4), pose_3d (B, J, 3) float64
        (NaN where the ground truth lacks a joint) and n_valid.

        device_warp=False: img_l / img_r are the crops (B, H, W, 3) uint8,
        cropped on the host. device_warp=True: they are the raw frames and
        trans (B, 2, 3) their crop affines, for the consumer to warp on the
        device; a movement of mixed frame sizes is cropped on the host
        instead. Either way the frames are uint8 tensors on the stream's
        device, uploaded by the prefetch thread.

        device_cache_bytes > 0: the movement is held on the device
        (build_device_cache) and batches carry frames / idx_l / idx_r /
        trans instead of images. Under a partial cache the resident frames
        come first as such batches, then the rest stream."""
        if device_cache_bytes:
            cache = self.build_device_cache(device_cache_bytes)
            if cache is not None and not cache.partial:
                return self.cached_batches(batch_size, cache)
            if cache is not None:
                def resident(m):
                    return (cache.has(m["left_img_path"])
                            and cache.has(m["right_img_path"]))

                def chain():
                    held = [m for m in self.metadata if resident(m)]
                    rest = [m for m in self.metadata if not resident(m)]
                    if held:
                        yield from self.cached_batches(batch_size, cache,
                                                       metas=held)
                    if rest:
                        yield from self._stream_batches(batch_size,
                                                        device_warp, rest)

                return chain()
        return self._stream_batches(batch_size, device_warp, self.metadata)

    def _stream_batches(self, batch_size: int, device_warp: bool,
                        metadata: List[Dict]) -> Iterator[Dict]:
        """Streamed batches over `metadata`: decoded, cropped on the host
        unless device_warp, uploaded."""

        def gen():
            for start in range(0, len(metadata), batch_size):
                metas = [copy.deepcopy(m)
                         for m in metadata[start:start + batch_size]]
                n_valid = len(metas)
                while len(metas) < batch_size:
                    metas.append(copy.deepcopy(metas[-1]))
                raw_l = self._decoder([m["left_img_path"] for m in metas])
                raw_r = self._decoder([m["right_img_path"] for m in metas])
                transes = [_centre_crop(*im.shape[:2], self.image_size)
                           for im in raw_l]
                batch = {
                    "proj": self._batch_proj(metas, transes),
                    "pose_3d": np.stack([np.array(m["pose_3d"],
                                                  dtype=np.float64)
                                         for m in metas]),
                    "n_valid": n_valid,
                }
                shapes = {i.shape for i in raw_l} | {i.shape for i in raw_r}
                if self._uniform_size is None:
                    self._uniform_size = (next(iter(shapes))
                                          if len(shapes) == 1 else False)
                # a batch off the probed size is cropped on the host, so
                # the raw batches keep one shape
                if (device_warp and self._uniform_size
                        and shapes == {self._uniform_size}):
                    img_l, img_r = np.stack(raw_l), np.stack(raw_r)
                    batch["trans"] = np.stack(transes).astype(np.float32)
                else:
                    img_l = np.stack([self._warp(i, t)
                                      for i, t in zip(raw_l, transes)])
                    img_r = np.stack([self._warp(i, t)
                                      for i, t in zip(raw_r, transes)])
                batch["img_l"] = torch.from_numpy(img_l).to(self.device)
                batch["img_r"] = torch.from_numpy(img_r).to(self.device)
                yield batch

        return _prefetch(gen())

    def cached_batches(self, batch_size: int, cache,
                       metas=None) -> Iterator[Dict]:
        """Index batches over resident frames (`metas`: a subset, the
        resident records of a partial cache): a few KB of host work a
        batch, no image bytes."""
        metadata = self.metadata if metas is None else metas

        def gen():
            h, w = int(cache.frames.shape[1]), int(cache.frames.shape[2])
            trans0 = _centre_crop(h, w, self.image_size)
            for start in range(0, len(metadata), batch_size):
                metas = metadata[start:start + batch_size]
                n_valid = len(metas)
                metas = metas + [metas[-1]] * (batch_size - n_valid)
                transes = [trans0] * len(metas)
                yield {
                    "frames": cache.frames,
                    "idx_l": cache.rows([m["left_img_path"] for m in metas]),
                    "idx_r": cache.rows([m["right_img_path"]
                                         for m in metas]),
                    "trans": np.stack(transes).astype(np.float32),
                    "proj": self._batch_proj(metas, transes),
                    "pose_3d": np.stack([np.array(m["pose_3d"],
                                                  dtype=np.float64)
                                         for m in metas]),
                    "n_valid": n_valid,
                }

        return _prefetch(gen())

    @staticmethod
    def _gen_metadata(data_path: str, movement: str) -> List[Dict]:
        left_img_paths = sorted(glob.glob(
            os.path.join(data_path, movement, "**/left/*.jpg")))
        right_img_paths = sorted(glob.glob(
            os.path.join(data_path, movement, "**/right/*.jpg")))
        gt_pose_paths = sorted(glob.glob(
            os.path.join(data_path, movement, "**/pose/*.json")))
        if not (len(left_img_paths) == len(right_img_paths)
                == len(gt_pose_paths)):
            raise ValueError("Number of images and ground truths must match")

        metadata = []
        for left, right, pose_path in zip(left_img_paths, right_img_paths,
                                          gt_pose_paths):
            with open(pose_path, "r") as f:
                data = json.load(f)
            metadata.append({
                "cam_left": data["calibs_info"]["cam_left"],
                "cam_right": data["calibs_info"]["cam_right"],
                "left_img_path": left,
                "right_img_path": right,
                "pose_3d": data["pose_3d"],
            })
        return metadata
