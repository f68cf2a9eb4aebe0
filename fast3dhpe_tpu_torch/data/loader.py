"""Host loaders: JPEG decode and per-sample randomness on the host, the rest
of the batch on the device. Port of fast3dhpe_tpu/data/loader.py
(:53-934).

Host threads decode JPEGs and draw the per-sample affine randomness with
numpy RandomState, in the same order as the JAX loaders, so for one seed
every host array a loader stacks is bit-equal to JAX's. The warp,
occlusion, normalisation and targets run on the loader's device
(data/device_pipeline.py). Occlusion draws come from a torch.Generator on
that device: batch b of epoch e takes train/steps.py step_generator(device,
seed * 10007 + e, b).

Three ways to a batch, picked once per epoch:
  - full device cache (DATASET.DEVICE_CACHE_BYTES holds every frame): the
    batch is gathered on the device by row; only indices and affines cross;
  - partial device cache (a prefix of the frames fits): each batch has a
    fixed-size lane of cached rows and a fixed-size upload lane for the
    rest (_partial_epoch_schedule);
  - no cache: decoded frames are uploaded each batch.
A background thread keeps up to two batches in flight, device work
included; it uses the same CUDA stream as the consumer.

A final partial batch is padded by repeating the last record and carries a
(B,) 0/1 "row_valid" mask.

Under a process group (parallel/distributed.py), as under the JAX
package's multi-process runs, each data shard keeps the records
[index::count] and makes BATCH_SIZE local rows a batch; every rank runs
the same number of lockstep batches (from the largest shard), and rows
past a rank's shard, or all of them where its shard is empty, are filler
with row_valid 0. The shard is the data index under `mesh=`
(parallel/mesh.py, the JAX API's argument: mesh.rank of mesh.size), so
that the M model ranks of a data group load the same rows, and the
process group's rank of its world without a mesh, as the JAX loaders'
follows jax.process_count(). Under several data shards each rank's
device frame cache holds its own shard's frames, whole or not at all;
`mesh=` puts the batches on the mesh's device in place of `device`.
"""

from __future__ import annotations

import functools
import math
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.affine import (affine_transform_points, fliplr_joints,
                               get_affine_transform)
from ..ops.heatmap import render_gaussian_heatmaps
from ..ops.warp import affine_warp, normalize_imagenet
from ..parallel import distributed
from ..parallel.mesh import mesh_device
from ..utils.logging import setup_logger
from . import native_jpeg
from .device_cache import DeviceFrameCache
from .device_pipeline import (preprocess_mono_batch,
                              preprocess_mono_batch_cached,
                              preprocess_mono_batch_partial,
                              preprocess_stereo_batch,
                              preprocess_stereo_batch_cached,
                              preprocess_stereo_batch_partial)
from .mads import MADS_FLIP_PAIRS, build_mads_index, build_mads_stereo_index
from .mpii import MPII_FLIP_PAIRS, build_mpii_index

_SHARED_POOL = None
_SHARED_POOL_LOCK = threading.Lock()


def shared_decode_pool(max_workers: int = 4) -> ThreadPoolExecutor:
    """One decode pool for the life of the process, shared by short-lived
    consumers (one LoadMADSData a movement), made on first use."""
    global _SHARED_POOL
    with _SHARED_POOL_LOCK:
        if _SHARED_POOL is None:
            _SHARED_POOL = ThreadPoolExecutor(
                max_workers=max_workers,
                thread_name_prefix="f3d-decode-shared")
        return _SHARED_POOL


def _threaded_route() -> Optional[str]:
    """The library that decodes one file a call: cv2, else PIL, else None."""
    try:
        import cv2  # noqa: F401
        return "cv2"
    except ImportError:
        pass
    try:
        from PIL import Image  # noqa: F401
        return "PIL"
    except ImportError:
        return None


def _read(route: str, path: str) -> np.ndarray:
    """BGR uint8 (H, W, 3) of one JPEG, by `route` ("cv2" or "PIL")."""
    if route == "cv2":
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"Fail to read {path}")
        return img
    from PIL import Image
    with Image.open(path) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[:, :, ::-1])


def _imread(path: str) -> np.ndarray:
    """BGR uint8 read, cv2.imread's channel order, by cv2 or else PIL."""
    route = _threaded_route()
    if route is None:
        raise RuntimeError(f"reading {path} needs cv2 or PIL; neither is "
                           f"installed")
    return _read(route, path)


def _prefetch(gen: Iterator, depth: int = 2) -> Iterator:
    """Run `gen` in a background thread with a bounded queue.

    The worker's puts poll a stop event that the consumer's `finally`
    sets, so an iterator closed or collected early releases the thread and
    its buffered batches, and waits for the thread to end (at most the
    batch it is making), so that no thread is left inside torch when the
    process exits; an exception in `gen` is raised in the consumer.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    error_box: List = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: B036 -- handed to the consumer
            error_box.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="f3d-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error_box:
                    raise error_box[0]
                return
            yield item
    finally:
        stop.set()
        t.join()


class _BatchDecoder:
    """Decodes a batch of JPEG paths to BGR uint8 frames by one route,
    picked once: "native" (native/jpeg_decoder.cpp, every frame of a batch
    the size probed on the first) where g++ and libjpeg build it, else
    "cv2", else "PIL", the last two one file a pool thread. `name` says
    which. The only swap is JAX's: the native route meeting a frame of
    another size hands the rest of the run to cv2 or PIL. Raises, naming
    what is missing, when no route exists."""

    def __init__(self, pool: ThreadPoolExecutor):
        self._pool = pool
        self._native_hw = None
        if native_jpeg.available():
            self.route = "native"
        else:
            self.route = _threaded_route()
            if self.route is None:
                raise RuntimeError(
                    f"no JPEG decoder: the native one is unavailable "
                    f"({native_jpeg.build_error()}), and neither cv2 nor PIL "
                    f"is installed")
        self.name = {"native": "native libjpeg"}.get(self.route, self.route)

    def __call__(self, paths: List[str]) -> List[np.ndarray]:
        if self.route == "native":
            if self._native_hw is None:
                self._native_hw = native_jpeg.probe(paths[0])
                if self._native_hw is None:
                    raise ValueError(f"cannot read the JPEG header of "
                                     f"{paths[0]!r}")
            try:
                return list(native_jpeg.decode_batch(paths,
                                                     *self._native_hw))
            except ValueError as err:
                self._swap_on_mixed_sizes(paths, err)
        return list(self._pool.map(functools.partial(_read, self.route),
                                   paths))

    def _swap_on_mixed_sizes(self, paths, err):
        """Re-raise `err` unless a frame of another size caused it; then
        decode by cv2 or PIL from here on."""
        sizes = [native_jpeg.probe(p) for p in paths]
        if None in sizes or all(s == self._native_hw for s in sizes):
            raise err
        route = _threaded_route()
        if route is None:
            raise RuntimeError("frames of mixed sizes need cv2 or PIL; "
                               "neither is installed") from err
        self.route = route
        self.name = f"{route} (native until frames of mixed sizes)"


def _train_scale_rot(rng: np.random.RandomState, sf: float, rf: float):
    """The reference's random scale and rotation draws."""
    s = np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
    r = np.clip(rng.randn() * rf, -rf * 2, rf * 2) \
        if rng.random_sample() <= 0.6 else 0.0
    return s, r


def _data_shard(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's data shard: the mesh's data index
    and data groups under a mesh, else the process group's rank and
    world size."""
    if mesh is not None:
        return mesh.rank, mesh.size
    return distributed.process_index(), distributed.process_count()


def _shard_for_host(records, mesh=None):
    """(local records, global count, filler record). Under several data
    shards (_data_shard) the local records are this rank's. The filler backs
    lockstep batches past the shard, also where the shard is empty (more
    ranks than records): such a rank must keep stepping, or the others
    wait in the collectives for ever. It is kept outside the records, so it
    is never counted valid; its rows carry row_valid 0."""
    pi, pc = _data_shard(mesh)
    if pc > 1:
        local = distributed.shard_records_for_host(records, pi, pc)
        filler = local[0] if local else (records[0] if records else None)
        return local, len(records), filler
    return records, len(records), records[0] if records else None


def _num_lockstep_batches(global_n: int, batch_size: int,
                          mesh=None) -> int:
    """The batches an epoch that every rank runs: those of the largest
    shard."""
    max_shard = math.ceil(global_n / max(_data_shard(mesh)[1], 1))
    return math.ceil(max_shard / batch_size)


def _row_mask(n_valid: int, batch_size: int) -> np.ndarray:
    m = np.zeros((batch_size,), np.float32)
    m[:n_valid] = 1.0
    return m


def _partial_epoch_schedule(records, batch_size, nb, rng, resident,
                            train):
    """Partial-cache epoch schedule: yields (n_valid, recs_cached,
    recs_upload) with FIXED lane sizes n_c + n_u = batch_size.

    The upload lane takes the misses, the cached records beyond the cached
    lane's room and the final padding (at the end of the upload pool, so
    the row_valid prefix stays right). Train epochs permute both pools;
    eval keeps the natural order. Every record appears once an epoch."""
    cached_rows, miss_rows = [], []
    for i, r in enumerate(records):
        (cached_rows if resident(r) else miss_rows).append(i)
    B = batch_size
    n_pad = nb * B - len(records)
    n_u = min(B, -(-(len(miss_rows) + n_pad) // nb))
    n_c = B - n_u
    if train:
        cached_rows = list(np.asarray(cached_rows, np.int64)[
            rng.permutation(len(cached_rows))])
        miss_rows = list(np.asarray(miss_rows, np.int64)[
            rng.permutation(len(miss_rows))])
    upool = miss_rows + cached_rows[nb * n_c:]
    cpool = cached_rows[:nb * n_c]
    assert len(cpool) == nb * n_c and len(upool) == nb * n_u - n_pad
    pad_rec = upool[-1] if upool else (cpool[-1] if cpool else 0)
    first_pad = len(upool)
    upool = upool + [pad_rec] * n_pad
    for b in range(nb):
        recs_c = [records[i] for i in cpool[b * n_c:(b + 1) * n_c]]
        uslice = upool[b * n_u:(b + 1) * n_u]
        recs_u = [records[i] for i in uslice]
        n_valid = n_c + n_u - sum(
            1 for k in range(len(uslice)) if b * n_u + k >= first_pad)
        yield n_valid, recs_c, recs_u


def _epoch_rec_batches(records, filler, n_batches, batch_size, rng, train):
    """(n_valid, recs) a batch: a permutation (train) or the natural order,
    the last batch padded with its last record."""
    order = (rng.permutation(len(records)) if train
             else np.arange(len(records)))
    B = batch_size
    for b in range(n_batches):
        idx = order[b * B:(b + 1) * B]
        recs = [records[i] for i in idx] or [filler]
        n_valid = len(idx)
        while len(recs) < B:
            recs.append(recs[-1])
        yield n_valid, recs


def _upload(frames: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device)


class _LoaderBase:
    """What both loaders share: the decode pool, the device cache's
    lifecycle and the per-batch log."""

    def __init__(self, cfg, image_set, records, seed, decode_threads,
                 device_cache_bytes, device, mesh):
        self.device = mesh_device(mesh, device)
        self.mesh = mesh
        self.cfg = cfg
        self.image_set = image_set
        self.train = image_set == cfg.DATASET.TRAIN_SET
        self.records, self._global_num, self._filler = _shard_for_host(
            records, mesh)
        self.batch_size = (cfg.TRAIN.BATCH_SIZE if self.train
                           else cfg.TEST.BATCH_SIZE)
        self.image_size = tuple(cfg.MODEL.IMAGE_SIZE)
        self.scale_factor = cfg.DATASET.SCALE_FACTOR
        self.rot_factor = cfg.DATASET.ROT_FACTOR
        self.seed = seed
        self._epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=decode_threads)
        self._decode_paths = _BatchDecoder(self._pool)
        self._device_cache_budget = device_cache_bytes
        self._device_cache = None
        self._device_cache_failed = False
        #: one dict a batch of the current __iter__ epoch: rows gathered
        #: from the device cache, frames uploaded (count, bytes, the shape
        #: of one), host ms decoding them, and the valid rows' paths
        self.batch_log: List[Dict] = []

    @property
    def decoder_name(self) -> str:
        """The JPEG route in use: "native libjpeg", "cv2" or "PIL"."""
        return self._decode_paths.name

    def close(self):
        """Shut down the decode pool."""
        self._pool.shutdown(wait=False)

    def __len__(self):
        return _num_lockstep_batches(self._global_num, self.batch_size,
                                     self.mesh)

    @property
    def num_samples(self):
        return self._global_num

    @property
    def device_cached(self) -> bool:
        return self._device_cache is not None

    def _epoch_rec_batches(self, rng):
        return _epoch_rec_batches(self.records, self._filler, len(self),
                                  self.batch_size, rng, self.train)

    def _build_cache(self, paths, pair_stride):
        """DeviceFrameCache of `paths` (this rank's records) on the
        loader's device, partial when over budget in a single process;
        None (recorded) when there is no budget, the frames have mixed
        sizes, or, under several processes or a mesh, they do not all fit.

        Under D > 1 data shards each rank caches its own shard's frames,
        1/D of them: the JAX package replicates one global cache over its
        devices, which a process that holds only its own records cannot
        assemble, so it turns the cache off there; a rank's cache here is
        its own tensor. The decision is logged once, with the frames and
        bytes. A partial cache's lanes are a single-process schedule, as
        in the JAX package (loader.py:400-405)."""
        if self._device_cache is not None or self._device_cache_failed:
            return self._device_cache
        cache = None
        index, shards = _data_shard(self.mesh)
        if self._device_cache_budget:
            cache = DeviceFrameCache.build(
                paths, self._decode_paths, self._device_cache_budget,
                allow_partial=self.mesh is None and shards == 1,
                pair_stride=pair_stride, device=self.device, mesh=self.mesh)
            if shards > 1:
                n = len(dict.fromkeys(paths))
                setup_logger().info(
                    "%s: data shard %d of %d caches its own %d frames on "
                    "%s: %s", self.image_set, index, shards, n, self.device,
                    "none (they exceed DEVICE_CACHE_BYTES, have mixed "
                    "sizes, or the shard is empty)" if cache is None else
                    f"{cache.frames.shape[0]} rows, "
                    f"{cache.nbytes / 2 ** 20:.1f} MiB")
        self._device_cache = cache
        self._device_cache_failed = cache is None
        return cache

    def _full_cache(self):
        cache = self.ensure_device_cache()
        if cache is None:
            raise RuntimeError(
                "stacked_epoch requires the device frame cache "
                "(DEVICE_CACHE_BYTES); use iteration for streaming")
        if cache.partial:
            # stacking would keep every miss frame resident for the epoch:
            # the memory the partial cache exists to save
            raise RuntimeError(
                "stacked_epoch requires a FULL device cache; this dataset "
                "exceeds DEVICE_CACHE_BYTES (partial cache): use per-batch "
                "iteration")
        return cache

    def _log(self, rows, uploads, decode_ms, valid_paths):
        """uploads: the arrays of (N, H, W, 3) frames sent to the device."""
        self.batch_log.append({
            "rows": rows, "uploaded": sum(len(u) for u in uploads),
            "upload_bytes": sum(int(u.nbytes) for u in uploads),
            "frame_shape": tuple(uploads[0].shape[1:]) if uploads else None,
            "decode_ms": decode_ms, "valid": valid_paths})


class Stereo3DLoader(_LoaderBase):
    """MADS stereo batches for CDRNet training and evaluation.

    Yields dicts of tensors on `device` (see preprocess_stereo_batch) with
    a "row_valid" (B,) mask.

    Args:
      cfg: the config (DATASET, MODEL.IMAGE_SIZE, TRAIN/TEST.BATCH_SIZE).
      image_set: DATASET.TRAIN_SET trains (shuffle, augmentation,
        occlusion); any other set evaluates.
      seed: RandomState seed of epoch e is seed + e.
      cache_bytes: budget of a RAM cache of decoded frames (exact: frames
        are cached before the warp).
      device_cache_bytes: budget of the device frame cache; over budget a
        partial cache keeps the largest prefix of whole stereo pairs.
      return_masks: also yield the occlusion keep-masks.
      device: where batches are made; the GPU unless "cpu" is asked for.
      mesh: a parallel.mesh.Mesh: batches on its device, in place of
        `device` (the records' sharding follows the process group).
    """

    def __init__(self, cfg, image_set: str, seed: int = 0,
                 decode_threads: int = 4, cache_bytes: int = 0,
                 device_cache_bytes: int = 0, return_masks: bool = False,
                 device="cuda", mesh=None):
        super().__init__(cfg, image_set,
                         build_mads_stereo_index(cfg.DATASET.ROOT,
                                                 image_set),
                         seed, decode_threads, device_cache_bytes, device,
                         mesh)
        self.occlusion = cfg.DATASET.OCCLUSION
        self._cache_budget = cache_bytes
        self._cache_used = 0
        self._cache = {}         # path -> uint8 array
        self.return_masks = return_masks

    def _decode_stereo(self, recs: List[dict]):
        """Both views of `recs`, through the RAM cache when it has a
        budget; returns (left frames, right frames, decode ms)."""
        t0 = time.perf_counter()
        paths = ([r["image_left"] for r in recs]
                 + [r["image_right"] for r in recs])
        if not self._cache_budget:
            imgs = self._decode_paths(paths)
        else:
            unique_missing = [p for p in dict.fromkeys(paths)
                              if p not in self._cache]
            fresh = {}
            if unique_missing:
                fresh = dict(zip(unique_missing,
                                 self._decode_paths(unique_missing)))
                for p, img in fresh.items():
                    if self._cache_used + img.nbytes <= self._cache_budget:
                        self._cache[p] = img
                        self._cache_used += img.nbytes
            imgs = [self._cache[p] if p in self._cache else fresh[p]
                    for p in paths]
        n = len(recs)
        return imgs[:n], imgs[n:], (time.perf_counter() - t0) * 1e3

    def _meta_arrays(self, recs: List[dict], rng: np.random.RandomState,
                     hw_list) -> dict:
        """Per-sample affines and projection/pose arrays (no frames). The
        train-time draws are taken in record order, so cached and uncached
        epochs consume the RandomState alike."""
        trans = np.zeros((len(recs), 2, 3), np.float64)
        for i, (h, w) in enumerate(hw_list):
            c = np.array([w / 2, h / 2])
            s, r = (1.0, 0.0)
            if self.train:
                s, r = _train_scale_rot(rng, self.scale_factor,
                                        self.rot_factor)
            trans[i] = get_affine_transform(c, s, r, min(h, w),
                                            self.image_size)
        return {
            "trans": trans.astype(np.float32),
            "P_l": np.stack([r["P_left"] for r in recs]).astype(np.float32),
            "P_r": np.stack([r["P_right"] for r in recs]).astype(np.float32),
            "pose_3d": np.stack([r["pose_3d"] for r in recs])
            .astype(np.float32),
            "joints_vis": np.stack([r["joints_vis"][:, 0] for r in recs])
            .astype(np.float32),
        }

    def ensure_device_cache(self):
        """Build the device frame cache once (left and right of each record
        adjacent, so a budget cut keeps pairs whole); None without one."""
        return self._build_cache([rec[k] for rec in self.records
                                  for k in ("image_left", "image_right")],
                                 pair_stride=2)

    def stacked_epoch(self):
        """One epoch's batches as stacked host arrays for
        train/steps.make_train_epoch_cdr; requires a full device cache.

        Returns (cache, xs, epoch_index): xs maps idx_l / idx_r (S, B)
        int32, trans (S, B, 2, 3), P_l / P_r (S, B, 4, 4), pose_3d
        (S, B, J, 3), joints_vis (S, B, J) and row_valid (S, B). Draws the
        same RandomState sequence as one __iter__ epoch."""
        cache = self._full_cache()
        rng = np.random.RandomState(self.seed + self._epoch)
        epoch_index = self._epoch
        self._epoch += 1
        hw = tuple(cache.frames.shape[1:3])
        cols = {k: [] for k in ("idx_l", "idx_r", "trans", "P_l", "P_r",
                                "pose_3d", "joints_vis", "row_valid")}
        for n_valid, recs in self._epoch_rec_batches(rng):
            hb = self._meta_arrays(recs, rng, [hw] * len(recs))
            hb["idx_l"] = cache.rows([r["image_left"] for r in recs])
            hb["idx_r"] = cache.rows([r["image_right"] for r in recs])
            hb["row_valid"] = _row_mask(n_valid, self.batch_size)
            for k in cols:
                cols[k].append(hb[k])
        return cache, {k: np.stack(v) for k, v in cols.items()}, epoch_index

    def __iter__(self):
        # train/steps.py imports this package: import it at call time
        from ..train.steps import step_generator
        rng = np.random.RandomState(self.seed + self._epoch)
        epoch_seed = self.seed * 10007 + self._epoch
        self._epoch += 1
        cache = self.ensure_device_cache()
        occl = self.occlusion if self.train else None
        dev = self.device
        self.batch_log = []
        kw = dict(image_size=self.image_size, occlusion=occl,
                  train=self.train, return_masks=self.return_masks)

        def generator(b):
            if occl in (None, "None"):
                return None
            return step_generator(dev, epoch_seed, b)

        def finish(batch, n_valid):
            batch["row_valid"] = torch.as_tensor(
                _row_mask(n_valid, self.batch_size), device=dev)
            return batch

        def gen_partial():
            """Partial cache: a fixed lane of cached rows gathered on the
            device, and a fixed upload lane of decoded frames."""
            hw = tuple(cache.frames.shape[1:3])
            for b, (n_valid, recs_c, recs_u) in enumerate(
                    self._epoch_partial_batches(rng, cache)):
                recs = recs_c + recs_u
                imgs_l, imgs_r, ms = (self._decode_stereo(recs_u) if recs_u
                                      else ([], [], 0.0))
                hb = self._meta_arrays(recs, rng, [hw] * len(recs))
                empty = np.zeros((0, *hw, 3), np.uint8)
                up_l = np.stack(imgs_l) if recs_u else empty
                up_r = np.stack(imgs_r) if recs_u else empty
                self._log(len(recs_c), (up_l, up_r), ms,
                          [r["image_left"] for r in recs[:n_valid]])
                batch = preprocess_stereo_batch_partial(
                    generator(b), cache.frames,
                    cache.rows([r["image_left"] for r in recs_c]),
                    cache.rows([r["image_right"] for r in recs_c]),
                    _upload(up_l, dev), _upload(up_r, dev), hb["trans"],
                    hb["P_l"], hb["P_r"], hb["pose_3d"], hb["joints_vis"],
                    **kw)
                yield finish(batch, n_valid)

        def gen():
            for b, (n_valid, recs) in enumerate(self._epoch_rec_batches(rng)):
                valid = [r["image_left"] for r in recs[:n_valid]]
                if cache is not None:
                    hb = self._meta_arrays(
                        recs, rng, [tuple(cache.frames.shape[1:3])] * len(recs))
                    self._log(len(recs), (), 0.0, valid)
                    batch = preprocess_stereo_batch_cached(
                        generator(b), cache.frames,
                        cache.rows([r["image_left"] for r in recs]),
                        cache.rows([r["image_right"] for r in recs]),
                        hb["trans"], hb["P_l"], hb["P_r"], hb["pose_3d"],
                        hb["joints_vis"], **kw)
                else:
                    imgs_l, imgs_r, ms = self._decode_stereo(recs)
                    hb = self._meta_arrays(recs, rng,
                                           [im.shape[:2] for im in imgs_l])
                    up_l, up_r = np.stack(imgs_l), np.stack(imgs_r)
                    self._log(0, (up_l, up_r), ms, valid)
                    batch = preprocess_stereo_batch(
                        generator(b), _upload(up_l, dev), _upload(up_r, dev),
                        hb["trans"], hb["P_l"], hb["P_r"], hb["pose_3d"],
                        hb["joints_vis"], **kw)
                yield finish(batch, n_valid)

        if cache is not None and cache.partial:
            return _prefetch(gen_partial())
        return _prefetch(gen())

    def _epoch_partial_batches(self, rng, cache):
        """Records whose both views are resident form the cached lane."""
        return _partial_epoch_schedule(
            self.records, self.batch_size, len(self), rng,
            lambda r: (cache.has(r["image_left"])
                       and cache.has(r["image_right"])),
            self.train)


class Mono2DLoader(_LoaderBase):
    """Single-view batches for PoseResNet training and evaluation (MPII,
    MADS_2d).

    The per-sample flip, scale and rotation and the joints' affine are
    drawn and applied on the host as the reference does; the frames are
    warped on the device (device_preprocess=True, the default), MPII's
    variable-size frames zero-padded to a multiple of 128 first.
    device_preprocess=False warps on the host, with ops/warp.py affine_warp
    on CPU tensors truncated to uint8 (the JAX loader's branch for a host
    without cv2), and renders the targets on the device.
    """

    def __init__(self, cfg, image_set: str, seed: int = 0,
                 decode_threads: int = 4,
                 device_preprocess: Optional[bool] = None,
                 device_cache_bytes: int = 0, device="cuda", mesh=None):
        dataset_type = cfg.DATASET.TYPE
        if dataset_type == "MPII":
            records = build_mpii_index(cfg.DATASET.ROOT, image_set,
                                       cfg.MODEL.NUM_JOINTS)
            self.flip_pairs = MPII_FLIP_PAIRS
        elif dataset_type == "MADS_2d":
            records = build_mads_index(cfg.DATASET.ROOT, image_set)
            self.flip_pairs = MADS_FLIP_PAIRS
        else:
            raise NotImplementedError(dataset_type)
        super().__init__(cfg, image_set, records, seed, decode_threads,
                         device_cache_bytes, device, mesh)
        self.dataset_type = dataset_type
        self.device_preprocess = (True if device_preprocess is None
                                  else device_preprocess)
        # zero padding is exact: the warp reads 0 beyond the frame anyway
        self.pad_bucket = 128 if dataset_type == "MPII" else None
        self.heatmap_size = tuple(cfg.MODEL.EXTRA.HEATMAP_SIZE)
        self.sigma = cfg.MODEL.EXTRA.SIGMA
        self.flip = cfg.DATASET.FLIP

    def _prepare_sample(self, rec, aug, img, hw=None):
        """aug: (scale multiplier, rotation, flip), drawn on the main
        thread. img: the decoded frame, or None on the cached path (hw
        then gives the frame size and the flip runs on the device).

        Returns (img, trans, joints_t, vis, do_flip): img host-warped on
        the host path, the raw (maybe flipped) frame on the device path,
        None on the cached path; joints in output pixels."""
        h, w = img.shape[:2] if img is not None else hw
        if self.dataset_type == "MPII":
            c = rec["center"].copy()
            s = rec["scale"].copy()
        else:
            c = np.array([w / 2, h / 2])
            s = np.array([1.0, 1.0])
        joints = rec["joints"][:, :2].copy()
        vis = rec["joints_vis"].copy()
        origin_size = 200 if self.dataset_type == "MPII" else min(h, w)

        s_mult, r, do_flip = aug
        s = s * s_mult
        if do_flip:
            if img is not None:
                img = img[:, ::-1, :]
            joints3 = np.concatenate(
                [joints, np.zeros((joints.shape[0], 1))], axis=1)
            joints3, vis = fliplr_joints(joints3, vis, w, self.flip_pairs)
            joints = joints3[:, :2]
            c[0] = w - c[0] - 1

        trans = get_affine_transform(c, s, r, origin_size, self.image_size)
        visible = vis[:, 0] > 0
        joints_t = joints.copy()
        if visible.any():
            joints_t[visible] = affine_transform_points(joints[visible],
                                                        trans)
        if img is not None and not self.device_preprocess:
            img = self._warp_host(img, trans)
        return img, trans.astype(np.float32), joints_t, vis[:, 0], do_flip

    def _bucket_pad(self, imgs: List[np.ndarray]) -> np.ndarray:
        """Zero-pad a batch of variable-size frames to the batch's largest
        height and width, each rounded up to a multiple of pad_bucket, so
        the device warp sees few distinct shapes."""
        b = self.pad_bucket
        hb = -(-max(im.shape[0] for im in imgs) // b) * b
        wb = -(-max(im.shape[1] for im in imgs) // b) * b
        out = np.zeros((len(imgs), hb, wb, imgs[0].shape[2]), imgs[0].dtype)
        for i, im in enumerate(imgs):
            out[i, :im.shape[0], :im.shape[1]] = im
        return out

    def _warp_host(self, img, trans):
        """The crop on the host: affine_warp on CPU tensors, truncated to
        uint8, as the JAX loader warps on a host without cv2."""
        out = affine_warp(torch.from_numpy(np.ascontiguousarray(img))[None],
                          trans, self.image_size)
        return out[0].numpy().astype(np.uint8)

    def _draw_augs(self, rng, recs):
        augs = []
        for _ in recs:
            if self.train:
                s_mult, r = _train_scale_rot(rng, self.scale_factor,
                                             self.rot_factor)
                do_flip = self.flip and rng.random_sample() <= 0.5
            else:
                s_mult, r, do_flip = 1.0, 0.0, False
            augs.append((s_mult, r, do_flip))
        return augs

    def _epoch_host_batches(self, rng):
        for n_valid, recs in self._epoch_rec_batches(rng):
            augs = self._draw_augs(rng, recs)
            t0 = time.perf_counter()
            imgs_raw = self._decode_paths([r["image"] for r in recs])
            ms = (time.perf_counter() - t0) * 1e3
            samples = list(self._pool.map(
                lambda ra: self._prepare_sample(*ra),
                zip(recs, augs, imgs_raw)))
            if self.device_preprocess and self.pad_bucket:
                imgs = self._bucket_pad([s[0] for s in samples])
            else:
                imgs = np.stack([np.ascontiguousarray(s[0])
                                 for s in samples])
            trans = np.stack([s[1] for s in samples])
            joints = np.stack([s[2] for s in samples]).astype(np.float32)
            vis = np.stack([s[3] for s in samples]).astype(np.float32)
            self._log(0, (imgs,), ms, [r["image"] for r in recs[:n_valid]])
            yield n_valid, imgs, trans, joints, vis

    def ensure_device_cache(self):
        """Build the device frame cache once: fixed-size sources only (MPII's
        mixed sizes give None and the host path), and only with the warp on
        the device."""
        if not self.device_preprocess:
            self._device_cache_failed = True
        return self._build_cache([rec["image"] for rec in self.records],
                                 pair_stride=1)

    def _epoch_partial_batches(self, rng, cache):
        return _partial_epoch_schedule(
            self.records, self.batch_size, len(self), rng,
            lambda r: cache.has(r["image"]), self.train)

    def _cached_meta(self, rng, recs, hw):
        """(flip, trans, joints, vis) of `recs` for the cached lanes."""
        augs = self._draw_augs(rng, recs)
        samples = [self._prepare_sample(rec, aug, None, hw=hw)
                   for rec, aug in zip(recs, augs)]
        return (np.asarray([s[4] for s in samples], bool),
                np.stack([s[1] for s in samples]),
                np.stack([s[2] for s in samples]).astype(np.float32),
                np.stack([s[3] for s in samples]).astype(np.float32))

    def stacked_epoch(self):
        """One epoch as stacked host arrays for
        train/steps.make_train_epoch_2d; requires a full device cache.
        Returns (cache, xs, epoch_index): idx (S, B) int32, flip (S, B)
        bool, trans (S, B, 2, 3), joints (S, B, J, 2), vis (S, B, J) and
        row_valid (S, B)."""
        cache = self._full_cache()
        rng = np.random.RandomState(self.seed + self._epoch)
        epoch_index = self._epoch
        self._epoch += 1
        hw = (int(cache.frames.shape[1]), int(cache.frames.shape[2]))
        cols = {k: [] for k in ("idx", "flip", "trans", "joints", "vis",
                                "row_valid")}
        for n_valid, recs in self._epoch_rec_batches(rng):
            flip, trans, joints, vis = self._cached_meta(rng, recs, hw)
            cols["idx"].append(cache.rows([r["image"] for r in recs]))
            cols["flip"].append(flip)
            cols["trans"].append(trans)
            cols["joints"].append(joints)
            cols["vis"].append(vis)
            cols["row_valid"].append(_row_mask(n_valid, self.batch_size))
        return cache, {k: np.stack(v) for k, v in cols.items()}, epoch_index

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        cache = self.ensure_device_cache()
        dev = self.device
        self.batch_log = []
        kw = dict(image_size=self.image_size, heatmap_size=self.heatmap_size,
                  sigma=self.sigma)

        def finish(batch, n_valid):
            batch["row_valid"] = torch.as_tensor(
                _row_mask(n_valid, self.batch_size), device=dev)
            return batch

        def partial_gen():
            """Cached lane and upload lane; both flip on the device, so the
            upload ships unflipped raw frames."""
            hw = (int(cache.frames.shape[1]), int(cache.frames.shape[2]))
            for n_valid, recs_c, recs_u in self._epoch_partial_batches(
                    rng, cache):
                recs = recs_c + recs_u
                flip, trans, joints, vis = self._cached_meta(rng, recs, hw)
                t0 = time.perf_counter()
                up = (np.stack(self._decode_paths(
                          [r["image"] for r in recs_u]))
                      if recs_u else np.zeros((0, *hw, 3), np.uint8))
                self._log(len(recs_c), (up,), (time.perf_counter() - t0) * 1e3,
                          [r["image"] for r in recs[:n_valid]])
                batch = preprocess_mono_batch_partial(
                    cache.frames,
                    cache.rows([r["image"] for r in recs_c]),
                    _upload(up, dev), flip, trans, joints, vis, **kw)
                yield finish(batch, n_valid)

        def cached_gen():
            hw = (int(cache.frames.shape[1]), int(cache.frames.shape[2]))
            for n_valid, recs in self._epoch_rec_batches(rng):
                flip, trans, joints, vis = self._cached_meta(rng, recs, hw)
                self._log(len(recs), (), 0.0,
                          [r["image"] for r in recs[:n_valid]])
                batch = preprocess_mono_batch_cached(
                    cache.frames,
                    cache.rows([r["image"] for r in recs]),
                    flip, trans, joints, vis, **kw)
                yield finish(batch, n_valid)

        def gen():
            for n_valid, imgs, trans, joints, vis in \
                    self._epoch_host_batches(rng):
                imgs = _upload(imgs, dev)
                if self.device_preprocess:
                    batch = preprocess_mono_batch(imgs, trans, joints, vis,
                                                  **kw)
                else:
                    target, weight = render_gaussian_heatmaps(
                        torch.as_tensor(joints, device=dev),
                        torch.as_tensor(vis, device=dev), self.heatmap_size,
                        self.image_size, self.sigma)
                    batch = {"image": normalize_imagenet(imgs),
                             "target": target, "target_weight": weight}
                yield finish(batch, n_valid)

        if cache is not None and cache.partial:
            return _prefetch(partial_gen())
        return _prefetch(cached_gen() if cache is not None else gen())


def load_data(config, mesh=None, seed: int = 0, device="cuda"):
    """(train_loader, valid_loader) for DATASET.TYPE: MPII and MADS_2d give
    Mono2DLoader, MADS_3d Stereo3DLoader; the valid loader's seed is
    seed + 1. mesh: as the loaders take it."""
    t = config.DATASET.TYPE
    kwargs = {"device_cache_bytes": config.DATASET.DEVICE_CACHE_BYTES,
              "device": device, "mesh": mesh}
    if t in ("MPII", "MADS_2d"):
        cls = Mono2DLoader
    elif t == "MADS_3d":
        cls = Stereo3DLoader
        kwargs["cache_bytes"] = config.DATASET.CACHE_BYTES
    else:
        raise NotImplementedError(t)
    return (cls(config, config.DATASET.TRAIN_SET, seed=seed, **kwargs),
            cls(config, config.DATASET.TEST_SET, seed=seed + 1, **kwargs))
