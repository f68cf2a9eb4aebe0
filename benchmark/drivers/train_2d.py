"""PoseResNet 2D training through the program's graphed stacked epochs
(`train/steps.py make_train_epoch_2d`): mono crops of cached raw frames
with flip, rotation and scale, Gaussian heatmap targets.

Traffic parameters: batch (images a step), steps_per_chunk, chunks,
check_steps, cache_frames, frame_height, frame_width, flip_prob,
joint_visible.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import scene
from benchmark.harness.training import TrainCell


class Cell(TrainCell):
    kind = "2d"

    @property
    def images_per_step(self):
        return self.B

    def build(self):
        from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
        return PoseResNet.from_config(self.cfg)

    def epoch_fn(self):
        from fast3dhpe_tpu_torch.models.losses import make_loss
        from fast3dhpe_tpu_torch.train.steps import make_train_epoch_2d
        cfg = self.cfg
        return make_train_epoch_2d(
            make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT,
                      layout="NHWC"),
            tuple(cfg.MODEL.IMAGE_SIZE), tuple(cfg.MODEL.EXTRA.HEATMAP_SIZE),
            sigma=cfg.MODEL.EXTRA.SIGMA)

    def run_chunk(self, xs, k):
        return self.epoch(self.state, self.frames, xs)

    def chunk(self, rng, k):
        """S steps of B distinct cached frames, each flipped with
        flip_prob, its training crop, and joints uniform over the crop."""
        t, S, B = self.traffic, self.S, self.B
        n, J = S * B, self.cfg.MODEL.NUM_JOINTS
        H0, W0 = t["frame_height"], t["frame_width"]
        ds = self.cfg.DATASET
        xs = {"idx": rng.permutation(t["cache_frames"])[:n],
              "flip": rng.random(n) < t["flip_prob"],
              "trans": scene.train_affines(rng, n, W0, H0, self.size,
                                           ds.SCALE_FACTOR, ds.ROT_FACTOR),
              "joints": rng.uniform(0, self.size, (n, J, 2)).astype(
                  np.float32),
              "vis": (rng.random((n, J)) < t["joint_visible"]).astype(
                  np.float32),
              "row_valid": np.ones(n, np.float32)}
        return {k: np.ascontiguousarray(v).reshape((S, B) + v.shape[1:])
                for k, v in xs.items()}

    def reference_batch(self, xs, k, i, rows=None):
        from benchmark.reference.pipeline import mono_batch
        x = {key: v[i][:rows] for key, v in xs.items()}
        e = self.cfg.MODEL.EXTRA
        return mono_batch(self.frames, x, self.size, e.HEATMAP_SIZE[0],
                          e.SIGMA)

    def heatmap_shape(self):
        h = self.cfg.MODEL.EXTRA.HEATMAP_SIZE
        return (self.B, h[1], h[0], self.cfg.MODEL.NUM_JOINTS, 4)
