"""CDRNet stereo training through the program's graphed stacked epochs
(`train/steps.py make_train_epoch_cdr`), with the device input pipeline
and its occlusion, fed from a frame cache of raw frames on the device.

Traffic parameters: batch (pairs a step), steps_per_chunk (the steps of
one epoch call), chunks (distinct chunks drawn, then repeated),
check_steps, cache_frames, frame_height, frame_width, use_3d,
occlusion, pose_range_mm, joint_visible.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import scene
from benchmark.harness.training import TrainCell


class Cell(TrainCell):
    kind = "cdr"
    clip = 100.0

    @property
    def images_per_step(self):
        return 2 * self.B

    def build(self):
        from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
        return CDRNet.from_config(self.cfg)

    def epoch_fn(self):
        from fast3dhpe_tpu_torch.models.losses import make_loss
        from fast3dhpe_tpu_torch.train.steps import make_train_epoch_cdr
        cfg = self.cfg
        return make_train_epoch_cdr(
            make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
            tuple(cfg.MODEL.IMAGE_SIZE), occlusion=self.traffic["occlusion"],
            graphed=True, loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
            num_joints=cfg.MODEL.NUM_JOINTS)

    def run_chunk(self, xs, k):
        return self.epoch(self.state, self.frames, xs, self.chunk_seeds[k],
                          self.traffic["use_3d"])

    def chunk(self, rng, k):
        """S steps of B pairs: distinct stereo pairs of the cache (frames
        2i and 2i + 1 are pair i's views), their training crops, the raw
        rig, poses and visibility."""
        t, S, B = self.traffic, self.S, self.B
        n = S * B
        pairs = rng.permutation(t["cache_frames"] // 2)[:n]
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

    def reference_batch(self, xs, k, i, rows=None):
        from benchmark.reference.pipeline import stereo_batch, step_seed
        x = {key: v[i][:rows] for key, v in xs.items()}
        return stereo_batch(self.frames, x, self.size,
                            step_seed(self.chunk_seeds[k], i))

    def heatmap_shape(self):
        h = self.cfg.MODEL.EXTRA.HEATMAP_SIZE
        return (2 * self.B, h[1], h[0], self.cfg.MODEL.NUM_JOINTS, 4)
