"""Learnable Triangulation's volumetric model trained through the
program's graphed stacked epochs (`train/steps.py make_train_epoch_vol`),
fed as CDRNet's stereo cells are: the device input pipeline with its
occlusion, from a frame cache of raw frames on the device. Each step turns
its cuboids by angles that its generator draws after the occlusion's.

Traffic parameters: those of train_cdr (use_3d is not read).

The weights: those of harness/weights.py for the trunk and the feature
reduction; Xavier-normal 3D convolutions, as the V2V's own initialiser
(harness/weights.py seeds only 4-d leaves). No head is calibrated: the
model's keypoints come from the V2V's volumes, whose logits have unit
spread under train-mode BN from the first step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.drivers.train_cdr import Cell as CdrCell
from benchmark.harness import scene
from benchmark.harness.weights import generator, seeded_state_dict, sub_seed


def seeded_volume_leaves(state_dict, device, seed):
    """The 5-d leaves (3D convolutions) of a seeded state dict drawn anew,
    Xavier-normal, in one call of a generator on the device."""
    names = [k for k, v in state_dict.items() if v.dim() == 5]
    sizes = [state_dict[k].numel() for k in names]
    flat = torch.randn(sum(sizes), generator=generator(device, seed),
                       device=device)
    for k, t in zip(names, flat.split(sizes)):
        w = state_dict[k]
        std = math.sqrt(2.0 / (w[0].numel() + w[:, 0].numel()))
        state_dict[k] = (t * std).view(w.shape)
    return state_dict


class Cell(CdrCell):
    kind = "vol"
    clip = None

    def build(self):
        from fast3dhpe_tpu_torch.models.volumetric import VolumetricNet
        return VolumetricNet.from_config(self.cfg)

    def epoch_fn(self):
        from fast3dhpe_tpu_torch.train.steps import make_train_epoch_vol
        return make_train_epoch_vol(
            tuple(self.cfg.MODEL.IMAGE_SIZE),
            occlusion=self.traffic["occlusion"], graphed=True)

    def run_chunk(self, xs, k):
        return self.epoch(self.state, self.frames, xs, self.chunk_seeds[k])

    def setup(self):
        from fast3dhpe_tpu_torch.train.state import TrainState
        t, dev = self.traffic, self.device
        self.frames = scene.frames(dev, t["cache_frames"], t["frame_height"],
                                   t["frame_width"], sub_seed(self.seed, 1))
        rng = np.random.default_rng(sub_seed(self.seed, 2))
        self.chunks = [self.on_device(self.chunk(rng, k))
                       for k in range(t["chunks"])]
        self.chunk_seeds = [sub_seed(self.seed, 3, k)
                            for k in range(t["chunks"])]
        with torch.device(dev):
            model = self.build()
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.sd0 = seeded_volume_leaves(
            seeded_state_dict(shapes, dev, sub_seed(self.seed, 4)), dev,
            sub_seed(self.seed, 5))
        model.load_state_dict(self.sd0)
        self.names = [k for k, _ in model.named_parameters()]
        self.state = TrainState.create(model, self.cfg, self.S)
        self.epoch = self.epoch_fn()
        self.record = {"loss": [], "loss_2d": [], "moments": [],
                       "start": None, "params": None}
        self.epoch.graphs.on_step = self._on_step
        float(self.run_chunk(self.chunks[0], 0)["loss"])   # waits for it
        self.epoch.graphs.on_step = None
        self.next_chunk = 1

    def reference_batch(self, xs, k, i, rows=None):
        from benchmark.reference.volumetric import train_batch
        x = {key: v[i][:rows] for key, v in xs.items()}
        return train_batch(self.frames, x, self.size, self.chunk_seeds[k], i)

    def _trainer(self, state_dict):
        from benchmark.reference.volumetric import CUBOID_SIDE, Trainer
        cfg = self.cfg
        return Trainer(state_dict, self.names, cfg.TRAIN.LR, self.depth,
                       cfg.MODEL.EXTRA.VOLUME_SIZE, CUBOID_SIDE)

    def trace_info(self, precision):
        from benchmark.reference.volumetric import forward_flops
        shapes = {k: tuple(v.shape) for k, v in self.sd0.items()}
        fwd = forward_flops(shapes, self.depth, self.B, self.size,
                            self.cfg.MODEL.EXTRA.VOLUME_SIZE)
        return {"flops_per_step": 3 * fwd, "precision": precision,
                "chips": 1, "heatmap": self.heatmap_shape()}

    def heatmap_shape(self):
        """The shape of each of the two K1 launches a step, (B, D * H, W,
        J, bytes) and (B, D, H * W, J, bytes): the same numel, so the same
        bound."""
        n = self.cfg.MODEL.EXTRA.VOLUME_SIZE
        return (self.B, n * n, n, self.cfg.MODEL.NUM_JOINTS, 4)
