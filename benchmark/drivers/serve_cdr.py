"""CDRNet batch serving through the program's `CDRNetInferencer
.predict_batch`: a closed loop of one client, each request a batch of
stereo pairs of uint8 crops with their projections, taken in turn from a
pool in host memory; a request ends when pred_2d and pred_3d are on the
host.

Traffic parameters: precision (the inferencer's compute type, and the
peak that MFU divides by), batch (pairs a request), pool (distinct
requests), warm_requests, trace_requests, check_requests (the window's
requests compared, drawn from the seed), fused_inference, control_calib
(the pool requests that calibrate the control's int8 pack).

The numbers compared, over the sampled requests:

- pred2d_vs_bf16, pred2d_over_2bf16: pred_2d against the reference in
  fp32 (the encoder with K3, the fusion, the decoder and K1), measured by
  a yardstick: the mean gap of the reference's own network computed in
  bf16, rounded where a bf16 network rounds, on the same requests. That
  is what rounding to the cell's precision alone moves a keypoint on
  these weights. pred2d_vs_bf16 is the mean gap over the yardstick;
  pred2d_over_2bf16 the share of coordinates whose gap exceeds twice it.
  Seeds differ in how far rounding moves a keypoint about as much as the
  control (the program's int8 path) differs from bf16, so no gap in
  pixels separates the two; these do (PERF.md).
- geometry_gap: pred_3d against the DLT of the program's own pred_2d and
  the request's projections, in float64: for each joint, how far the
  point is from solving its DLT system, (|A h| - s_min) / s_max (the
  reference's dlt_residual_gap), worst joint. It judges the geometry
  (the Jacobi DLT) alone: end to end, the rays of random weights barely
  meet, and the rounding that moves a keypoint by a hundredth of a pixel
  moves a point by metres.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import scene
from benchmark.harness.weights import (calibrate_head, generator,
                                       seeded_state_dict, sub_seed)

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class Cell:
    def __init__(self, config, traffic, seed, device):
        from fast3dhpe_tpu_torch.config import config_from_dict
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cfg = config_from_dict(config)
        self.size = self.cfg.MODEL.IMAGE_SIZE[0]
        self.depth = self.cfg.MODEL.NUM_LAYERS
        self.B = traffic["batch"]
        self.served = []            # (pool index, pred_2d, pred_3d) on host

    # ------------------------------------------------------------ set-up
    def setup(self):
        from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
        from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
        t, dev, B, S = self.traffic, self.device, self.B, self.size
        g = generator(dev, sub_seed(self.seed, 1))
        frames = torch.randint(0, 256, (t["pool"], 2, B, S, S, 3),
                               dtype=torch.uint8, generator=g, device=dev)
        # requests staged in pinned host memory, as a server stages them
        self.pool = frames.cpu().pin_memory() if dev.type == "cuda" \
            else frames.cpu()
        del frames
        self.proj = np.ascontiguousarray(np.broadcast_to(
            scene.converging_rig(S, S)[:, :3], (B, 2, 3, 4)))
        with torch.device("meta"):
            shapes = {k: tuple(v.shape) for k, v in
                      CDRNet.from_config(self.cfg).state_dict().items()}
        self.sd0 = seeded_state_dict(shapes, dev, sub_seed(self.seed, 2))
        with torch.no_grad():
            calibrate_head(self.sd0, self.reference(0, rows=4,
                                                    heatmaps=True))
        self.inf = CDRNetInferencer(
            self.cfg, dtype=DTYPES[t["precision"]],
            fused_inference=t["fused_inference"], state_dict=self.sd0,
            device=dev)
        for i in range(t["warm_requests"]):
            self._request(i % t["pool"])
        self.next = t["warm_requests"]
        self.served.clear()

    def _request(self, i):
        img_l, img_r = self.pool[i, 0], self.pool[i, 1]
        p2, p3 = self.inf.predict_batch(img_l, img_r, self.proj)
        out = (i, p2.float().cpu().numpy(), p3.float().cpu().numpy())
        self.served.append(out)
        return out

    # ------------------------------------------------------------ window
    def run_for(self, seconds):
        n = failed = 0
        t0 = time.perf_counter()
        while True:
            _, p2, p3 = self._request(self.next % self.traffic["pool"])
            self.next += 1
            n += 1
            if not (np.isfinite(p2).all() and np.isfinite(p3).all()):
                failed += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"attempted": n, "failed": failed, "elapsed": elapsed,
                "metrics": {"serve_pairs_per_s": n * self.B / elapsed}}

    def traced(self):
        n = self.traffic["trace_requests"]

        def fn():
            for _ in range(n):
                self._request(self.next % self.traffic["pool"])
                self.next += 1
        return fn, n

    def trace_info(self, precision):
        from benchmark.harness.flops import forward_flops
        shapes = {k: tuple(v.shape) for k, v in self.sd0.items()}
        h = self.cfg.MODEL.EXTRA.HEATMAP_SIZE
        elt = torch.finfo(DTYPES[self.traffic["precision"]]).bits // 8
        return {"flops_per_step": forward_flops("cdr", shapes, self.depth,
                                                self.B, self.size),
                "precision": precision, "chips": 1,
                "heatmap": (2 * self.B, h[1], h[0],
                            self.cfg.MODEL.NUM_JOINTS, elt)}

    # ------------------------------------------------------------- check
    def release(self):
        del self.inf
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, i, rows=None, heatmaps=False, dtype=torch.float32):
        """The reference's (pred_2d, pred_3d) of pool request i, its network
        computed in `dtype` (or its heatmap logits)."""
        from benchmark.reference import model as ref
        from benchmark.reference.pipeline import normalize
        imgs = self.pool[i, :, :rows].to(self.device)
        imgs = normalize(imgs.permute(1, 0, 4, 2, 3).float())
        proj = torch.as_tensor(self.proj[:rows], device=self.device)
        ops = ref.Ops(self.sd0, self.sd0, train=False, dtype=dtype)
        with torch.no_grad():
            if heatmaps:
                return ref.cdrnet_heatmaps(ops, imgs, proj, self.depth)
            p2, p3, _ = ref.cdrnet(ops, imgs, proj, self.depth)
        return p2.float().cpu().numpy(), p3.float().cpu().numpy()

    def sample(self):
        """The window's requests that are compared, drawn from the seed."""
        rng = np.random.default_rng(sub_seed(self.seed, 3))
        n = min(self.traffic["check_requests"], len(self.served))
        return [self.served[j] for j in sorted(
            rng.choice(len(self.served), n, replace=False))]

    def gaps(self, outs):
        """outs: [(pool index, pred_2d, pred_3d)] against the reference."""
        from benchmark.reference.geometry import dlt_residual_gap
        d2 = np.stack([np.abs(p2 - self.ref[i][0]) for i, p2, _ in outs])
        P = torch.as_tensor(self.proj, dtype=torch.float64)
        geo = np.stack([dlt_residual_gap(P, torch.as_tensor(p2),
                                         torch.as_tensor(p3)).numpy()
                        for _, p2, p3 in outs])
        # a NaN compares False: the share of NaNs reads 1, and a NaN gap
        # is not correct
        return {"pred2d_vs_bf16": float(np.mean(d2) / self.yardstick),
                "pred2d_over_2bf16": float(np.mean(
                    ~(d2 <= 2.0 * self.yardstick))),
                "geometry_gap": float(np.max(geo))
                if np.isfinite(geo).all() else float("nan")}

    def diagnostics(self, outs=None):
        """What lies behind the numbers: the 2D gaps in pixels and against
        the yardstick, and the 3D points end to end."""
        outs = outs or self.outs
        d2 = np.stack([np.abs(p2 - self.ref[i][0]) for i, p2, _ in outs])
        gap3 = [float(np.abs(p3 - self.ref[i][1]).max()) for i, _, p3 in outs]
        return {"pred2d_mean_px": float(np.mean(d2)),
                "pred2d_max_px": float(np.max(d2)),
                "yardstick_px": self.yardstick,
                "pred3d_gap_mm": float(np.max(gap3))}

    def readings(self):
        outs = self.outs = self.sample()
        self.ref = {i: self.reference(i) for i, _, _ in outs}
        # the mean gap of the reference's own network in bf16, rounded where
        # a bf16 network rounds: what rounding to the cell's precision
        # alone moves a keypoint on these weights and inputs
        bf16 = {i: self.reference(i, dtype=torch.bfloat16) for i in self.ref}
        self.yard = np.stack([np.abs(bf16[i][0] - self.ref[i][0])
                              for i in self.ref])
        self.yardstick = float(np.mean(self.yard))
        return self.gaps(outs)

    def control_readings(self):
        """The control in the program's place: the program's int8 path
        (a pack calibrated on the pool's first requests), on the sampled
        requests (after readings())."""
        from fast3dhpe_tpu_torch.models import quantized as qz
        from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet
        dev = self.device

        def inputs(i):
            v = [normalize_imagenet(self.pool[i, k].to(dev))
                 for k in (0, 1)]
            return (torch.stack(v, dim=1),
                    torch.as_tensor(self.proj, device=dev))

        calib = [inputs(i) for i in range(self.traffic["control_calib"])]
        model = qz.cdrnet_int8(qz.quantize_cdrnet(self.sd0, calib),
                               self.cfg.MODEL.EXTRA.DLT_METHOD, dev)
        outs = self.low = []
        with torch.inference_mode():
            for i in self.ref:
                p2, p3 = model(*inputs(i))
                outs.append((i, p2.float().cpu().numpy(),
                             p3.float().cpu().numpy()))
        return self.gaps(outs)
