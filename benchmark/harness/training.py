"""The training cells' driver: the program's graphed stacked epochs, fed
from a frame cache on the device, run chunk after chunk, and checked
against the plain reference over their first steps.

Set-up builds one TrainState and drives it through the first chunk, whose
first three steps the reference follows: step 0 runs eagerly and warms
up, step 1 is captured into the step's CUDA graph and replayed, as is
every later step (the program's train/graphs.py). The window then runs further
chunks of the same state. The numbers compared (`readings`; a cell's
limits file names those it holds):

- loss_gap: the relative gap of step 0's loss;
- grad_gap: step 0's gradient as Adam received it (its first moment
  after step 0 over 1 - beta1), leaf by leaf: the gap between the
  program's norm and the reference's over the larger of the reference's
  norm and the median leaf's, worst leaf;
- replay_loss_gap, replay_grad_gap: the same of step 1, the first step
  that a graph replay computes (its gradient from the first moments
  after steps 0 and 1, (m1 - beta1 m0) / (1 - beta1)), against the
  reference's step 1 started from the program's weights after step 0,
  so that the noise of Adam's first update does not enter;
- loss2d_gap, replay_loss2d_gap (CDRNet): those of the loss's 2D term;
- change_gap: each leaf's change over the three steps, as grad_gap.

Leaves whose reference gradient is below a thousandth of the median
leaf's (a convolution's bias under BN, whose gradient is zero but for
rounding) move under Adam by round-off alone and are left out.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import scene
from .weights import calibrate_head, seeded_state_dict, sub_seed

BETA1 = 0.9
QUIET_LEAF = 1e-3          # of the median leaf's reference gradient norm


def _norms(tensors):
    return np.array([float(torch.linalg.vector_norm(t)) for t in tensors])


def leaf_gap(prog, ref, keep):
    prog, ref = np.asarray(prog), np.asarray(ref)
    floor = np.maximum(ref, np.median(ref))
    return float(np.max(np.abs(prog - ref)[keep] / floor[keep]))


class TrainCell:
    """Subclasses give: kind ("cdr" or "2d"), images_per_step, build()
    (the model on the device, from self.cfg), epoch_fn(), chunk(rng, k)
    (the stacked metadata of chunk k, numpy), run_chunk(xs, k) (one epoch
    call, returning its summed metrics), reference_batch(x, k, i) and
    heatmap_shape()."""

    kind = None
    clip = None

    def __init__(self, config, traffic, seed, device):
        from fast3dhpe_tpu_torch.config import config_from_dict
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cfg = config_from_dict(config)
        self.size = self.cfg.MODEL.IMAGE_SIZE[0]
        self.depth = self.cfg.MODEL.NUM_LAYERS
        self.S = traffic["steps_per_chunk"]
        self.B = traffic["batch"]
        self.check_steps = traffic["check_steps"]
        self.record = None

    # ------------------------------------------------------------ set-up
    def setup(self):
        from fast3dhpe_tpu_torch.train.state import TrainState
        t = self.traffic
        dev = self.device
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
        self.sd0 = seeded_state_dict(shapes, dev, sub_seed(self.seed, 4))
        with torch.no_grad():
            calibrate_head(self.sd0, self.reference_logits())
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

    def on_device(self, xs):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in xs.items()}

    def _on_step(self, m):
        rec = self.record
        i = len(rec["loss"])
        if i >= self.check_steps:
            return
        rec["loss"].append(m["loss"].detach().clone())
        rec["loss_2d"].append(m.get("loss_2d", m["loss"]).detach().clone())
        params = list(self.state.model.parameters())
        if i < 2:
            # an update that never ran has no moments: zero, not an error
            st = self.state.optimizer.state
            rec["moments"].append([st[p]["exp_avg"].detach().clone()
                                   if "exp_avg" in st[p] else
                                   torch.zeros_like(p) for p in params])
        if i == 0:
            rec["start"] = [p.detach().clone() for p in params]
        if i == self.check_steps - 1:
            rec["params"] = [p.detach().clone() for p in params]

    def reference_logits(self):
        """The heatmap logits of the reference in train mode on the first
        pairs of step 0, which the head is scaled by."""
        from ..reference import model as ref
        batch = self.reference_batch(self.chunks[0], 0, 0, rows=4)
        ops = ref.Ops(self.sd0, self.sd0, train=True, update=False)
        if self.kind == "cdr":
            return ref.cdrnet_heatmaps(ops, batch["images"], batch["proj"],
                                       self.depth)
        return ref.poseresnet(ops, batch["images"], self.depth)

    # ------------------------------------------------------------ window
    def _chunk(self):
        k = self.next_chunk % len(self.chunks)
        sums = self.run_chunk(self.chunks[k], k)
        self.next_chunk += 1
        return sums

    def run_for(self, seconds):
        steps = failed = 0
        t0 = time.perf_counter()
        while True:
            loss = float(self._chunk()["loss"])        # waits for the chunk
            steps += self.S
            if not np.isfinite(loss):
                failed += self.S
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"attempted": steps, "failed": failed, "elapsed": elapsed,
                "metrics": {"train_images_per_s":
                            steps * self.images_per_step / elapsed}}

    def traced(self):
        """fn, steps: one chunk, for the traced window."""
        return (lambda: self._chunk()), self.S

    def trace_info(self, precision):
        from .flops import forward_flops
        shapes = {k: tuple(v.shape) for k, v in self.sd0.items()}
        fwd = forward_flops(self.kind, shapes, self.depth, self.B, self.size)
        return {"flops_per_step": 3 * fwd, "precision": precision,
                "chips": 1, "heatmap": self.heatmap_shape()}

    # ------------------------------------------------------------- check
    def release(self):
        """Free the program's state: the reference runs after it. What is
        kept: the readings' inputs, and the weights after step 0 that the
        reference's replayed step starts from."""
        rec = self.record
        m0, m1 = rec["moments"]
        self.prog = {
            "loss": float(rec["loss"][0]),
            "loss_2d": float(rec["loss_2d"][0]),
            "grad": _norms(m0) / (1 - BETA1),
            "replay_loss": float(rec["loss"][1]),
            "replay_loss_2d": float(rec["loss_2d"][1]),
            "replay_grad": _norms((b.double() - BETA1 * a.double())
                                 / (1 - BETA1) for a, b in zip(m0, m1)),
            "change": _norms(p - self.sd0[k] for k, p in
                            zip(self.names, rec["params"])),
            "losses": [float(v) for v in rec["loss"]]}
        self.start = dict(self.sd0)
        self.start.update(zip(self.names, rec["start"]))
        del self.state, self.epoch, self.record
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _trainer(self, state_dict):
        from ..reference.train import Trainer
        return Trainer(state_dict, self.names, self.cfg.TRAIN.LR,
                       self.depth, self.kind, clip=self.clip,
                       use_3d=self.traffic.get("use_3d", False))

    def replay_reference(self):
        """The reference's step 1 from the program's weights after step 0
        (release): its loss and its gradients' norms."""
        trainer = self._trainer(self.start)
        loss, grads = trainer.grads(self.reference_batch(self.chunks[0], 0,
                                                         1))
        return {"replay_loss": float(loss),
                "replay_loss_2d": float(trainer.loss_2d),
                "replay_grad": _norms(grads)}

    def reference_run(self):
        """The reference's step 0 loss and gradients' norms and its
        leaves' changes over the first check_steps steps of chunk 0, from
        the seeded weights; and its step 1 from the program's weights
        after step 0 (replay_reference)."""
        def batch(i):
            return self.reference_batch(self.chunks[0], 0, i)

        out = self.replay_reference()
        trainer = self._trainer(self.sd0)
        losses = []
        for i in range(self.check_steps):
            loss, grads = trainer.step(batch(i))
            losses.append(float(loss))
            if i == 0:
                out.update(loss=float(loss), loss_2d=float(trainer.loss_2d),
                           grad=_norms(grads))
            del grads
        out["change"] = _norms(trainer.params[k].detach() - self.sd0[k]
                              for k in self.names)
        out["losses"] = losses
        return out

    @staticmethod
    def _keep(grad):
        return grad >= QUIET_LEAF * np.median(grad)

    def gaps(self, prog, ref):
        def rel(key):
            return float(abs(prog[key] - ref[key]) / abs(ref[key]))

        keep = self._keep(ref["grad"])
        out = {"loss_gap": rel("loss"),
               "grad_gap": leaf_gap(prog["grad"], ref["grad"], keep),
               "replay_loss_gap": rel("replay_loss"),
               "replay_grad_gap": leaf_gap(prog["replay_grad"],
                                           ref["replay_grad"],
                                           self._keep(ref["replay_grad"])),
               "change_gap": leaf_gap(prog["change"], ref["change"], keep)}
        if self.kind == "cdr":
            out.update(loss2d_gap=rel("loss_2d"),
                       replay_loss2d_gap=rel("replay_loss_2d"))
        return out

    def readings(self):
        self.ref = self.reference_run()
        return self.gaps(self.prog, self.ref)

    def diagnostics(self, prog=None):
        """What lies behind the gaps: each step's loss gap (the later
        steps' from the reference's own weights) and the leaves' gaps by
        rank."""
        prog, ref = prog or self.prog, self.ref
        out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in
                             zip(prog["losses"], ref["losses"])],
               "quiet_leaves": [n for n, k in
                                zip(self.names, self._keep(ref["grad"]))
                                if not k]}
        for key, by in (("grad", "grad"), ("change", "grad"),
                        ("replay_grad", "replay_grad")):
            keep = self._keep(ref[by])
            floor = np.maximum(ref[key], np.median(ref[key]))
            gap = np.abs(prog[key] - ref[key]) / floor
            gap[~keep] = 0.0
            order = np.argsort(gap)[::-1][:3]
            out[f"{key}_median_gap"] = float(np.median(gap[keep]))
            out[f"{key}_worst"] = [(self.names[i], float(gap[i]))
                                   for i in order]
        return out

    def control_readings(self):
        """The control in the program's place: the reference with TF32 on
        in cuDNN and cuBLAS, against the reference (after readings())."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            self.low = self.reference_run()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        return self.gaps(self.low, self.ref)

    def witness_readings(self):
        """The reference with its DLT in fp32, against the reference (after
        readings()): how far rounding in the DLT alone moves each number."""
        from ..reference import geometry
        saved = geometry.DLT_DTYPE
        geometry.DLT_DTYPE = torch.float32
        try:
            self.wit = self.reference_run()
        finally:
            geometry.DLT_DTYPE = saved
        return self.gaps(self.wit, self.ref)
