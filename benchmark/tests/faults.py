"""Faults planted underneath the timed path, for the check's own tests.
Each takes a setter, `setattr` or pytest's monkeypatch.setattr, so that
a process that a driver starts can take it too."""

import torch


def state_unchanged(put):
    """The optimizer's update leaves the weights as they were."""
    put(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(put):
    """The train step takes the first half of its rows, its loss the mean
    over them."""
    from fast3dhpe_tpu_torch.train import steps
    on_device = steps._on_device

    def half(batch, device):
        out = on_device(batch, device)
        return {k: v[:v.shape[0] // 2] for k, v in out.items()}
    put(steps, "_on_device", half)


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def half_batch_captured(put):
    """half_batch inside the captured step alone: step 0, which runs
    eagerly, is sound, and every replayed step takes half its rows. Acts
    on the card only (on the CPU every step runs eagerly)."""
    from fast3dhpe_tpu_torch.train import steps
    on_device = steps._on_device

    def half(batch, device):
        out = on_device(batch, device)
        if not _capturing():
            return out
        return {k: v[:v.shape[0] // 2] for k, v in out.items()}
    put(steps, "_on_device", half)


def tf32_captured(put):
    """The step's graph captured with TF32 on in cuDNN and cuBLAS: step 0,
    which runs eagerly, is sound. Acts on the card only."""
    from fast3dhpe_tpu_torch.train.graphs import StepGraphs
    capture = StepGraphs._capture

    def tf32(self, *a, **k):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            return capture(self, *a, **k)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    put(StepGraphs, "_capture", tf32)


def _forward(put, change):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    forward = CDRNet.forward

    def broken(self, imgs, projs, *a, **k):
        return change(forward, self, imgs, projs, *a, **k)
    put(CDRNet, "forward", broken)


def serve_half_batch(put):
    """The request's forward runs its first half of the pairs and returns
    their answers twice."""
    def change(forward, self, imgs, projs, *a, **k):
        n = imgs.shape[0] // 2
        kp, p3 = forward(self, imgs[:n], projs[:n], *a, **k)
        return torch.cat([kp, kp]), torch.cat([p3, p3])
    _forward(put, change)


def answer_altered(put):
    """Each request's answer leaves the forward a pixel off: every
    keypoint moves by (1, 1)."""
    def change(forward, self, imgs, projs, *a, **k):
        kp, p3 = forward(self, imgs, projs, *a, **k)
        return kp + 1.0, p3
    _forward(put, change)


def pred3d_moved(put):
    """Each 3D point leaves the forward 1 mm deeper (along the world's z
    axis, which the rig fixes worst): the answer altered where the
    geometry produces it."""
    def change(forward, self, imgs, projs, *a, **k):
        kp, p3 = forward(self, imgs, projs, *a, **k)
        return kp, p3 + p3.new_tensor([0.0, 0.0, 1.0])
    _forward(put, change)


def _jacobi(put, sweeps):
    from fast3dhpe_tpu_torch.geometry import triangulation
    from fast3dhpe_tpu_torch.ops.small_svd import jacobi_svd
    put(triangulation, "smallest_right_singular_vector",
        lambda A: jacobi_svd(A, sweeps)[2][..., :, -1])


def jacobi_sweep_dropped(put):
    """The DLT's Jacobi SVD runs one sweep fewer than the program's."""
    from fast3dhpe_tpu_torch.ops.small_svd import SWEEPS
    _jacobi(put, SWEEPS - 1)


def jacobi_one_sweep(put):
    """The DLT's Jacobi SVD runs a single sweep."""
    _jacobi(put, 1)


def dlt_by_torch_svd(put):
    """Not a fault: the program's own cross-check path, the DLT by
    torch.linalg.svd in place of the Jacobi SVD, for a witness that tells
    the Jacobi's backward from the rest of the step. Every step then runs
    eagerly: torch.linalg.svd cannot be captured in a CUDA graph."""
    from fast3dhpe_tpu_torch.models import cdrnet
    from fast3dhpe_tpu_torch.train import steps
    from fast3dhpe_tpu_torch.train.graphs import StepGraphs
    triangulate = cdrnet.dlt_triangulate
    put(cdrnet, "dlt_triangulate",
        lambda proj, points, method="jacobi": triangulate(proj, points,
                                                          method="svd"))
    put(steps, "StepGraphs",
        lambda graphed=True, mesh=None: StepGraphs(False, mesh))
