"""The PyTorch port's stacked epochs and segments under a mesh
(fast3dhpe_tpu_torch/parallel/mesh.py shard_stacked, train/steps.py's
epoch and segment factories with mesh=, train/graphs.py under a process
group, the loaders' per-shard device cache and the loops' agreed path)
against the JAX package's scan epochs and segments on a 2-device mesh,
on the CPU; depth 18 at 64 px.

Two gloo ranks of each case are subprocesses that run this file as a
script (`python tests/test_torch_stacked_mesh.py <epochs|loops> <rank>
<dir>`), meeting through a file:// store in the test's temporary
directory, one thread each, spawned together by one module fixture while
the test process runs JAX:
- "epochs": each rank runs make_train_epoch_cdr (CUTOUT),
  make_eval_epoch_cdr, make_segment_cdr and make_segment_2d on
  shard_stacked(mesh, ...) of one global stack, with the whole frames,
  and the same steps under a dispatch mode that flags host-made tensors;
- "loops": each rank runs loop_cdr.run and loop2d.run with its shard
  cached, by segments, by stacked epochs and batch by batch, and
  loop_cdr.run where one rank's shard misses the cache budget.
JAX runs the same epochs and segments on shard_stacked(make_mesh(2), ...)
with replicated frames and state. Under gloo the port's steps run
eagerly (a CPU rank has no graphs); the CUDA graphs of these steps under
NCCL are held against their eager form on the card (chip_smoke.py
phases 17 and 18).

Tolerances (each test names its own):
- shard_stacked against JAX's device shards: bit for bit;
- the world-2 epochs against JAX's: tests/test_torch_train_epoch.py's
  bounds for an epoch of two steps at LR 1e-6 (losses 1e-4 relative,
  grad_norm 1e-2, parameters 2.5 LR, BN statistics BN_TOL of each
  buffer's range), the eval sums 1e-4 relative and n exact: the ranks'
  partial sums round apart from one sum, as in
  tests/test_torch_distributed.py's steps;
- the world-2 segments against JAX's: tests/test_torch_segments.py's;
- the ranks against each other, and the loops' three paths against each
  other: bit for bit (every reduction sums the same values in the same
  order on every path).
"""

import logging
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

# The ranks run this file as a script and need no JAX.
if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import optax
    from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
    from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
    from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
    from fast3dhpe_tpu.models import make_loss as jax_make_loss
    from fast3dhpe_tpu.ops.occlusion import cutout as jax_cutout
    from fast3dhpe_tpu.parallel import mesh as jax_mesh
    from fast3dhpe_tpu.train import steps as jsteps
    from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
    from fast3dhpe_tpu.train.state import multistep_lr as jax_multistep_lr
    from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
    from fast3dhpe_tpu_torch.parallel import distributed
    from fast3dhpe_tpu_torch.parallel import mesh as pmesh
    from fast3dhpe_tpu_torch.train import graphs as tgraphs
    from test_torch_device_pipeline import _rig
    from test_torch_loops import GRAD_3D_TOL, TOL_3D
    from test_torch_pipeline_ops import _smooth_frames
    from test_torch_train_epoch import _trans

    torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CHILD_TIMEOUT = 600
IMG, HM, J, J2, H0, W0, N_FRAMES = 64, 16, 19, 4, 60, 80, 12
S, B = 2, 4                   # the epochs: 2 steps of 2 + 2 pairs
E_FULL, E_VALID, WARMUP, SEED, EPOCH0 = 3, 2, 1, 0, 1   # the segments
LR, BN_TOL = 1e-6, 1e-3       # tests/test_torch_train_epoch.py's
CFG = {"MODEL": {"NAME": "tiny_cdr", "NUM_LAYERS": 18,
                 "IMAGE_SIZE": [IMG, IMG],
                 "EXTRA": {"HEATMAP_SIZE": [HM, HM], "SIGMA": 1}},
       "TRAIN": {"LR": LR, "LR_STEP": [1], "LR_FACTOR": 0.1},
       "LOSS": {"TYPE": "JointsMSESmooth", "USE_TARGET_WEIGHT": True}}
# the loops: 4 pairs a split (2 a rank), 2 pairs a rank a step, 3 epochs
# checkpointed every 2 (segments of 2 and a padded 1)
LOOP_FRAMES, LOOP_BATCH, LOOP_EVERY, LOOP_EPOCHS = 2, 2, 2, 3
# the budget case: 5 records a split, 3 on rank 0 and 2 on rank 1; the
# budget holds rank 1's 4 frames of 96 x 128 and not rank 0's 6
MISS_FRAMES, MISS_BUDGET = 5, 4 * 96 * 128 * 3
PATHS = {"segments": {}, "epochs": {"segments": False},
         "batches": {"scan_epochs": False}}


def _loop_dict(root, dataset, name, budget=1 << 30):
    return {
        "DATASET": {"TYPE": dataset, "ROOT": str(root),
                    "OCCLUSION": "CUTOUT" if dataset == "MADS_3d"
                    else "None", "DEVICE_CACHE_BYTES": budget},
        "MODEL": {"NAME": name, "NUM_LAYERS": 18, "IMAGE_SIZE": [IMG, IMG],
                  "PRETRAINED": "",
                  "EXTRA": {"HEATMAP_SIZE": [HM, HM], "SIGMA": 1}},
        "TRAIN": {"BATCH_SIZE": LOOP_BATCH, "EPOCH": LOOP_EPOCHS,
                  "WARMUP": 1, "LR": 1e-4, "LR_STEP": [40],
                  "LR_FACTOR": 0.1},
        "TEST": {"BATCH_SIZE": LOOP_BATCH},
        "LOSS": {"TYPE": "JointsMSESmooth" if dataset == "MADS_3d"
                 else "JointsMSE", "USE_TARGET_WEIGHT": True}}


# --------------------------------------------------------------- ranks

class _HostData(TorchDispatchMode):
    """A dispatch mode that records every tensor made from host data
    (aten.lift_fresh: torch.tensor(...)) and every read of a device value
    on the host (aten._local_scalar_dense: .item(), float(t)), which a
    CUDA graph of the step cannot hold."""

    FLAGGED = ("aten.lift_fresh", "aten._local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.FLAGGED):
            self.found.append((str(func), "".join(
                traceback.format_stack(limit=6)[:-1])))
        return func(*args, **(kwargs or {}))


def _audited(found):
    """StepGraphs.epoch with each step run under _HostData; the optimizer
    update (the CPU's Adam reads its step count) is left out, as a graph
    captures only the CUDA optimizer's capturable step."""
    from fast3dhpe_tpu_torch.train.graphs import StepGraphs
    orig = StepGraphs.epoch

    def epoch(self, key, owner, xs, fn, **kw):
        def step(x, gen, update):
            def quiet():
                with _disable_current_modes():
                    update()

            mode = _HostData()
            with mode:
                out = fn(x, gen, None if update is None else quiet)
            found.extend((key[0],) + f for f in mode.found)
            return out

        return orig(self, key, owner, xs, step, **kw)

    return orig, epoch


def _rank_epochs(rank, work):
    from fast3dhpe_tpu_torch.config import config_from_dict
    from fast3dhpe_tpu_torch.data import device_pipeline
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.ops.occlusion import fill_occluded
    from fast3dhpe_tpu_torch.parallel import make_mesh, replicate
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS, shard_stacked
    from fast3dhpe_tpu_torch.train import steps
    from fast3dhpe_tpu_torch.train.graphs import StepGraphs
    from fast3dhpe_tpu_torch.train.loop2d import _best_snapshot
    from fast3dhpe_tpu_torch.train.state import TrainState
    inp = torch.load(os.path.join(work, "epochs_in.pt"), weights_only=False)
    mesh = make_mesh()
    frames = torch.from_numpy(inp["frames"])
    cfg = config_from_dict(CFG)
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    loss2d = make_loss("JointsMSE", True, layout="NHWC")

    def state(cls, sd, steps_per_epoch, **kw):
        model = cls(num_layers=18, **kw)
        model.load_state_dict(sd, strict=True)
        replicate(mesh, model, spatial=False)
        return TrainState.create(model, cfg, steps_per_epoch)

    def snap(st):
        return {k: v.clone() for k, v in st.model.state_dict().items()}

    out = {"graphed": StepGraphs(mesh=mesh).graphed,
           "backend": StepGraphs(mesh=mesh).backend}
    # a. CUTOUT train epoch, the keep-masks JAX drew for the global batch
    keeps = list(shard_stacked(mesh, {"k": inp["keep"]})["k"])
    replay = []

    def occlude(gen, warped, occlusion, occl_prob=0.3):
        keep = keeps[len(replay)]
        replay.append(occlusion)
        return fill_occluded(warped, keep), keep

    orig = device_pipeline.occlude_stereo
    device_pipeline.occlude_stereo = occlude
    try:
        st = state(CDRNet, inp["cdr_init"], 1)
        COUNTS.clear()
        tm = steps.make_train_epoch_cdr(loss, (IMG, IMG), occlusion="CUTOUT",
                                        mesh=mesh)(
            st, frames, shard_stacked(mesh, inp["xs"]), SEED, False)
        out["train"] = {"sums": {k: float(v) for k, v in tm.items()},
                        "state": snap(st), "step": st.step,
                        "counts": dict(COUNTS), "replayed": replay}
    finally:
        device_pipeline.occlude_stereo = orig
    # b. eval epoch at the initial weights
    ev = steps.make_eval_epoch_cdr(loss, (IMG, IMG), mesh=mesh)(
        state(CDRNet, inp["cdr_init"], 1), frames,
        shard_stacked(mesh, inp["vxs"]), True)
    out["eval"] = {k: float(v) for k, v in ev.items()}
    # c. the CDR segment from EPOCH0: two valid epochs and a padding one
    st = state(CDRNet, inp["cdr_init"], 1)
    best = _best_snapshot(st)
    _, _, err, ms = steps.make_segment_cdr(
        loss, (IMG, IMG), warmup=WARMUP, seed=SEED, mesh=mesh)(
        st, best, torch.tensor(float("inf")), frames, frames,
        shard_stacked(mesh, inp["seq"], lead=2),
        shard_stacked(mesh, inp["seg_vxs"]), EPOCH0, inp["valid"])
    out["segment_cdr"] = {"ms": ms, "err": float(err), "state": snap(st),
                          "best": {k: v.clone() for k, v in best.items()},
                          "step": st.step}
    # d. the 2D segment
    st = state(PoseResNet, inp["pose_init"], 1, num_joints=J2)
    best = _best_snapshot(st)
    _, _, acc, ms = steps.make_segment_2d(
        loss2d, (IMG, IMG), (HM, HM), 2, mesh=mesh)(
        st, best, torch.tensor(-1.0), frames, frames,
        shard_stacked(mesh, inp["seq2d"], lead=2),
        shard_stacked(mesh, inp["vxs2d"]), inp["valid"])
    out["segment_2d"] = {"ms": ms, "acc": float(acc), "state": snap(st),
                         "best": {k: v.clone() for k, v in best.items()}}
    # e. every step kind of the stacked path under the host-data audit
    found = []
    orig, audited = _audited(found)
    StepGraphs.epoch = audited
    try:
        one = {k: v[:1] for k, v in inp["xs"].items()}
        st = state(CDRNet, inp["cdr_init"], 1)
        steps.make_train_epoch_cdr(loss, (IMG, IMG), occlusion="CUTOUT",
                                   mesh=mesh)(
            st, frames, shard_stacked(mesh, one), SEED, True)
        steps.make_segment_cdr(loss, (IMG, IMG), warmup=0, mesh=mesh)(
            st, _best_snapshot(st), torch.tensor(float("inf")), frames,
            frames, shard_stacked(mesh, {k: v[:1, :1] for k, v in
                                         inp["seq"].items()}, lead=2),
            shard_stacked(mesh, one), 1, [True])
        one2d = {k: v[:1] for k, v in inp["vxs2d"].items()}
        st = state(PoseResNet, inp["pose_init"], 1, num_joints=J2)
        steps.make_train_epoch_2d(loss2d, (IMG, IMG), (HM, HM), 2,
                                  mesh=mesh)(
            st, frames, shard_stacked(mesh, one2d))
        steps.make_eval_epoch_2d(loss2d, (IMG, IMG), (HM, HM), 2,
                                 mesh=mesh)(
            st, frames, shard_stacked(mesh, one2d))
    finally:
        StepGraphs.epoch = orig
    out["host_data"] = found
    torch.save(out, os.path.join(work, f"epochs_out_{rank}.pt"))


def _rank_loops(rank, work):
    import json
    import shutil
    from fast3dhpe_tpu_torch.config import config_from_dict
    from fast3dhpe_tpu_torch.parallel import make_mesh
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train import loop2d, loop_cdr
    from fast3dhpe_tpu_torch.utils.logging import setup_logger
    mesh = make_mesh()
    with open(os.path.join(work, "loops.json")) as f:
        cfgs = json.load(f)
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = setup_logger()
    logger.addHandler(Keep())
    loaders, load = [], {m: m.load_data for m in (loop_cdr, loop2d)}

    def spy(module):
        def load_data(config, **kw):
            out = load[module](config, **kw)
            loaders[:] = out
            return out
        return load_data

    out = {}
    runs = [(kind, path, cfgs[kind], kw) for kind in ("cdr", "2d")
            for path, kw in PATHS.items()]
    runs += [("miss", path, cfgs["miss"], PATHS[path])
             for path in ("segments", "batches")]
    for kind, path, cfg, kw in runs:
        loop = loop2d if kind == "2d" else loop_cdr
        loop.load_data = spy(loop)
        del lines[:]
        COUNTS.clear()
        root = os.path.join(work, f"w_{kind}_{path}_{rank}")
        try:
            hist = loop.run(config_from_dict(cfg), mesh=mesh,
                            overwrite=True, seed=SEED,
                            checkpoint_every=LOOP_EVERY, device="cpu",
                            weights_root=root, **kw)
        finally:
            loop.load_data = load[loop]
        # what the run wrote, then the checkpoints go (they are large)
        written = sorted(os.path.relpath(os.path.join(d, f), root)
                         for d, _, fs in os.walk(root) for f in fs)
        shutil.rmtree(root, ignore_errors=True)
        out[(kind, path)] = {
            "written": written,
            "hist": hist, "log": [ln for ln in lines
                                  if ln.startswith("Training path")],
            "counts": dict(COUNTS),
            "cached": [ld.device_cached for ld in loaders],
            "cache_rows": [ld.ensure_device_cache().frames.shape[0]
                           if ld.device_cached else 0 for ld in loaders],
            "records": [len(ld.records) for ld in loaders]}
    torch.save(out, os.path.join(work, f"loops_out_{rank}.pt"))


def _rank_main(case, rank, work):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed)
    assert init_distributed(backend="gloo", device="cpu",
                            init_method="file://" + os.path.join(
                                work, f"{case}.store"))
    try:
        {"epochs": _rank_epochs, "loops": _rank_loops}[case](rank, work)
    finally:
        destroy_distributed()


# --------------------------------------------------------- test process

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spawn(case, work):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST") and k not in
           ("RANK", "WORLD_SIZE", "LOCAL_RANK", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r),
         str(work)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _wait(procs, what):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} rank {r} failed:\n{log[-4000:]}"


def _stereo_xs(seed, n_steps=S, batch=B):
    """n_steps stacked batches of `batch` pairs drawn from the 6 pairs of
    the frames (with repeats), the last row of the last batch padded."""
    r = np.random.RandomState(seed)
    pair = r.randint(0, N_FRAMES // 2, (n_steps, batch))
    P_l, P_r = _rig(n_steps * batch, H0, W0)
    rv = np.ones((n_steps, batch), np.float32)
    rv[-1, -1] = 0.0
    return {"idx_l": (2 * pair).astype(np.int32),
            "idx_r": (2 * pair + 1).astype(np.int32),
            "trans": _trans(r, n_steps * batch).reshape(
                n_steps, batch, 2, 3).astype(np.float32),
            "P_l": P_l.reshape(n_steps, batch, 4, 4),
            "P_r": P_r.reshape(n_steps, batch, 4, 4),
            "pose_3d": r.uniform(-250, 250, (n_steps, batch, J, 3))
            .astype(np.float32),
            "joints_vis": np.ones((n_steps, batch, J), np.float32),
            "row_valid": rv}


def _mono_xs(seed, n_steps=1, batch=B):
    r = np.random.RandomState(seed)
    rv = np.ones((n_steps, batch), np.float32)
    rv[-1, -1] = 0.0
    return {"idx": r.randint(0, N_FRAMES, (n_steps, batch)).astype(np.int32),
            "flip": r.rand(n_steps, batch) > 0.5,
            "trans": _trans(r, n_steps * batch).reshape(
                n_steps, batch, 2, 3).astype(np.float32),
            "joints": r.uniform(4, IMG - 4, (n_steps, batch, J2, 2))
            .astype(np.float32),
            "vis": (r.rand(n_steps, batch, J2) > 0.2).astype(np.float32),
            "row_valid": rv}


def _seq(xs_list):
    """(E_FULL, 1, B, ...) metadata, padded with the last epoch."""
    xs_list = xs_list + [xs_list[-1]] * (E_FULL - len(xs_list))
    return {k: np.stack([x[k] for x in xs_list]) for k in xs_list[0]}


def _jax_keep(epoch_key, n_steps, batch):
    """The keep-masks (n_steps, batch, 2, H, W) that JAX's CUTOUT train
    epoch draws (data/device_pipeline.py: step i's key fold_in(epoch key,
    i) split into the gate's and each view's, the gate at 0.3)."""
    z = jnp.zeros((batch, IMG, IMG, 3))
    out = []
    for i in range(n_steps):
        kg, kl, kr = jax.random.split(jax.random.fold_in(epoch_key, i), 3)
        gate = (jax.random.uniform(kg, (batch,)) <= 0.3)[:, None, None]
        out.append(np.stack([np.asarray(jnp.where(gate, jax_cutout(k, z)[1],
                                                  True))
                             for k in (kl, kr)], 1))
    return np.stack(out)


def _cdr_init(proj):
    """JAX's CDRNet-18 init, the head scaled as tests/
    test_torch_train_epoch.py scales it (the views decode apart)."""
    model = JaxCDRNet(num_layers=18)
    v = _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, IMG, IMG, 3)),
        jnp.asarray(proj[0, :1, None, :3].repeat(2, 1)), train=False))
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    head["bias"] = head["bias"] + np.random.RandomState(3).randn(J).astype(
        np.float32)
    return model, v


def _jax_runs(inp, v_cdr, model_cdr, v_pose, model_pose):
    """JAX's epochs and segments on a 2-device mesh: the metadata by
    shard_stacked, the frames and the state replicated."""
    mesh = jax_mesh.make_mesh(WORLD)
    frames = jax_mesh.replicate(mesh, jnp.asarray(inp["frames"]))
    jloss = jax_make_loss("JointsMSESmooth", True)

    def st(v, steps_per_epoch):
        tx = optax.adam(jax_multistep_lr(LR, [1], 0.1, steps_per_epoch))
        return jax_mesh.replicate(mesh, JaxTrainState.create(v, tx))

    def sh(tree, lead=1):
        return jax_mesh.shard_stacked(
            mesh, {k: jnp.asarray(a) for k, a in tree.items()}, lead)

    out = {}
    state, tm = jsteps.make_train_epoch_cdr(
        model_cdr, jloss, (IMG, IMG), occlusion="CUTOUT")(
        st(v_cdr, 1), frames, sh(inp["xs"]), jax.random.PRNGKey(SEED),
        False)
    out["train"] = {"sums": _np(tm), "state": jax_variables_to_state_dict(
        _np(state.variables))}
    out["eval"] = _np(jsteps.make_eval_epoch_cdr(model_cdr, jloss,
                                                 (IMG, IMG))(
        st(v_cdr, 1), frames, sh(inp["vxs"]), True))
    s0 = st(v_cdr, 1)
    jst, jbest, jerr, jms = jsteps.make_segment_cdr(
        model_cdr, jloss, (IMG, IMG), warmup=WARMUP, seed=SEED)(
        s0, s0, jnp.asarray(np.inf, jnp.float32), frames, frames,
        sh(inp["seq"], 2), sh(inp["seg_vxs"]), jnp.asarray(EPOCH0),
        jnp.asarray(inp["valid"]))
    out["segment_cdr"] = {
        "ms": _np(jms), "err": float(jerr),
        "state": jax_variables_to_state_dict(_np(jst.variables)),
        "best": jax_variables_to_state_dict(_np(jbest.variables))}
    s0 = st(v_pose, 1)
    jst, jbest, jacc, jms = jsteps.make_segment_2d(
        model_pose, jax_make_loss("JointsMSE", True, layout="NHWC"),
        (IMG, IMG), (HM, HM), 2)(
        s0, s0, jnp.asarray(-1.0, jnp.float32), frames, frames,
        sh(inp["seq2d"], 2), sh(inp["vxs2d"]), jnp.asarray(inp["valid"]))
    out["segment_2d"] = {
        "ms": _np(jms), "acc": float(jacc),
        "state": jax_variables_to_state_dict(_np(jst.variables)),
        "best": jax_variables_to_state_dict(_np(jbest.variables))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both cases' ranks, spawned together, and JAX meanwhile."""
    import json
    work = tmp_path_factory.mktemp("stacked_mesh")
    for name, n, mv in (("mads", LOOP_FRAMES, ("HipHop", "Jazz")),
                        ("mads_odd", MISS_FRAMES, ("HipHop",))):
        make_synthetic_mads(str(work / name), n_frames=n, img_w=128,
                            img_h=96, movements=mv)
    with open(work / "loops.json", "w") as f:
        json.dump({"cdr": _loop_dict(work / "mads", "MADS_3d", "cdr"),
                   "2d": _loop_dict(work / "mads", "MADS_2d", "pose"),
                   "miss": _loop_dict(work / "mads_odd", "MADS_3d", "miss",
                                      MISS_BUDGET)}, f)
    procs = {"loops": _spawn("loops", work)}
    try:
        xs = _stereo_xs(31)
        seq = _seq([_stereo_xs(40 + e, 1) for e in range(E_VALID)])
        seq2d = _seq([_mono_xs(100 + e) for e in range(E_VALID)])
        model_cdr, v_cdr = _cdr_init(xs["P_l"])
        model_pose = JaxPoseResNet(num_joints=J2, num_layers=18)
        v_pose = _np(jax.jit(model_pose.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
            train=False))
        inp = {"frames": _smooth_frames(30, N_FRAMES, H0, W0), "xs": xs,
               "keep": _jax_keep(jax.random.PRNGKey(SEED), S, B),
               "vxs": _stereo_xs(50), "seq": seq,
               "seg_vxs": _stereo_xs(60, 1), "seq2d": seq2d,
               "vxs2d": _mono_xs(110),
               "valid": np.arange(E_FULL) < E_VALID,
               "cdr_init": jax_variables_to_state_dict(v_cdr),
               "pose_init": jax_variables_to_state_dict(v_pose)}
        torch.save(inp, work / "epochs_in.pt")
        procs["epochs"] = _spawn("epochs", work)
        ref = _jax_runs(inp, v_cdr, model_cdr, v_pose, model_pose)
    finally:
        for case, ps in procs.items():
            _wait(ps, case)
    out = {case: [torch.load(work / f"{case}_out_{r}.pt",
                             weights_only=False) for r in range(WORLD)]
           for case in ("epochs", "loops")}
    return {"work": work, "jax": ref, "inp": inp, **out}


def _rank0(runs, key):
    """Rank 0's result of the epochs case, after holding rank 1's equal to
    it bit for bit."""
    a, b = (r[key] for r in runs["epochs"])
    _same(a, b, key)
    return a


def _same(a, b, path):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], (path, k))
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _state_close(got, ref, tag):
    """Parameters within 2.5 LR of JAX's, BN statistics within BN_TOL of
    each buffer's range."""
    for name, t in got.items():
        if name not in ref or "num_batches" in name:
            continue
        r = torch.as_tensor(np.asarray(ref[name]))
        if "running" in name:
            assert float((t - r).abs().max()) <= BN_TOL * float(
                r.abs().max()), (tag, name)
        else:
            assert float((t - r).abs().max()) <= 2.5 * LR, (tag, name)


# ------------------------------------------------------- shard_stacked

@pytest.mark.parametrize("n_dev,lead", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_shard_stacked_matches_jax(n_dev, lead):
    """Rank r of a D-rank mesh gets what JAX's shard_stacked puts on
    device r of a D-device mesh, bit for bit: the contiguous block
    [r * B / D, (r + 1) * B / D) of the batch axis at `lead`, on the
    mesh's device, for every leaf (nested dicts too); the model ranks of
    a data group get their data index's block."""
    r = np.random.RandomState(n_dev + lead)
    shape = (3,) * lead + (8,)
    tree = {"a": r.randn(*shape, 5).astype(np.float32),
            "b": {"c": r.randint(0, 9, shape).astype(np.int32),
                  "d": r.rand(*shape) > 0.5}}
    jm = jax_mesh.make_mesh(n_dev)
    got_jax = jax_mesh.shard_stacked(jm, jax.tree_util.tree_map(
        jnp.asarray, tree), lead)
    for rank in range(n_dev):
        dev = jm.devices.reshape(-1)[rank]
        for m in (0, 1):
            mesh = pmesh.Mesh(None, rank, n_dev, torch.device("cpu"),
                              model_rank=m, model_size=2)
            got = pmesh.shard_stacked(mesh, tree, lead)
            for path, x in (("a", got["a"]), ("c", got["b"]["c"]),
                            ("d", got["b"]["d"])):
                leaf = (got_jax["a"] if path == "a"
                        else got_jax["b"][path])
                want = next(np.asarray(s.data) for s in
                            leaf.addressable_shards if s.device == dev)
                assert x.device == torch.device("cpu")
                np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_shard_stacked_refuses_an_indivisible_batch(n_dev):
    """A batch axis of 6 rows over 4 shards, or of 3 over 2: JAX's
    device_put and the port both raise ValueError, the port naming the
    rows and the shards."""
    rows = 6 if n_dev == 4 else 3
    tree = {"x": np.zeros((2, rows), np.float32)}
    with pytest.raises(ValueError):
        jax_mesh.shard_stacked(jax_mesh.make_mesh(n_dev),
                               {"x": jnp.asarray(tree["x"])})
    mesh = pmesh.Mesh(None, 0, n_dev, torch.device("cpu"))
    with pytest.raises(ValueError, match=f"holds {rows} rows, which "
                                         f"{n_dev} data shards"):
        pmesh.shard_stacked(mesh, tree)


# ------------------------------------------------------------ graphs.py

def test_step_graphs_follow_the_backend(monkeypatch):
    """The choice is the backend's, made when StepGraphs is built: gloo
    runs the steps eagerly (graphed False), NCCL captures them (graphed,
    unless graphed=False asks for eager), no mesh keeps graphed."""
    mesh = pmesh.Mesh("group", 0, 2, torch.device("cpu"))
    backends = []

    def backend(group=None):
        backends.append(group)
        return which

    monkeypatch.setattr(tgraphs.dist, "get_backend", backend)
    which = "gloo"
    g = tgraphs.StepGraphs(mesh=mesh)
    assert (g.graphed, g.backend) == (False, "gloo")
    which = "nccl"
    assert tgraphs.StepGraphs(mesh=mesh).graphed
    assert not tgraphs.StepGraphs(graphed=False, mesh=mesh).graphed
    assert backends == ["group"] * 3
    g = tgraphs.StepGraphs()
    assert g.graphed and g.backend is None


def test_captured_collective_needs_a_formed_group(tmp_path, monkeypatch):
    """A collective inside a CUDA graph capture on a group that has run no
    collective eagerly raises, naming the cause; once one ran eagerly the
    group passes. Here in a one-rank gloo group on the CPU, with the
    capture's state stubbed (a CPU build cannot capture)."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert distributed.init_distributed(
        device="cpu", init_method="file://" + str(tmp_path / "store"))
    try:
        fresh = torch.distributed.new_group([0])
        x = [torch.ones(3)]
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "is_current_stream_capturing",
                       lambda: True)
            with pytest.raises(RuntimeError, match="run no collective "
                                                   "eagerly"):
                pmesh.all_reduce(fresh, x, "metrics")
        pmesh.all_reduce(fresh, x, "metrics")
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "is_current_stream_capturing",
                       lambda: True)
            got = pmesh.all_reduce(fresh, x, "metrics")
        assert torch.equal(got[0], x[0])
    finally:
        distributed.destroy_distributed()


# ----------------------------------------------------- epochs, segments

def test_ranks_run_gloo_steps_eagerly(runs):
    """Under gloo the epoch functions record the backend and run eagerly
    (graphed False); the CUTOUT epoch's two steps replayed JAX's masks."""
    assert _rank0(runs, "graphed") is False
    assert _rank0(runs, "backend") == "gloo"
    assert _rank0(runs, "train")["replayed"] == ["CUTOUT"] * S


def test_train_epoch_two_ranks_matches_jax(runs):
    """make_train_epoch_cdr with CUTOUT (a warmup epoch of two steps, 2 +
    2 pairs, the last padded), each rank on its shard_stacked block and
    JAX's keep-masks, against JAX's epoch on the 2-device mesh: the ranks
    bit-equal; losses within 1e-4 relative, grad_norm within 1e-2, the
    parameters within 2.5 LR and the BN statistics within BN_TOL of each
    buffer's range (module docstring); every parameter moved."""
    got, ref = _rank0(runs, "train"), runs["jax"]["train"]
    for key in ("loss", "loss_2d", "loss_3d"):
        assert got["sums"][key] == pytest.approx(
            float(ref["sums"][key]), rel=1e-4), key
    assert got["sums"]["grad_norm"] == pytest.approx(
        float(ref["sums"]["grad_norm"]), rel=1e-2)
    assert got["step"] == S
    _state_close(got["state"], ref["state"], "train")
    init = runs["inp"]["cdr_init"]
    for name, t in got["state"].items():
        if t.is_floating_point() and "running" not in name:
            assert not torch.equal(t, init[name]), name


def test_train_epoch_collectives_by_kind(runs):
    """A step of the epoch under the mesh: one row-count all_reduce, a
    forward and a backward one a BN site, one of the gradient, one of the
    metrics (tests/test_torch_distributed.py's step), S steps."""
    n_bn = sum(1 for k in runs["inp"]["cdr_init"]
               if k.endswith("running_mean"))
    assert _rank0(runs, "train")["counts"] == {
        "rows": S, "bn forward": S * n_bn, "bn backward": S * n_bn,
        "gradients": S, "metrics": S}


def test_eval_epoch_two_ranks_matches_jax(runs):
    """make_eval_epoch_cdr over two steps of 2 + 2 pairs (the last
    padded): the global sums within 1e-4 relative of JAX's, n exact."""
    got, ref = _rank0(runs, "eval"), runs["jax"]["eval"]
    assert got["n"] == float(ref["n"]) == S * B - 1
    for key in ("loss_sum", "e2_sum", "e3_sum"):
        assert got[key] == pytest.approx(float(ref[key]), rel=1e-4), key


def test_segment_cdr_two_ranks_matches_jax(runs):
    """make_segment_cdr at world 2 from epoch 1 (both valid epochs with the
    3D loss, the second improves), E_FULL 3 with one padding epoch,
    against JAX's on the 2-device mesh: tests/test_torch_segments.py's
    bounds (train sums 1e-4, the 3D terms TOL_3D, grad_norm GRAD_3D_TOL;
    eval sums 1e-4 and TOL_3D, n exact), the padding epoch's zeros,
    `improved` and the best error as JAX's, the final and best states
    within the module's bounds."""
    got, ref = _rank0(runs, "segment_cdr"), runs["jax"]["segment_cdr"]
    gm, rm = got["ms"], ref["ms"]
    for e in range(E_FULL):
        for k, t in gm["train"].items():
            r = float(rm["train"][k][e])
            if e >= E_VALID:
                assert float(t[e]) == r == 0.0, (e, k)
                continue
            tol = (GRAD_3D_TOL if k == "grad_norm"
                   else TOL_3D if k != "loss_2d" else 1e-4)
            assert float(t[e]) == pytest.approx(r, rel=tol), (e, k)
        for k, t in gm["eval"].items():
            tol = 1e-4 if k in ("n", "e2_sum") else TOL_3D
            assert float(t[e]) == pytest.approx(float(rm["eval"][k][e]),
                                                rel=tol), (e, k)
    assert [bool(x) for x in gm["improved"]] == \
        [bool(x) for x in rm["improved"]] == [False, True, False]
    assert got["err"] == pytest.approx(ref["err"], rel=TOL_3D)
    assert got["step"] == E_VALID
    _state_close(got["state"], ref["state"], "final")
    _state_close(got["best"], ref["best"], "best")


def test_segment_ranks_choose_the_same_best(runs):
    """The best is chosen from the global eval sums: both ranks report the
    same `improved` and best metric and hold the same best state, bit for
    bit (_rank0); in the CDR segment the improving epoch is the last valid
    one, so the best state is the final weights."""
    for key in ("segment_cdr", "segment_2d"):
        got = _rank0(runs, key)
        assert any(bool(x) for x in got["ms"]["improved"]), key
    got = _rank0(runs, "segment_cdr")
    for k, t in got["state"].items():
        assert torch.equal(got["best"][k], t), k


def test_segment_2d_two_ranks_matches_jax(runs):
    """make_segment_2d at world 2, E_FULL 3 with one padding epoch,
    against JAX's on the 2-device mesh: tests/test_torch_segments.py's
    bounds (losses 1e-4, grad_norm 1e-2, acc, hits, cnt, n and val PCK
    exactly), `improved` (the first epoch improves on -1), the best PCK,
    the padding row's zeros, the states within the module's bounds."""
    got, ref = _rank0(runs, "segment_2d"), runs["jax"]["segment_2d"]
    gm, rm = got["ms"], ref["ms"]
    for e in range(E_FULL):
        for k, t in gm["train"].items():
            r = float(rm["train"][k][e])
            if k == "acc":
                assert float(t[e]) == r, (e, k)
            else:
                tol = 1e-2 if k == "grad_norm" else 1e-4
                assert float(t[e]) == pytest.approx(r, rel=tol), (e, k)
        assert float(gm["eval"]["loss_sum"][e]) == pytest.approx(
            float(rm["eval"]["loss_sum"][e]), rel=1e-4)
        for k in ("hits", "cnt", "n"):
            np.testing.assert_array_equal(gm["eval"][k][e].numpy(),
                                          rm["eval"][k][e])
        assert float(gm["val_acc"][e]) == float(rm["val_acc"][e])
    assert [bool(x) for x in gm["improved"]] == \
        [bool(x) for x in rm["improved"]]
    assert bool(gm["improved"][0]) and not bool(gm["improved"][E_VALID])
    assert got["acc"] == ref["acc"]
    _state_close(got["state"], ref["state"], "final")
    _state_close(got["best"], ref["best"], "best")


def test_mesh_steps_make_no_tensor_from_host_data(runs):
    """The steps of the stacked path under a mesh (the CDR train step with
    CUTOUT and the 3D loss, the CDR eval step and the best state's copy
    through a segment, the 2D train and eval steps), audited on both
    ranks: no tensor made from host data and no device value read on the
    host, neither of which a CUDA graph of the step can hold."""
    for r, out in enumerate(runs["epochs"]):
        assert out["host_data"] == [], (r, out["host_data"][:2])


# -------------------------------------------------------------- _plan

class _Loader:
    """What loop2d._plan reads of a loader."""

    def __init__(self, records, steps, whole, image_set="train"):
        self.records, self.batch_size = [None] * records, 2
        self._steps, self._whole, self.image_set = steps, whole, image_set

    def __len__(self):
        return self._steps

    def ensure_device_cache(self):
        return type("Cache", (), {"partial": False})() if self._whole \
            else None


@pytest.mark.parametrize("case", ["whole", "one_misses", "steps_differ"])
def test_plan_agrees_over_the_world(monkeypatch, case):
    """loop2d._plan gives every rank one answer from one collective of
    every rank's row (world_rows, here stubbed with rank 1's row beside
    this rank's): the caches count as whole only where every rank's is,
    the valid rows are summed over the data shards (min(records, steps *
    batch) a rank), and ranks whose stacked epochs would hold other step
    counts raise ValueError naming both."""
    from fast3dhpe_tpu_torch.train import loop2d
    mine = [_Loader(3, 2, True), _Loader(4, 2, True, "valid")]
    other = {"whole": [1, 1, 2, 2, 2, 4], "one_misses": [1, 0, 2, 2, 2, 4],
             "steps_differ": [1, 1, 3, 2, 2, 4]}[case]
    seen = []

    def rows(mesh, values, kind):
        seen.append((list(values), kind))
        return np.array([list(values), other], np.int64)

    monkeypatch.setattr(loop2d, "world_rows", rows)
    mesh = pmesh.Mesh(None, 0, 2, torch.device("cpu"))
    if case == "steps_differ":
        with pytest.raises(ValueError, match="train: the ranks' stacked "
                                             "epochs hold 2 and 3 steps"):
            loop2d._plan(mesh, mine, True, None)
        return
    whole, got = loop2d._plan(mesh, mine, True, None)
    assert seen == [([1, 1, 2, 2, 3, 4], "plan")]
    assert whole == ([True, True] if case == "whole" else [True, False])
    assert got == [5, 8]
    assert loop2d._plan(None, mine, True, 1) == ([True, True], [2, 2])


# ------------------------------------------------------- CLI, retries

def test_cli_path_flags_choose_the_path_under_torchrun(capsys):
    """--no_segments and --per_batch say that they choose the path under
    torchrun too."""
    from fast3dhpe_tpu_torch.apps import _train_cli
    with pytest.raises(SystemExit):
        _train_cli.parse_and_run(lambda *a, **k: None, "x.yaml", "test",
                                 ["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for flag in ("--no_segments", "--per_batch"):
        assert "torchrun" in text.rsplit(flag, 1)[1].split("--", 1)[0], flag


def test_retries_and_the_degrade_ladder_stay_off_under_a_mesh(monkeypatch):
    """Under several processes run_with_retries makes one attempt, with
    the path the caller asked for (segments=None, scan_epochs=None): no
    retry and no rung of the degrade ladder, which would split the ranks'
    paths."""
    from fast3dhpe_tpu_torch.train import resilience
    monkeypatch.setattr(resilience, "process_count", lambda: 2)
    calls = []

    def failing(config, **kw):
        calls.append((kw.get("segments"), kw.get("scan_epochs")))
        raise OSError(5, "Input/output error")

    with pytest.raises(OSError):
        resilience.run_with_retries(
            failing, None, retries=3, _sleep=lambda s: None,
            _probe=lambda: None,
            logger=logging.getLogger("test_torch_stacked_mesh"))
    assert calls == [(None, None)]


# ------------------------------------------------------------- the loops

def _loop(runs, kind, path):
    """Rank 0's run of a loop after holding rank 1's history equal to it
    (but the throughput)."""
    a, b = (r[(kind, path)] for r in runs["loops"])
    for k in a["hist"]:
        if not k.endswith("_per_sec"):
            assert a["hist"][k] == b["hist"][k], (kind, path, k)
    return a


@pytest.mark.parametrize("kind", ["cdr", "2d"])
def test_loop_paths_bit_equal_under_a_mesh(runs, kind):
    """loop_cdr.run (CUTOUT) and loop2d.run at world 2, each rank's shard
    cached: by segments (the default), by stacked epochs (segments=False)
    and batch by batch (scan_epochs=False) the histories are bit-equal
    (but the throughput), and equal on both ranks; the loss moves."""
    ref = _loop(runs, kind, "batches")["hist"]
    assert ref["train_loss"][0] > 0
    assert ref["train_loss"][-1] != ref["train_loss"][0]
    for path in ("segments", "epochs"):
        got = _loop(runs, kind, path)["hist"]
        for k in ref:
            if not k.endswith("_per_sec"):
                assert got[k] == ref[k], (kind, path, k)


@pytest.mark.parametrize("kind", ["cdr", "2d"])
def test_loops_log_their_path_and_cache_their_shard(runs, kind):
    """Each run logs its path once: segments under the 2 x 1 mesh, gloo's
    steps eagerly; stacked epochs; batch by batch. Each rank's loaders
    cache their own shard whole (half of each split's records, two frames
    a record stereo, one mono); the segment run agrees its path in one
    "plan" collective, and the per-batch run makes none."""
    logs = {path: _loop(runs, kind, path)["log"] for path in PATHS}
    assert logs["segments"] == [
        "Training path: segments under a 2 x 1 mesh (gloo: the steps run "
        "eagerly); eval stacked"]
    assert logs["epochs"][0].startswith("Training path: stacked epochs")
    assert logs["batches"][0].startswith("Training path: batch by batch")
    frames = 2 if kind == "cdr" else 1
    for r, rank in enumerate(runs["loops"]):
        run = rank[(kind, "segments")]
        assert run["records"] == [LOOP_FRAMES, LOOP_FRAMES], r
        assert run["cached"] == [True, True], r
        assert run["cache_rows"] == [frames * LOOP_FRAMES] * 2, r
        assert run["counts"]["plan"] == 1
        assert "plan" not in rank[(kind, "batches")]["counts"]


def test_loops_write_one_checkpoint_set_from_rank_zero(runs):
    """Every run writes its checkpoints under rank 0's weights root only
    (latest and its optimizer state; best.pth where an epoch after the
    CDR warmup, or any 2D epoch, improved); rank 1 writes nothing."""
    for kind, name in (("cdr", "cdr"), ("2d", "pose"), ("miss", "miss")):
        for path in PATHS if kind != "miss" else ("segments", "batches"):
            w0, w1 = (r[(kind, path)]["written"] for r in runs["loops"])
            assert {f"{name}/latest.pth", f"{name}/latest.opt.pt"} <= \
                set(w0) <= {f"{name}/{f}" for f in (
                    "latest.pth", "latest.opt.pt", "best.pth")}, \
                (kind, path, w0)
            assert w1 == [], (kind, path, w1)


def test_budget_one_shard_misses_takes_batches_everywhere(runs):
    """5 records a split: rank 0 holds 3 pairs, rank 1 2, and the budget
    holds rank 1's 4 frames only. Rank 1's cache is whole, rank 0's is
    none (no partial cache under a mesh), so the agreed path is batch by
    batch on both ranks, with no hang, and the history is the per-batch
    run's, bit for bit."""
    got = _loop(runs, "miss", "segments")
    ref = _loop(runs, "miss", "batches")
    assert got["log"][0].startswith("Training path: batch by batch")
    assert [r[("miss", "segments")]["records"] for r in runs["loops"]] == \
        [[3, 3], [2, 2]]
    assert [r[("miss", "segments")]["cached"] for r in runs["loops"]] == \
        [[False, False], [True, True]]
    for k in ref["hist"]:
        if not k.endswith("_per_sec"):
            assert got["hist"][k] == ref["hist"][k], k


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    sys.exit(0)
