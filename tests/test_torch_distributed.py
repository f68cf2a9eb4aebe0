"""Data parallelism in the PyTorch port (fast3dhpe_tpu_torch/parallel: the
synced masked BN, the global loss and gradient, the host-sharded loaders,
rank-0 checkpoints and the training CLI under a process group) against
the JAX package's global-batch computation, on the CPU.

Two gloo ranks are two subprocesses that run this file as a script
(`python tests/test_torch_distributed.py <case> <rank> <world> <dir>`).
They meet through a file:// store in the test's temporary directory, so
xdist workers never race for a port, and each takes one thread. The JAX
side runs in the test process, single-process, on the concatenated global
batch: what JAX computes under a mesh, up to float reassociation. The
ranks start first, and the JAX side runs while they do. The CLI case (two
more ranks against JAX's loop) is marked slow: its JAX loop compiles three
steps, and the file would otherwise take ~90 s.

Tolerances (each test names its own):
- masked BN, fp32: 1e-5 (fp32 sums in another order, as
  tests/test_torch_train_step.py holds the single-process BN); bf16: y and
  dx within one bf16 rounding of their largest value, the statistics
  within 1e-5 and the parameters' gradients within 1e-4 of their largest
  value (tests/test_torch_bf16_train.py's bounds);
- the CDR and 2D steps against JAX: tests/test_torch_train_step.py's and
  tests/test_torch_train_2d.py's bounds, the parameters after one Adam
  update within 2.5 lr (test_adam_steps_match_jax);
- the steps against the port's own 1-process step: the same bounds, since
  the ranks' partial sums round apart from one sum and ReLU units within
  that rounding of zero switch;
- the CLI against JAX's single-process loop: tests/
  test_distributed_real.py's tolerances.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# The ranks run this file as a script and need no JAX.
if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import optax
    import yaml
    from flax import linen as fnn
    from fast3dhpe_tpu.config import config_from_dict as jax_config
    from fast3dhpe_tpu.data import loader as jax_loader
    from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
    from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
    from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
    from fast3dhpe_tpu.models import make_loss as jax_make_loss
    from fast3dhpe_tpu.models.layers import bn_row_mask as jax_bn_mask
    from fast3dhpe_tpu.parallel import distributed as jax_dist
    from fast3dhpe_tpu.train import loop_cdr as jax_loop_cdr
    from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
    from fast3dhpe_tpu.train.state import multistep_lr as jax_lr
    from fast3dhpe_tpu.train.steps import make_train_step_2d as jax_step_2d
    from fast3dhpe_tpu.train.steps import make_train_step_cdr as jax_step_cdr
    from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
    from fast3dhpe_tpu_torch.data import loader
    from fast3dhpe_tpu_torch.parallel import distributed, mesh as pmesh
    from fast3dhpe_tpu_torch.train import checkpoint, resilience
    from test_torch_train_step import _recording, _rig

    torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
IMG, J, J2D, HM = 64, 19, 4, 16
# global batches of 2 + 2 rows: the CDR step's last row is padded, the 2D
# step's second rank holds only filler rows
CDR_ROW_VALID = np.array([1, 1, 1, 0], np.float32)
POSE_ROW_VALID = np.array([1, 1, 0, 0], np.float32)
BN_CASES = {"no_mask": None, "uneven": [1, 1, 1, 0],
            "filler_rank": [1, 1, 0, 0], "all_filler": [0, 0, 0, 0]}
CFG = {"MODEL": {"NUM_LAYERS": 18, "IMAGE_SIZE": [IMG, IMG]},
       "TRAIN": {"LR": 1e-3, "LR_STEP": [1], "LR_FACTOR": 0.1},
       "LOSS": {"TYPE": "JointsMSESmooth", "USE_TARGET_WEIGHT": True}}
BF16_ULP = 2.0 ** -7
CHILD_TIMEOUT = 600


# --------------------------------------------------------------- ranks

def _local(batch, rank):
    per = len(next(iter(batch.values()))) // WORLD
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def _rank_bn(inp, rank, mesh):
    """Each case and dtype: a replicated BatchNorm2d on this rank's two
    rows, the BN mask from the global valid count; y, dx, the local shares
    of dweight and dbias, and the running statistics."""
    from fast3dhpe_tpu_torch.models.layers import BatchNorm2d, bn_row_mask
    from fast3dhpe_tpu_torch.parallel.mesh import replicate, row_counts
    out = {}
    lo, hi = 2 * rank, 2 * rank + 2
    for name, rv in BN_CASES.items():
        for dt in ("float32", "bfloat16"):
            bn = BatchNorm2d(6).train()
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(inp["bn_scale"]))
                bn.bias.copy_(torch.from_numpy(inp["bn_bias"]))
            replicate(mesh, bn)
            x = torch.from_numpy(inp["bn_x"][dt][lo:hi]).to(
                getattr(torch, dt)).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
            local_rv = (None if rv is None
                        else torch.tensor(rv[lo:hi], dtype=torch.float32))
            counts = row_counts(mesh, local_rv, 2, "cpu")
            y = bn(x, bn_row_mask(local_rv, counts[0]))
            (y.float() * torch.from_numpy(inp["bn_cot"][dt][lo:hi])).sum() \
                .backward()
            out[f"{name}/{dt}"] = {
                "y": y.detach().float(), "dx": x.grad.float(),
                "dweight": bn.weight.grad.clone(),
                "dbias": bn.bias.grad.clone(),
                "mean": bn.running_mean.clone(),
                "var": bn.running_var.clone()}
    return out


def _step_record(model, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: t.clone() for k, t in model.state_dict().items()}}


def _port_cdr_step(sd, batch, mesh):
    """One use_3d CDR step with the config's Adam, from sd."""
    from fast3dhpe_tpu_torch.config import config_from_dict
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.parallel.mesh import replicate
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_train_step_cdr
    cfg = config_from_dict(CFG)
    model = CDRNet(num_layers=18)
    model.load_state_dict(sd, strict=True)
    if mesh is not None:
        replicate(mesh, model)
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    step = make_train_step_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT), mesh=mesh)
    return _step_record(model, step(state, batch, True))


def _port_pose_step(sd, batch, mesh):
    """One 2D step with the config's Adam, from sd."""
    from fast3dhpe_tpu_torch.config import config_from_dict
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.parallel.mesh import replicate
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_train_step_2d
    model = PoseResNet(num_joints=J2D, num_layers=18)
    model.load_state_dict(sd, strict=True)
    if mesh is not None:
        replicate(mesh, model)
    state = TrainState.create(model, config_from_dict(CFG), 1)
    step = make_train_step_2d(make_loss("JointsMSE", True, layout="NHWC"),
                              mesh=mesh)
    return _step_record(model, step(state, batch))


def _rank_steps(rank, work):
    from fast3dhpe_tpu_torch.parallel import make_mesh
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    inp = torch.load(os.path.join(work, "steps_in.pt"), weights_only=False)
    mesh = make_mesh()
    out = {"bn": _rank_bn(inp, rank, mesh)}
    COUNTS.clear()
    out["cdr"] = _port_cdr_step(inp["cdr_sd"],
                                _local(inp["cdr_batch"], rank), mesh)
    out["cdr_counts"] = dict(COUNTS)
    out["pose"] = _port_pose_step(inp["pose_sd"],
                                  _local(inp["pose_batch"], rank), mesh)
    torch.save(out, os.path.join(work, f"steps_out_{rank}.pt"))


def _rank_cli(rank, work):
    """`train_cdr` under WORLD_SIZE=2 from JAX's init of the loop, each
    rank with its own weights root; the history to a JSON file."""
    from fast3dhpe_tpu_torch.apps import train_cdr
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.train import loop_cdr
    sd = torch.load(os.path.join(work, "cli_init.pt"), weights_only=True)

    def init_model(config, seed):
        model = CDRNet.from_config(config)
        model.load_state_dict(sd, strict=True)
        return model

    loop_cdr._init_model = init_model
    hist = train_cdr.main([
        "--config_path", os.path.join(work, "cli.yaml"), "--overwrite",
        "--device", "cpu", "--weights_root",
        os.path.join(work, f"w_rank{rank}")])
    with open(os.path.join(work, f"cli_out_{rank}.json"), "w") as f:
        json.dump(hist, f)


def _rank_shared(rank, work):
    """loop_cdr.run into ONE weights root shared by the ranks, without
    overwrite: torchrun's ranks on one file system under the CLI's
    defaults. Rank 1 leaves load_data only once rank 0 has made the model
    dir, the order in which a rank other than 0 that checked or made the
    dir after its load_data would fail."""
    from fast3dhpe_tpu_torch.config import config_from_dict
    from fast3dhpe_tpu_torch.parallel import make_mesh
    from fast3dhpe_tpu_torch.train import loop_cdr
    weights = os.path.join(work, "w")
    load = loop_cdr.load_data

    def load_after_rank_zero(*args, **kw):
        out = load(*args, **kw)
        deadline = time.monotonic() + 60
        while (rank and not os.path.isdir(os.path.join(weights, "shared"))
               and time.monotonic() < deadline):
            time.sleep(0.05)
        return out

    loop_cdr.load_data = load_after_rank_zero
    hist = loop_cdr.run(config_from_dict(_tiny_dict(
        os.path.join(work, "mads"), "MADS_3d", "shared")), mesh=make_mesh(),
        seed=0, scan_epochs=False, weights_root=weights, device="cpu")
    with open(os.path.join(work, f"shared_out_{rank}.json"), "w") as f:
        json.dump(hist, f)


def _rank_main(case, rank, world, work):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed)
    assert init_distributed(backend="gloo", device="cpu",
                            init_method="file://" + os.path.join(
                                work, f"{case}.store"))
    try:
        {"steps": _rank_steps, "cli": _rank_cli,
         "shared": _rank_shared}[case](rank, work)
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
         str(WORLD), str(work)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


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


def _bn_inputs():
    r = np.random.RandomState(1)
    x = (r.randn(4, 6, 5, 7) * 2 + 0.5).astype(np.float32)      # NCHW
    scale = r.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = r.randn(6).astype(np.float32)
    cot = r.randn(*x.shape).astype(np.float32)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    return {"bn_x": {"float32": x, "bfloat16": bf16(x)},
            "bn_cot": {"float32": cot, "bfloat16": bf16(cot)},
            "bn_scale": scale, "bn_bias": bias}


def _cdr_batch():
    """4 pairs near the origin of tests/test_torch_train_step.py's rig,
    their exact projections as target_2d, the last row padded."""
    r = np.random.RandomState(0)
    b = len(CDR_ROW_VALID)
    proj = _rig(b, IMG)
    p3 = r.uniform(-300, 300, (b, J, 3)).astype(np.float32)
    hom = np.concatenate([p3, np.ones((b, J, 1), np.float32)], -1)
    uvw = np.einsum("bvij,bkj->bvki", proj, hom)
    return {"image": r.randn(b, 2, IMG, IMG, 3).astype(np.float32),
            "proj": proj, "target_3d": p3,
            "target_2d": (uvw[..., :2] / uvw[..., 2:]).astype(np.float32),
            "target_weight": np.ones((b, J), np.float32),
            "row_valid": CDR_ROW_VALID}


def _pose_batch():
    from fast3dhpe_tpu.ops import render_gaussian_heatmaps
    r = np.random.RandomState(0)
    b = len(POSE_ROW_VALID)
    joints = r.uniform(5, IMG - 5, size=(b, J2D, 2)).astype(np.float32)
    target, weight = render_gaussian_heatmaps(
        joints, np.ones((b, J2D), np.float32), (HM, HM), (IMG, IMG),
        sigma=1)
    return {"image": r.randn(b, IMG, IMG, 3).astype(np.float32),
            "target": np.array(target), "target_weight": np.array(weight),
            "row_valid": POSE_ROW_VALID}


def _cdr_init():
    """JAX's CDRNet-18 init with the head scaled for unit-spread logits,
    as tests/test_torch_train_step.py scales it."""
    batch = _cdr_batch()
    v = _np(jax.jit(JaxCDRNet(num_layers=18).init,
                    static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"]),
        jnp.asarray(batch["proj"]), train=False))
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    head["bias"] = head["bias"] + np.random.RandomState(3).randn(J).astype(
        np.float32)
    return v


def _jax_step(model, step, v, batch, *use_3d):
    """One JAX step on the global batch with the config's Adam, the clipped
    gradient recorded: metrics, gradients, variables after."""
    tx = _recording(optax.adam(jax_lr(CFG["TRAIN"]["LR"],
                                      CFG["TRAIN"]["LR_STEP"],
                                      CFG["TRAIN"]["LR_FACTOR"], 1)))
    state = JaxTrainState.create(v, tx)
    state, m = step(state, {k: jnp.asarray(a) for k, a in batch.items()},
                    *use_3d)
    return {"metrics": {k: float(x) for k, x in m.items()},
            "grads": jax_variables_to_state_dict(
                {"params": _np(state.opt_state[0])}),
            "state": jax_variables_to_state_dict(_np(state.variables))}


def _cli_dict(root, batch, name):
    """tests/test_distributed_real.py's config, at this batch size."""
    return {
        "DATASET": {"TYPE": "MADS_3d", "ROOT": str(root),
                    "TRAIN_SET": "train", "TEST_SET": "valid",
                    "FLIP": False, "ROT_FACTOR": 0, "SCALE_FACTOR": 0,
                    "OCCLUSION": "None"},
        "MODEL": {"NUM_JOINTS": 19, "NUM_LAYERS": 18, "NAME": name,
                  "PRETRAINED": "", "IMAGE_SIZE": [64, 64],
                  "EXTRA": {"TARGET_TYPE": "gaussian", "SIGMA": 1,
                            "HEATMAP_SIZE": [16, 16]}},
        "TRAIN": {"BATCH_SIZE": batch, "EPOCH": 2, "LR": 1e-3,
                  "LR_STEP": [40], "LR_FACTOR": 0.1, "WARMUP": 1,
                  "LOSS_3D_WEIGHT": 4},
        "TEST": {"BATCH_SIZE": batch},
        "LOSS": {"USE_TARGET_WEIGHT": True, "TYPE": "JointsMSE"}}


def _jax_loop_init(cfg):
    """The variables JAX's loop_cdr.run initialises (loop_cdr.py:117-124),
    jitted here, which rounds some 1 ulp apart from the loop's eager init:
    the fixture hands them to the JAX loop too."""
    H, W = cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]
    proj = jnp.broadcast_to(jnp.asarray(
        [[600.0, 0, 128, 0], [0, 600.0, 128, 0], [0, 0, 1, 3000.0]],
        jnp.float32), (1, 2, 3, 4))
    model = JaxCDRNet.from_config(cfg)
    return _np(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3), jnp.float32),
        proj, train=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the step ranks, run the JAX side and the port's 1-process
    steps meanwhile, then collect the ranks' outputs."""
    work = tmp_path_factory.mktemp("dp")
    cdr_v = _cdr_init()
    pose_model = JaxPoseResNet(num_joints=J2D, num_layers=18)
    pose_v = _np(jax.jit(pose_model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    inp = dict(_bn_inputs(), cdr_sd=jax_variables_to_state_dict(cdr_v),
               cdr_batch=_cdr_batch(),
               pose_sd=jax_variables_to_state_dict(pose_v),
               pose_batch=_pose_batch())
    torch.save(inp, work / "steps_in.pt")
    procs = _spawn("steps", work)
    try:
        ref = {}
        for name, rv in BN_CASES.items():
            for dt in ("float32", "bfloat16"):
                ref[f"bn/{name}/{dt}"] = _flax_bn(inp, rv, dt)
        cdr_model = JaxCDRNet(num_layers=18)
        ref["cdr"] = _jax_step(cdr_model, jax_step_cdr(
            cdr_model, jax_make_loss("JointsMSESmooth", True)), cdr_v,
            inp["cdr_batch"], True)
        ref["pose"] = _jax_step(pose_model, jax_step_2d(
            pose_model, jax_make_loss("JointsMSE", True, layout="NHWC")),
            pose_v, inp["pose_batch"])
        one = {"cdr": _port_cdr_step(inp["cdr_sd"], inp["cdr_batch"], None),
               "pose": _port_pose_step(inp["pose_sd"], inp["pose_batch"],
                                       None)}
    finally:
        _wait(procs, "steps")
    ranks = [torch.load(work / f"steps_out_{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ref": ref, "ranks": ranks, "one": one}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Spawn the CLI ranks, run JAX's loop meanwhile from the same init,
    then collect the ranks' histories."""
    work = tmp_path_factory.mktemp("dp_cli")
    root = work / "mads"
    # 256x192 frames, 6 records a split: tests/test_distributed_real.py's
    # tree (smaller frames project the joints out of bounds)
    make_synthetic_mads(str(root), n_frames=6, img_w=256, img_h=192)
    with open(work / "cli.yaml", "w") as f:
        yaml.safe_dump(_cli_dict(root, 4, "dist"), f)
    jcfg = jax_config(_cli_dict(root, 8, "single"))
    cli_v = _jax_loop_init(jcfg)
    torch.save(jax_variables_to_state_dict(cli_v), work / "cli_init.pt")
    procs = _spawn("cli", work)
    try:
        def merge(variables, _pretrained):
            # the ranks' init: the loop's own, computed jitted (1 ulp apart)
            assert (jax.tree_util.tree_structure(_np(variables))
                    == jax.tree_util.tree_structure(cli_v))
            return cli_v

        jcfg.MODEL.PRETRAINED = "jax-init"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_loop_cdr, "load_variables", lambda path: None)
            mp.setattr(jax_loop_cdr, "merge_encoder_only", merge)
            ref = jax_loop_cdr.run(jcfg, overwrite=True, seed=0,
                                   weights_root=str(work / "w_single"))
    finally:
        _wait(procs, "cli")
    return {"work": work, "ref": ref,
            "hists": [json.load(open(work / f"cli_out_{r}.json"))
                      for r in range(WORLD)]}


def _flax_bn(inp, rv, dt):
    """flax's BatchNorm(mask=) on the global batch, as the JAX package
    builds it (fp32, or dtype bf16 with fp32 parameters): y, running
    statistics, and the gradients of x, scale and bias."""
    dtype = getattr(jnp, dt)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=dtype, param_dtype=jnp.float32)
    mask = jax_bn_mask(None if rv is None else jnp.asarray(rv, jnp.float32))
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}
    params = {"scale": jnp.asarray(inp["bn_scale"]),
              "bias": jnp.asarray(inp["bn_bias"])}
    x = jnp.asarray(inp["bn_x"][dt].transpose(0, 2, 3, 1), dtype)
    cot = jnp.asarray(inp["bn_cot"][dt].transpose(0, 2, 3, 1), dtype)

    def f(xx, pp):
        y, upd = bn.apply({"params": pp, "batch_stats": stats}, xx,
                          mask=mask, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, new = f(x, params)
    gx, gp = jax.grad(lambda xx, pp: jnp.sum(
        (f(xx, pp)[0] * cot).astype(jnp.float32)), argnums=(0, 1))(x, params)

    def nchw(a):
        return np.asarray(a, np.float32).transpose(0, 3, 1, 2)

    return {"y": nchw(y), "dx": nchw(gx), "mean": np.asarray(new["mean"]),
            "var": np.asarray(new["var"]), "dweight": np.asarray(gp["scale"]),
            "dbias": np.asarray(gp["bias"])}


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("n", [0, 1, 5, 6])
@pytest.mark.parametrize("pc", [1, 2, 3])
def test_record_shards_match_jax(monkeypatch, pc, n):
    """shard_records_for_host, _shard_for_host (local records, global
    count, filler) and _num_lockstep_batches at batch 2 and 4, against
    JAX's for every rank, with each package's process count patched as the
    JAX tests patch it: exactly equal."""
    records = [{"i": i} for i in range(n)]
    for pi in range(pc):
        monkeypatch.setattr(jax, "process_count", lambda: pc)
        monkeypatch.setattr(jax, "process_index", lambda: pi)
        monkeypatch.setattr(distributed, "process_count", lambda: pc)
        monkeypatch.setattr(distributed, "process_index", lambda: pi)
        assert (distributed.shard_records_for_host(records, pi, pc)
                == jax_dist.shard_records_for_host(records, pi, pc))
        assert loader._shard_for_host(records) == \
            jax_loader._shard_for_host(records)
        for b in (2, 4):
            assert loader._num_lockstep_batches(n, b) == \
                jax_loader._num_lockstep_batches(n, b)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BN_CASES))
def test_synced_bn_matches_flax_global_batch(runs, case, dt):
    """Two ranks of two rows against flax's BatchNorm(mask=) on the four:
    y and dx (the ranks' rows together), the ranks' dweight and dbias
    summed, and every rank's running statistics. fp32 within 1e-5; bf16:
    y and dx within one bf16 rounding of their largest value, statistics
    within 1e-5, parameter gradients within 1e-4 of their largest value.
    The ranks' statistics are equal bit for bit."""
    ref = runs["ref"][f"bn/{case}/{dt}"]
    got = [r["bn"][f"{case}/{dt}"] for r in runs["ranks"]]
    cat = {k: torch.cat([g[k] for g in got]).numpy() for k in ("y", "dx")}
    tot = {k: sum(g[k] for g in got).numpy() for k in ("dweight", "dbias")}
    for k in ("mean", "var"):
        assert torch.equal(got[0][k], got[1][k]), k

    def close(a, b, rel):
        if dt == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(a - b).max() <= rel * np.abs(b).max()

    close(cat["y"], ref["y"], BF16_ULP)
    close(cat["dx"], ref["dx"], BF16_ULP)
    close(got[0]["mean"].numpy(), ref["mean"], 1e-5)
    close(got[0]["var"].numpy(), ref["var"], 1e-5)
    close(tot["dweight"], ref["dweight"], 1e-4)
    close(tot["dbias"], ref["dbias"], 1e-4)


def _global_rel(got, ref):
    num = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref)
    den = sum(float((ref[n] ** 2).sum()) for n in ref)
    return (num / den) ** 0.5


def _hold_step(got, ref, loss_keys, lr):
    """test_torch_train_step.py's bounds: losses 1e-4 relative, grad_norm
    1e-2, the gradient 2e-2 of its norm globally and each leaf 5e-2 of the
    larger of its norm and 1e-6 of the global norm, the BN statistics 1e-4
    of each buffer's range, the parameters after the Adam update 2.5 lr."""
    gm, rm = got["metrics"], ref["metrics"]
    for key in loss_keys:
        assert gm[key] == pytest.approx(rm[key], rel=1e-4), key
    assert gm["grad_norm"] == pytest.approx(rm["grad_norm"], rel=1e-2)
    assert set(got["grads"]) == set(ref["grads"])
    assert _global_rel(got["grads"], ref["grads"]) <= 2e-2
    floor = 1e-6 * rm["grad_norm"]
    for name, g in got["grads"].items():
        r = ref["grads"][name]
        assert float((g - r).norm()) <= 5e-2 * max(float(r.norm()), floor), \
            name
    for name, t in got["state"].items():
        r = ref["state"][name]
        if "running" in name:
            assert float((t - r).abs().max()) <= 1e-4 * float(
                r.abs().max()), name
        elif t.is_floating_point():
            assert float((t - r).abs().max()) <= 2.5 * lr, name


def _ranks_agree(runs, key):
    """Every rank reports the same metrics and holds the same gradients,
    parameters and statistics after the step, bit for bit."""
    a, b = (r[key] for r in runs["ranks"])
    assert a["metrics"] == b["metrics"]
    for part in ("grads", "state"):
        for name in a[part]:
            assert torch.equal(a[part][name], b[part][name]), (part, name)
    return a


def test_cdr_step_two_ranks_matches_jax_global_batch(runs):
    """A use_3d CDR step (depth 18, 64 px), 2 + 2 pairs with the last
    padded, on two ranks, against JAX's make_train_step_cdr on the 4 pairs
    with the config's Adam: _hold_step's bounds. Besides replicate's, one
    collective of the row counts, two a BN (forward and backward), one of
    the gradients and one of the losses."""
    got = _ranks_agree(runs, "cdr")
    ref = runs["ref"]["cdr"]
    _hold_step(got, ref, ("loss", "loss_2d", "loss_3d"), CFG["TRAIN"]["LR"])
    gm = got["metrics"]
    assert gm["loss"] == pytest.approx(gm["loss_2d"] + 4 * gm["loss_3d"],
                                       rel=1e-6)
    n_bn = sum(1 for k in got["state"] if k.endswith("running_mean"))
    # replicate: one broadcast a dtype (fp32, and int64 batch counts)
    assert runs["ranks"][0]["cdr_counts"] == {
        "broadcast": 2, "rows": 1, "bn forward": n_bn, "bn backward": n_bn,
        "gradients": 1, "metrics": 1}


def test_cdr_step_two_ranks_matches_one_process(runs):
    """The same step against the port's own step on the 4 pairs in one
    process: _hold_step's bounds."""
    _hold_step(_ranks_agree(runs, "cdr"), runs["one"]["cdr"],
               ("loss", "loss_2d", "loss_3d"), CFG["TRAIN"]["LR"])


def test_2d_step_two_ranks_matches_jax_global_batch(runs):
    """A PoseResNet-18 step on 2 + 2 rows whose second rank holds only
    filler rows (its BN rows stay out, the global batch has valid rows):
    against JAX's make_train_step_2d on the 4 rows, _hold_step's bounds and
    PCK exactly."""
    got = _ranks_agree(runs, "pose")
    ref = runs["ref"]["pose"]
    _hold_step(got, ref, ("loss",), CFG["TRAIN"]["LR"])
    assert got["metrics"]["acc"] == ref["metrics"]["acc"]


def test_2d_step_two_ranks_matches_one_process(runs):
    """The same step against the port's own on the 4 rows in one process:
    _hold_step's bounds, PCK exactly."""
    got = _ranks_agree(runs, "pose")
    _hold_step(got, runs["one"]["pose"], ("loss",), CFG["TRAIN"]["LR"])
    assert got["metrics"]["acc"] == runs["one"]["pose"]["metrics"]["acc"]


@pytest.mark.slow
def test_train_cdr_cli_two_ranks_matches_jax_loop(cli_runs):
    """`train_cdr` under WORLD_SIZE=2 (4 pairs a rank) against JAX's
    single-process loop_cdr.run at 8, from the same init, with
    tests/test_distributed_real.py's config and tolerances: the ranks'
    histories equal but the throughput; warmup train_loss rtol 1e-4, after
    it 5e-2; val_mpjpe_2d 1e-2; warmup val_loss 1e-2; the 3D figures
    finite, positive and within one decade. One checkpoint set, under rank
    0's root; rank 1's root stays empty. Slow (~45 s alone: JAX's loop
    compiles three steps); test_world_size_one_mesh_equals_no_mesh drives
    both loops through a mesh in the fast set."""
    h0, h1 = cli_runs["hists"]
    ref = cli_runs["ref"]
    assert h0["train_loss"][0] > 1e-5 and h0["grad_norm"][0] > 1e-5, h0
    for k in h0:
        if not k.endswith("_per_sec"):
            assert h0[k] == h1[k], k
    np.testing.assert_allclose(h0["train_loss"][0], ref["train_loss"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(h0["train_loss"][1:], ref["train_loss"][1:],
                               rtol=5e-2)
    np.testing.assert_allclose(h0["val_mpjpe_2d"], ref["val_mpjpe_2d"],
                               rtol=1e-2)
    np.testing.assert_allclose(h0["val_loss"][0], ref["val_loss"][0],
                               rtol=1e-2)
    for k, a, b in (("val_mpjpe_3d", h0["val_mpjpe_3d"],
                     ref["val_mpjpe_3d"]),
                    ("val_loss[post]", h0["val_loss"][1:],
                     ref["val_loss"][1:])):
        a, b = np.asarray(a, float), np.asarray(b, float)
        assert np.isfinite(a).all() and (a > 0).all(), (k, a)
        assert np.abs(np.log10(a) - np.log10(b)).max() < 1.0, (k, a, b)
    work = cli_runs["work"]
    assert sorted(os.listdir(work / "w_rank0" / "dist")) == [
        "latest.opt.pt", "latest.pth"]
    w1 = work / "w_rank1"
    assert not w1.exists() or list(w1.rglob("*")) == []


def _tiny_dict(root, dataset, name):
    """tests/test_torch_loops.py's tiny loop config, the tree whole in the
    device frame cache."""
    return {
        "DATASET": {"TYPE": dataset, "ROOT": str(root), "OCCLUSION": "None",
                    "DEVICE_CACHE_BYTES": 1 << 30},
        "MODEL": {"NAME": name, "NUM_LAYERS": 18, "IMAGE_SIZE": [64, 64],
                  "PRETRAINED": "",
                  "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}},
        "TRAIN": {"BATCH_SIZE": 4, "EPOCH": 2, "WARMUP": 1, "LR": 1e-7,
                  "LR_STEP": [40], "LR_FACTOR": 0.1},
        "TEST": {"BATCH_SIZE": 4},
        "LOSS": {"TYPE": "JointsMSESmooth" if dataset == "MADS_3d"
                 else "JointsMSE", "USE_TARGET_WEIGHT": True}}


@pytest.mark.parametrize("dataset", ["MADS_3d", "MADS_2d"])
def test_world_size_one_mesh_equals_no_mesh(tmp_path, monkeypatch, dataset):
    """Each loop through a gloo group of one rank in this process (the
    loaders and the device frame cache built with the mesh, replicate,
    the mesh steps, the barriers) against the same loop without a mesh,
    both batch by batch: every reduction over one rank is an identity, so
    the histories are equal bit for bit but the throughput, and so are the
    weights in latest.pth."""
    from fast3dhpe_tpu_torch.config import config_from_dict
    from fast3dhpe_tpu_torch.data.device_cache import DeviceFrameCache
    from fast3dhpe_tpu_torch.train import loop2d, loop_cdr
    make_synthetic_mads(str(tmp_path / "mads"), n_frames=4, img_w=128,
                        img_h=96, movements=("HipHop", "Jazz"))
    run = loop_cdr.run if dataset == "MADS_3d" else loop2d.run
    built = []
    build = DeviceFrameCache.build.__func__

    def spy(cls, *args, **kw):
        built.append(kw.get("mesh"))
        return build(cls, *args, **kw)

    monkeypatch.setattr(DeviceFrameCache, "build", classmethod(spy))
    hists = {}
    for name in ("plain", "mesh"):
        mesh = None
        if name == "mesh":
            monkeypatch.setenv("WORLD_SIZE", "1")
            monkeypatch.setenv("RANK", "0")
            assert distributed.init_distributed(
                device="cpu", init_method="file://" + str(tmp_path / "st"))
        try:
            if name == "mesh":
                mesh = pmesh.make_mesh(n_devices=1)
            hists[name] = run(config_from_dict(
                _tiny_dict(tmp_path / "mads", dataset, name)), mesh=mesh,
                overwrite=True, seed=0, scan_epochs=False,
                weights_root=str(tmp_path / "w"), device="cpu")
        finally:
            distributed.destroy_distributed()
    assert built[-1] is not None and built[0] is None
    a, b = hists["plain"], hists["mesh"]
    for k in a:
        if not k.endswith("_per_sec"):
            assert a[k] == b[k], k
    sd = [torch.load(tmp_path / "w" / n / "latest.pth", weights_only=True)
          for n in ("plain", "mesh")]
    for k in sd[0]:
        assert torch.equal(sd[0][k], sd[1][k]), k


def test_ranks_share_one_weights_root_without_overwrite(tmp_path):
    """Two ranks run loop_cdr.run into one weights root without overwrite,
    rank 1 reaching the model dir after rank 0 has made it: both finish
    with the same history (exact, but the throughput), and one checkpoint
    set is there."""
    make_synthetic_mads(str(tmp_path / "mads"), n_frames=4, img_w=128,
                        img_h=96, movements=("HipHop", "Jazz"))
    _wait(_spawn("shared", tmp_path), "shared")
    h0, h1 = [json.load(open(tmp_path / f"shared_out_{r}.json"))
              for r in range(WORLD)]
    for k in h0:
        if not k.endswith("_per_sec"):
            assert h0[k] == h1[k], k
    assert os.listdir(tmp_path / "w") == ["shared"]
    assert sorted(os.listdir(tmp_path / "w" / "shared")) == [
        "latest.opt.pt", "latest.pth"]


def test_device_frame_cache_on_the_mesh_device():
    """DeviceFrameCache.build(mesh=) builds whole on the mesh's device and
    refuses a partial cache."""
    from fast3dhpe_tpu_torch.data.device_cache import DeviceFrameCache
    mesh = pmesh.Mesh(None, 0, 1, torch.device("cpu"))
    frames = {f"f{i}": np.full((4, 6, 3), i, np.uint8) for i in range(3)}

    def decode(paths):
        return [frames[p] for p in paths]

    cache = DeviceFrameCache.build(list(frames), decode, 1 << 20, mesh=mesh,
                                   device="cpu")
    assert cache.frames.device == mesh.device and not cache.partial
    assert int(cache.frames[2, 0, 0, 0]) == 2
    with pytest.raises(ValueError, match="single-process"):
        DeviceFrameCache.build(list(frames), decode, 1 << 20, mesh=mesh,
                               allow_partial=True, device="cpu")


def test_mesh_refusals(monkeypatch):
    """Without a process group make_mesh raises; n_devices other than the
    world size says why; a world size that model_parallel does not divide
    names both."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="init_distributed"):
        pmesh.make_mesh(model_parallel=2)
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(distributed, "_RANK_DEVICE", torch.device("cpu"))
    with pytest.raises(ValueError, match="one process a device"):
        pmesh.make_mesh(n_devices=4)
    with pytest.raises(ValueError, match="2 ranks .* not divisible by "
                                         "model_parallel=4"):
        pmesh.make_mesh(model_parallel=4)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda group=None: 3)
    with pytest.raises(ValueError, match="3 ranks .* not divisible by "
                                         "model_parallel=2"):
        pmesh.make_mesh(model_parallel=2)


def test_init_distributed_is_explicit(monkeypatch, tmp_path):
    """No WORLD_SIZE: a no-op. With one: the default device is the card,
    which this host lacks, so it raises instead of taking the CPU; a group
    that cannot form (an unknown rendezvous, a backend the host lacks)
    raises too, and leaves no group behind."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.init_distributed()
    store = "file://" + str(tmp_path / "store")
    with pytest.raises(RuntimeError, match="rendezvous"):
        distributed.init_distributed(device="cpu", init_method="bogus://x")
    if not torch.distributed.is_nccl_available():
        # NCCL asked for and missing: raises, never takes gloo instead
        with pytest.raises(RuntimeError):
            distributed.init_distributed(backend="nccl", device="cpu",
                                         init_method=store)
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0


def test_rank_zero_writes_and_retries_are_off(monkeypatch, caplog):
    import logging
    """Ranks other than 0 get the null writer; under several processes
    run_with_retries makes one attempt and warns."""
    assert isinstance(checkpoint.make_checkpoint_writer(False),
                      checkpoint.SyncCheckpointWriter)
    monkeypatch.setattr(checkpoint, "process_index", lambda: 1)
    assert isinstance(checkpoint.make_checkpoint_writer(True),
                      checkpoint.NullCheckpointWriter)
    monkeypatch.setattr(resilience, "process_count", lambda: 2)
    calls = []

    def failing(config, **kw):
        calls.append(kw)
        raise OSError(5, "EIO")

    with pytest.raises(OSError):
        resilience.run_with_retries(
            failing, None, retries=3, _sleep=lambda s: None,
            _probe=lambda: None,
            logger=logging.getLogger("test_torch_distributed"))
    assert len(calls) == 1
    assert "--retries disabled" in caplog.text


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)
