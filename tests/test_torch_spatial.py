"""Spatial partitioning in the PyTorch port (fast3dhpe_tpu_torch/parallel/
spatial.py and the spatial forms of the layers, the networks, the int8
executor and the eval steps) against the unsplit ops and the JAX
package's forward, on the CPU.

Four layouts, each spawned once by a module-scoped fixture: "m2" (world
2, M = 2, 64 px), "m4" (world 4, M = 4, 128 px: the interior ranks have a
neighbour on both sides), "d2m2" (world 4, D = 2 data groups x M = 2,
64 px) and "d2m4" (world 8, D = 2 x M = 4 at 64 px, JAX's own
TestSpatialSharding layout and its dryrun's mp = 4 eval step: 16 rows a
rank, and before layer4.0 a rank's block of 1 row no longer splits at
stride 2, so the forward gathers there and runs the rest whole). Each
rank is a subprocess that runs this file as a script
(`python tests/test_torch_spatial.py <layout> <rank> <dir>`), meets the
others through a file:// store in the test's temporary directory and
takes one thread; it runs every check of its layout and saves what it
got. The test process runs the unsplit ops and JAX meanwhile.

Tolerances:
- the halo table, op by op (stem, max-pool, 3x3 at stride 1 and 2, 1x1 at
  stride 2, the transposed convolution): the split op within 1e-6 of the
  unsplit output's largest value in fp32 (the same sums; oneDNN may block
  a smaller plane differently); the int8 convolutions, transposed
  convolution and pool bit-equal (int32 accumulators are exact); the fused
  bottleneck on a haloed bf16 tile within one bf16 rounding (2^-8) of the
  largest value;
- halo_rows and gather_height: bit for bit, -0.0, NaN and inf included;
- split_soft_argmax against the plain soft_argmax of the whole heatmap:
  1e-4 px (fp32 sums in another order), with one rank's logits 120 above
  the rest too;
- against JAX's unsharded forward, tests/test_train_steps.py
  TestSpatialSharding's: PoseResNet-18 heatmaps rtol 1e-4 / atol 1e-5,
  CDRNet-18 keypoints atol 1e-3 px (its heatmaps within 1e-4 of their
  largest value, tests/test_torch_model.py's bound); the model ranks'
  keypoints and 3D points bit-equal to each other, and where the forward
  gathered (d2m4) their whole heatmaps too;
- the split CDR eval step (d2m2 and d2m4) against JAX's eval step on the
  whole batch: the loss and MPJPE2D within 1e-4 relative, MPJPE3D within
  1e-3 relative (the DLT of an untrained model amplifies the keypoints'
  1e-5 px), n exact; the split 2D eval step against the port's unsplit
  one: within 1e-5 relative, n, hits and counts exact;
- int8 at M = 2 and at d2m4 against JAX's cdrnet_int8_apply on JAX's
  pack: the codes of every requant point before cf_out bit-equal (a
  rank's rows before the gather, whole after it), cf_out's flipped by one
  code in at most CF_FLIPS of them, heatmaps within 0.05 of their largest
  value, pred_2d within 1e-2 px at M = 2 and 1e-4 px at d2m4, pred_3d
  within 1e-2 of its largest coordinate (tests/test_torch_quantized.py's
  bounds).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# The ranks run this file as a script and need no JAX.
if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import optax
    from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
    from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
    from fast3dhpe_tpu.models import make_loss as jax_make_loss
    from fast3dhpe_tpu.models import quantized as jqz
    from fast3dhpe_tpu.ops import quant as JQ
    from fast3dhpe_tpu.parallel import mesh as jax_mesh
    from fast3dhpe_tpu.train.state import TrainState as JaxTrainState
    from fast3dhpe_tpu.train.steps import make_eval_step_cdr as jax_eval_cdr
    from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict

    torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# layout -> (data groups D, model ranks M, image size)
LAYOUTS = {"m2": (1, 2, 64), "m4": (1, 4, 128), "d2m2": (2, 2, 64),
           "d2m4": (2, 4, 64)}
# the exchanges of a depth-18 forward: a halo for the stem, the pool, each
# 3x3 convolution and each deconv, and one keypoint combine, where the
# split holds throughout; at d2m4 14 halos (the stem, the pool, layers
# 1-3), the gather before layer4.0 and nothing after it
EXCHANGES = {layout: {"halo": 21} for layout in LAYOUTS}
EXCHANGES["d2m4"] = {"halo": 14, "gather": 1}
EVAL_LAYOUTS = ("d2m2", "d2m4")      # the eval steps and JAX's sharded run
INT8_LAYOUTS = ("m2", "d2m4")
J, J2D = 19, 4
CF_FLIPS = 1e-3
OP_W = 10                    # the op table's plane width
CDR_ROW_VALID = np.array([1, 1, 1, 0], np.float32)
CHILD_TIMEOUT = 600


def _pairs(layout):
    """Pairs (and mono images) of a layout's global batch: 2 a data
    group."""
    return 2 * LAYOUTS[layout][0]


def _op_height(m):
    """The op table's plane height: 8 rows a rank, enough for the stem's
    halo of 3 and even for the stride-2 ops."""
    return 8 * m


def _op_inputs(m):
    """The op table's modules and inputs, the same on every rank and in
    the test process (seeded)."""
    from fast3dhpe_tpu_torch.models.layers import Conv2d, ConvTranspose2d
    r = np.random.RandomState(5)
    mods = {"stem": Conv2d(3, 8, 7, 2, 3, bias=False),
            "conv3x3_s1": Conv2d(4, 6, 3, 1, 1, bias=True),
            "conv3x3_s2": Conv2d(4, 6, 3, 2, 1, bias=False),
            "conv1x1_s2": Conv2d(4, 6, 1, 2, 0, bias=False),
            "deconv": ConvTranspose2d(4, 6)}
    with torch.no_grad():
        for mod in mods.values():
            mod.eval()
            for p in mod.parameters():
                p.copy_(torch.from_numpy(
                    r.randn(*p.shape).astype(np.float32)))
    h = _op_height(m)
    xs = {name: torch.from_numpy(r.randn(
        2, 3 if name == "stem" else 4, h, OP_W).astype(np.float32))
        .contiguous(memory_format=torch.channels_last) for name in mods}
    xs["maxpool"] = torch.from_numpy(r.randn(2, 4, h, OP_W).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    return mods, xs


def _int8_pack():
    """A small int8 pack: the stem, a 3x3 at stride 1 and 2, a deconv."""
    r = np.random.RandomState(6)

    def layer(shape, cout):
        return {"w": torch.from_numpy(r.randint(-127, 128, shape).astype(
            np.int8)), "sw": torch.from_numpy(r.uniform(
                1e-3, 2e-3, cout).astype(np.float32)),
            "b": torch.from_numpy(r.randn(cout).astype(np.float32))}

    names = {"encoder.conv1": ((7, 7, 3, 8), 8),
             "encoder.layer1_0.conv2": ((3, 3, 4, 6), 6),
             "encoder.layer2_0.conv2": ((3, 3, 4, 6), 6),
             "decoder.deconv1": ((4, 4, 6, 4), 6)}
    return {"layers": {n: layer(*a) for n, a in names.items()},
            "scales": {n: torch.tensor(0.5, dtype=torch.float32)
                       for n in names}, "depth": 18}


def _int8_inputs(m):
    r = np.random.RandomState(7)
    h = _op_height(m)
    return {c: torch.from_numpy(r.randint(-128, 128, (2, h, OP_W, c))
                                .astype(np.int8)) for c in (3, 4)}


def _int8_ops(mesh, m, rows=slice(None)):
    """Each int8 op of the executor on its input (this rank's rows on a
    spatial mesh): int8 codes."""
    from fast3dhpe_tpu_torch.models import quantized as qz
    rt = qz.Int8Pack(_int8_pack())
    ctx = qz._Int8Ctx(rt, mesh)
    x3, x4 = (x[:, rows] for x in _int8_inputs(m).values())
    s = torch.tensor(0.25)
    return {"int8 stem": ctx.conv("encoder.conv1", (x3, s), 2, 3, True,
                                  True)[0],
            "int8 conv3x3_s1": ctx.conv("encoder.layer1_0.conv2", (x4, s), 1,
                                        1, True, True)[0],
            "int8 conv3x3_s2": ctx.conv("encoder.layer2_0.conv2", (x4, s), 2,
                                        1, True, True)[0],
            "int8 deconv": ctx.deconv("decoder.deconv1", (x4, s))[0],
            "int8 maxpool": ctx.maxpool((x4, s))[0]}


def _bottleneck():
    """A fusable Bottleneck (layer1.0's shape, 32 rows x 32 columns, bf16)
    with running statistics that make relu(b1) > 0, so that a wrong halo
    shows at the tile's edge."""
    from fast3dhpe_tpu_torch.models.layers import init_weights
    from fast3dhpe_tpu_torch.models.resnet import Bottleneck
    blk = Bottleneck(64, 64, 1, True, fused_inference=True)
    init_weights(blk, torch.Generator().manual_seed(8))
    r = np.random.RandomState(8)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2, blk.bn3, blk.downsample[1]):
            c = bn.num_features
            bn.running_mean.copy_(torch.from_numpy(
                r.randn(c).astype(np.float32) * 0.3))
            bn.bias.copy_(torch.from_numpy(r.uniform(0.1, 0.5, c).astype(
                np.float32)))
    x = torch.from_numpy(r.randn(2, 64, 32, 32).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return blk.eval(), x


def _special(dtype, shape):
    """Values that an fp add of zero could change: -0.0, NaN, inf,
    subnormals, among random ones."""
    r = np.random.RandomState(9)
    x = torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype)
    flat = x.view(-1)
    n = flat.numel()
    vals = [-0.0, float("nan"), float("inf"), float("-inf"), 1e-40, -1e-40]
    for i, v in enumerate(vals):
        flat[(i * 7) % n::11] = v
    return x


def _bits(t):
    """A tensor's bits, comparable with torch.equal whatever NaNs hold."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else
                               torch.int32 if t.element_size() == 4 else
                               torch.int8)


def _heatmap(m, lift):
    """(2, 8m, 6, 3) logits; `lift` adds 120 to model rank 1's rows."""
    r = np.random.RandomState(10)
    hm = torch.from_numpy(r.randn(2, 8 * m, 6, 3).astype(np.float32) * 3)
    if lift:
        hm[:, 8:16] += 120.0
    return hm


# --------------------------------------------------------------- ranks

def _local(batch, d, n_groups):
    per = len(next(iter(batch.values()))) // n_groups
    return {k: v[d * per:(d + 1) * per] for k, v in batch.items()}


def _rank_ops(mesh):
    from fast3dhpe_tpu_torch.models.layers import max_pool
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    m, j = mesh.model_size, mesh.model_rank
    h = _op_height(m) // m
    rows = slice(j * h, (j + 1) * h)
    mods, xs = _op_inputs(m)
    blk, x = _bottleneck()
    out, halos = {}, {}
    with torch.inference_mode():
        for name, mod in mods.items():
            COUNTS.clear()
            out[name] = mod(xs[name][:, :, rows], mesh)
            halos[name] = COUNTS["halo"]
        out["maxpool"] = max_pool(xs["maxpool"][:, :, rows], mesh)
        out.update(_int8_ops(mesh, m, rows))
        heights, fused = [], blk._fused

        def recorded(t):
            heights.append(t.shape[2])
            return fused(t)

        blk._fused = recorded
        out["bottleneck"] = blk(x[:, :, 32 // m * j:32 // m * (j + 1)],
                                None, mesh)
    return {"out": out, "halos": halos, "k3_heights": heights}


def _rank_halo(mesh):
    """halo_rows of special values along dim 2 (NCHW) and dim 1 (NHWC
    int8), pad 7 at the global edge; gather_height of them."""
    from fast3dhpe_tpu_torch.parallel.spatial import gather_height, halo_rows
    m, j = mesh.model_size, mesh.model_rank
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = _special(dt, (2, 3, 4 * m, 5))[:, :, 4 * j:4 * (j + 1)]
        out[str(dt)] = halo_rows(x, 2, 2, 1, mesh, 7.0)
        out[f"gather {dt}"] = gather_height(x, mesh, 2)
    x8 = torch.arange(2 * 4 * m * 5 * 3).remainder(256).sub(128).to(
        torch.int8).view(2, 4 * m, 5, 3)[:, 4 * j:4 * (j + 1)]
    out["int8"] = halo_rows(x8, 1, 1, 2, mesh, -128)
    return out


def _rank_softargmax(mesh):
    from fast3dhpe_tpu_torch.parallel.spatial import split_soft_argmax
    m, j = mesh.model_size, mesh.model_rank
    return {lift: split_soft_argmax(
        _heatmap(m, lift)[:, 8 * j:8 * (j + 1)], mesh)
        for lift in (False, True)}


def _rank_models(inp, mesh):
    """PoseResNet-18 heatmaps and CDRNet-18 keypoints on this rank's rows
    of its data group's batch, with the exchanges of one forward."""
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.parallel.mesh import (COUNTS, replicate,
                                                   shard_batch_spatial)
    from fast3dhpe_tpu_torch.parallel.spatial import heatmap_split
    out = {}
    pose = PoseResNet(num_joints=J2D, num_layers=18)
    pose.load_state_dict(inp["pose_sd"], strict=True)
    replicate(mesh, pose.eval())
    b = shard_batch_spatial(mesh, _local({"image": inp["pose_img"]},
                                         mesh.rank, mesh.size))
    COUNTS.clear()
    with torch.inference_mode():
        out["pose_hm"] = pose(b["image"])
    out["pose_counts"] = dict(COUNTS)
    out["pose_split"] = heatmap_split(pose, b["image"].shape[1])
    cdr = CDRNet(num_layers=18)
    cdr.load_state_dict(inp["cdr_sd"], strict=True)
    replicate(mesh, cdr.eval())
    b = shard_batch_spatial(mesh, _local(
        {"image": inp["cdr_img"], "proj": inp["cdr_proj"]}, mesh.rank,
        mesh.size))
    COUNTS.clear()
    with torch.inference_mode():
        out["cdr_kp"], out["cdr_p3"], out["cdr_hm"] = cdr(
            b["image"], b["proj"], return_heatmaps=True)
    out["cdr_counts"] = dict(COUNTS)
    return out, pose, cdr


def _rank_eval(inp, mesh, pose, cdr):
    """The CDR and 2D eval steps on the data group's rows, split."""
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS, shard_batch_spatial
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import (make_eval_step_2d,
                                                 make_eval_step_cdr)
    out = {}
    step = make_eval_step_cdr(make_loss("JointsMSESmooth", True), mesh=mesh)
    batch = shard_batch_spatial(mesh, _local(inp["eval_batch"], mesh.rank,
                                             mesh.size))
    COUNTS.clear()
    out["cdr"] = {k: float(v) for k, v in
                  step(TrainState(cdr, None), batch, True).items()}
    out["cdr_counts"] = dict(COUNTS)
    step = make_eval_step_2d(make_loss("JointsMSE", True, layout="NHWC"),
                             mesh=mesh)
    batch = shard_batch_spatial(mesh, _local(inp["pose_batch"], mesh.rank,
                                             mesh.size))
    out["pose"] = {k: v.tolist() for k, v in
                   step(TrainState(pose, None), batch).items()}
    return out


def _rank_int8(inp, mesh):
    """The int8 CDRNet-18 on JAX's pack, split, every requant recorded."""
    from fast3dhpe_tpu_torch.models import quantized as qz
    from fast3dhpe_tpu_torch.ops import quant as Q
    from fast3dhpe_tpu_torch.parallel.mesh import replicate, shard_batch_spatial
    model = replicate(mesh, qz.cdrnet_int8(qz.load_pack(inp["pack_path"]),
                                           device="cpu"))
    b = shard_batch_spatial(mesh, {"image": inp["cdr_img"],
                                   "proj": inp["cdr_proj"]})
    codes, orig = [], Q.requant

    def recorded(y, s):
        q = orig(y, s)
        codes.append(q)
        return q

    Q.requant = recorded
    try:
        with torch.inference_mode():
            kp, p3, hm = model(b["image"], b["proj"], return_heatmaps=True)
    finally:
        Q.requant = orig
    return {"kp": kp, "p3": p3, "hm": hm, "codes": codes}


def _rank_main(layout, rank, work):
    d, m, _ = LAYOUTS[layout]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(d * m),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    assert init_distributed(backend="gloo", device="cpu",
                            init_method="file://" + os.path.join(
                                work, "store"))
    try:
        mesh = make_mesh(model_parallel=m)
        inp = torch.load(os.path.join(work, "inp.pt"), weights_only=False)
        out = {"mesh": (mesh.rank, mesh.size, mesh.model_rank,
                        mesh.model_size)}
        if layout not in EVAL_LAYOUTS:
            out["ops"] = _rank_ops(mesh)
            out["halo"] = _rank_halo(mesh)
            out["softargmax"] = _rank_softargmax(mesh)
        out["models"], pose, cdr = _rank_models(inp, mesh)
        if layout in EVAL_LAYOUTS:
            out["eval"] = _rank_eval(inp, mesh, pose, cdr)
        if layout in INT8_LAYOUTS:
            out["int8"] = _rank_int8(inp, mesh)
        torch.save(out, os.path.join(work, f"out_{rank}.pt"))
    finally:
        destroy_distributed()


# --------------------------------------------------------- test process

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rig(batch, img):
    """Two cameras 3 m from the origin at x = -+400 mm, turned toward it
    (tests/test_torch_train_step.py's rig)."""
    f, c = 1100.0 * img / 256, img / 2
    K = np.array([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]])
    Ps = []
    for cx in (-400.0, 400.0):
        centre = np.array([cx, 0.0, -3000.0])
        z = -centre / np.linalg.norm(centre)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Ps.append(K @ np.hstack([R, -R @ centre[:, None]]))
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    """JAX's CDRNet-18 (head scaled so that the views decode apart, as
    tests/test_torch_model.py) and PoseResNet-18 variables."""
    cdr = JaxCDRNet(num_layers=18)
    v = _np(jax.jit(cdr.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)),
        jnp.asarray(_rig(1, 64)), train=False))
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0
    head["bias"] = head["bias"] + np.random.RandomState(3).randn(J).astype(
        np.float32)
    pose = JaxPoseResNet(num_joints=J2D, num_layers=18)
    pv = _np(jax.jit(pose.init, static_argnames=("train",))(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)), train=False))
    return {"cdr": (cdr, v), "pose": (pose, pv)}


def _eval_batches(img):
    """A CDR eval batch of 4 pairs (the last padded), their projections'
    exact targets, and a 2D batch of 4 images with Gaussian targets."""
    from fast3dhpe_tpu.ops import render_gaussian_heatmaps
    r = np.random.RandomState(11)
    b = len(CDR_ROW_VALID)
    proj = _rig(b, img)
    p3 = r.uniform(-300, 300, (b, J, 3)).astype(np.float32)
    hom = np.concatenate([p3, np.ones((b, J, 1), np.float32)], -1)
    uvw = np.einsum("bvij,bkj->bvki", proj, hom)
    cdr = {"image": r.randn(b, 2, img, img, 3).astype(np.float32),
           "proj": proj, "target_3d": p3,
           "target_2d": (uvw[..., :2] / uvw[..., 2:]).astype(np.float32),
           "target_weight": np.ones((b, J), np.float32),
           "row_valid": CDR_ROW_VALID}
    joints = r.uniform(5, img - 5, (b, J2D, 2)).astype(np.float32)
    target, weight = render_gaussian_heatmaps(
        joints, np.ones((b, J2D), np.float32), (img // 4, img // 4),
        (img, img), sigma=1)
    pose = {"image": r.randn(b, img, img, 3).astype(np.float32),
            "target": np.array(target), "target_weight": np.array(weight),
            "row_valid": np.array([1, 1, 1, 0], np.float32)}
    return cdr, pose


def _spawn(layout, work):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST") and k not in
           ("RANK", "WORLD_SIZE", "LOCAL_RANK", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    d, m, _ = LAYOUTS[layout]
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), layout, str(r),
         str(work)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(d * m)]


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


def _jax_refs(layout, inp, variables):
    """JAX's unsharded forwards of the layout's global batch, and for
    EVAL_LAYOUTS the eval step and the sharded forward, for INT8_LAYOUTS
    the int8 apply."""
    cdr, v = variables["cdr"]
    pose, pv = variables["pose"]
    ref = {"pose_hm": np.asarray(pose.apply(pv, jnp.asarray(inp[
        "pose_img"].numpy()), train=False))}
    kp, p3, hm = cdr.apply(v, jnp.asarray(inp["cdr_img"].numpy()),
                           jnp.asarray(inp["cdr_proj"].numpy()),
                           train=False, return_heatmaps=True)
    ref.update(cdr_kp=np.asarray(kp), cdr_p3=np.asarray(p3),
               cdr_hm=np.asarray(hm))
    d, m, _ = LAYOUTS[layout]
    if layout in EVAL_LAYOUTS:
        batch = {k: jnp.asarray(a) for k, a in inp["eval_np"].items()}
        state = JaxTrainState.create(v, optax.sgd(0.0))
        ref["eval"] = {k: float(x) for k, x in jax_eval_cdr(
            cdr, jax_make_loss("JointsMSESmooth", True))(
            state, batch, True).items()}
        mesh = jax_mesh.make_mesh(d * m, model_parallel=m)
        b = jax_mesh.shard_batch_spatial(mesh, {"image": jnp.asarray(
            inp["pose_img"].numpy())})
        ref["pose_hm_sharded"] = np.asarray(jax.jit(
            lambda vv, x: pose.apply(vv, x, train=False))(
            jax_mesh.replicate(mesh, pv), b["image"]))
    if layout in INT8_LAYOUTS:
        (kp8, p38, hm8), codes = _recorded(JQ, lambda: jqz.cdrnet_int8_apply(
            inp["jpack"], jnp.asarray(inp["cdr_img"].numpy()),
            jnp.asarray(inp["cdr_proj"].numpy()), depth=18,
            return_heatmaps=True))
        ref["int8"] = {"kp": np.asarray(kp8), "p3": np.asarray(p38),
                       "hm": np.asarray(hm8), "codes": codes}
    return ref


def _recorded(module, fn):
    seen, orig = [], module.requant

    def requant(y, s):
        out = orig(y, s)
        seen.append(np.asarray(out))
        return out

    module.requant = requant
    try:
        return fn(), seen
    finally:
        module.requant = orig


def _port_eval_2d(inp):
    """The port's unsplit 2D eval step on the whole batch."""
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_eval_step_2d
    pose = PoseResNet(num_joints=J2D, num_layers=18)
    pose.load_state_dict(inp["pose_sd"], strict=True)
    step = make_eval_step_2d(make_loss("JointsMSE", True, layout="NHWC"))
    return {k: x.tolist() for k, x in step(TrainState(pose.eval(), None), {
        k: torch.from_numpy(a) for k, a in inp["pose_batch"].items()})
        .items()}


def _unsplit_ops(m):
    from fast3dhpe_tpu_torch.models.layers import max_pool
    mods, xs = _op_inputs(m)
    blk, x = _bottleneck()
    with torch.inference_mode():
        out = {name: mod(xs[name]) for name, mod in mods.items()}
        out["maxpool"] = max_pool(xs["maxpool"])
        out.update(_int8_ops(None, m))
        out["bottleneck"] = blk(x)
    return out


def _run_layout(layout, variables, work):
    """Spawn a layout's ranks, run the unsplit ops and JAX meanwhile, then
    collect the ranks' outputs."""
    d, m, img = LAYOUTS[layout]
    r = np.random.RandomState(12)
    n = _pairs(layout)
    cdr, v = variables["cdr"]
    pose, pv = variables["pose"]
    inp = {"cdr_sd": jax_variables_to_state_dict(v),
           "pose_sd": jax_variables_to_state_dict(pv),
           "cdr_img": torch.from_numpy(r.randn(n, 2, img, img, 3).astype(
               np.float32)),
           "cdr_proj": torch.from_numpy(_rig(n, img)),
           "pose_img": torch.from_numpy(r.randn(n, img, img, 3).astype(
               np.float32))}
    if layout in EVAL_LAYOUTS:
        ev, pb = _eval_batches(img)
        inp.update(eval_np=ev, pose_batch=pb, cdr_img=torch.from_numpy(
            ev["image"]), cdr_proj=torch.from_numpy(ev["proj"]),
            eval_batch={k: torch.from_numpy(a) for k, a in ev.items()},
            pose_img=torch.from_numpy(pb["image"]))
    if layout in INT8_LAYOUTS:
        jpack = _np(jqz.quantize_cdrnet(v, [(
            jnp.asarray(inp["cdr_img"].numpy()),
            jnp.asarray(inp["cdr_proj"].numpy()))]))
        inp["pack_path"] = str(work / "jax_pack.npz")
        jqz.save_pack(inp["pack_path"], jpack)
    torch.save({k: val for k, val in inp.items() if k != "eval_np"},
               work / "inp.pt")
    procs = _spawn(layout, work)
    try:
        inp["jpack"] = jpack if layout in INT8_LAYOUTS else None
        ref = _jax_refs(layout, inp, variables)
        ops = None if layout in EVAL_LAYOUTS else _unsplit_ops(m)
        eval2d = _port_eval_2d(inp) if layout in EVAL_LAYOUTS else None
    finally:
        _wait(procs, layout)
    outs = [torch.load(work / f"out_{rank}.pt", weights_only=False)
            for rank in range(d * m)]
    return {"layout": layout, "d": d, "m": m, "ref": ref, "ops": ops,
            "eval2d": eval2d, "outs": outs}


@pytest.fixture(scope="module")
def runs(variables, tmp_path_factory):
    """Each layout's run, made once, when a test first asks for it."""
    done = {}

    def get(layout):
        if layout not in done:
            done[layout] = _run_layout(layout, variables,
                                       tmp_path_factory.mktemp(layout))
        return done[layout]

    return get


@pytest.fixture
def run(request, runs):
    """The run of the layout that the test names (an indirect
    parameter)."""
    return runs(request.param)


def _groups(run):
    """The ranks' outputs by data group, each in model-rank order."""
    d, m = run["d"], run["m"]
    return [run["outs"][g * m:(g + 1) * m] for g in range(d)]


def _rows(t, dim, j, m):
    h = t.shape[dim] // m
    return t.narrow(dim, j * h, h)


def _gathers(run):
    """Whether the layout's forward gathers (and returns whole
    heatmaps)."""
    return "gather" in EXCHANGES[run["layout"]]


def _whole(run, group, tensors, dim):
    """A data group's tensor whole: its model ranks' rows joined along
    `dim` where the split held, else the one whole tensor, which must then
    be bit-equal on every model rank."""
    if _gathers(run):
        assert all(torch.equal(t, tensors[0]) for t in tensors[1:])
        return tensors[0]
    return torch.cat(tensors, dim)


def _layouts(*names):
    """The layouts a test runs in: indirect parameters of `run`."""
    return pytest.mark.parametrize("run", names or list(LAYOUTS),
                                   indirect=True)


@_layouts()
def test_mesh_layout(run):
    """Rank r: data index r // M, model index r % M (JAX's
    devices.reshape(n // M, M))."""
    d, m = run["d"], run["m"]
    for r, out in enumerate(run["outs"]):
        assert out["mesh"] == (r // m, d, r % m, m)


@_layouts("m2", "m4")
def test_halo_table(run):
    """Each op split over the model ranks against the unsplit op: fp32
    within 1e-6 of the largest value, int8 bit-equal, one exchange an op
    with a halo and none for the 1x1."""
    m = run["m"]
    for j, out in enumerate(run["outs"]):
        got = out["ops"]["out"]
        for name, ref in run["ops"].items():
            want = _rows(ref, 1 if name.startswith("int8") else 2, j, m)
            assert got[name].shape == want.shape, name
            if name.startswith("int8"):
                assert torch.equal(got[name], want), (name, j)
            elif name == "bottleneck":
                scale = want.float().abs().max()
                assert ((got[name].float() - want.float()).abs().max()
                        <= 2.0 ** -8 * scale), (name, j)
            else:
                scale = max(1.0, float(want.abs().max()))
                assert float((got[name] - want).abs().max()) <= 1e-6 * scale, \
                    (name, j)
        assert out["ops"]["halos"] == {"stem": 1, "conv3x3_s1": 1,
                                       "conv3x3_s2": 1, "conv1x1_s2": 0,
                                       "deconv": 1}


@_layouts("m2", "m4")
def test_fused_bottleneck_haloed_tiles(run):
    """The fused block runs on the rank's rows plus one row of each
    neighbour's input: 32/M + 1 rows at the global edge, + 2 inside."""
    m = run["m"]
    for j, out in enumerate(run["outs"]):
        inner = int(j > 0) + int(j < m - 1)
        assert out["ops"]["k3_heights"] == [32 // m + inner]


@_layouts("m2", "m4")
def test_halo_rows_bit_exact(run):
    """halo_rows delivers fp32 and bf16 rows bit for bit (-0.0, NaN, inf,
    subnormals), int8 along dim 1, the pad value at the global edge;
    gather_height returns the whole tensor bit for bit."""
    m = run["m"]
    for j, out in enumerate(run["outs"]):
        for dt in (torch.float32, torch.bfloat16):
            x = _special(dt, (2, 3, 4 * m, 5))
            pad = torch.full((2, 3, 4 * m + 3, 5), 7.0, dtype=dt)
            pad[:, :, 2:-1] = x
            want = pad[:, :, 4 * j:4 * j + 7]
            assert torch.equal(_bits(out["halo"][str(dt)]), _bits(want))
            assert torch.equal(_bits(out["halo"][f"gather {dt}"]), _bits(x))
        x8 = torch.arange(2 * 4 * m * 5 * 3).remainder(256).sub(128).to(
            torch.int8).view(2, 4 * m, 5, 3)
        pad = torch.full((2, 4 * m + 3, 5, 3), -128, dtype=torch.int8)
        pad[:, 1:-2] = x8
        assert torch.equal(out["halo"]["int8"], pad[:, 4 * j:4 * j + 7])


@_layouts("m2", "m4")
def test_split_soft_argmax(run):
    """split_soft_argmax against the plain soft_argmax of the whole
    heatmap (1e-4 px), with and without model rank 1's logits 120 above
    the rest; the same on every model rank, bit for bit."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
    m = run["m"]
    for lift in (False, True):
        want = soft_argmax(_heatmap(m, lift))
        got = [out["softargmax"][lift] for out in run["outs"]]
        assert float((got[0] - want).abs().max()) <= 1e-4
        assert all(torch.equal(g, got[0]) for g in got)
    lifted = soft_argmax(_heatmap(m, True))
    assert float(lifted[..., 1].min()) >= 8 and float(
        lifted[..., 1].max()) < 16          # the lifted rows win


def _pose_heatmaps(run):
    return torch.cat([_whole(run, g, [o["models"]["pose_hm"] for o in g], 1)
                      for g in _groups(run)], 0)


@_layouts()
def test_poseresnet_matches_jax(run):
    """PoseResNet-18 heatmaps, the model ranks' rows together (or the
    whole heatmaps, bit-equal on every model rank, where the forward
    gathered), against JAX's unsharded forward (rtol 1e-4, atol 1e-5);
    the exchanges of EXCHANGES, and heatmap_split saying which kind of
    heatmap the forward returned."""
    ref = run["ref"]["pose_hm"]
    got = _pose_heatmaps(run)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    for out in run["outs"]:
        assert out["models"]["pose_counts"] == EXCHANGES[run["layout"]]
        assert out["models"]["pose_split"] == (not _gathers(run))


@_layouts(*EVAL_LAYOUTS)
def test_poseresnet_matches_jax_sharded(run):
    """The same heatmaps against JAX's own shard_batch_spatial forward on
    the layout's mesh of the virtual CPU devices (D = 2 x M = 2, and
    TestSpatialSharding's D = 2 x M = 4)."""
    got = _pose_heatmaps(run)
    np.testing.assert_allclose(got.numpy(), run["ref"]["pose_hm_sharded"],
                               rtol=1e-4, atol=1e-5)


@_layouts()
def test_cdrnet_matches_jax(run):
    """CDRNet-18 (J = 19) keypoints against JAX's unsharded forward (atol
    1e-3 px), bit-equal across the model ranks of a data group, the
    heatmaps (rows, or whole where the forward gathered) within 1e-4 of
    their largest value; 21 halos and one keypoint exchange a forward
    where the split holds, 14 halos and the gather at d2m4."""
    ref = run["ref"]
    kps, hms = [], []
    for g in _groups(run):
        for o in g[1:]:
            assert torch.equal(o["models"]["cdr_kp"], g[0]["models"]["cdr_kp"])
            assert torch.equal(o["models"]["cdr_p3"], g[0]["models"]["cdr_p3"])
        kps.append(g[0]["models"]["cdr_kp"])
        hms.append(_whole(run, g, [o["models"]["cdr_hm"] for o in g], 2))
    hm = torch.cat(hms, 0).numpy()
    assert np.abs(hm - ref["cdr_hm"]).max() < 1e-4 * np.abs(
        ref["cdr_hm"]).max()
    kp = torch.cat(kps, 0).numpy()
    np.testing.assert_allclose(kp, ref["cdr_kp"], atol=1e-3)
    assert kp.std() > 1.0                  # the views decode apart
    combine = {} if _gathers(run) else {"keypoints": 1}
    for out in run["outs"]:
        assert out["models"]["cdr_counts"] == dict(
            EXCHANGES[run["layout"]], **combine)


@_layouts(*EVAL_LAYOUTS)
def test_eval_steps_match_global_batch(run):
    """The split CDR eval step on D = 2 x M = 2 and D = 2 x M = 4 (the
    dryrun's mp = 2 and 4 at 64 px) against JAX's eval step on the whole
    batch, the same metrics on every rank (reduced over the data group,
    never counted M times); the split 2D eval step against the port's
    unsplit one (at d2m4 on the whole heatmaps the forward returns, not
    gathered a second time)."""
    ref = run["ref"]["eval"]
    for out in run["outs"]:
        got = out["eval"]["cdr"]
        assert got["n"] == ref["n"] == 3.0
        for k in ("loss", "mpjpe_2d", "loss_sum", "e2_sum"):
            assert got[k] == pytest.approx(ref[k], rel=1e-4), k
        for k in ("mpjpe_3d", "e3_sum"):
            assert got[k] == pytest.approx(ref[k], rel=1e-3), k
        assert got == run["outs"][0]["eval"]["cdr"]
        combine = {} if _gathers(run) else {"keypoints": 1}
        assert out["eval"]["cdr_counts"] == dict(
            EXCHANGES[run["layout"]], rows=1, metrics=1, **combine)
        pose = out["eval"]["pose"]
        for k in ("n", "hits", "cnt"):
            assert pose[k] == run["eval2d"][k], k
        for k in ("loss", "acc", "loss_sum"):
            np.testing.assert_allclose(pose[k], run["eval2d"][k], rtol=1e-5,
                                       err_msg=k)


@_layouts(*INT8_LAYOUTS)
def test_int8_matches_jax(run):
    """Int8 CDRNet-18 at M = 2 and at d2m4 on JAX's pack against JAX's
    cdrnet_int8_apply: every code before cf_out bit-equal (row by row
    while split: all 18 of the encoder at M = 2, the input, stem and
    layers 1-3's 14 at d2m4; whole after the gather), cf_out within
    CF_FLIPS, heatmaps, pred_2d (1e-2 px at M = 2, 1e-4 px at d2m4) and
    pred_3d within tests/test_torch_quantized.py's bounds; pred_2d
    bit-equal across the model ranks."""
    ref = run["ref"]["int8"]
    m = run["m"]
    outs = [o["int8"] for o in run["outs"]]
    assert all(torch.equal(o["kp"], outs[0]["kp"]) for o in outs[1:])
    cf = len(ref["codes"]) - 4
    n_split = 14 if _gathers(run) else len(ref["codes"])
    for k, out in enumerate(outs):
        j = k % m
        assert len(out["codes"]) == len(ref["codes"]) == 22
        for i, (a, b) in enumerate(zip(out["codes"], ref["codes"])):
            want = torch.from_numpy(b.copy())
            if i < n_split:
                want = _rows(want, 1, j, m)
            if i == cf:
                got_cf, want_cf = a.numpy().astype(int), want.numpy()
                assert (got_cf != want_cf).sum() <= CF_FLIPS * want_cf.size
                assert np.abs(got_cf - want_cf).max() <= 1
            elif i < cf:
                np.testing.assert_array_equal(a.numpy(), want.numpy())
    hm = (outs[0]["hm"] if _gathers(run) else
          torch.cat([o["hm"] for o in outs], 2)).numpy()
    assert np.abs(hm - ref["hm"]).max() <= 0.05 * np.abs(ref["hm"]).max()
    kp_tol = 1e-4 if _gathers(run) else 1e-2
    assert np.abs(outs[0]["kp"].numpy() - ref["kp"]).max() < kp_tol
    assert (np.abs(outs[0]["p3"].numpy() - ref["p3"]).max()
            <= 1e-2 * np.abs(ref["p3"]).max())


# ----------------------------------------------------------- refusals

def _fake_mesh(m=2):
    from fast3dhpe_tpu_torch.parallel.mesh import Mesh
    return Mesh(None, 0, 1, torch.device("cpu"), None, 0, m)


def test_split_rule_refuses_uneven_heights():
    """The split rule is JAX's, H divisible by M: an H that M does not
    divide raises naming the rule, from spatial_sharding and
    shard_batch_spatial, and so does another ndim; 64 px at M = 4 cuts 16
    rows a rank, which 32 x M no longer has to divide."""
    from fast3dhpe_tpu_torch.parallel.mesh import (shard_batch_spatial,
                                                   spatial_sharding)
    mesh = _fake_mesh(4)
    assert spatial_sharding(mesh, 5, 64) == (slice(None), slice(None),
                                             slice(0, 16))
    assert spatial_sharding(mesh, 4, 128) == (slice(None), slice(0, 32))
    assert spatial_sharding(mesh, 4, 100) == (slice(None), slice(0, 25))
    for bad in (62, 66, 99):
        with pytest.raises(ValueError, match="divisible by model_parallel "
                                             "= 4"):
            spatial_sharding(mesh, 5, bad)
    with pytest.raises(ValueError, match="divisible"):
        shard_batch_spatial(mesh, {"image": np.zeros((1, 2, 62, 64, 3))})
    b = shard_batch_spatial(mesh, {"image": np.zeros((1, 2, 64, 64, 3))})
    assert b["image"].shape == (1, 2, 16, 64, 3)
    with pytest.raises(ValueError, match="ndim"):
        spatial_sharding(mesh, 3, 128)


def test_spatial_training_loops_and_export_refuse(monkeypatch, tmp_path):
    """What still refuses on a spatial mesh, with the "not applicable"
    wording: a network in training mode (CDRNet, PoseResNet) raises
    NotImplementedError, and so does the export of a split model. The
    loops, the loaders and the device cache run on such a mesh
    (tests/test_torch_spatial_loops.py): mesh_device is the mesh's at any
    M, and replicate(..., spatial=False), the loops' call, installs no
    split."""
    from fast3dhpe_tpu_torch import export
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.parallel import mesh as pmesh
    mesh = _fake_mesh()
    model = CDRNet(num_layers=18)
    model.spatial = mesh
    with pytest.raises(NotImplementedError, match="not applicable"):
        model.train()(torch.zeros(1, 2, 64, 64, 3), torch.zeros(1, 2, 3, 4))
    pose = PoseResNet(num_joints=J2D, num_layers=18)
    pose.spatial = mesh
    with pytest.raises(NotImplementedError, match="not applicable"):
        pose.train()(torch.zeros(1, 64, 64, 3))
    with pytest.raises(NotImplementedError, match="not applicable"):
        export.export_cdrnet(model.eval(), model.state_dict(), 1, (64, 64),
                             device="cpu")
    assert pmesh.mesh_device(mesh, "cuda") == torch.device("cpu")
    monkeypatch.setattr(pmesh, "broadcast_", lambda *a, **k: None)
    fresh = pmesh.replicate(mesh, CDRNet(num_layers=18), spatial=False)
    assert fresh.spatial is None
    assert all(bn.process_group is mesh.group for bn in fresh.modules()
               if isinstance(bn, torch.nn.BatchNorm2d))
    assert pmesh.replicate(mesh, fresh).spatial is mesh


def test_gather_point_against_brute_force():
    """gather_point against a brute-force reading of the rule, for every
    H <= 320 that M divides, M = 2..8: each op's outputs are assigned to
    the rank whose input rows hold their window's anchor row s * o; the
    split holds at an op while every rank gets n / s outputs (the same
    number, a whole block) and every window it reads lies in its own rows
    or a block's height on either side (halo_rows fetches a neighbour's
    rows, or as many pad rows at the global edge, and no further). The
    first op where that fails is the gather point. Then the examples:
    64 px (JAX's TestSpatialSharding) and 192 px at M = 4 gather before
    layer4.0, 256 px at M <= 8 never, odd rows a rank at the input."""
    from fast3dhpe_tpu_torch.models.resnet import encoder_ops
    from fast3dhpe_tpu_torch.parallel.spatial import gather_point, split_after

    def brute(h, m, ops):
        n = h // m
        for i, (_, k, s, p) in enumerate(ops):
            out = (h + 2 * p - k) // s + 1
            owned = [[o for o in range(out) if j * n <= s * o < (j + 1) * n]
                     for j in range(m)]
            if any(len(o) != len(owned[0]) for o in owned) or \
                    len(owned[0]) * s != n:
                return i
            for j, outs in enumerate(owned):
                for o in outs:
                    lo, hi = s * o - p, s * o - p + k - 1
                    if lo < (j - 1) * n or hi >= (j + 2) * n:
                        return i
            h, n = out, n // s
        return None

    ops = encoder_ops(18)
    checked = 0
    for m in range(2, 9):
        for h in range(m, 321, m):
            assert gather_point(h, m, ops) == brute(h, m, ops), (h, m)
            checked += 1
    assert checked > 500
    names = {(h, m): gather_point(h, m, encoder_ops(101))
             for h, m in ((64, 4), (192, 4), (96, 2))}
    ops101 = encoder_ops(101)
    assert ops101[names[64, 4]][0] == ops101[names[192, 4]][0] == "layer4.0"
    assert ops101[names[96, 2]][0] == "layer4.0"
    for m in (1, 2, 4, 8):
        assert gather_point(256, m, ops101) is None
    for h, m in ((6, 2), (50, 2), (36, 4), (100, 4)):
        assert gather_point(h, m, ops101) == 0      # odd rows: the input
    assert gather_point(200, 4, ops101) == 1        # 25 rows at the pool
    assert len(ops101) == 2 + 33
    with pytest.raises(ValueError, match="divisible"):
        gather_point(66, 4, ops101)
    mesh = _fake_mesh(4)
    assert split_after(mesh, 64, ops101) is mesh
    assert split_after(mesh, 16, ops101) is None
    assert split_after(None, 64, ops101) is None


def test_halo_rules_from_the_windows():
    """conv_halo and deconv_halo against a brute-force reading of which
    input rows each output row of a block touches."""
    from fast3dhpe_tpu_torch.parallel.spatial import conv_halo, deconv_halo
    assert conv_halo(7, 2, 3) == (3, 2)
    assert conv_halo(3, 2, 1) == (1, 0)
    assert conv_halo(3, 1, 1) == (1, 1)
    assert conv_halo(1, 2, 0) == (0, 0)
    assert deconv_halo(4, 2, 1) == (1, 1, 3, 3)
    a, b = 8, 16                             # a block of input rows
    for k, s, p in ((7, 2, 3), (3, 2, 1), (3, 1, 1), (1, 1, 0), (1, 2, 0)):
        rows = {s * o - p + t for o in range(a // s, b // s)
                for t in range(k)}
        assert (a - min(rows), max(0, max(rows) - (b - 1))) == \
            conv_halo(k, s, p)
    k, s, p = 4, 2, 1
    reads = {i for o in range(s * a, s * b) for i in range(a - 4, b + 4)
             for t in range(k) if s * i - p + t == o}
    top, bottom, c_top, c_bottom = deconv_halo(k, s, p)
    assert (a - min(reads), max(reads) - (b - 1)) == (top, bottom)
    n = b - a + top + bottom                 # the padded block, padding 0
    assert (n - 1) * s + k - c_top - c_bottom == s * (b - a)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    sys.exit(0)
