"""The neighbour form of the spatial exchanges in the PyTorch port
(fast3dhpe_tpu_torch/parallel/spatial.py under Mesh.exchange =
"neighbours": a halo is one batch_isend_irecv with the model ranks above
and below, the gather and the keypoint statistics one all_gather) against
the slot form (one all_reduce of M slots) and against the JAX package's
unsharded forward, on the CPU; and how make_mesh, init_distributed and
barrier take the process group's backend.

NCCL runs the neighbour form on the card; gloo on CPU tensors has both
batch_isend_irecv and all_gather_into_tensor, so the ranks here run it
over gloo with make_mesh(exchange="neighbours"). Three layouts, spawned
together by one module fixture while JAX runs in the test process, each
rank a subprocess that runs this file as a script (`python
tests/test_torch_neighbours.py <layout> <rank> <dir>`), meeting the others
through a file:// store in the test's temporary directory, one thread
each:
- "m2": world 2, M = 2: the exchanges in both forms, and the int8
  CDRNet-18 at 64 px on JAX's pack;
- "m4": world 4, M = 4 (the interior ranks have both neighbours): the
  exchanges in both forms, and CDRNet-18 at 128 px;
- "d2m2": world 4, D = 2 data groups x M = 2: PoseResNet-18 at 64 px.

Tolerances:
- halo_rows, gather_height and split_soft_argmax: the neighbour form bit
  for bit the slot form (fp32 with -0.0, NaN, inf and subnormals, bf16,
  int8 NHWC along dim 1), and halo_rows bit for bit the rows of the whole
  tensor with the pad value (or nothing) at the global edge;
- COUNTS_BYTES: a halo sends exactly its edge rows' bytes (the last `top`
  rows down where there is a rank below, the first `bottom` rows up where
  there is one above), the slot form M slots of the rows' int32 words;
- against JAX's unsharded forward, tests/test_torch_spatial.py's:
  CDRNet-18 keypoints atol 1e-3 px and heatmaps within 1e-4 of their
  largest value, PoseResNet-18 heatmaps rtol 1e-4 / atol 1e-5; the model
  ranks' keypoints and 3D points bit-equal; int8 at M = 2 on JAX's pack:
  every code before cf_out bit-equal row by row, cf_out flipped by one
  code in at most CF_FLIPS of them, heatmaps within 0.05 of their largest
  value, pred_2d within 1e-2 px, pred_3d within 1e-2 of its largest
  coordinate (tests/test_torch_quantized.py's bounds).
"""

import dataclasses
import datetime
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
    from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
    from fast3dhpe_tpu.models import PoseResNet as JaxPoseResNet
    from fast3dhpe_tpu.models import quantized as jqz
    from fast3dhpe_tpu.ops import quant as JQ
    from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict

    torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# layout -> (data groups D, model ranks M)
LAYOUTS = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
EXCHANGE_LAYOUTS = ("m2", "m4")
J, J2D = 19, 4
CDR_PX, INT8_PX, POSE_PX = 128, 64, 64
CF_FLIPS = 1e-3
BLOCK = 4                    # rows a rank in the exchange checks
HALOS = ((1, 0), (0, 1), (1, 1), (2, 1), (1, 2), (3, 2), (2, 3), (3, 3))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# a depth-18 forward where the split holds: the stem, the pool, 16 3x3
# convolutions, 3 deconvs, and the keypoint combine (CDRNet)
HALOS_18 = 21
CHILD_TIMEOUT = 300


def _special(dtype, shape):
    """Values that an add of zero could change: -0.0, NaN, inf,
    subnormals, among random ones."""
    r = np.random.RandomState(9)
    x = torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype)
    flat = x.view(-1)
    for i, v in enumerate((-0.0, float("nan"), float("inf"),
                           float("-inf"), 1e-40, -1e-40)):
        flat[(i * 7) % flat.numel()::11] = v
    return x


def _int8_whole(m):
    return torch.arange(2 * BLOCK * m * 5 * 3).remainder(256).sub(128).to(
        torch.int8).view(2, BLOCK * m, 5, 3)


def _bits(t):
    """A tensor's bits, comparable with torch.equal whatever NaNs hold."""
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])


def _heatmap(m, lift):
    """(2, 8m, 6, 3) logits; `lift` adds 120 to model rank 1's rows."""
    r = np.random.RandomState(10)
    hm = torch.from_numpy(r.randn(2, 8 * m, 6, 3).astype(np.float32) * 3)
    if lift:
        hm[:, 8:16] += 120.0
    return hm


def _rig(batch, img):
    """Two cameras 3 m from the origin at x = -+400 mm, turned toward it
    (tests/test_torch_spatial.py's rig)."""
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


# --------------------------------------------------------------- ranks

def _rank_exchanges(mesh):
    """halo_rows (every HALOS case, pad 7 and none, fp32, bf16 along dim
    2 and int8 along dim 1), gather_height and split_soft_argmax in both
    forms, with the bytes each halo counted."""
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS, COUNTS_BYTES
    from fast3dhpe_tpu_torch.parallel.spatial import (gather_height,
                                                      halo_rows,
                                                      split_soft_argmax)
    m, j = mesh.model_size, mesh.model_rank
    rows = slice(BLOCK * j, BLOCK * (j + 1))
    xs = {name: _special(dt, (2, 3, BLOCK * m, 5))[:, :, rows]
          .contiguous(memory_format=torch.channels_last)
          for name, dt in DTYPES.items()}
    x8 = _int8_whole(m)[:, rows].contiguous()
    out = {}
    for form in ("neighbours", "slots"):
        fm = dataclasses.replace(mesh, exchange=form)
        got = {}
        for top, bottom in HALOS:
            for pad in (7, None):
                for name, x in xs.items():
                    COUNTS.clear()
                    COUNTS_BYTES.clear()
                    got[name, top, bottom, pad] = (
                        halo_rows(x, 2, top, bottom, fm, pad),
                        COUNTS["halo"], COUNTS_BYTES["halo"])
                COUNTS.clear()
                COUNTS_BYTES.clear()
                got["int8", top, bottom, pad] = (
                    halo_rows(x8, 1, top, bottom, fm,
                              None if pad is None else -128),
                    COUNTS["halo"], COUNTS_BYTES["halo"])
        for name, x in list(xs.items()) + [("int8", x8)]:
            dim = 1 if name == "int8" else 2
            COUNTS.clear()
            COUNTS_BYTES.clear()
            got["gather", name] = (gather_height(x, fm, dim),
                                   COUNTS["gather"], COUNTS_BYTES["gather"])
        for lift in (False, True):
            COUNTS.clear()
            COUNTS_BYTES.clear()
            got["keypoints", lift] = (split_soft_argmax(
                _heatmap(m, lift)[:, 8 * j:8 * (j + 1)], fm),
                COUNTS["keypoints"], COUNTS_BYTES["keypoints"])
        out[form] = got
    return out


def _rank_cdr(inp, mesh):
    """CDRNet-18 at CDR_PX on this rank's rows, its exchanges and bytes."""
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.parallel.mesh import (COUNTS, COUNTS_BYTES,
                                                   replicate,
                                                   shard_batch_spatial)
    cdr = CDRNet(num_layers=18)
    cdr.load_state_dict(inp["cdr_sd"], strict=True)
    replicate(mesh, cdr.eval())
    b = shard_batch_spatial(mesh, {"image": inp["cdr_img"],
                                   "proj": inp["cdr_proj"]})
    COUNTS.clear()
    COUNTS_BYTES.clear()
    with torch.inference_mode():
        kp, p3, hm = cdr(b["image"], b["proj"], return_heatmaps=True)
    return {"kp": kp, "p3": p3, "hm": hm, "counts": dict(COUNTS),
            "bytes": dict(COUNTS_BYTES)}


def _rank_pose(inp, mesh):
    """PoseResNet-18 at POSE_PX on this rank's rows of its data group's
    images."""
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.parallel.mesh import (COUNTS, replicate,
                                                   shard_batch_spatial)
    pose = PoseResNet(num_joints=J2D, num_layers=18)
    pose.load_state_dict(inp["pose_sd"], strict=True)
    replicate(mesh, pose.eval())
    per = len(inp["pose_img"]) // mesh.size
    b = shard_batch_spatial(mesh, {"image": inp["pose_img"][
        mesh.rank * per:(mesh.rank + 1) * per]})
    COUNTS.clear()
    with torch.inference_mode():
        hm = pose(b["image"])
    return {"hm": hm, "counts": dict(COUNTS)}


def _rank_int8(inp, mesh):
    """The int8 CDRNet-18 at INT8_PX on JAX's pack, every requant
    recorded."""
    from fast3dhpe_tpu_torch.models import quantized as qz
    from fast3dhpe_tpu_torch.ops import quant as Q
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS, replicate, \
        shard_batch_spatial
    model = replicate(mesh, qz.cdrnet_int8(qz.load_pack(inp["pack_path"]),
                                           device="cpu"))
    b = shard_batch_spatial(mesh, {"image": inp["int8_img"],
                                   "proj": inp["int8_proj"]})
    codes, orig = [], Q.requant

    def recorded(y, s):
        q = orig(y, s)
        codes.append(q)
        return q

    Q.requant = recorded
    COUNTS.clear()
    try:
        with torch.inference_mode():
            kp, p3, hm = model(b["image"], b["proj"], return_heatmaps=True)
    finally:
        Q.requant = orig
    return {"kp": kp, "p3": p3, "hm": hm, "codes": codes,
            "counts": dict(COUNTS)}


def _rank_main(layout, rank, work):
    d, m = LAYOUTS[layout]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(d * m),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    assert init_distributed(backend="gloo", device="cpu",
                            init_method="file://" + os.path.join(
                                work, "store"), timeout=CHILD_TIMEOUT)
    try:
        mesh = make_mesh(model_parallel=m, exchange="neighbours")
        inp = torch.load(os.path.join(work, "inp.pt"), weights_only=False)
        out = {"mesh": (mesh.rank, mesh.size, mesh.model_rank,
                        mesh.model_size, mesh.exchange),
               "default": make_mesh(model_parallel=m).exchange}
        if layout in EXCHANGE_LAYOUTS:
            out["exchanges"] = _rank_exchanges(mesh)
        if layout == "m2":
            out["int8"] = _rank_int8(inp, mesh)
        if layout == "m4":
            out["cdr"] = _rank_cdr(inp, mesh)
        if layout == "d2m2":
            out["pose"] = _rank_pose(inp, mesh)
        torch.save(out, os.path.join(work, f"out_{rank}.pt"))
    finally:
        destroy_distributed()


# --------------------------------------------------------- test process

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spawn(layout, work):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST") and k not in
           ("RANK", "WORLD_SIZE", "LOCAL_RANK", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    d, m = LAYOUTS[layout]
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), layout, str(r),
         str(work)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(d * m)]


def _wait(procs):
    """Wait for every layout's ranks; on a failure or the timeout kill
    them all and name the rank."""
    logs = {}
    try:
        for key, p in procs:
            logs[key] = p.communicate(timeout=CHILD_TIMEOUT)[0]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for key, p in procs:
        assert p.returncode == 0, f"{key} failed:\n{logs.get(key, '')[-4000:]}"


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's ranks, spawned together once JAX's variables and
    pack are written; JAX's unsharded forwards run meanwhile."""
    r = np.random.RandomState(12)
    cdr = JaxCDRNet(num_layers=18)
    v = _np(jax.jit(cdr.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)),
        jnp.asarray(_rig(1, 64)), train=False))
    head = v["params"]["decoder"]["final_layer"]
    head["kernel"] = head["kernel"] * 50.0     # the views decode apart
    head["bias"] = head["bias"] + np.random.RandomState(3).randn(J).astype(
        np.float32)
    pose = JaxPoseResNet(num_joints=J2D, num_layers=18)
    pv = _np(jax.jit(pose.init, static_argnames=("train",))(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)), train=False))
    cdr_img = r.randn(1, 2, CDR_PX, CDR_PX, 3).astype(np.float32)
    int8_img = r.randn(2, 2, INT8_PX, INT8_PX, 3).astype(np.float32)
    pose_img = r.randn(4, POSE_PX, POSE_PX, 3).astype(np.float32)
    int8_proj = _rig(2, INT8_PX)
    jpack = _np(jqz.quantize_cdrnet(v, [(jnp.asarray(int8_img),
                                         jnp.asarray(int8_proj))]))
    works = {layout: tmp_path_factory.mktemp(layout) for layout in LAYOUTS}
    for work in works.values():
        jqz.save_pack(str(work / "jax_pack.npz"), jpack)
        torch.save({"cdr_sd": jax_variables_to_state_dict(v),
                    "pose_sd": jax_variables_to_state_dict(pv),
                    "cdr_img": torch.from_numpy(cdr_img),
                    "cdr_proj": torch.from_numpy(_rig(1, CDR_PX)),
                    "int8_img": torch.from_numpy(int8_img),
                    "int8_proj": torch.from_numpy(int8_proj),
                    "pose_img": torch.from_numpy(pose_img),
                    "pack_path": str(work / "jax_pack.npz")},
                   work / "inp.pt")
    procs = [((layout, rank), p) for layout, work in works.items()
             for rank, p in enumerate(_spawn(layout, work))]
    try:
        kp, p3, hm = cdr.apply(v, jnp.asarray(cdr_img),
                               jnp.asarray(_rig(1, CDR_PX)), train=False,
                               return_heatmaps=True)
        ref = {"cdr_kp": np.asarray(kp), "cdr_p3": np.asarray(p3),
               "cdr_hm": np.asarray(hm),
               "pose_hm": np.asarray(pose.apply(pv, jnp.asarray(pose_img),
                                                train=False))}
        (kp8, p38, hm8), codes = _recorded(JQ, lambda: jqz.cdrnet_int8_apply(
            jpack, jnp.asarray(int8_img), jnp.asarray(int8_proj), depth=18,
            return_heatmaps=True))
        ref["int8"] = {"kp": np.asarray(kp8), "p3": np.asarray(p38),
                       "hm": np.asarray(hm8), "codes": codes}
    finally:
        _wait(procs)
    return {"ref": ref, "outs": {
        layout: [torch.load(work / f"out_{rank}.pt", weights_only=False)
                 for rank in range(np.prod(LAYOUTS[layout]))]
        for layout, work in works.items()}}


def _layouts(*names):
    return pytest.mark.parametrize("layout", names or list(LAYOUTS))


@_layouts()
def test_mesh_records_the_form(runs, layout):
    """Rank r: data index r // M, model index r % M, the form asked for;
    over gloo make_mesh picks the slot form by itself."""
    d, m = LAYOUTS[layout]
    for r, out in enumerate(runs["outs"][layout]):
        assert out["mesh"] == (r // m, d, r % m, m, "neighbours")
        assert out["default"] == "slots"


def _halo_want(name, m, j, top, bottom, pad):
    """This rank's rows of the whole tensor with `top` rows above and
    `bottom` below, the pad value (or nothing) beyond the global edge."""
    if name == "int8":
        whole, dim, pad = _int8_whole(m), 1, None if pad is None else -128
    else:
        whole, dim = _special(DTYPES[name], (2, 3, BLOCK * m, 5)), 2
    lo, hi = BLOCK * j - top, BLOCK * (j + 1) + bottom
    pieces = []
    if lo < 0 and pad is not None:
        shape = list(whole.shape)
        shape[dim] = -lo
        pieces.append(torch.full(shape, pad, dtype=whole.dtype))
    pieces.append(whole.narrow(dim, max(lo, 0),
                               min(hi, whole.shape[dim]) - max(lo, 0)))
    if hi > whole.shape[dim] and pad is not None:
        shape = list(whole.shape)
        shape[dim] = hi - whole.shape[dim]
        pieces.append(torch.full(shape, pad, dtype=whole.dtype))
    return torch.cat(pieces, dim)


@_layouts(*EXCHANGE_LAYOUTS)
@pytest.mark.parametrize("name", ["fp32", "bf16", "int8"])
def test_halo_rows_neighbours_bit_equal_slots(runs, layout, name):
    """halo_rows in the neighbour form is the slot form bit for bit, and
    both are the whole tensor's rows around the rank's block: halos of 1,
    2 and 3 rows above and below, at the top, bottom and interior ranks,
    the pad value at the global edge or nothing there; fp32 and bf16
    NCHW in channels_last memory with -0.0, NaN, inf and subnormals, int8
    NHWC along dim 1; one exchange a halo."""
    m = LAYOUTS[layout][1]
    for j, out in enumerate(runs["outs"][layout]):
        nb, sl = out["exchanges"]["neighbours"], out["exchanges"]["slots"]
        for top, bottom in HALOS:
            for pad in (7, None):
                key = (name, top, bottom, pad)
                want = _halo_want(name, m, j, top, bottom, pad)
                assert nb[key][1] == sl[key][1] == 1, key
                assert torch.equal(_bits(nb[key][0]), _bits(sl[key][0])), key
                assert torch.equal(_bits(nb[key][0]), _bits(want)), key
                if name != "int8":
                    assert nb[key][0].is_contiguous(
                        memory_format=torch.channels_last), key


@_layouts(*EXCHANGE_LAYOUTS)
def test_halo_bytes_are_the_edge_rows(runs, layout):
    """COUNTS_BYTES of a halo: in the neighbour form exactly the edge rows
    this rank sends (its last `top` rows where a rank lies below, its
    first `bottom` rows where one lies above), (top + bottom) rows at an
    interior rank; in the slot form M slots of the two edges' int32
    words, M times an interior rank's neighbour bytes where the rows fill
    whole words."""
    m = LAYOUTS[layout][1]
    rows = {"fp32": 2 * 3 * 5 * 4, "bf16": 2 * 3 * 5 * 2, "int8": 2 * 5 * 3}
    for j, out in enumerate(runs["outs"][layout]):
        nb, sl = out["exchanges"]["neighbours"], out["exchanges"]["slots"]
        for key, (_, _, sent) in nb.items():
            if key[0] not in rows:
                continue                  # the gathers and keypoints
            name, top, bottom, pad = key
            row = rows[name]
            want = ((top if j < m - 1 else 0)
                    + (bottom if j > 0 else 0)) * row
            assert sent == want, (name, top, bottom, j)
            slot = -(-(top + bottom) * row // 4) * 4
            assert sl[name, top, bottom, pad][2] == m * slot
            if 0 < j < m - 1 and (top + bottom) * row % 4 == 0:
                assert m * sent == sl[name, top, bottom, pad][2]


@_layouts(*EXCHANGE_LAYOUTS)
def test_gather_and_keypoints_neighbours_bit_equal_slots(runs, layout):
    """gather_height (fp32, bf16, int8) and split_soft_argmax (with and
    without model rank 1's logits 120 above the rest) in the neighbour
    form, one all_gather each, bit for bit the slot form's, the gather
    the whole tensor; an all_gather sends the rank's own part once."""
    m = LAYOUTS[layout][1]
    outs = runs["outs"][layout]
    for out in outs:
        nb, sl = out["exchanges"]["neighbours"], out["exchanges"]["slots"]
        for name in ("fp32", "bf16", "int8"):
            whole = (_int8_whole(m) if name == "int8" else
                     _special(DTYPES[name], (2, 3, BLOCK * m, 5)))
            got, n, sent = nb["gather", name]
            assert n == sl["gather", name][1] == 1
            assert torch.equal(_bits(got), _bits(sl["gather", name][0]))
            assert torch.equal(_bits(got), _bits(whole))
            assert sent == whole.numel() * whole.element_size() // m
        for lift in (False, True):
            got, n, sent = nb["keypoints", lift]
            assert n == 1 and torch.equal(got, sl["keypoints", lift][0])
            assert torch.equal(got, outs[0]["exchanges"]["neighbours"][
                "keypoints", lift][0])
            assert sent == 2 * 3 * 4 * 4      # (N, J, (m, 1/S, cx, cy)) fp32


def test_cdrnet_m4_matches_jax(runs):
    """CDRNet-18 at 128 px over M = 4 in the neighbour form against JAX's
    unsharded forward: keypoints atol 1e-3 px, bit-equal on every model
    rank, heatmap rows within 1e-4 of their largest value; 21 halos and
    one keypoint combine a forward."""
    ref, outs = runs["ref"], [o["cdr"] for o in runs["outs"]["m4"]]
    for o in outs[1:]:
        assert torch.equal(o["kp"], outs[0]["kp"])
        assert torch.equal(o["p3"], outs[0]["p3"])
    hm = torch.cat([o["hm"] for o in outs], 2).numpy()
    assert np.abs(hm - ref["cdr_hm"]).max() < 1e-4 * np.abs(
        ref["cdr_hm"]).max()
    kp = outs[0]["kp"].numpy()
    np.testing.assert_allclose(kp, ref["cdr_kp"], atol=1e-3)
    assert kp.std() > 1.0
    for o in outs:
        assert o["counts"] == {"halo": HALOS_18, "keypoints": 1}
        assert o["bytes"]["keypoints"] == 2 * J * 4 * 4


def test_cdrnet_halo_bytes_shrink_with_the_edge(runs):
    """A forward's halo bytes in the neighbour form: an edge rank of M = 4
    sends less than an interior one (one side against two)."""
    sent = [o["cdr"]["bytes"]["halo"] for o in runs["outs"]["m4"]]
    assert sent[1] == sent[2] > max(sent[0], sent[3]) > 0


def test_poseresnet_d2m2_matches_jax(runs):
    """PoseResNet-18 at 64 px over data 2 x model 2 in the neighbour form:
    the model ranks' rows together, the data groups' images in order,
    against JAX's unsharded forward (rtol 1e-4, atol 1e-5); 21 halos a
    forward and no other exchange."""
    outs = [o["pose"] for o in runs["outs"]["d2m2"]]
    got = torch.cat([torch.cat([outs[2 * g]["hm"], outs[2 * g + 1]["hm"]], 1)
                     for g in range(2)], 0)
    np.testing.assert_allclose(got.numpy(), runs["ref"]["pose_hm"],
                               rtol=1e-4, atol=1e-5)
    for o in outs:
        assert o["counts"] == {"halo": HALOS_18}


def test_int8_m2_matches_jax(runs):
    """Int8 CDRNet-18 at 64 px over M = 2 in the neighbour form on JAX's
    pack against JAX's cdrnet_int8_apply: every code before cf_out
    bit-equal row by row, cf_out within CF_FLIPS, heatmaps, pred_2d
    (1e-2 px) and pred_3d within tests/test_torch_quantized.py's bounds;
    pred_2d bit-equal across the model ranks."""
    ref = runs["ref"]["int8"]
    outs = [o["int8"] for o in runs["outs"]["m2"]]
    m = 2
    assert torch.equal(outs[1]["kp"], outs[0]["kp"])
    cf = len(ref["codes"]) - 4
    for j, out in enumerate(outs):
        assert out["counts"] == {"halo": HALOS_18, "keypoints": 1}
        assert len(out["codes"]) == len(ref["codes"]) == 22
        for i, (a, b) in enumerate(zip(out["codes"], ref["codes"])):
            h = b.shape[1] // m
            want = b[:, j * h:(j + 1) * h]
            if i == cf:
                diff = a.numpy().astype(int) - want
                assert (diff != 0).sum() <= CF_FLIPS * want.size
                assert np.abs(diff).max() <= 1
            elif i < cf:
                np.testing.assert_array_equal(a.numpy(), want)
    hm = torch.cat([o["hm"] for o in outs], 2).numpy()
    assert np.abs(hm - ref["hm"]).max() <= 0.05 * np.abs(ref["hm"]).max()
    assert np.abs(outs[0]["kp"].numpy() - ref["kp"]).max() < 1e-2
    assert (np.abs(outs[0]["p3"].numpy() - ref["p3"]).max()
            <= 1e-2 * np.abs(ref["p3"]).max())


# ------------------------------------------------- the backend's choices

@pytest.fixture
def fake_group(monkeypatch):
    """A process group of one rank on the CPU, as make_mesh reads it."""
    from fast3dhpe_tpu_torch.parallel import distributed, mesh as pmesh
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(pmesh.dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(distributed, "_RANK_DEVICE", torch.device("cpu"))
    return pmesh


@pytest.mark.parametrize("backend,form", [("gloo", "slots"),
                                          ("nccl", "neighbours")])
def test_make_mesh_takes_the_backends_form(fake_group, monkeypatch,
                                           backend, form):
    """make_mesh records NCCL's neighbour form and gloo's slot form; an
    explicit exchange= wins over the backend's; another backend or form
    raises, naming the choice."""
    monkeypatch.setattr(fake_group.dist, "get_backend",
                        lambda group=None: backend)
    assert fake_group.make_mesh().exchange == form
    other = "slots" if form == "neighbours" else "neighbours"
    assert fake_group.make_mesh(exchange=other).exchange == other
    with pytest.raises(ValueError, match="exchange='bogus'"):
        fake_group.make_mesh(exchange="bogus")
    monkeypatch.setattr(fake_group.dist, "get_backend",
                        lambda group=None: "mpi")
    with pytest.raises(ValueError, match="'mpi'"):
        fake_group.make_mesh()
    assert fake_group.make_mesh(exchange=form).exchange == form


def test_init_distributed_passes_timeout_and_device_id(monkeypatch):
    """init_distributed(timeout=s) reaches init_process_group as a
    timedelta; under NCCL on a card it also names the card (device_id,
    after set_device), and gloo on the CPU gets no device_id."""
    from fast3dhpe_tpu_torch.parallel import distributed
    calls, order = [], []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw))
                        or order.append("init"))
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    try:
        assert distributed.init_distributed(device="cpu", timeout=90)
        (backend,), kw = calls[-1]
        assert backend == "gloo" and "device_id" not in kw
        assert kw["timeout"] == datetime.timedelta(seconds=90)
        assert kw["rank"] == 1 and kw["world_size"] == 2
        card = torch.device("cuda", 1)
        monkeypatch.setattr(distributed, "_rank_device",
                            lambda device, local_rank: card)
        monkeypatch.setattr(distributed.torch.cuda, "set_device",
                            lambda d: order.append(("set_device", d)))
        assert distributed.init_distributed(timeout=120)
        (backend,), kw = calls[-1]
        assert backend == "nccl" and kw["device_id"] == card
        assert kw["timeout"] == datetime.timedelta(seconds=120)
        assert order[-2:] == [("set_device", card), "init"]
        assert distributed.init_distributed(backend="gloo",
                                            device="cuda:1")
        assert "device_id" not in calls[-1][1]
        assert "timeout" not in calls[-1][1]
        assert distributed.rank_device() == card
    finally:
        distributed._RANK_DEVICE = None


@pytest.mark.parametrize("backend,want", [("nccl", [[3]]), ("gloo", [None])])
def test_barrier_names_the_card_under_nccl(monkeypatch, backend, want):
    """barrier(mesh) passes device_ids=[the mesh's card] under NCCL, and
    nothing under gloo; it is counted either way."""
    from fast3dhpe_tpu_torch.parallel import mesh as pmesh
    seen = []
    monkeypatch.setattr(pmesh.dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(pmesh.dist, "barrier",
                        lambda device_ids=None: seen.append(device_ids))
    pmesh.COUNTS.clear()
    pmesh.barrier(pmesh.Mesh(None, 0, 1, torch.device("cuda", 3)))
    pmesh.barrier(None)
    assert seen == want and pmesh.COUNTS["barrier"] == 1


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    sys.exit(0)
