"""The training loops, the loaders and the device frame cache of the
PyTorch port on a (data, model) mesh with M > 1 model ranks
(fast3dhpe_tpu_torch/train/loop_cdr.py and loop2d.py run(config, mesh)),
against the same loops at M = 1 and the JAX package's single-process loop,
on the CPU.

The JAX loops take any mesh and train whole images on its D data shards,
replicated over the model axis (nothing there calls shard_batch_spatial).
The port does the same: the records are sharded by the data index, the
model is replicated without the spatial split, and every reduction runs
over the data group, so the M model ranks of a data group run the same
steps on the same rows.

Four layouts of gloo ranks, each rank a subprocess that runs this file as
a script (`python tests/test_torch_spatial_loops.py <case> <rank> <dir>`),
meeting through a file:// store in the test's temporary directory, one
thread each, all spawned together by one module fixture while JAX's loop
runs in the test process:
- "cdr_d2m2": loop_cdr.run on D = 2 x M = 2 (4 ranks, 4 pairs a rank);
- "cdr_d2m1": the same loop on the 2 data ranks at M = 1;
- "2d_d1m2": loop2d.run on D = 1 x M = 2, the tree whole in the device
  frame cache, so by segments;
- "2d_d1m1": the same loop on one rank at M = 1.

Tolerances (each test names its own):
- 2 x 2 against 2 x 1 and 1 x 2 against 1 x 1: bit-equal histories (but
  the throughput), final weights and latest.pth (every reduction sums the
  same data group's values in the same order, or is an identity);
- the model ranks of a data group: bit-equal histories and weights;
- against JAX's single-process loop at the global batch of 8, from the
  same init: tests/test_distributed_real.py's tolerances (warmup
  train_loss rtol 1e-4, after it 5e-2; val_mpjpe_2d 1e-2; warmup val_loss
  1e-2; the 3D figures finite, positive and within one decade).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# The ranks run this file as a script and need no JAX.
if __name__ != "__main__":
    import jax
    from fast3dhpe_tpu.config import config_from_dict as jax_config
    from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
    from fast3dhpe_tpu.train import loop_cdr as jax_loop_cdr
    from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
    from test_torch_distributed import _cli_dict, _jax_loop_init, _np

    torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# case -> (loop, data groups D, model ranks M)
CASES = {"cdr_d2m2": ("cdr", 2, 2), "cdr_d2m1": ("cdr", 2, 1),
         "2d_d1m2": ("2d", 1, 2), "2d_d1m1": ("2d", 1, 1)}
CHILD_TIMEOUT = 600


def _rel(root, rec):
    return os.path.relpath(rec.get("image_left", rec.get("image")), root)


# --------------------------------------------------------------- ranks

def _rank_main(case, rank, work):
    kind, d, m = CASES[case]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(d * m),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from fast3dhpe_tpu_torch.config import config_from_dict
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train import loop2d, loop_cdr
    assert init_distributed(backend="gloo", device="cpu",
                            init_method="file://" + os.path.join(
                                work, f"{case}.store"))
    try:
        mesh = make_mesh(model_parallel=m)
        loop = loop_cdr if kind == "cdr" else loop2d
        with open(os.path.join(work, f"{kind}.json")) as f:
            cfg = json.load(f)
        models, loaders = [], []
        init, load = loop._init_model, loop.load_data

        def init_model(config, seed):
            model = init(config, seed)
            if kind == "cdr":       # JAX's init of its loop
                model.load_state_dict(torch.load(
                    os.path.join(work, "cdr_init.pt"), weights_only=True),
                    strict=True)
            models.append(model)
            return model

        def load_data(config, **kw):
            out = load(config, **kw)
            loaders.extend(out)
            return out

        loop._init_model, loop.load_data = init_model, load_data
        hist = loop.run(config_from_dict(cfg), mesh=mesh, overwrite=True,
                        seed=0, weights_root=os.path.join(
                            work, f"w_{case}_{rank}"), device="cpu")
        root = cfg["DATASET"]["ROOT"]
        torch.save({
            "mesh": (mesh.rank, mesh.size, mesh.model_rank, mesh.model_size),
            "hist": hist, "counts": dict(COUNTS),
            "state": {k: v.clone() for k, v in
                      models[0].state_dict().items()},
            "spatial": models[0].spatial,
            "records": [[_rel(root, r) for r in ld.records]
                        for ld in loaders],
            "batches": [len(ld) for ld in loaders],
            "cached": [ld.device_cached for ld in loaders]},
            os.path.join(work, f"out_{case}_{rank}.pt"))
    finally:
        destroy_distributed()


# --------------------------------------------------------- test process

def _spawn(case, work):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST") and k not in
           ("RANK", "WORLD_SIZE", "LOCAL_RANK", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    _, d, m = CASES[case]
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r),
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


def _dict_2d(root):
    """tests/test_torch_distributed.py's tiny 2D loop config, the tree
    whole in the device frame cache."""
    return {
        "DATASET": {"TYPE": "MADS_2d", "ROOT": str(root),
                    "OCCLUSION": "None", "DEVICE_CACHE_BYTES": 1 << 30},
        "MODEL": {"NAME": "pose", "NUM_LAYERS": 18, "IMAGE_SIZE": [64, 64],
                  "PRETRAINED": "",
                  "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}},
        "TRAIN": {"BATCH_SIZE": 4, "EPOCH": 2, "WARMUP": 1, "LR": 1e-3,
                  "LR_STEP": [40], "LR_FACTOR": 0.1},
        "TEST": {"BATCH_SIZE": 4},
        "LOSS": {"TYPE": "JointsMSE", "USE_TARGET_WEIGHT": True}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks, spawned together, and JAX's single-process CDR
    loop at the global batch (8 pairs) from the same init meanwhile."""
    work = tmp_path_factory.mktemp("loops")
    root = work / "mads"
    # tests/test_distributed_real.py's tree: 256x192 frames, 6 records a
    # split (smaller frames project the joints out of bounds)
    make_synthetic_mads(str(root), n_frames=6, img_w=256, img_h=192)
    cfg = _cli_dict(root, 4, "dist")
    with open(work / "cdr.json", "w") as f:
        json.dump(cfg, f)
    with open(work / "2d.json", "w") as f:
        json.dump(_dict_2d(root), f)
    jcfg = jax_config(_cli_dict(root, 8, "single"))
    init = _jax_loop_init(jcfg)
    torch.save(jax_variables_to_state_dict(init), work / "cdr_init.pt")
    procs = {case: _spawn(case, work) for case in CASES}
    try:
        def merge(variables, _pretrained):
            assert (jax.tree_util.tree_structure(_np(variables))
                    == jax.tree_util.tree_structure(init))
            return init

        jcfg.MODEL.PRETRAINED = "jax-init"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_loop_cdr, "load_variables", lambda path: None)
            mp.setattr(jax_loop_cdr, "merge_encoder_only", merge)
            ref = jax_loop_cdr.run(jcfg, overwrite=True, seed=0,
                                   weights_root=str(work / "w_jax"))
    finally:
        for case, ps in procs.items():
            _wait(ps, case)
    outs = {case: [torch.load(work / f"out_{case}_{r}.pt",
                              weights_only=False)
                   for r in range(CASES[case][1] * CASES[case][2])]
            for case in CASES}
    return {"work": work, "root": root, "jax": ref, "outs": outs}


def _same_hist(a, b):
    for k in a:
        if not k.endswith("_per_sec"):
            assert a[k] == b[k], k


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_mesh_layouts(runs):
    """Rank r of a (D, M) mesh: data index r // M, model index r % M."""
    for case, outs in runs["outs"].items():
        _, d, m = CASES[case]
        for r, out in enumerate(outs):
            assert out["mesh"] == (r // m, d, r % m, m), case


def test_records_sharded_by_data_index(runs):
    """Each rank loads its data shard, records[index::D] of the index
    (rank r of D x M: data index r // M), the same records on the M model
    ranks of a data group and the same as the M = 1 rank of that index;
    every rank runs the lockstep batches of the largest shard. At D = 1
    the whole index, with the device frame cache on; the D = 2 CDR
    config sets no cache budget, so its loaders make their batches from
    the host."""
    from fast3dhpe_tpu_torch.data.mads import (build_mads_index,
                                               build_mads_stereo_index)
    root = runs["root"]
    index = {s: [_rel(str(root), r) for r in
                 build_mads_stereo_index(str(root), s)]
             for s in ("train", "valid")}
    mono = [[_rel(str(root), r) for r in build_mads_index(str(root), s)]
            for s in ("train", "valid")]
    d2m2, d2m1 = runs["outs"]["cdr_d2m2"], runs["outs"]["cdr_d2m1"]
    for r, out in enumerate(d2m2):
        di = r // 2
        assert out["records"] == [index["train"][di::2],
                                  index["valid"][di::2]]
        assert out["records"] == d2m1[di]["records"]
        assert out["batches"] == d2m1[di]["batches"] == [1, 1]
        assert out["cached"] == [False, False]
    for out in runs["outs"]["2d_d1m2"] + runs["outs"]["2d_d1m1"]:
        assert out["records"] == mono
        assert out["cached"] == [True, True]


def test_model_ranks_agree(runs):
    """The model ranks of a data group (and every rank, whose histories
    are the global batch's) end with bit-equal histories and weights."""
    for case in ("cdr_d2m2", "2d_d1m2"):
        outs = runs["outs"][case]
        for out in outs[1:]:
            _same_hist(out["hist"], outs[0]["hist"])
        _, _, m = CASES[case]
        for g in range(len(outs) // m):
            for out in outs[g * m + 1:(g + 1) * m]:
                _same_state(out["state"], outs[g * m]["state"])


def test_cdr_loop_2x2_bit_equal_to_2x1(runs):
    """loop_cdr.run on D = 2 x M = 2 against the same loop on the two data
    ranks at M = 1: histories (but the throughput), every rank's final
    weights and rank 0's latest.pth bit-equal."""
    d2m2, d2m1 = runs["outs"]["cdr_d2m2"], runs["outs"]["cdr_d2m1"]
    assert d2m2[0]["hist"]["train_loss"][0] > 1e-5
    for r, out in enumerate(d2m2):
        _same_hist(out["hist"], d2m1[r // 2]["hist"])
        _same_state(out["state"], d2m1[r // 2]["state"])
    work = runs["work"]
    _same_state(*[torch.load(work / f"w_{case}_0" / "dist" / "latest.pth",
                             weights_only=True)
                  for case in ("cdr_d2m2", "cdr_d2m1")])


def test_cdr_loop_on_mesh_matches_jax_loop(runs):
    """The 2 x 2 loop (4 pairs a rank) against JAX's single-process
    loop_cdr.run at 8 from the same init, with
    tests/test_distributed_real.py's tolerances."""
    h0, ref = runs["outs"]["cdr_d2m2"][0]["hist"], runs["jax"]
    assert h0["grad_norm"][0] > 1e-5
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


def test_2d_loop_1x2_matches_m1(runs):
    """loop2d.run on D = 1 x M = 2 from the device frame cache against
    the same loop on one rank at M = 1: histories (but the throughput) and
    final weights bit-equal, since each reduction is over a data group of
    one rank; the loss moves."""
    one = runs["outs"]["2d_d1m1"][0]
    h = one["hist"]
    assert h["train_loss"][0] > 0 and h["train_acc"][0] >= 0
    assert h["train_loss"][-1] != h["train_loss"][0]
    for out in runs["outs"]["2d_d1m2"]:
        _same_hist(out["hist"], h)
        _same_state(out["state"], one["state"])


def test_loops_train_whole_images(runs):
    """On the mesh the loops install no spatial split (the models'
    `spatial` stays None) and make no halo, gather or keypoint exchange;
    global rank 0 alone writes checkpoints (latest; the CDR loop no best
    before its warmup ends), after one barrier of the world."""
    work = runs["work"]
    for case, outs in runs["outs"].items():
        for r, out in enumerate(outs):
            assert out["spatial"] is None
            assert not {"halo", "gather", "keypoints"} & set(out["counts"])
            assert out["counts"]["barrier"] == 1
            name = "dist" if case.startswith("cdr") else "pose"
            wr = work / f"w_{case}_{r}"
            if r == 0:
                assert {"latest.opt.pt", "latest.pth"} <= set(
                    os.listdir(wr / name))
                assert case != "cdr_d2m2" or "best.pth" not in os.listdir(
                    wr / name)
            else:
                assert not wr.exists() or list(wr.rglob("*")) == []


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    sys.exit(0)
