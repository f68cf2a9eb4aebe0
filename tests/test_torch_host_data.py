"""The PyTorch port's host data (fast3dhpe_tpu_torch/data/mads.py, mpii.py,
synthetic.py, and loader.py's _partial_epoch_schedule and _prefetch)
against the JAX package's, on the CPU on small synthetic trees.

Tolerance: none. Index records, the synthetic tree's files and the partial
schedule are bit-equal to JAX's (the MADS 2D joints too: the port projects
with XLA's order of fused multiply-adds)."""

import filecmp
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from fast3dhpe_tpu.data import loader as jax_loader
from fast3dhpe_tpu.data import mads as jax_mads
from fast3dhpe_tpu.data import mpii as jax_mpii
from fast3dhpe_tpu.data import synthetic as jax_synthetic
from fast3dhpe_tpu_torch.data import loader, mads, mpii, synthetic

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same small MADS and MPII trees written by both packages; an MPII
    `test` split without joints beside them."""
    out = {}
    for name, mod in (("jax", jax_synthetic), ("port", synthetic)):
        root = tmp_path_factory.mktemp(name)
        mod.make_synthetic_mads(str(root / "mads"), n_frames=8, img_w=128,
                                img_h=96, movements=("HipHop", "Jazz"),
                                nan_joint_every=3)
        mod.make_synthetic_mpii(str(root / "mpii"), n_train=6, n_valid=3)
        out[name] = root
    for root in out.values():
        with open(root / "mpii" / "annot" / "valid.json") as f:
            entries = json.load(f)
        test = [{k: v for k, v in e.items()
                 if k not in ("joints", "joints_vis")} for e in entries]
        test[0]["center"] = [-1, -1]            # no centre: no fixup
        with open(root / "mpii" / "annot" / "test.json", "w") as f:
            json.dump(test, f)
    return out


def _records_equal(a, b):
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k, va in ra.items():
            if isinstance(va, np.ndarray):
                assert va.dtype == rb[k].dtype, k
                assert va.shape == rb[k].shape, k
                np.testing.assert_array_equal(rb[k], va, err_msg=k)
            else:
                assert va == rb[k], k


def test_synthetic_trees_are_byte_equal(trees):
    """The port's writer makes JAX's tree: every JSON and JPEG file."""
    jroot, proot = trees["jax"], trees["port"]
    n = 0
    for dirpath, _, names in os.walk(jroot):
        for name in names:
            path = os.path.join(dirpath, name)
            twin = os.path.join(proot, os.path.relpath(path, jroot))
            assert filecmp.cmp(path, twin, shallow=False), twin
            n += 1
    assert n == 2 * 2 * 8 * 3 + 9 + 3       # MADS + MPII images + annots


@pytest.mark.parametrize("image_set", ["train", "valid"])
def test_mads_stereo_index_matches_jax(trees, image_set):
    root = str(trees["jax"] / "mads")
    recs = mads.build_mads_stereo_index(root, image_set)
    _records_equal(jax_mads.build_mads_stereo_index(root, image_set), recs)
    vis = np.stack([r["joints_vis"] for r in recs])
    assert vis.dtype == bool and vis.shape[1:] == (19, 1)
    assert 0 < (~vis).sum() < vis.size      # the NaN joints, zeroed
    assert np.isfinite(np.stack([r["pose_3d"] for r in recs])).all()


@pytest.mark.parametrize("image_set", ["train", "valid"])
def test_mads_2d_index_matches_jax(trees, image_set):
    root = str(trees["jax"] / "mads")
    recs = mads.build_mads_index(root, image_set)
    _records_equal(jax_mads.build_mads_index(root, image_set), recs)
    assert all(r["image"].endswith(".jpg") and "/right/" in r["image"]
               for r in recs)


@pytest.mark.parametrize("image_set", ["train", "valid", "test"])
def test_mpii_index_matches_jax(trees, image_set):
    root = str(trees["jax"] / "mpii")
    recs = mpii.build_mpii_index(root, image_set)
    _records_equal(jax_mpii.build_mpii_index(root, image_set), recs)
    if image_set == "test":
        assert not any(r["joints"].any() or r["joints_vis"].any()
                       for r in recs)
        with open(os.path.join(root, "annot", "test.json")) as f:
            scale = json.load(f)[0]["scale"]
        # no centre: only the 1-based -> 0-based shift
        assert recs[0]["center"].tolist() == [-2.0, -2.0]
        assert recs[0]["scale"].tolist() == [scale, scale]


def test_skeleton_constants_match_jax():
    assert mads.MADS_FLIP_PAIRS == jax_mads.MADS_FLIP_PAIRS
    assert mads.MADS_PARENT_IDS == jax_mads.MADS_PARENT_IDS
    assert mpii.MPII_FLIP_PAIRS == jax_mpii.MPII_FLIP_PAIRS
    assert mpii.MPII_PARENT_IDS == jax_mpii.MPII_PARENT_IDS


def test_missing_tree_names_extract_data(tmp_path):
    for build in (mads.build_mads_index, mads.build_mads_stereo_index):
        with pytest.raises(FileNotFoundError, match="extract_data"):
            build(str(tmp_path), "train")


# n records, batch size, which records are resident, train
SCHEDULES = [
    (10, 4, "none", True), (10, 4, "all", True), (10, 4, "half", True),
    (10, 4, "half", False), (7, 3, "odd", True), (7, 3, "odd", False),
    (32, 8, "prefix", True), (33, 8, "prefix", True), (5, 8, "half", True),
    (90, 32, "prefix", True), (90, 32, "prefix", False),
    (17, 5, "every3", True), (1, 1, "all", False),
]
RESIDENT = {"none": lambda i: False, "all": lambda i: True,
            "half": lambda i: i % 2 == 0, "odd": lambda i: i % 2 == 1,
            "prefix": lambda i: i < 45, "every3": lambda i: i % 3 == 0}


@pytest.mark.parametrize("n,batch,resident,train", SCHEDULES)
def test_partial_epoch_schedule_matches_jax(n, batch, resident, train):
    """(n_valid, cached records, upload records) a batch, equal to JAX's
    for the same RandomState; fixed lanes; every record once."""
    records = [{"id": i} for i in range(n)]
    nb = -(-n // batch)

    def run(schedule):
        rng = np.random.RandomState(n * 31 + batch)
        return [(v, [r["id"] for r in c], [r["id"] for r in u])
                for v, c, u in schedule(records, batch, nb, rng,
                                        lambda r: RESIDENT[resident](r["id"]),
                                        train)]

    got = run(loader._partial_epoch_schedule)
    assert got == run(jax_loader._partial_epoch_schedule)
    assert len({(len(c), len(u)) for _, c, u in got}) <= 1
    assert sorted(i for v, c, u in got for i in (c + u)[:v]) == list(
        range(n))


def test_prefetch_releases_its_worker_when_closed_early():
    """An abandoned iterator stops its producer within the worker's poll."""
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    before = {t.ident for t in threading.enumerate()}
    it = loader._prefetch(gen(), depth=2)
    assert [next(it), next(it)] == [0, 1]
    it.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "f3d-prefetch" and t.ident not in before]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive
    assert len(produced) <= 6               # depth 2 + the two taken + 2


def test_prefetch_hands_an_error_to_the_consumer():
    def gen():
        yield 1
        raise KeyError("decode failed")

    it = loader._prefetch(gen())
    assert next(it) == 1
    with pytest.raises(KeyError, match="decode failed"):
        next(it)


def test_prefetch_keeps_order():
    assert list(loader._prefetch(iter(range(50)), depth=2)) == list(
        range(50))


def test_train_scale_rot_and_row_mask_match_jax():
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(50):
        assert (loader._train_scale_rot(a, 0.25, 30)
                == jax_loader._train_scale_rot(b, 0.25, 30))
    np.testing.assert_array_equal(loader._row_mask(3, 5),
                                  jax_loader._row_mask(3, 5))
    assert loader._num_lockstep_batches(90, 32) == 3
    recs = [{"id": 0}, {"id": 1}]
    assert loader._shard_for_host(recs) == (recs, 2, recs[0])
