"""The PyTorch port's MADS ETL (fast3dhpe_tpu_torch/data/extract.py)
against the JAX package's, on tests/test_extract.py's synthetic
Bouguet-style .mat fixtures and MJPG videos; skipped without scipy or cv2,
as that file skips.

Tolerances: intrinsics, translations, distortion, rectified images and
the extracted JPEGs are equal to JAX's; rotations (Rodrigues in fp32 in
both packages) within 1e-6."""

import glob
import json
import os

import numpy as np
import pytest
import torch

scipy_io = pytest.importorskip("scipy.io")
cv2 = pytest.importorskip("cv2")

from fast3dhpe_tpu.data import extract as jax_extract  # noqa: E402
from fast3dhpe_tpu_torch.data import build_mads_stereo_index  # noqa: E402
from fast3dhpe_tpu_torch.data import extract  # noqa: E402

from test_extract import (TestFullETL, write_calib_mats,  # noqa: E402
                          write_rectify_mats)

torch.set_num_threads(2)
rng = np.random.RandomState(1)


def test_parse_bouguet_matches_jax(tmp_path):
    lp, rp = write_calib_mats(tmp_path)
    got = extract.parse_bouguet_calibs(lp, rp)
    ref = jax_extract.parse_bouguet_calibs(lp, rp)
    for cam in ("left", "right"):
        for k in ("intrinsics", "translation", "distortion_coeffs"):
            np.testing.assert_array_equal(got[cam][k], ref[cam][k])
        R = got[cam]["rotation"]
        assert R.dtype == np.float64
        np.testing.assert_allclose(R, ref[cam]["rotation"], atol=1e-6)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    # the right camera's K for both; the left rotation vector negated
    np.testing.assert_array_equal(got["left"]["intrinsics"],
                                  got["right"]["intrinsics"])
    np.testing.assert_allclose(
        got["left"]["rotation"],
        cv2.Rodrigues(-np.array([0.01, 0.02, 0.03]))[0], atol=1e-5)


@pytest.mark.parametrize("camera", ["left", "right"])
def test_rectify_maps_match_jax(tmp_path, camera):
    lp, _ = write_rectify_mats(tmp_path, h=8, w=10)
    got = extract.parse_rectify_maps(lp, camera)
    ref = jax_extract.parse_rectify_maps(lp, camera)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    img = rng.randint(0, 255, size=(8, 10, 3), dtype=np.uint8)
    np.testing.assert_array_equal(extract.rectify_image(img, got), img)
    with pytest.raises(ValueError, match="camera"):
        extract.parse_rectify_maps(lp, "middle")


def test_rectify_bilinear_matches_jax():
    """A 50/50 blend of each pixel and the next in Fortran order, with the
    unmapped pixels at the fill value."""
    h, w, n = 4, 4, 16
    idx = np.arange(n)
    maps = {"ind_new": idx[:12], "ind_1": idx[:12],
            "ind_2": np.minimum(idx + 1, n - 1)[:12], "ind_3": idx[:12],
            "ind_4": idx[:12], "a1": np.full(12, 0.5), "a2": np.full(12, 0.5),
            "a3": np.zeros(12), "a4": np.zeros(12)}
    img = rng.randint(0, 255, size=(h, w, 3), dtype=np.uint8)
    got = extract.rectify_image(img, maps)
    np.testing.assert_array_equal(got, jax_extract.rectify_image(img, maps))
    assert (got.reshape(-1, 3, order="F")[12:] == extract.RECTIFY_FILL).all()


def test_extract_all_matches_jax(tmp_path):
    """The whole ETL on two videos of HipHop: the first to valid/, the
    second to train/; JPEGs byte-equal to JAX's, poses and calibration
    equal (rotations within 1e-6); the tree feeds the index builder."""
    depth, multi = TestFullETL().make_fixture(tmp_path)
    out, ref = str(tmp_path / "out"), str(tmp_path / "ref")
    extract.extract_all(depth, multi, out, movements=("HipHop",))
    jax_extract.extract_all(depth, multi, ref, movements=("HipHop",))
    files = sorted(os.path.relpath(p, out) for p in glob.glob(
        os.path.join(out, "**", "*.*"), recursive=True))
    assert files == sorted(os.path.relpath(p, ref) for p in glob.glob(
        os.path.join(ref, "**", "*.*"), recursive=True))
    assert len(files) == 2 * 3 * 3
    assert os.path.isdir(os.path.join(out, "valid", "HipHop", "0"))
    assert os.path.isdir(os.path.join(out, "train", "HipHop", "1"))
    for rel in files:
        a, b = os.path.join(out, rel), os.path.join(ref, rel)
        if rel.endswith(".jpg"):
            assert open(a, "rb").read() == open(b, "rb").read(), rel
            continue
        ja, jb = json.load(open(a)), json.load(open(b))
        np.testing.assert_array_equal(ja["pose_3d"], jb["pose_3d"])
        for cam, ca in ja["calibs_info"].items():
            for k, va in ca.items():
                np.testing.assert_allclose(va, jb["calibs_info"][cam][k],
                                           atol=1e-6, err_msg=f"{cam} {k}")
    recs = build_mads_stereo_index(out, "valid")
    assert len(recs) == 3 and recs[0]["P_left"].shape == (4, 4)


def test_extract_all_refuses_unmatched_videos(tmp_path):
    depth, multi = TestFullETL().make_fixture(tmp_path)
    os.remove(glob.glob(os.path.join(depth, "HipHop", "*_GT.mat"))[0])
    with pytest.raises(ValueError, match="Number of videos"):
        extract.extract_all(depth, multi, str(tmp_path / "o"),
                            movements=("HipHop",))


def test_extract_data_cli_parses_the_reference_flags(monkeypatch):
    from fast3dhpe_tpu_torch.apps import extract_data
    seen = {}
    monkeypatch.setattr(extract_data, "extract_all",
                        lambda *a: seen.setdefault("args", a))
    monkeypatch.setattr("sys.argv", ["extract_data", "--output_path", "o",
                                     "--undistort"])
    extract_data.main()
    assert seen["args"] == ("data/MADS/MADS_depth/depth_data",
                            "data/MADS/MADS_multiview/multi_view_data", "o",
                            True, False)
