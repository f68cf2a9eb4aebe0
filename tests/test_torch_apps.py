"""The port's CLI apps (fast3dhpe_tpu_torch/apps/train.py, train_cdr.py,
inference.py, baseline.py, display_data_2d.py, display_data_3d.py) and
its rendering (utils/visualize.py, utils/render.py), called through
`main(argv)` with --device cpu on a small synthetic MADS tree (depth 18,
64 px, 16 px heatmaps, batch 4), against the JAX package where it has the
same function.

Tolerances: the inference app's MPJPE2D within 1e-4 relative of the JAX
inferencer's evaluate_movement on the same weights and movement (fp32;
tests/test_torch_stream_eval.py's bound; measured equal), MPJPE3D within
1e-3 (measured 1.4e-5: the DLT of an untrained model's keypoints
amplifies their rounding); the baseline's
pred_2d equal to JAX's (no near-tie of a heatmap's maximum on this
batch), pred_3d within 1e-4 of each joint's largest coordinate (at the floor of
w, where the sign is rounding noise, in magnitude); the 2D overlays bit-equal and the 3D plots equal pixel for
pixel (the same cv2 and matplotlib calls).
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from fast3dhpe_tpu.apps.baseline import BaselineEstimator as JaxBaseline
from fast3dhpe_tpu.apps.inference import CDRNetInferencer as JaxInferencer
from fast3dhpe_tpu.config import load_config as jax_load_config
from fast3dhpe_tpu.data.stream import LoadMADSData as JaxStream
from fast3dhpe_tpu.data.synthetic import make_synthetic_mads
from fast3dhpe_tpu.utils import visualize as jvis
from fast3dhpe_tpu_torch.apps import (baseline, display_data_2d,
                                      display_data_3d, inference, train,
                                      train_cdr)
from fast3dhpe_tpu_torch.config import load_config
from fast3dhpe_tpu_torch.data.stream import LoadMADSData
from fast3dhpe_tpu_torch.utils import visualize

torch.set_num_threads(2)

FRAMES = 4


def _yaml(path, root, dataset, name, epochs, warmup):
    with open(path, "w") as f:
        yaml.safe_dump({
            "DATASET": {"TYPE": dataset, "ROOT": str(root),
                        "OCCLUSION": "None"},
            "MODEL": {"NAME": name, "NUM_LAYERS": 18,
                      "IMAGE_SIZE": [64, 64], "PRETRAINED": "",
                      "EXTRA": {"HEATMAP_SIZE": [16, 16], "SIGMA": 1}},
            "TRAIN": {"BATCH_SIZE": 4, "EPOCH": epochs, "WARMUP": warmup,
                      "LR": 1e-3, "LR_STEP": [40]},
            "TEST": {"BATCH_SIZE": 4},
            "LOSS": {"TYPE": "JointsMSESmooth" if dataset == "MADS_3d"
                     else "JointsMSE", "USE_TARGET_WEIGHT": True}}, f)
    return str(path)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The tree, both configs, and the weights train_cdr.main and
    train.main write (CDR: 3 epochs, WARMUP 1; 2D: 2 epochs)."""
    root = tmp_path_factory.mktemp("apps")
    make_synthetic_mads(str(root / "data"), n_frames=FRAMES, img_w=128,
                        img_h=96, movements=("HipHop", "Jazz"))
    cfg3 = _yaml(root / "tiny_3d.yaml", root / "data", "MADS_3d", "cdr", 3,
                 1)
    cfg2 = _yaml(root / "tiny_2d.yaml", root / "data", "MADS_2d", "pose",
                 2, 0)
    weights = str(root / "weights")
    h3 = train_cdr.main(["--config_path", cfg3, "--overwrite", "--device",
                         "cpu", "--weights_root", weights])
    h2 = train.main(["--config_path", cfg2, "--overwrite", "--device", "cpu",
                     "--weights_root", weights, "--per_batch"])
    return {"root": root, "cfg3": cfg3, "cfg2": cfg2, "weights": weights,
            "h3": h3, "h2": h2, "valid": str(root / "data" / "valid")}


def test_train_apps_write_checkpoints(ws):
    assert len(ws["h3"]["val_mpjpe_3d"]) == 3
    assert len(ws["h2"]["val_acc"]) == 2
    for hist in (ws["h3"], ws["h2"]):
        assert all(np.isfinite(v).all() for v in hist.values())
    assert set(os.listdir(os.path.join(ws["weights"], "cdr"))) == {
        "best.pth", "latest.pth", "latest.opt.pt"}
    assert {"latest.pth", "latest.opt.pt"} <= set(
        os.listdir(os.path.join(ws["weights"], "pose")))


def test_train_app_flags(ws, monkeypatch):
    argv = ["--config_path", ws["cfg3"], "--device", "cpu",
            "--weights_root", ws["weights"]]
    with pytest.raises(FileExistsError, match="--overwrite"):
        train_cdr.main(argv)
    # --bf16, refused until bf16 training was ported, reaches the loop as
    # compute_dtype (tests/test_torch_bf16_train.py trains with it)
    from fast3dhpe_tpu_torch.train import loop_cdr
    seen = {}
    monkeypatch.setattr(loop_cdr, "run",
                        lambda config, **kw: seen.update(kw) or {})
    train_cdr.main(argv + ["--overwrite", "--bf16"])
    assert seen["compute_dtype"] == "bfloat16"
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            train.main(["--config_path", ws["cfg2"], "--overwrite",
                        "--weights_root", ws["weights"]])
        else:
            raise RuntimeError("CUDA present: the default device runs")


def test_inference_app_matches_jax(ws, tmp_path, monkeypatch, capsys):
    """--movement all, fp32, --save_frames 2: the printed MPJPEs against
    the JAX inferencer's evaluate_movement on the same best.pth; the GIFs
    and test.jpg are written and decode."""
    monkeypatch.chdir(tmp_path)
    got = inference.main(["--config_path", ws["cfg3"], "--device", "cpu",
                          "--weights_root", ws["weights"], "--movement",
                          "all", "--data_path", ws["valid"], "--batch_size",
                          "4", "--save_frames", "2"])
    out = capsys.readouterr().out
    assert sorted(got) == ["HipHop", "Jazz"]
    jinf = JaxInferencer(jax_load_config(ws["cfg3"]),
                         weights_root=ws["weights"])
    for movement, (e2, e3) in got.items():
        assert f"[{movement}] MPJPE2D:  {e2}" in out
        assert f"[{movement}] MPJPE3D:  {e3}" in out
        r2, r3 = jinf.evaluate_movement(
            JaxStream(ws["valid"], (64, 64), movement), 4,
            device_cache_bytes=64 << 20)
        assert e2 == pytest.approx(r2, rel=1e-4)
        assert e3 == pytest.approx(r3, rel=1e-3)
    assert "MPJPE3D (all)" in out
    from PIL import Image
    for name in ("HipHop.gif", "Jazz.gif"):
        with Image.open(name) as im:
            assert im.n_frames == 2
    import cv2
    assert cv2.imread("test.jpg") is not None


def test_inference_app_bf16_fused_and_refusals(ws, tmp_path, capsys):
    """--bf16 --fused_inference runs (K3's plain version on the CPU);
    --fused_inference needs --bf16; --int8, refused until int8 serving was
    ported, runs, and an int8 inferencer with neither a calibration stream
    nor a pack raises (tests/test_torch_quantized.py holds int8 against
    JAX)."""
    argv = ["--config_path", ws["cfg3"], "--device", "cpu", "--weights_root",
            ws["weights"], "--data_path", ws["valid"], "--batch_size", "4",
            "--device_cache_mb", "0"]
    got = inference.main(argv + ["--bf16", "--fused_inference"])
    assert np.isfinite(got["HipHop"]).all()
    with pytest.raises(SystemExit):
        inference.main(argv + ["--fused_inference"])
    got = inference.main(argv + ["--int8"])
    assert np.isfinite(got["HipHop"]).all()
    with pytest.raises(ValueError, match="calib_stream"):
        inference.CDRNetInferencer(load_config(ws["cfg3"]),
                                   weights_root=ws["weights"], device="cpu",
                                   int8=True)


def test_baseline_matches_jax(ws, tmp_path, monkeypatch, capsys):
    """BaselineEstimator.predict_batch against JAX's on the same
    latest.pth and batch (module docstring), then the app's main."""
    est = baseline.BaselineEstimator(load_config(ws["cfg2"]),
                                     weights_root=ws["weights"],
                                     device="cpu")
    jest = JaxBaseline(jax_load_config(ws["cfg2"]),
                       weights_root=ws["weights"])
    batch = next(JaxStream(ws["valid"], (64, 64), "HipHop").batches(4))
    kp, p3 = est.predict_batch(batch["img_l"], batch["img_r"],
                               batch["proj"])
    jkp, jp3 = (np.asarray(t) for t in jest.predict_batch(
        jnp.asarray(batch["img_l"]), jnp.asarray(batch["img_r"]),
        jnp.asarray(batch["proj"])))
    np.testing.assert_array_equal(kp.numpy(), jkp)
    # joints whose two views decode to one pixel triangulate at the floor
    # of w (|w| = 1e-9, coordinates ~1e9), where the sign of w is rounding
    # noise: there the magnitudes agree; elsewhere the values
    p3, scale = p3.numpy(), np.abs(jp3).max(-1, keepdims=True)
    floor = scale > 1e8
    assert (np.abs(np.abs(p3) - np.abs(jp3)) <= 1e-4 * scale).all()
    assert (np.abs(np.where(floor, 0, p3 - jp3)) <= 1e-4 * scale).all()
    monkeypatch.chdir(tmp_path)
    e2, e3 = baseline.main(["--config_path", ws["cfg2"], "--device", "cpu",
                            "--weights_root", ws["weights"], "--data_path",
                            ws["valid"], "--batch_size", "4",
                            "--save_frames", "1"])
    assert np.isfinite([e2, e3]).all()
    assert f"MPJPE2D:  {e2}" in capsys.readouterr().out
    assert os.path.isfile("HipHop.gif") and os.path.isfile("test.jpg")


def test_render_matches_jax(ws, tmp_path):
    """plot_pose_2d bit-equal and plot_pose_3d pixel-equal to JAX's
    utils/visualize.py on the same inputs; plot_loss and save_gif write
    their files; the render flow's frames stack the 2D overlay over the
    3D plot."""
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (64, 64, 3), np.uint8) for _ in range(2)]
    gt = [r.uniform(0, 64, (19, 2)) for _ in range(2)]
    pred = [r.uniform(0, 64, (19, 2)) for _ in range(2)]
    gt[0][3] = np.nan
    got = visualize.plot_pose_2d(gt, pred, [i.copy() for i in imgs])
    ref = jvis.plot_pose_2d(gt, pred, [i.copy() for i in imgs])
    np.testing.assert_array_equal(got, ref)
    pose, est = r.randn(19, 3) * 300, r.randn(19, 3) * 300
    np.testing.assert_array_equal(visualize.plot_pose_3d(pose, est),
                                  jvis.plot_pose_3d(pose, est))
    png = visualize.plot_loss([3.0, 2.0, 1.0], str(tmp_path), "Loss")
    assert os.path.getsize(png) > 0
    visualize.save_gif([got, 255 - got], str(tmp_path / "x.gif"))
    from PIL import Image
    with Image.open(tmp_path / "x.gif") as im:
        assert im.n_frames == 2
    est_ = baseline.BaselineEstimator(load_config(ws["cfg2"]),
                                      weights_root=ws["weights"],
                                      device="cpu")
    stream = LoadMADSData(ws["valid"], (64, 64), "Jazz", device="cpu")
    frames = est_.render_frames(stream, 3, str(tmp_path / "t.jpg"), 2)
    assert len(frames) == 3
    assert frames[0].shape[1] == 128 and frames[0].shape[0] > 64
    assert os.path.isfile(tmp_path / "t.jpg")


def test_display_apps_write_images(ws, tmp_path):
    out2, out3 = str(tmp_path / "v2"), str(tmp_path / "v3")
    assert display_data_2d.main(["--config_path", ws["cfg2"], "--device",
                                 "cpu", "--num_samples", "3", "--out_dir",
                                 out2]) == 3
    assert display_data_3d.main(["--config_path", ws["cfg3"], "--device",
                                 "cpu", "--num_samples", "5", "--out_dir",
                                 out3, "--show_masks"]) == 5
    import cv2
    for d, n, w in ((out2, 3, 64), (out3, 5, 128)):
        names = sorted(os.listdir(d))
        assert len(names) == n
        img = cv2.imread(os.path.join(d, names[0]))
        assert img.shape == (64, w, 3)
