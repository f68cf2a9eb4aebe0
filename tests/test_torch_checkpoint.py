"""The port's checkpoints (fast3dhpe_tpu_torch/train/checkpoint.py)
against the JAX package's readers and writers, on the CPU: depth 18 at
64 px.

Tolerances: weights cross over exactly (a state dict is copied, never
recomputed); the JAX forward of a port checkpoint within 1e-4 of the
largest heatmap value of the port's forward on the same batch, and its
keypoints within 1e-3 px (tests/test_torch_model.py's bounds for one
model on two frameworks).
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.models import CDRNet as JaxCDRNet
from fast3dhpe_tpu.train import checkpoint as jckpt
from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
from fast3dhpe_tpu_torch.config import config_from_dict
from fast3dhpe_tpu_torch.convert import jax_variables_to_state_dict
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.layers import init_weights
from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
from fast3dhpe_tpu_torch.train import checkpoint
from fast3dhpe_tpu_torch.train.state import TrainState

from test_torch_model import _projs

torch.set_num_threads(2)

B, IMG = 2, 64


def _model(cls=CDRNet, seed=0):
    model = cls(num_layers=18)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v)), k


def test_state_dict_round_trip_strict(tmp_path):
    model = _model()
    writer = checkpoint.SyncCheckpointWriter()
    writer.save(str(tmp_path / "best.pth"),
                checkpoint.weights_with_step(model, 12))
    sd = checkpoint.load_variables(str(tmp_path))        # a directory
    assert checkpoint.weights_step(sd) == 12
    other = CDRNet(num_layers=18)
    other.load_state_dict(sd, strict=True)
    _assert_same(other.state_dict(), model.state_dict())
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]


def test_port_best_loads_in_jax_with_the_same_forward(tmp_path):
    """The port's best.pth read by JAX's load_torch_checkpoint: JAX's
    forward of it within 1e-4 of the port's (module docstring)."""
    model = _model()
    with torch.no_grad():                     # views decode apart
        model.decoder.final_layer.weight.mul_(50.0)
    path = tmp_path / "best.pth"
    checkpoint.SyncCheckpointWriter().save(
        str(path), checkpoint.weights_with_step(model, 3))
    v = jckpt.load_torch_checkpoint(str(path))
    imgs = np.random.RandomState(0).randn(B, 2, IMG, IMG, 3).astype(
        np.float32)
    projs = _projs(B, IMG)
    jkp, _, jhm = JaxCDRNet(num_layers=18).apply(
        v, jnp.asarray(imgs), jnp.asarray(projs), train=False,
        return_heatmaps=True)
    with torch.inference_mode():
        kp, _, hm = model.eval()(torch.from_numpy(imgs),
                                 torch.from_numpy(projs),
                                 return_heatmaps=True)
    jhm = np.asarray(jhm)
    assert np.abs(hm.numpy() - jhm).max() / np.abs(jhm).max() < 1e-4
    np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), atol=1e-3)


def test_jax_saved_pth_loads_in_the_port(tmp_path):
    model = JaxCDRNet(num_layers=18)
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, IMG, IMG, 3)),
        jnp.asarray(_projs(1, IMG)), train=False))
    jckpt.save_torch_checkpoint(str(tmp_path / "latest.pth"), v)
    sd = checkpoint.load_variables(str(tmp_path / "latest.pth"))
    port = CDRNet(num_layers=18)
    port.load_state_dict(sd, strict=True)
    _assert_same(port.state_dict(), jax_variables_to_state_dict(v))


def test_merge_encoder_only_matches_jax():
    """The PoseResNet -> CDRNet encoder handoff: the port's key filter
    against JAX's subtree swap, BN statistics included."""
    pose = _model(PoseResNet, seed=1)
    with torch.no_grad():
        for name, buf in pose.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5)
    cdr = _model(CDRNet, seed=2)
    got = checkpoint.merge_encoder_only(cdr.state_dict(), pose.state_dict())
    jv = jckpt.torch_state_dict_to_flax(cdr.state_dict())
    jp = jckpt.torch_state_dict_to_flax(pose.state_dict())
    ref = jckpt.flax_to_torch_state_dict(jckpt.merge_encoder_only(jv, jp))
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert torch.equal(got["encoder.bn1.running_var"],
                       pose.state_dict()["encoder.bn1.running_var"])
    assert torch.equal(got["decoder.final_layer.weight"],
                       cdr.state_dict()["decoder.final_layer.weight"])
    with pytest.raises(KeyError, match="pretrained encoder differs"):
        checkpoint.merge_encoder_only(
            cdr.state_dict(), {"encoder.conv1.weight": torch.zeros(1)})


def test_async_writer_snapshot_isolation(tmp_path):
    """save() copies before it returns: the model and optimizer changed
    in place after it leave the file as it was at save()."""
    model = _model(PoseResNet)
    state = TrainState.create(model, type("C", (), {"TRAIN": type(
        "T", (), {"LR": 1e-3, "LR_STEP": [40], "LR_FACTOR": 0.1})})(), 1)
    model(torch.randn(1, 32, 32, 3)).sum().backward()
    state.apply_gradients()
    want_w = {k: v.clone() for k, v in model.state_dict().items()}
    want_o = checkpoint.to_host(state.optimizer.state_dict())
    writer = checkpoint.AsyncCheckpointWriter()
    gate = threading.Event()
    save_file = checkpoint.save_file

    def slow(path, obj):
        gate.wait(10)
        save_file(path, obj)

    checkpoint.save_file = slow
    try:
        writer.save(str(tmp_path / "w.pth"), model.state_dict())
        writer.save(str(tmp_path / "o.pt"), state.optimizer.state_dict())
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        model(torch.randn(1, 32, 32, 3)).sum().backward()
        state.apply_gradients()
        gate.set()
        writer.close()
    finally:
        checkpoint.save_file = save_file
    _assert_same(torch.load(tmp_path / "w.pth", weights_only=True), want_w)
    got_o = torch.load(tmp_path / "o.pt", weights_only=True)
    for i, s in want_o["state"].items():
        for k, v in s.items():
            assert torch.equal(got_o["state"][i][k], v), (i, k)


def test_async_writer_coalesces_and_surfaces_errors(tmp_path):
    """A save to a path whose last save is queued, not started, replaces
    it; a worker's error is raised by wait(), once."""
    writer = checkpoint.AsyncCheckpointWriter()
    gate, started, written = threading.Event(), threading.Event(), []
    save_file = checkpoint.save_file

    def slow(path, obj):
        started.set()
        gate.wait(10)
        written.append((os.path.basename(path), int(obj["x"])))
        if obj["x"] < 0:
            raise OSError("disk full")

    checkpoint.save_file = slow
    try:
        writer.save(str(tmp_path / "a"), {"x": torch.tensor(0)})
        assert started.wait(10)                     # in flight, not queued
        for x in (1, 2, 3):
            writer.save(str(tmp_path / "a"), {"x": torch.tensor(x)})
        writer.save(str(tmp_path / "b"), {"x": torch.tensor(9)})
        gate.set()
        writer.wait()
        assert written == [("a", 0), ("a", 3), ("b", 9)]
        writer.save(str(tmp_path / "a"), {"x": torch.tensor(-1)})
        with pytest.raises(OSError, match="disk full"):
            writer.wait()
        writer.wait()                          # raised once
        writer.close()
    finally:
        checkpoint.save_file = save_file
    assert not writer._thread.is_alive() and writer._thread.daemon


def test_mismatched_latest_pair_is_refused(tmp_path):
    model = _model(PoseResNet)
    state = TrainState.create(model, type("C", (), {"TRAIN": type(
        "T", (), {"LR": 1e-3, "LR_STEP": [40], "LR_FACTOR": 0.1})})(), 1)
    w = checkpoint.SyncCheckpointWriter()
    assert checkpoint.load_resume(str(tmp_path)) is None
    state.step = 4
    w.save(str(tmp_path / "latest.pth"), checkpoint.weights_with_step(model, 4))
    with pytest.raises(FileNotFoundError, match="latest.opt.pt"):
        checkpoint.load_resume(str(tmp_path))
    w.save(str(tmp_path / checkpoint.OPT_FILE),
           checkpoint.resume_payload(state, 0.5))
    weights, payload = checkpoint.load_resume(str(tmp_path))
    assert payload["step"] == 4 and payload["best_metric"] == 0.5
    state.step = 6                            # a crash between the writes
    w.save(str(tmp_path / checkpoint.OPT_FILE),
           checkpoint.resume_payload(state, 0.5))
    with pytest.raises(RuntimeError, match="not written together"):
        checkpoint.load_resume(str(tmp_path))


def test_orbax_directory_error_names_the_conversion(tmp_path):
    orbax = tmp_path / "ckpt"
    os.makedirs(orbax)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for call in (lambda: checkpoint.load_variables(str(orbax)),
                 lambda: checkpoint.load_variables(str(tmp_path / "m")),
                 lambda: CDRNetInferencer(
                     config_from_dict({"MODEL": {"NAME": "m"}}),
                     weights_root=str(tmp_path), device="cpu")):
        os.makedirs(tmp_path / "m" / "best", exist_ok=True)
        with pytest.raises(NotImplementedError) as err:
            call()
        msg = str(err.value)
        assert "orbax" in msg and "save_torch_checkpoint" in msg
        assert "where JAX runs" in msg
    with pytest.raises(FileNotFoundError):
        checkpoint.load_variables(str(tmp_path / "nothing"))


def test_async_writer_stress_keeps_each_paths_last_save(tmp_path):
    """Saves from several threads to a few paths with a short switch
    interval: after wait() each path holds the last value saved to it by
    the thread that owns it, and nothing is left queued."""
    import sys
    writer = checkpoint.AsyncCheckpointWriter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(k):
            for x in range(40):
                writer.save(str(tmp_path / f"p{k}"), {"x": torch.tensor(x)})

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        writer.wait()
    finally:
        sys.setswitchinterval(old)
        writer.close()
    for k in range(8):
        assert int(torch.load(tmp_path / f"p{k}", weights_only=True)["x"]) \
            == 39
    assert not writer._queue and writer._busy == 0
