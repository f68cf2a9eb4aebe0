"""The port's serving export (fast3dhpe_tpu_torch/export.py,
apps/export.py) and the kernels' registered operators, on the CPU: CDRNet
at depth 18, 19 joints, 64 px, batch 2, random weights from a seed, fp32
and int8.

Tolerances, as tests/test_export.py: the loaded artifact against the
in-process serving function within rtol 1e-4 / atol 1e-3 for pred_2d, and
pred_3d within 1e-3 of its largest coordinate (the same operations run
eagerly from the graph; measured equal). A float frame raises TypeError
and a wrong batch ValueError. torch.library.opcheck passes for
fast3dhpe::soft_argmax, fast3dhpe::soft_argmax_bwd and
fast3dhpe::fused_bottleneck (their CPU implementations are the plain
versions).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from fast3dhpe_tpu_torch import export as E
from fast3dhpe_tpu_torch.apps import export as export_app
from fast3dhpe_tpu_torch.models import quantized as qz
from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
from fast3dhpe_tpu_torch.models.layers import init_weights
from fast3dhpe_tpu_torch.ops import bottleneck, softargmax
from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H = 2, 64


def _proj(batch):
    K = np.array([[300.0, 0, 32], [0, 300.0, 32], [0, 0, 1]])
    Ps = [K @ np.hstack([np.eye(3), np.array([[dx], [0.0], [3000.0]])])
          for dx in (-400.0, 400.0)]
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Weights, frames, an int8 pack, and both artifacts written."""
    tmp = tmp_path_factory.mktemp("export")
    model = CDRNet(num_joints=19, num_layers=18)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():                # logits of unit-ish spread
        model.decoder.final_layer.weight.mul_(50.0)
    sd = model.state_dict()
    r = np.random.RandomState(0)
    imgs = r.randint(0, 256, (B, 2, H, H, 3)).astype(np.uint8)
    proj = _proj(B)
    norm = torch.stack([normalize_imagenet(torch.from_numpy(imgs[:, v]))
                        for v in (0, 1)], dim=1)
    pack = qz.quantize_cdrnet(sd, [(norm, torch.from_numpy(proj))])
    paths = {"fp32": str(tmp / "m.pt2"), "int8": str(tmp / "m_int8.pt2")}
    sizes = {
        "fp32": E.save_exported(E.export_cdrnet(
            CDRNet(num_joints=19, num_layers=18), sd, B, (H, H),
            device="cpu"), paths["fp32"]),
        "int8": E.save_exported(E.export_cdrnet_int8(
            pack, B, (H, H), device="cpu"), paths["int8"])}
    return {"tmp": tmp, "sd": sd, "imgs": imgs, "proj": proj, "pack": pack,
            "paths": paths, "sizes": sizes}


def _reference(tiny, kind):
    if kind == "fp32":
        serve = E.make_serving_fn(CDRNet(num_joints=19, num_layers=18),
                                  tiny["sd"])
    else:
        serve = E.make_serving_fn_int8(tiny["pack"])
    with torch.no_grad():
        return serve(torch.from_numpy(tiny["imgs"][:, 0]),
                     torch.from_numpy(tiny["imgs"][:, 1]),
                     torch.from_numpy(tiny["proj"]))


def _close(got, ref):
    (kp, p3), (kp_ref, p3_ref) = got, ref
    assert kp.shape == (B, 2, 19, 2) and p3.shape == (B, 19, 3)
    np.testing.assert_allclose(kp.numpy(), kp_ref.numpy(), rtol=1e-4,
                               atol=1e-3)
    scale = float(p3_ref.abs().max()) + 1.0
    np.testing.assert_allclose(p3.numpy() / scale, p3_ref.numpy() / scale,
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_round_trip_matches_serving_fn(tiny, kind):
    serve = E.load_serving(tiny["paths"][kind], device="cpu")
    assert serve.batch_size == B
    got = serve(tiny["imgs"][:, 0], tiny["imgs"][:, 1], tiny["proj"])
    _close(got, _reference(tiny, kind))
    # weights baked in: fp32 ~ the parameters' bytes, int8 ~4x smaller
    n_params = sum(t.numel() for k, t in tiny["sd"].items()
                   if "num_batches" not in k)
    assert tiny["sizes"]["fp32"] > 4 * n_params * 0.9
    assert tiny["sizes"]["int8"] < 0.5 * tiny["sizes"]["fp32"]


def test_float_frames_and_wrong_batch_raise(tiny):
    serve = E.load_serving(tiny["paths"]["fp32"], device="cpu")
    img = tiny["imgs"][:, 0]
    with pytest.raises(TypeError, match="uint8"):
        serve(img.astype(np.float32), img, tiny["proj"])
    with pytest.raises(ValueError, match="batch 2"):
        serve(img[:1], img[:1], tiny["proj"][:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            E.load_serving(tiny["paths"]["fp32"])
        else:
            raise RuntimeError("CUDA present: the default device loads")


def test_loads_in_a_fresh_process_with_export_alone(tiny):
    """A new interpreter that imports fast3dhpe_tpu_torch.export only
    (which registers the operators) serves the int8 artifact; it loads
    no JAX."""
    np.save(tiny["tmp"] / "imgs.npy", tiny["imgs"])
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from fast3dhpe_tpu_torch.export import load_serving\n"
        f"serve = load_serving({tiny['paths']['int8']!r}, device='cpu')\n"
        f"imgs = np.load({str(tiny['tmp'] / 'imgs.npy')!r})\n"
        f"proj = np.asarray({tiny['proj'].tolist()!r}, np.float32)\n"
        "kp, p3 = serve(imgs[:, 0], imgs[:, 1], proj)\n"
        "print(json.dumps({'kp': kp.tolist(), 'mods': sorted(\n"
        "    m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'flax', 'fast3dhpe_tpu'))}))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["mods"] == []
    kp_ref = _reference(tiny, "int8")[0].numpy()
    np.testing.assert_allclose(np.asarray(res["kp"]), kp_ref, rtol=1e-4,
                               atol=1e-3)


def test_export_app_writes_an_artifact_that_loads(tiny, tmp_path):
    weights = tmp_path / "weights" / "tiny"
    weights.mkdir(parents=True)
    torch.save(tiny["sd"], weights / "best.pth")
    cfg = tmp_path / "c.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump({"MODEL": {"NAME": "tiny", "NUM_LAYERS": 18,
                                  "IMAGE_SIZE": [H, H]}}, f)
    os.chdir(tmp_path)
    try:
        path, size = export_app.main(
            ["--config_path", str(cfg), "--weights_root",
             str(tmp_path / "weights"), "--batch_size", str(B), "--device",
             "cpu"])
    finally:
        os.chdir(ROOT)
    assert path == "tiny.pt2"
    assert os.path.getsize(tmp_path / path) == size
    serve = E.load_serving(str(tmp_path / path), device="cpu")
    _close(serve(tiny["imgs"][:, 0], tiny["imgs"][:, 1], tiny["proj"]),
           _reference(tiny, "fp32"))


def test_opcheck_soft_argmax_ops():
    r = np.random.RandomState(3)
    for dt in (torch.float32, torch.bfloat16):
        hm = (torch.from_numpy(r.randn(2, 5, 19, 8).astype(np.float32))
              .to(dt).contiguous(memory_format=torch.channels_last)
              .permute(0, 2, 3, 1))
        torch.library.opcheck(softargmax._k1_op,
                              (hm.detach().requires_grad_(True),))
        out, stats = softargmax._k1_op(hm)
        g = torch.from_numpy(r.randn(2, 5, 2).astype(np.float32))
        torch.library.opcheck(softargmax._k2_op, (hm, stats, g))


def test_opcheck_fused_bottleneck_op():
    r = np.random.RandomState(4)
    cin, planes = 32, 8
    args = [torch.from_numpy(r.randn(*s).astype(np.float32) * 0.1)
            for s in ((cin, planes), (planes,), (planes,),
                      (3, 3, planes, planes), (planes,), (planes,),
                      (planes, 4 * planes), (4 * planes,), (4 * planes,),
                      (cin, 4 * planes), (4 * planes,), (4 * planes,))]
    p = bottleneck.pack_weights(*args)
    x = torch.from_numpy(r.randn(2, cin, 6, 5).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    torch.library.opcheck(bottleneck._k3_op, (x, p.w, p.sb, p.cin, p.planes,
                                              p.cout, p.downsample))
