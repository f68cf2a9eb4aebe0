"""The PyTorch port (fast3dhpe_tpu_torch) and chip_smoke.py stand apart
from JAX: importing every module of the port loads no jax, flax or
fast3dhpe_tpu, and no source of theirs names them. A subprocess, because
this test process already imported jax (tests/conftest.py)."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fast3dhpe_tpu")


def _port_modules():
    import fast3dhpe_tpu_torch
    names = ["fast3dhpe_tpu_torch"]
    for info in pkgutil.walk_packages(fast3dhpe_tpu_torch.__path__,
                                      "fast3dhpe_tpu_torch."):
        names.append(info.name)
    return names


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "fast3dhpe_tpu_torch.models.cdrnet" in mods
    assert "fast3dhpe_tpu_torch.ops.softargmax" in mods
    for name in ("data.mads", "data.mpii", "data.native_jpeg",
                 "data.synthetic", "data.loader", "data.stream",
                 "data.extract", "apps.eval_loop", "apps.extract_data",
                 "train.checkpoint", "train.loop2d", "train.loop_cdr",
                 "train.resilience", "utils.logging", "utils.interrupt",
                 "utils.profiling", "utils.visualize", "utils.render",
                 "apps.train", "apps.train_cdr", "apps.inference",
                 "apps.baseline", "apps.display_data_2d",
                 "apps.display_data_3d", "ops.quant", "models.quantized",
                 "export", "apps.export", "parallel", "parallel.mesh",
                 "parallel.distributed"):
        assert f"fast3dhpe_tpu_torch.{name}" in mods, name
    # -I: no PYTHONPATH and no user site, so nothing but the port is loaded
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules)))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert bad == [], bad
    assert "triton" not in loaded       # the port has no Triton kernel
    # cv2, PIL and matplotlib are imported where a frame is read, written
    # or drawn, not before
    assert not {"cv2", "PIL", "matplotlib"} & {m.split(".")[0]
                                                for m in loaded}


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_source_names_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    pkg = os.path.join(ROOT, "fast3dhpe_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for name in _imported_names(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
