"""Time the soft-argmax kernels (fast3dhpe_tpu_torch/csrc/softargmax.cu)
over launch plans and source variants on one GPU.

    python3 scripts/softargmax_plan_sweep.py [--variants]

On the decoder's logits (64x64 heatmaps, 19 joints, channels_last): K1 at
2 and 64 images in bf16 and at 64 in fp32, for each chunk size in pixels;
K2 at 64 images in fp32 and bf16, for each chunk size in 16-byte vectors.
With --variants instead: K1 at 64 images, bf16 and fp32, built from
edited copies of the source (VARIANTS: its per-element work, its
combining tail, its cluster combine or its tile loop taken out, another
ring depth or run length, conditional loads) into build/sweep/. Each time is
chip_smoke.device_ms, L2 cold. The plan that ops/softargmax.py
launch_plan picks is marked with '*'. Prints a line a plan, then one JSON
object. Needs a CUDA device.
"""

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from fast3dhpe_tpu_torch.ops import _build  # noqa: E402
from fast3dhpe_tpu_torch.ops import softargmax as sa  # noqa: E402

K1_CHUNKS = (512, 1024, 2048, 4096)        # at most 8 CTAs an image
K2_CHUNKS = (256, 512, 1024, 2048, 4096, 8192, 19456)


# name -> [(text of csrc/softargmax.cu, its replacement), ...]
NO_COMPUTE = ("    float v[kRun];\n",
              "    if (W > 0) continue;\n    float v[kRun];\n")
NO_TAIL = ("  cp_async_wait<0>();\n\n",
           "  cp_async_wait<0>();\n  if (W > 0) {\n"
           "    if (m + s + sx + sy == 1234.5f) out[0] = 0.f;\n"
           "    return;\n  }\n\n")
NO_LOOP = ("  const int tiles = (p_end - p_begin + tpix - 1) / tpix;",
           "  const int tiles = 0 * (p_end - p_begin + tpix);")
NO_COMBINE = ("  cluster.sync();\n",
              "  if (W > 0) return;\n  cluster.sync();\n")
VARIANTS = {
    "as built": [],
    "no compute": [NO_COMPUTE],
    "no tail": [NO_TAIL],
    "loads only": [NO_COMPUTE, NO_TAIL],
    "tail only": [NO_LOOP],
    "no cluster combine": [NO_COMBINE],
    "2 stages": [("constexpr int kStages = 3;",
                  "constexpr int kStages = 2;")],
    "4 stages": [("constexpr int kStages = 3;",
                  "constexpr int kStages = 4;")],
    "runs of 8": [("constexpr int kRun = 16;", "constexpr int kRun = 8;")],
    "runs of 32": [("constexpr int kRun = 16;", "constexpr int kRun = 32;")],
    # the loads of a run's short tail behind a branch, as first written
    "conditional loads": [(
        "      const float raw = to_float(run[i * J]);\n"
        "      v[i] = i < cnt ? raw : -INFINITY;",
        "      v[i] = i < cnt ? to_float(run[i * J]) : -INFINITY;")],
}


def _ceil_div(a, b):
    return -(-a // b)


def build_variants():
    """Compile each variant (all nvcc processes at once); returns
    {name: K1 entry}."""
    src = (_build.CSRC_DIR / "softargmax.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"softargmax_plan_sweep: variant {name!r} does not "
                         f"apply to the source")
            text = text.replace(old, new)
        cu = out_dir / f"softargmax_v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libsoftargmax_v{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    entries = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for variant {name!r}:\n{log}")
        fwd = ctypes.CDLL(str(so)).softargmax_fwd
        fwd.argtypes = sa._entries()[0].argtypes
        fwd.restype = ctypes.c_int
        entries[name] = fwd
    return entries


def sweep_variants(gen, dev):
    entries = build_variants()
    k2 = sa._entries()[1]
    rows = []
    for n, dt in (cs.K1_TIMED[0], cs.K1_TIMED[2]):
        hm = cs._decoder_logits(gen, dev, n, dt)
        for chunk in (sa._plan_of(hm).chunk_pix, 512):
            plan = dataclasses.replace(sa._plan_of(hm), chunk_pix=chunk,
                                       chunks=_ceil_div(64 * 64, chunk))
            for name, fwd in entries.items():
                sa._entries = lambda f=fwd: (f, k2)
                try:
                    ms = cs.device_ms(lambda: sa._fwd_cuda(hm, plan),
                                      "softargmax_fwd", cold=True)
                except RuntimeError as err:       # recorded, not timed
                    print(f"K1 {name}: {err}")
                    ms = None
                    continue
                rows.append({"variant": name, "n": n, "dtype": str(dt),
                             "chunk_pix": chunk, "device_ms_cold": ms})
                print(f"K1 {name}: n={n} {dt} chunk {chunk} px: "
                      f"{ms:.4f} ms")
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("softargmax_plan_sweep: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    gen = torch.Generator().manual_seed(cs.SEED)
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--variants"]:
        print(json.dumps({"variants": sweep_variants(gen, dev)}))
        return
    out = {"k1": [], "k2": []}
    for n, dt in cs.K1_TIMED:
        hm = cs._decoder_logits(gen, dev, n, dt)
        picked = sa._plan_of(hm)
        for chunk in sorted(set(K1_CHUNKS) | {picked.chunk_pix}):
            plan = dataclasses.replace(picked, chunk_pix=chunk,
                                       chunks=_ceil_div(64 * 64, chunk))
            ms = cs.device_ms(lambda: sa._fwd_cuda(hm, plan),
                              "softargmax_fwd", cold=True)
            row = {"n": n, "dtype": str(dt), "chunk_pix": chunk,
                   "ctas": n * plan.chunks, "device_ms_cold": ms,
                   "picked": plan == picked}
            out["k1"].append(row)
            print(f"K1 n={n} {dt} chunk {chunk} px, {row['ctas']} CTAs: "
                  f"{ms:.4f} ms{' *' if row['picked'] else ''}")
    for n, dt in cs.K2_TIMED:
        hm = cs._decoder_logits(gen, dev, n, dt)
        g = torch.randn((n, 19, 2), generator=gen).to(dev)
        picked = sa._plan_of(hm)
        _, stats = sa._fwd_cuda(hm, picked)
        nvec = 64 * 64 * 19 * hm.element_size() // 16
        for chunk in sorted(set(K2_CHUNKS) | {picked.bwd_chunk_vec}):
            plan = dataclasses.replace(picked, bwd_chunk_vec=chunk,
                                       bwd_chunks=_ceil_div(nvec, chunk))
            ms = cs.device_ms(lambda: sa._bwd_cuda(hm, stats, g, plan),
                              "softargmax_bwd", cold=True)
            row = {"n": n, "dtype": str(dt), "chunk_vec": chunk,
                   "ctas": n * plan.bwd_chunks, "device_ms_cold": ms,
                   "picked": plan == picked}
            out["k2"].append(row)
            print(f"K2 n={n} {dt} chunk {chunk} vectors, {row['ctas']} "
                  f"CTAs: {ms:.4f} ms{' *' if row['picked'] else ''}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
