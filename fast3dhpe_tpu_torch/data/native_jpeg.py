"""ctypes binding to the native batch JPEG decoder, native/jpeg_decoder.cpp.
The port's own binding beside fast3dhpe_tpu/data/native_jpeg.py (:54-104):
the same C functions, error codes and BGR uint8 output as cv2.imread.

The source is read, never written: g++ builds it on first use into
`build/jpeg/libf3djpeg-<hash>.so` at the root of the checkout (a directory
git ignores), named by a hash of the source and the flags, as
ops/_build.py names the kernels. A host without g++ or libjpeg's headers
has no native decoder: `available()` is False and `build_error()` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "jpeg_decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jpeg"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-pthread")

_lock = threading.Lock()
_state = {"lib": None, "tried": False, "error": None}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libf3djpeg-{digest[:12]}.so"


def _build(out: Path) -> Optional[str]:
    """g++ the source into `out`; None on success, else why it failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ could not run: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"g++ failed: {proc.stderr.strip()[-500:]}"
    os.replace(tmp, out)            # atomic against a parallel build
    return None


def _load():
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        if not SRC.exists():
            _state["error"] = f"{SRC} is missing"
            return None
        out = library_path()
        if not out.exists():
            _state["error"] = _build(out)
            if _state["error"]:
                return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            _state["error"] = f"cannot load {out}: {e}"
            return None
        lib.f3d_decode_jpeg_batch.restype = ctypes.c_int
        lib.f3d_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.f3d_probe_jpeg.restype = ctypes.c_int
        lib.f3d_probe_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _state["lib"] = lib
        return lib


def available() -> bool:
    """True when the library is built (or could be built now) and loads."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native decoder is unavailable, or None."""
    _load()
    return _state["error"]


def probe(path: str) -> Optional[Tuple[int, int]]:
    """(height, width) of a JPEG, or None when the header cannot be read
    or the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.f3d_probe_jpeg(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        return None
    return h.value, w.value


def decode_batch(paths: List[str], height: int, width: int,
                 n_threads: int = 4) -> Optional[np.ndarray]:
    """Decode same-size JPEGs into one (N, H, W, 3) BGR uint8 array, the
    GIL released for the whole batch.

    Returns None when the library is unavailable; raises ValueError naming
    a file that failed to open or decode or is not height x width x 3.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.f3d_decode_jpeg_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        height, width, n_threads)
    if rc != 0:
        raise ValueError(f"native JPEG decode failed for {paths[rc - 1]!r} "
                         f"(expected {height}x{width}x3)")
    return out
