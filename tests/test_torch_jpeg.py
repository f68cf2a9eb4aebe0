"""The PyTorch port's JPEG decoding (fast3dhpe_tpu_torch/data/native_jpeg.py
and loader.py's _BatchDecoder) against the JAX package's binding of the
same native/jpeg_decoder.cpp and against cv2.imread, on the CPU.

Tolerance: the port's native decode is bit-equal to JAX's; against
cv2.imread (its own bundled libjpeg) within 2 levels and 0.1 on average,
tests/test_native_jpeg.py's bound, and so is the PIL route. Skipped
without g++ and libjpeg, or without cv2, as that file skips."""

import os
import sys

import numpy as np
import pytest
import torch

from fast3dhpe_tpu.data import native_jpeg as jax_native_jpeg
from fast3dhpe_tpu_torch.data import loader, native_jpeg

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_native():
    if not native_jpeg.available():
        pytest.skip(f"native decoder unavailable: "
                    f"{native_jpeg.build_error()}")


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Six 96x128 noise JPEGs at quality 92 and one 64x80."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        p = str(d / f"img_{i}.jpg")
        cv2.imwrite(p, rng.randint(0, 256, (96, 128, 3), dtype=np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 92])
        paths.append(p)
    odd = str(d / "odd.jpg")
    cv2.imwrite(odd, rng.randint(0, 256, (64, 80, 3), dtype=np.uint8))
    return paths, odd


def _near(got, ref):
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 2 and d.mean() < 0.1, (d.max(), d.mean())


def test_builds_into_build_dir_and_leaves_native_untouched(tmp_path,
                                                           monkeypatch):
    """A fresh build goes to the build directory, named by the source's
    hash; the source and native/ stay as they were."""
    _need_native()
    native = os.path.join(ROOT, "native")
    src = os.path.join(native, "jpeg_decoder.cpp")
    before = {n: os.stat(os.path.join(native, n)).st_mtime_ns
              for n in os.listdir(native)}
    src_bytes = open(src, "rb").read()
    assert native_jpeg.library_path().parent == \
        native_jpeg.Path(ROOT) / "build" / "jpeg"
    monkeypatch.setattr(native_jpeg, "BUILD_DIR", tmp_path / "jpeg")
    monkeypatch.setattr(native_jpeg, "_state",
                        {"lib": None, "tried": False, "error": None})
    assert native_jpeg.available()
    built = native_jpeg.library_path()
    assert built.parent == tmp_path / "jpeg" and built.exists()
    assert built.name.startswith("libf3djpeg-")
    assert open(src, "rb").read() == src_bytes
    after = {n: os.stat(os.path.join(native, n)).st_mtime_ns
             for n in os.listdir(native)}
    # native/libf3djpeg.so is the JAX binding's own build, which other test
    # files may make meanwhile; the port never writes there
    before.pop("libf3djpeg.so", None)
    after.pop("libf3djpeg.so", None)
    assert after == before


def test_probe(jpegs):
    _need_native()
    paths, odd = jpegs
    assert native_jpeg.probe(paths[0]) == (96, 128)
    assert native_jpeg.probe(odd) == (64, 80)
    assert native_jpeg.probe(os.path.join(ROOT, "README.md")) is None


def test_decode_batch_matches_jax_and_cv2(jpegs):
    _need_native()
    if not jax_native_jpeg.available():
        pytest.skip("the JAX package's native decoder is unavailable")
    paths, _ = jpegs
    for threads in (1, 3):
        got = native_jpeg.decode_batch(paths, 96, 128, n_threads=threads)
        assert got.shape == (6, 96, 128, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(
            got, jax_native_jpeg.decode_batch(paths, 96, 128))
    for img, p in zip(got, paths):
        _near(img, cv2.imread(p, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("hw", [(100, 100), (96, 127), (64, 80)])
def test_wrong_size_raises(jpegs, hw):
    _need_native()
    paths, _ = jpegs
    with pytest.raises(ValueError, match=r"img_\d.jpg"):
        native_jpeg.decode_batch(paths, *hw)


def test_missing_file_raises():
    _need_native()
    with pytest.raises(ValueError, match="nonexistent"):
        native_jpeg.decode_batch(["/nonexistent.jpg"], 96, 128)


def test_pil_route_is_bgr(tmp_path):
    """A frame that is blue on the left and red on the right reads back as
    cv2 reads it (BGR), by the PIL route."""
    img = np.zeros((32, 64, 3), np.uint8)
    img[:, :32, 0] = 255                 # BGR: blue
    img[:, 32:, 2] = 255                 # red
    p = str(tmp_path / "br.jpg")
    cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, 100])
    got = loader._read("PIL", p)
    assert got.shape == (32, 64, 3) and got.flags["C_CONTIGUOUS"]
    _near(got, cv2.imread(p, cv2.IMREAD_COLOR))
    assert got[16, 8, 0] > 200 and got[16, 8, 2] < 50
    assert got[16, 56, 2] > 200 and got[16, 56, 0] < 50


def test_batch_decoder_routes(jpegs, monkeypatch):
    """native where it builds (frames bit-equal to JAX's); cv2, then PIL
    where it does not; each names itself."""
    paths, _ = jpegs
    pool = loader.shared_decode_pool()
    dec = loader._BatchDecoder(pool)
    if native_jpeg.available():
        assert dec.name == "native libjpeg"
        np.testing.assert_array_equal(
            np.stack(dec(paths)), native_jpeg.decode_batch(paths, 96, 128))
    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    dec = loader._BatchDecoder(pool)
    assert dec.name == "cv2"
    ref = [cv2.imread(p, cv2.IMREAD_COLOR) for p in paths]
    for a, b in zip(dec(paths), ref):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setitem(sys.modules, "cv2", None)
    dec = loader._BatchDecoder(pool)
    assert dec.name == "PIL"
    for a, b in zip(dec(paths), ref):
        _near(a, b)


def test_no_route_names_what_is_missing(monkeypatch):
    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    monkeypatch.setattr(native_jpeg, "build_error",
                        lambda: "g++ failed: jpeglib.h: No such file")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="jpeglib.h.*neither cv2 nor PIL"):
        loader._BatchDecoder(loader.shared_decode_pool())
    with pytest.raises(RuntimeError, match="cv2 or PIL"):
        loader._imread("any.jpg")


def test_native_swaps_once_on_mixed_sizes_and_raises_on_broken(jpegs,
                                                               tmp_path):
    """JAX's one swap: a frame of another size hands the run to cv2, and
    the name says so; a file that is no JPEG raises instead."""
    _need_native()
    paths, odd = jpegs
    dec = loader._BatchDecoder(loader.shared_decode_pool())
    assert len(dec(paths[:2])) == 2 and dec.route == "native"
    broken = str(tmp_path / "broken.jpg")
    with open(broken, "wb") as f:
        f.write(b"not a JPEG at all" * 10)
    with pytest.raises(ValueError, match="broken.jpg"):
        dec([paths[1], broken])
    assert dec.route == "native"
    out = dec([paths[2], odd])
    assert dec.route == "cv2" and "mixed sizes" in dec.name
    assert out[1].shape == (64, 80, 3)
    np.testing.assert_array_equal(out[1], cv2.imread(odd, cv2.IMREAD_COLOR))
