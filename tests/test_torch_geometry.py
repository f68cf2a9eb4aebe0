"""Small-matrix geometry of the PyTorch port (fast3dhpe_tpu_torch/ops/
small_svd.py, geometry/triangulation.py) against the JAX package on the
same inputs, on the stereo rig of bench.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast3dhpe_tpu.geometry import triangulation as jtri
from fast3dhpe_tpu.ops import small_svd as jsvd
from fast3dhpe_tpu_torch.geometry.triangulation import (
    _dehomogenize, _dlt_system, dlt_triangulate, pinv_projection)
from fast3dhpe_tpu_torch.ops.small_svd import jacobi_svd, pinv_small

torch.set_num_threads(2)


def _rig(batch):
    """bench.py:29-38: f = 1100 px, principal point (128, 128), cameras at
    x = +-400 mm, 3000 mm from the origin."""
    K = np.array([[1100.0, 0.0, 128.0], [0.0, 1100.0, 128.0],
                  [0.0, 0.0, 1.0]])
    Ps = [K @ np.hstack([np.eye(3), np.array([[dx], [0.0], [3000.0]])])
          for dx in (-400.0, 400.0)]
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


def _observe(seed, B=4, J=19, noise_px=0.5):
    """Known 3D joints (mm) projected into both views, plus pixel noise."""
    r = np.random.RandomState(seed)
    X = r.randn(B, J, 3) * np.array([300.0, 500.0, 200.0])
    P = _rig(B).astype(np.float64)
    Xh = np.concatenate([X, np.ones((B, J, 1))], -1)
    uvw = np.einsum("bvij,bkj->bkvi", P, Xh)               # (B, J, V, 3)
    pts = uvw[..., :2] / uvw[..., 2:3] + r.randn(B, J, 2, 2) * noise_px
    proj = np.broadcast_to(P[:, None], (B, J, 2, 3, 4))
    return (X.astype(np.float32), proj.astype(np.float32),
            pts.astype(np.float32))


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("shape", [(32, 4, 4), (6, 3, 3), (16, 5, 3)])
def test_jacobi_svd_matches_jax(shape):
    A = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    U, S, V = jacobi_svd(torch.from_numpy(A))
    jU, jS, jV = (np.asarray(t) for t in jsvd.jacobi_svd(jnp.asarray(A)))
    assert _rel(S.numpy(), jS) < 1e-4
    # singular vectors up to the sign of each column
    sign = np.sign(np.sum(V.numpy() * jV, axis=-2, keepdims=True))
    assert _rel(V.numpy() * sign, jV) < 1e-4
    assert _rel(U.numpy() * sign, jU) < 1e-4
    recon = np.einsum("...ij,...j,...kj->...ik", U.numpy(), S.numpy(),
                      V.numpy())
    assert _rel(recon, A) < 1e-5


def test_jacobi_sort_is_stable_on_ties():
    """Equal singular values keep their column order, as jnp.argsort."""
    A = np.diag([2.0, 3.0, 2.0, 1.0]).astype(np.float32)[None]
    _, S, V = jacobi_svd(torch.from_numpy(A))
    _, jS, jV = jsvd.jacobi_svd(jnp.asarray(A))
    np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
    np.testing.assert_array_equal(V.numpy(), np.asarray(jV))


def test_pinv_small_and_projection_match_jax():
    P = _rig(3)
    got = pinv_projection(torch.from_numpy(P)).numpy()
    ref = np.asarray(jtri.pinv_projection(jnp.asarray(P)))
    assert got.shape == (3, 2, 4, 3)
    assert _rel(got, ref) < 1e-4
    # rtol = 0: P pinv(P) = I although P's singular values span ~1e6
    np.testing.assert_allclose(np.einsum("...ij,...jk->...ik", P, got),
                               np.broadcast_to(np.eye(3), (3, 2, 3, 3)),
                               atol=1e-4)
    A = np.random.RandomState(1).randn(8, 4, 3).astype(np.float32)
    assert _rel(pinv_small(torch.from_numpy(A)).numpy(),
                np.asarray(jsvd.pinv_small(jnp.asarray(A)))) < 1e-4


def test_dlt_system_rows_and_signs_match_jax():
    _, proj, pts = _observe(0)
    got = _dlt_system(torch.from_numpy(proj), torch.from_numpy(pts))
    ref = np.asarray(jtri._dlt_system(jnp.asarray(proj), jnp.asarray(pts)))
    assert got.shape == (4, 19, 4, 4)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_dehomogenize_floors_w():
    v = np.array([[1.0, 2.0, 3.0, 0.0], [1.0, 2.0, 3.0, -1e-12],
                  [2.0, 4.0, 6.0, 2.0]], np.float32)
    got = _dehomogenize(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jtri._dehomogenize(jnp.asarray(v))))
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("seed", [0, 1])
def test_dlt_triangulate_matches_jax_on_the_rig(seed):
    X, proj, pts = _observe(seed)
    got = dlt_triangulate(torch.from_numpy(proj),
                          torch.from_numpy(pts)).numpy()
    ref = np.asarray(jtri.dlt_triangulate(jnp.asarray(proj),
                                          jnp.asarray(pts)))
    assert _rel(got, ref) < 1e-4
    # and it recovers the points: depth moves Z^2 / (f b) ~ 10 mm per px of
    # disparity on this rig, so 0.5 px of noise stays within a few cm
    assert np.abs(got - X).max() < 50.0


@pytest.mark.parametrize("method", ["svd", "sii"])
def test_unported_dlt_methods_raise(method):
    """"svd" and "sii" raised NotImplementedError until the port took them
    (tests/test_torch_triangulation.py holds them against JAX); now they
    recover the rig's points like "jacobi", and only a method the config
    does not accept raises."""
    X, proj, pts = _observe(0, B=1, noise_px=0.0)
    got = dlt_triangulate(torch.from_numpy(proj), torch.from_numpy(pts),
                          method=method).numpy()
    assert np.abs(got - X).max() < 1.0
    with pytest.raises(ValueError, match="unknown DLT method"):
        dlt_triangulate(torch.from_numpy(proj), torch.from_numpy(pts),
                        method=method + "x")
