"""The port's DLT by "svd" and "sii" and its closed-form two-view
triangulation (fast3dhpe_tpu_torch/geometry/triangulation.py) against the
JAX package's on the same inputs: seeded camera-scale rigs whose
projection matrices reach ~1.5e6 (tests/test_geometry.py two_view_setup),
exact and with 1 px of detection noise, 19 joints.

Tolerances: each method within 1e-4 of the JAX method's largest
coordinate plus 1e-3 mm (fp32 SVDs and solves in another order of
summation), and within 0.05 mm of the true points where the detections
are exact; sii within 5 mm of the jacobi DLT under noise
(triangulation.py:150-152: another weighting of the same system).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast3dhpe_tpu.geometry import triangulation as jtri
from fast3dhpe_tpu_torch.geometry.triangulation import (
    _dlt_system, dlt_triangulate, sii_triangulate, triangulate_closed_form)

from test_geometry import two_view_setup

torch.set_num_threads(2)

REL, ABS = 1e-4, 1e-3


def _system(seed, noise_px):
    P1, P2, X, uv1, uv2 = two_view_setup(seed)
    r = np.random.RandomState(seed + 100)
    uv1 = uv1 + r.randn(*uv1.shape) * noise_px
    uv2 = uv2 + r.randn(*uv2.shape) * noise_px
    proj = np.stack([P1[:3], P2[:3]])[None].repeat(X.shape[0], 0)
    pts = np.stack([uv1, uv2], axis=1)
    return (P1, P2, X, uv1.astype(np.float32), uv2.astype(np.float32),
            proj.astype(np.float32), pts.astype(np.float32))


def _close(got, ref):
    got = got.numpy() if hasattr(got, "numpy") else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL * np.abs(ref).max() + ABS)


def test_rig_reaches_camera_scale():
    """The column equilibration matters only where P's entries are large:
    these rigs' reach ~1e6."""
    _, _, _, _, _, proj, _ = _system(4, 0.0)
    assert np.abs(proj).max() > 1e6


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("noise_px", [0.0, 1.0])
@pytest.mark.parametrize("method", ["svd", "sii", "jacobi"])
def test_dlt_methods_match_jax(seed, noise_px, method):
    _, _, X, _, _, proj, pts = _system(seed, noise_px)
    got = dlt_triangulate(torch.from_numpy(proj), torch.from_numpy(pts),
                          method=method)
    ref = jtri.dlt_triangulate(jnp.asarray(proj), jnp.asarray(pts),
                               method=method)
    _close(got, ref)
    if noise_px == 0.0:
        np.testing.assert_allclose(got.numpy(), X, rtol=1e-3, atol=0.05)
    elif method == "sii":
        jac = dlt_triangulate(torch.from_numpy(proj), torch.from_numpy(pts))
        assert float((got - jac).abs().max()) < 5.0


def test_sii_column_equilibration_matches_jax():
    """The scaled system of sii_triangulate (triangulation.py:161-163):
    each column of A at unit norm; A's entries reach ~1e6 and its column
    norms span more than three orders of magnitude."""
    _, _, _, _, _, proj, pts = _system(6, 1.0)
    A = _dlt_system(torch.from_numpy(proj), torch.from_numpy(pts))
    colnorm = torch.linalg.vector_norm(A, dim=-2)
    assert float(colnorm.max() / colnorm.min()) > 1e3
    An = (A / colnorm[..., None, :]).numpy()
    jA = np.asarray(jtri._dlt_system(jnp.asarray(proj), jnp.asarray(pts)))
    jAn = jA / np.linalg.norm(jA, axis=-2, keepdims=True)
    np.testing.assert_allclose(An, jAn, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(An, axis=-2), 1.0, rtol=1e-6)


@pytest.mark.parametrize("noise_px", [0.0, 1.0])
def test_sii_explicit_start_matches_jax(monkeypatch, noise_px):
    """An explicit start: JAX draws it from a key, the port from a
    torch.Generator; both are fed JAX's draw (the port's torch.rand
    returns it), and 1 and 3 iterations agree."""
    _, _, _, _, _, proj, pts = _system(5, noise_px)
    key = jax.random.PRNGKey(7)
    start = np.array(jax.random.uniform(key, (proj.shape[0], 4),
                                        jnp.float32))
    drawn = []

    def rand(shape, generator=None, dtype=None, device=None):
        assert generator is not None and tuple(shape) == start.shape
        drawn.append(1)
        return torch.from_numpy(start).to(dtype)

    monkeypatch.setattr(torch, "rand", rand)
    for iters in (1, 3):
        got = sii_triangulate(torch.from_numpy(proj), torch.from_numpy(pts),
                              num_iterations=iters,
                              generator=torch.Generator().manual_seed(0))
        ref = jtri.sii_triangulate(jnp.asarray(proj), jnp.asarray(pts),
                                   num_iterations=iters, key=key)
        _close(got, ref)
    assert len(drawn) == 2


def test_sii_generator_start_is_seeded():
    """Two generators of one seed give one answer; the start converges to
    the all-ones start's answer within 0.05 mm on exact detections."""
    _, _, X, _, _, proj, pts = _system(4, 0.0)
    p, q = torch.from_numpy(proj), torch.from_numpy(pts)
    a = sii_triangulate(p, q, generator=torch.Generator().manual_seed(3))
    b = sii_triangulate(p, q, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), sii_triangulate(p, q).numpy(),
                               rtol=1e-4, atol=0.05)


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("noise_px", [0.0, 1.0])
def test_closed_form_matches_jax(seed, noise_px):
    P1, P2, X, uv1, uv2, _, _ = _system(seed, noise_px)
    got = triangulate_closed_form(P1, P2, uv1, uv2)
    ref = jtri.triangulate_closed_form(jnp.asarray(P1), jnp.asarray(P2),
                                       jnp.asarray(uv1), jnp.asarray(uv2))
    assert got.shape == (19, 3)
    _close(got, ref)
    if noise_px == 0.0:
        np.testing.assert_allclose(got.numpy(), X, rtol=1e-3, atol=0.05)


def test_svd_method_is_differentiable():
    """torch.linalg.svd with full_matrices=False has a gradient, as JAX's
    svd needs for training with DLT_METHOD svd."""
    _, _, _, _, _, proj, pts = _system(4, 1.0)
    q = torch.from_numpy(pts).requires_grad_()
    dlt_triangulate(torch.from_numpy(proj), q, method="svd").sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
