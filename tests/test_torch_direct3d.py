"""The port's 3D plane block-Thomas factorization and its substitution scans
(full and bf16 pivots, the support / cached / resumed solves) against the
JAX package and against a dense solve, on the random stencil of
``tests/test_pallas_plane.py`` (L, M, N = 6, 5, 7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix3D as JStencilMatrix3D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from torch_threads import few_threads  # noqa: F401

L, M, N = 6, 5, 7
MN = M * N


def _values(dtype):
    rng = np.random.default_rng(9)
    vals = rng.standard_normal((L, M, N, 3, 3, 3)) + 1j * rng.standard_normal((L, M, N, 3, 3, 3))
    vals = vals.astype(dtype)
    vals[:, :, :, 1, 1, 1] += 30.0
    return vals


def _rand(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def c128():
    vals = _values(np.complex128)
    jfac = jdirect.factor_stencil_3d(JStencilMatrix3D(values=jnp.asarray(vals)))
    st = convert.stencil_matrix_3d(vals, device="cpu")
    return vals, st, jfac, direct.factor_stencil_3d(st)


@pytest.fixture(scope="module")
def bf16():
    """complex64 stencil, bf16 pivots on both sides, and the JAX stack's
    planes carried across (the two complex64 factorizations round
    differently, so a few bf16 entries differ between them)."""
    vals = _values(np.complex64)
    jfac = jdirect.factor_stencil_3d(JStencilMatrix3D(values=jnp.asarray(vals)), pivot_dtype="bf16")
    tfac = direct.factor_stencil_3d(convert.stencil_matrix_3d(vals, device="cpu"), pivot_dtype="bf16")
    carried = convert.factorization_3d(
        np.asarray(jfac.lsten), np.asarray(jfac.usten),
        cinv_re=np.asarray(jfac.cinv_re).view(np.uint16),
        cinv_im=np.asarray(jfac.cinv_im).view(np.uint16), device="cpu")
    return jfac, tfac, carried


def test_dense_plane_stencil_matches(c128):
    vals = c128[0]
    sten = vals[2, :, :, 0]
    np.testing.assert_array_equal(direct._plane_stencil_to_dense(torch.as_tensor(sten)).numpy(),
                                  np.asarray(jdirect._plane_stencil_to_dense(jnp.asarray(sten))))
    v = _rand(np.random.default_rng(0), (M, N, 3))
    np.testing.assert_allclose(
        direct._plane_stencil_matvec(torch.as_tensor(sten), torch.as_tensor(v)).numpy(),
        np.asarray(jdirect._plane_stencil_matvec(jnp.asarray(sten), jnp.asarray(v))), rtol=1e-14)


def test_full_factorization_matches(c128):
    """complex128: the same recursion, agreement to rounding."""
    _, _, jfac, tfac = c128
    assert tfac.cinv.shape == (L, MN, MN)
    np.testing.assert_allclose(tfac.cinv.numpy(), np.asarray(jfac.cinv), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jfac.cinv)).max())
    np.testing.assert_array_equal(tfac.lsten.numpy(), np.asarray(jfac.lsten))
    np.testing.assert_array_equal(tfac.usten.numpy(), np.asarray(jfac.usten))


def test_bf16_factorization_matches(bf16):
    """bf16 pivots: one bf16 rounding of planes that agree to complex64
    rounding, so within 2^-8 of the plane's largest entry."""
    jfac, tfac, _ = bf16
    for got, want in ((tfac.cinv_re, jfac.cinv_re), (tfac.cinv_im, jfac.cinv_im)):
        assert got.dtype == torch.bfloat16 and got.shape == (L, MN, MN)
        want = np.asarray(want.astype(jnp.float32))
        assert np.max(np.abs(got.float().numpy() - want)) <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(L * MN,), (L, MN), (L * MN, 2), (L, MN, 3)])
def test_solve_matches_dense(c128, shape):
    vals, st, _, tfac = c128
    b = _rand(np.random.default_rng(1), shape)
    x = direct.block_thomas_solve_3d(tfac, torch.as_tensor(b)).numpy()
    assert x.shape == b.shape
    want = np.linalg.solve(st.to_dense(), b.reshape(L * MN, -1)).reshape(shape)
    np.testing.assert_allclose(x, want, rtol=0, atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("r", [1, 2])
def test_support_cached_resume_match(c128, r):
    """The variants the sweeps use, full pivots, complex128, against JAX."""
    _, _, jfac, tfac = c128
    shape = (L * MN,) if r == 1 else (L * MN, r)
    b = _rand(np.random.default_rng(2 + r), shape)
    bz = b.copy()
    bz[: 2 * MN] = 0
    tol = 1e-11
    got = direct.block_thomas_solve_support_3d(tfac, torch.as_tensor(bz), start=2, tail=3)
    want = jdirect.block_thomas_solve_support_3d(jfac, jnp.asarray(bz), start=2, tail=3)
    assert _relerr(got, want) < tol
    tx, ty, tt = direct.block_thomas_solve_cached_3d(tfac, torch.as_tensor(b), 3)
    jx, jy, jt = jdirect.block_thomas_solve_cached_3d(jfac, jnp.asarray(b), 3)
    for g, w in ((tx, jx), (ty, jy), (tt, jt)):
        assert g.shape == w.shape and _relerr(g, w) < tol
    got = direct.block_thomas_solve_resume_3d(tfac, torch.as_tensor(b), ty, tt, 3)
    want = jdirect.block_thomas_solve_resume_3d(jfac, jnp.asarray(b), jy, jt, 3)
    assert _relerr(got, want) < tol
    # resuming with a rhs changed only on the last planes equals a full solve
    b2 = b.copy()
    b2[(L - 3) * MN :] += 1.0
    got = direct.block_thomas_solve_resume_3d(tfac, torch.as_tensor(b2), ty, tt, 3)
    full = direct.block_thomas_solve_3d(tfac, torch.as_tensor(b2))
    assert _relerr(got, full) < tol


@pytest.mark.parametrize("shape", [(L * MN,), (L * MN, 2)])
def test_bf16_solve_matches_on_carried_pivots(bf16, shape):
    """The same bf16 planes on both sides: f32 accumulation order only."""
    jfac, _, carried = bf16
    b = _rand(np.random.default_rng(5), shape, np.complex64)
    got = direct.block_thomas_solve_3d(carried, torch.as_tensor(b))
    want = jdirect.block_thomas_solve_3d(jfac, jnp.asarray(b))
    assert got.dtype == torch.complex64 and _relerr(got, want) < 1e-5


def test_unported_pivot_modes_raise(c128):
    """Every pivot storage of the JAX package's ``factor_stencil_3d`` is
    ported (int8: ``tests/test_torch_int8_planes.py``); an unknown one
    raises."""
    st = c128[1]
    assert isinstance(direct.factor_stencil_3d(st, pivot_dtype="int8"),
                      direct.BlockTridiagFactorization3DInt8)
    with pytest.raises(ValueError):
        direct.factor_stencil_3d(st, pivot_dtype="fp8")
