"""The port's full-precision block-Thomas solver against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix2D as JStencilMatrix2D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix2D
from torch_threads import few_threads  # noqa: F401

M, N = 8, 11
RTOL = 1e-9   # complex128 on both sides; LAPACK inversions differ in rounding only


def _values(seed, batch=()):
    rng = np.random.default_rng(seed)
    shape = batch + (M, N, 3, 3)
    v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    v[..., 1, 1] += 8.0      # diagonally dominant: well-conditioned pivots
    return v


@pytest.fixture(scope="module")
def facs():
    v = _values(0)
    jf = jdirect.factor_stencil_2d(JStencilMatrix2D(values=jnp.asarray(v)))
    tf = direct.factor_stencil_2d(StencilMatrix2D(values=torch.as_tensor(v)))
    return v, jf, tf


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


def test_factorization_matches(facs):
    _, jf, tf = facs
    _close(tf.cinv, jf.cinv)
    _close(tf.lband, jf.lband)
    _close(tf.uband, jf.uband)


def test_batched_factorization_matches():
    v = _values(1, batch=(2,))
    jf = jax.vmap(lambda w: jdirect.factor_stencil_2d(JStencilMatrix2D(values=w)))(jnp.asarray(v))
    tf = direct.factor_stencil_values(torch.as_tensor(v))
    _close(tf.cinv, jf.cinv)
    _close(tf.slab(1).cinv, jf.cinv[1])


def test_band_helpers_match():
    rng = np.random.default_rng(2)
    band = rng.standard_normal((N, 3)) + 1j * rng.standard_normal((N, 3))
    mat = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    vec = rng.standard_normal((N, 2)) + 1j * rng.standard_normal((N, 2))
    tb, tm = torch.as_tensor(band), torch.as_tensor(mat)
    _close(direct.band_matvec(tb, torch.as_tensor(vec)), jdirect.band_matvec(jnp.asarray(band), jnp.asarray(vec)), 1e-14)
    _close(direct.band_matvec(tb, tm), jdirect.band_matvec(jnp.asarray(band), jnp.asarray(mat)), 1e-14)
    _close(direct._band_mul_left(tb, tm), jdirect.band_matvec(jnp.asarray(band), jnp.asarray(mat)), 1e-14)
    _close(direct._band_mul_right(tm, tb), jdirect._band_mul_right(jnp.asarray(mat), jnp.asarray(band)), 1e-14)
    _close(direct._band_to_dense(tb), jdirect._band_to_dense(jnp.asarray(band)), 1e-14)


@pytest.mark.parametrize("shape", [(M * N,), (M, N), (M, N, 2), (M * N, 3)])
def test_solve_matches(facs, shape):
    v, jf, tf = facs
    rng = np.random.default_rng(3)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    want = jdirect.block_thomas_solve(jf, jnp.asarray(b))
    got = direct.block_thomas_solve(tf, torch.as_tensor(b))
    assert tuple(got.shape) == shape
    _close(got, want)


def test_solve_inverts_the_stencil_matrix(facs):
    v, _, tf = facs
    s = StencilMatrix2D(values=torch.as_tensor(v))
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(M * N) + 0j)
    x = direct.block_thomas_solve(tf, b)
    np.testing.assert_allclose(s.matvec(x).numpy(), b.numpy(), rtol=0, atol=1e-11)


@pytest.mark.parametrize("start,tail", [(3, 0), (0, 2), (3, 2), (0, M), (M, 0)])
def test_solve_start_tail_matches(facs, start, tail):
    """``start``/``tail`` against the JAX package's
    ``block_thomas_solve_support``; the kept lines are exact."""
    _, jf, tf = facs
    rng = np.random.default_rng(5)
    b = rng.standard_normal((M, N, 2)) + 1j * rng.standard_normal((M, N, 2))
    if start < M:
        b[:start] = 0
    want = jdirect.block_thomas_solve_support(jf, jnp.asarray(b), start=start, tail=tail)
    got = direct.block_thomas_solve(tf, torch.as_tensor(b), start=start, tail=tail)
    _close(got, want)
    full = direct.block_thomas_solve(tf, torch.as_tensor(b))
    keep = slice(M - tail, M) if 0 < tail < M else slice(0, M)
    _close(got[keep], full[keep].numpy(), 1e-12)


def test_converted_factorization_solves(facs):
    _, jf, _ = facs
    cf = convert.block_tridiag_factorization(
        np.asarray(jf.cinv), np.asarray(jf.lband), np.asarray(jf.uband), device="cpu"
    )
    b = np.random.default_rng(6).standard_normal((M, N)) + 0j
    _close(direct.block_thomas_solve(cf, torch.as_tensor(b)),
           jdirect.block_thomas_solve(jf, jnp.asarray(b)), 1e-13)


# ---------------------------------------------------------------------------
# The tail, support, cached and resumed solves of the multi-slab sweeps, on
# the carried-over factorization (same pivots on both sides): 1e-12 of the
# max-norm, complex128 matmul order being the only difference.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried(facs):
    _, jf, _ = facs
    cf = convert.block_tridiag_factorization(
        np.asarray(jf.cinv), np.asarray(jf.lband), np.asarray(jf.uband), device="cpu"
    )
    return jf, cf


def _rhs(seed, r):
    rng = np.random.default_rng(seed)
    shape = (M, N) if r is None else (M, N, r)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("r", [None, 3])
@pytest.mark.parametrize("tail", [0, 1, 3, M])
def test_solve_tail_matches(carried, r, tail):
    jf, cf = carried
    b = _rhs(7, r)
    want = jdirect.block_thomas_solve_tail(jf, jnp.asarray(b), tail)
    got = direct.block_thomas_solve_tail(cf, torch.as_tensor(b), tail)
    assert tuple(got.shape) == b.shape
    _close(got, want, 1e-12)
    if 0 < tail < M:
        assert not got[: M - tail].any()


@pytest.mark.parametrize("r", [None, 3])
@pytest.mark.parametrize("start,tail", [(0, 0), (3, 0), (3, 2), (M - 1, 1), (M, 0)])
def test_solve_support_matches(carried, r, start, tail):
    jf, cf = carried
    b = _rhs(8, r)
    if start < M:
        b[:start] = 0
    want = jdirect.block_thomas_solve_support(jf, jnp.asarray(b), start=start, tail=tail)
    got = direct.block_thomas_solve_support(cf, torch.as_tensor(b), start=start, tail=tail)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("r", [None, 3])
@pytest.mark.parametrize("tail", [0, 3])
def test_solve_cached_matches(carried, r, tail):
    jf, cf = carried
    b = _rhs(9, r)
    jx, jy, jt = jdirect.block_thomas_solve_cached(jf, jnp.asarray(b), tail)
    x, y, t = direct.block_thomas_solve_cached(cf, torch.as_tensor(b), tail)
    assert tuple(y.shape) == tuple(t.shape) == np.asarray(jy).shape
    _close(x, jx, 1e-12)
    _close(y, jy, 1e-12)
    _close(t, jt, 1e-12)


@pytest.mark.parametrize("r", [None, 3])
@pytest.mark.parametrize("resume", [0, 1, 3, M - 1, M])
def test_solve_resume_matches_and_equals_full_solve(carried, r, resume):
    """The rhs of the resumed solve differs from the cached one's on the last
    ``resume`` lines only; the result equals a full solve bit for bit."""
    jf, cf = carried
    b = _rhs(10, r)
    b2 = b.copy()
    if 0 < resume:
        b2[M - resume:] += _rhs(11, r)[M - resume:]
    _, jy, jt = jdirect.block_thomas_solve_cached(jf, jnp.asarray(b), 2)
    _, y, t = direct.block_thomas_solve_cached(cf, torch.as_tensor(b), 2)
    want = jdirect.block_thomas_solve_resume(jf, jnp.asarray(b2), jy, jt, resume)
    got = direct.block_thomas_solve_resume(cf, torch.as_tensor(b2), y, t, resume)
    _close(got, want, 1e-12)
    assert torch.equal(got, direct.block_thomas_solve(cf, torch.as_tensor(b2)))
