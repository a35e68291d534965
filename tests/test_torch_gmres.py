"""The port's GMRES against the JAX package's on small dense systems."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.solver import gmres as jgmres
from fast_solver_lippmann_schwinger_tpu_torch.solver import gmres as tgmres
from torch_threads import few_threads  # noqa: F401

N = 40


def _system(seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(N) * 4 + 0.7 * (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    Minv = np.linalg.inv(A + 0.15 * (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))))
    B = rng.standard_normal((3, N)) + 1j * rng.standard_normal((3, N))
    return A, Minv, B


def _callables(A, Minv, precond):
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    jM, tM = jnp.asarray(Minv), torch.as_tensor(Minv)
    return (
        (lambda v: jA @ v), (lambda v: tA @ v),
        (lambda v: jM @ v) if precond else None,
        (lambda v: tM @ v) if precond else None,
    )


def _compare_info(info, jinfo, tol=1e-8):
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it
    assert bool(info.converged) == bool(jinfo.converged)
    want = np.asarray(jinfo.residuals)
    got = info.residuals.numpy()
    assert got.shape == want.shape
    # complex128 on both sides; the port rotates on the host in complex128
    # too, so the histories agree to rounding (rtol 1e-8), with an absolute
    # floor at rounding level of the initial norm
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-13 * want[0])
    assert not got[n_it + 1:].any()


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("restart,maxiter", [(20, 60), (5, 40), (20, 12), (3, 6)])
def test_gmres_matches(precond, restart, maxiter):
    A, Minv, B = _system()
    jmv, tmv, jpc, tpc = _callables(A, Minv, precond)
    kw = dict(rtol=1e-9, restart=restart, maxiter=maxiter)
    jx, jinfo = jgmres.gmres(jmv, jnp.asarray(B[0]), preconditioner=jpc, **kw)
    tx, info = tgmres.gmres(tmv, torch.as_tensor(B[0]), preconditioner=tpc, **kw)
    _compare_info(info, jinfo)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8, atol=1e-10)
    want_true = np.linalg.norm(B[0] - A @ tx.numpy()) / np.linalg.norm(B[0])
    assert float(info.true_residual) == pytest.approx(want_true, rel=1e-6, abs=1e-15)
    if bool(info.converged) and precond:
        assert float(info.true_residual) < 1e-7


def test_gmres_x0_and_atol_match():
    A, Minv, B = _system(1)
    jmv, tmv, jpc, tpc = _callables(A, Minv, True)
    x0 = np.random.default_rng(5).standard_normal(N) + 0j
    kw = dict(rtol=1e-7, atol=1e-6, restart=8, maxiter=32)
    jx, jinfo = jgmres.gmres(jmv, jnp.asarray(B[1]), preconditioner=jpc, x0=jnp.asarray(x0), **kw)
    tx, info = tgmres.gmres(tmv, torch.as_tensor(B[1]), preconditioner=tpc, x0=torch.as_tensor(x0), **kw)
    _compare_info(info, jinfo)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8, atol=1e-10)


def test_gmres_zero_rhs_converges_at_once():
    A, _, _ = _system()
    tA = torch.as_tensor(A)
    x, info = tgmres.gmres(lambda v: tA @ v, torch.zeros(N, dtype=torch.complex128), atol=1e-12)
    assert bool(info.converged) and int(info.n_iterations) == 0 and not x.any()


def test_gmres_complex64_runs_in_working_dtype():
    A, Minv, B = _system(2)
    tA, tM = torch.as_tensor(A).to(torch.complex64), torch.as_tensor(Minv).to(torch.complex64)
    b = torch.as_tensor(B[0]).to(torch.complex64)
    x, info = tgmres.gmres(lambda v: tA @ v, b, preconditioner=lambda v: tM @ v, rtol=1e-5)
    assert x.dtype == torch.complex64 and info.residuals.dtype == torch.float32
    assert bool(info.converged) and float(info.true_residual) < 1e-4


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("restart,maxiter", [(20, 60), (5, 40), (20, 12)])
def test_gmres_batched_matches(precond, restart, maxiter):
    A, Minv, B = _system(3)
    # rows of different difficulty converge at different iterations
    B[1] = 1e-3 * B[1] + Minv @ B[1]
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    jM, tM = jnp.asarray(Minv), torch.as_tensor(Minv)
    kw = dict(rtol=1e-9, restart=restart, maxiter=maxiter)
    jX, jinfo = jgmres.gmres_batched(
        lambda V: V @ jA.T, jnp.asarray(B),
        preconditioner=(lambda V: V @ jM.T) if precond else None, **kw)
    tX, info = tgmres.gmres_batched(
        lambda V: V @ tA.T, torch.as_tensor(B),
        preconditioner=(lambda V: V @ tM.T) if precond else None, **kw)
    np.testing.assert_array_equal(info.n_iterations.numpy(), np.asarray(jinfo.n_iterations))
    np.testing.assert_array_equal(info.converged.numpy(), np.asarray(jinfo.converged))
    want = np.asarray(jinfo.residuals)
    np.testing.assert_allclose(info.residuals.numpy(), want, rtol=1e-8, atol=1e-13 * want.max())
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-8, atol=1e-10)
    want_true = np.linalg.norm(B - tX.numpy() @ A.T, axis=1) / np.linalg.norm(B, axis=1)
    np.testing.assert_allclose(info.true_residual.numpy(), want_true, rtol=1e-6, atol=1e-15)


def test_gmres_batched_rows_match_single_solves():
    A, Minv, B = _system(4)
    tA, tM = torch.as_tensor(A), torch.as_tensor(Minv)
    kw = dict(rtol=1e-9, restart=10, maxiter=40)
    X, info = tgmres.gmres_batched(lambda V: V @ tA.T, torch.as_tensor(B),
                                   preconditioner=lambda V: V @ tM.T, **kw)
    for i in range(B.shape[0]):
        x, one = tgmres.gmres(lambda v: tA @ v, torch.as_tensor(B[i]),
                              preconditioner=lambda v: tM @ v, **kw)
        n_it = int(one.n_iterations)
        assert int(info.n_iterations[i]) == n_it
        np.testing.assert_allclose(info.residuals[i, : n_it + 1].numpy(),
                                   one.residuals[: n_it + 1].numpy(), rtol=1e-8,
                                   atol=1e-13 * float(one.residuals[0]))
        np.testing.assert_allclose(X[i].numpy(), x.numpy(), rtol=1e-8, atol=1e-11)
