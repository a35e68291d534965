"""Differentiable solves of the port against the JAX package: the cases of
``tests/test_adjoint.py`` at h = 1/16 (k = 8, trapezoidal operator at the
reference's exact extended sizes, complex128), each also held against the
JAX function on the same operator, carried across.

Conjugation: for a real loss, ``jax.grad`` with respect to a complex input
gives ``dL/dx - i dL/dy``, PyTorch's autograd ``dL/dx + i dL/dy``: the rhs
gradients agree up to that conjugation; the real medium's gradients agree
as they are."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D as JGrid2D
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.ops.fastconv import (
    build_fast_convolution_2d as jbuild_fast_convolution_2d,
)
from fast_solver_lippmann_schwinger_tpu.precond.sparsifying import (
    SparsifyingPreconditioner as JSparsifyingPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu.precond.sparsifying import (
    SparsifyingPreconditionerT as JSparsifyingPreconditionerT,
)
from fast_solver_lippmann_schwinger_tpu.solver import adjoint as jadjoint
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ops import greens
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner,
    SparsifyingPreconditionerT,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.adjoint import (
    apply_transpose,
    differentiable_solve,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils
from torch_threads import few_threads  # noqa: F401

K = 8.0
TIGHT = dict(rtol=1e-12, restart=40, maxiter=400)


@pytest.fixture(scope="module")
def small_problem():
    """The JAX test's operator, carried across, and the sparsifying
    stencils of each package."""
    grid = JGrid2D(a=1.0, h=1.0 / 16.0)
    X, Y = grid.mesh()
    nu = jmedia.gaussian_bump_2d(X, Y)
    jop = jbuild_fast_convolution_2d(grid.x, grid.y, grid.h, K, nu, quad_rule="trapezoidal",
                                     dtype=jnp.complex128, pad_to_friendly=False)
    op = convert.lippmann_schwinger_2d(np.asarray(jop.symbol), np.asarray(jop.nu), jop.omega,
                                       jop.n, jop.m, jop.quad_rule, device="cpu")
    ja, jag = jstencils.build_sparse_a_ag_2d(K, grid.x, grid.y, grid.h, dtype=jnp.complex128)
    jmsp = jstencils.build_msp_2d(ja, jag, nu, K)
    a, ag = stencils.build_sparse_a_ag_2d(K, grid.x, grid.y, grid.h, dtype=torch.complex128,
                                          device="cpu")
    msp = stencils.build_msp_2d(a, ag, nu, K)
    return grid, X, Y, nu, jop, op, (ja, jmsp), (a, msp)


def _rng_problem(seed, size):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    return b, rng.standard_normal(size)


def test_matrix_transpose_matches_dense(small_problem):
    *_, (ja, jmsp), (a, msp) = small_problem
    got = msp.matrix_transpose()
    np.testing.assert_allclose(got.to_dense(), msp.to_dense().T, rtol=1e-13, atol=1e-15)
    want = np.asarray(jmsp.matrix_transpose().values)
    np.testing.assert_allclose(got.values.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    # on the same entries the transpose is a permutation: bit-equal
    carried = convert.stencil_matrix_2d(np.asarray(ja.values), device="cpu")
    np.testing.assert_array_equal(carried.matrix_transpose().values.numpy(),
                                  np.asarray(ja.matrix_transpose().values))


def test_apply_transpose_matches_dense(small_problem):
    grid, X, Y, nu, jop, op, *_ = small_problem
    d0 = greens.duan_rokhlin_d0(K * grid.h)
    G = greens.dense_conv_matrix_2d(K, X.ravel(), Y.ravel(), d0, grid.h)
    M = np.eye(grid.size) + (K ** 2) * G @ np.diag(nu.ravel())
    x, _ = _rng_problem(0, grid.size)
    got = apply_transpose(op, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, M.T @ x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jadjoint.apply_transpose(jop, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-14)
    y, _ = _rng_problem(5, grid.size)
    # <M x, y> = <x, M^T y> (the bilinear pairing of the transpose)
    lhs = np.sum(op.apply(torch.as_tensor(x)).numpy() * y)
    rhs = np.sum(x * apply_transpose(op, torch.as_tensor(y)).numpy())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_differentiable_solve_matches_gmres(small_problem):
    grid, X, Y, nu, jop, op, *_ = small_problem
    b, _ = _rng_problem(1, grid.size)
    u = differentiable_solve(op, torch.as_tensor(b), **TIGHT)
    want, info = gmres(op.apply, torch.as_tensor(b), **TIGHT)
    assert bool(info.converged)
    np.testing.assert_allclose(u.numpy(), want.numpy(), rtol=1e-8)
    ju = np.asarray(jadjoint.differentiable_solve(jop, jnp.asarray(b), **TIGHT))
    np.testing.assert_allclose(u.numpy(), ju, rtol=1e-8)


def _torch_grads(op, b, w, pc=None, pc_t=None, rtol=1e-13):
    nu = op.nu.clone().requires_grad_()
    bt = torch.as_tensor(b).requires_grad_()
    u = differentiable_solve(dataclasses.replace(op, nu=nu), bt, preconditioner=pc,
                             preconditioner_t=pc_t, rtol=rtol, restart=40, maxiter=400)
    (torch.as_tensor(w) * u.abs() ** 2).sum().backward()
    return nu.grad.numpy(), bt.grad.numpy()


def _jax_loss(jop, w, pc=None, pc_t=None, rtol=1e-13):
    def loss(nu_arr, b_arr):
        u = jadjoint.differentiable_solve(jop.replace(nu=nu_arr), b_arr, preconditioner=pc,
                                          preconditioner_t=pc_t, rtol=rtol, restart=40,
                                          maxiter=400)
        return jnp.sum(jnp.asarray(w) * jnp.abs(u) ** 2)
    return loss


def test_gradient_wrt_medium_matches_finite_differences(small_problem):
    """d/d(nu) of a scalar loss of the solution: the adjoint against central
    differences (rtol 2e-4, the JAX test's) and against ``jax.grad`` (to the
    solve tolerance); the rhs gradient against ``jax.grad``'s conjugate."""
    grid, X, Y, nu, jop, op, *_ = small_problem
    b, w = _rng_problem(2, grid.size)
    g_nu, g_b = _torch_grads(op, b, w)
    jloss = _jax_loss(jop, w)
    jg_nu, jg_b = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(np.asarray(jop.nu)), jnp.asarray(b))
    np.testing.assert_allclose(g_nu, np.asarray(jg_nu), rtol=0, atol=1e-9 * np.abs(jg_nu).max())
    np.testing.assert_allclose(g_b, np.conj(np.asarray(jg_b)), rtol=0,
                               atol=1e-9 * np.abs(jg_b).max())

    def loss(nu_arr):
        u, _ = gmres(dataclasses.replace(op, nu=nu_arr).apply, torch.as_tensor(b), rtol=1e-13,
                     restart=40, maxiter=400)
        return float((torch.as_tensor(w) * u.abs() ** 2).sum())

    eps = 1e-6
    for (j, i) in [(5, 7), (8, 8), (12, 3)]:
        e = torch.zeros_like(op.nu)
        e[j, i] = 1.0
        fd = (loss(op.nu + eps * e) - loss(op.nu - eps * e)) / (2 * eps)
        np.testing.assert_allclose(g_nu[j, i], fd, rtol=2e-4)


def test_gradient_wrt_rhs_matches_finite_differences(small_problem):
    """PyTorch's convention, ``dL/dRe(b) + i dL/dIm(b)``, checked by central
    differences along both parts of one entry."""
    grid, X, Y, nu, jop, op, *_ = small_problem
    b, w = _rng_problem(6, grid.size)
    _, g_b = _torch_grads(op, b, w)

    def loss(bb):
        u, _ = gmres(op.apply, torch.as_tensor(bb), rtol=1e-13, restart=40, maxiter=400)
        return float((torch.as_tensor(w) * u.abs() ** 2).sum())

    eps, idx = 1e-6, 40
    for unit in (1.0, 1j):
        e = np.zeros(grid.size, complex)
        e[idx] = unit * eps
        fd = (loss(b + e) - loss(b - e)) / (2 * eps)
        part = g_b[idx].real if unit == 1.0 else g_b[idx].imag
        np.testing.assert_allclose(part, fd, rtol=2e-4)


def test_gradient_with_sparsifying_preconditioners(small_problem):
    """The preconditioned forward/transposed solves give the same gradient
    as the plain ones (the JAX test's rtol 1e-5), and the JAX package's
    preconditioned gradient; the transposed preconditioner applies as the
    JAX one."""
    grid, X, Y, nu, jop, op, (ja, jmsp), (a, msp) = small_problem
    pc, pc_t = SparsifyingPreconditioner.build(msp, a), SparsifyingPreconditionerT.build(msp, a)
    jpc = JSparsifyingPreconditioner.build(jmsp, ja)
    jpc_t = JSparsifyingPreconditionerT.build(jmsp, ja)
    b, w = _rng_problem(3, grid.size)
    want = np.asarray(jpc_t.apply(jnp.asarray(b)))
    jfac_t = jpc_t.factorization
    carried_t = convert.sparsifying_preconditioner_t(
        dict(cinv=np.asarray(jfac_t.cinv), lband=np.asarray(jfac_t.lband),
             uband=np.asarray(jfac_t.uband)),
        np.asarray(jpc_t.a_s_t.values), device="cpu")
    for p_t in (pc_t, carried_t):
        np.testing.assert_allclose(p_t(torch.as_tensor(b)).numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())

    g_plain, _ = _torch_grads(op, b, w, rtol=1e-12)
    g_pc, gb_pc = _torch_grads(op, b, w, pc.apply, pc_t.apply, rtol=1e-12)
    np.testing.assert_allclose(g_pc, g_plain, rtol=1e-5, atol=1e-10)
    jloss = _jax_loss(jop, w, jpc.apply, jpc_t.apply, rtol=1e-12)
    jg_nu, jg_b = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(np.asarray(jop.nu)), jnp.asarray(b))
    np.testing.assert_allclose(g_pc, np.asarray(jg_nu), rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(gb_pc, np.conj(np.asarray(jg_b)), rtol=0,
                               atol=1e-8 * np.abs(jg_b).max())
