"""Differentiable Lippmann-Schwinger solves (adjoint method).

Counterpart of the JAX package's ``solver/adjoint.py``, beyond the
reference's capability surface: the scattering solve ``u = M(nu)^{-1} b`` is
differentiated with respect to the medium ``nu`` and the right-hand side,
for inverse problems (medium reconstruction from scattered-field data).

``differentiable_solve`` is a ``torch.autograd.Function``: its backward pass
costs ONE transposed GMRES solve, never back-propagation through the Krylov
iterations.  ``M^T = I + omega^2 diag(nu) G`` because the discrete Green's
convolution is symmetric (even kernel): the transpose moves the medium factor
to the other side of the convolution.  Its natural preconditioner is the
transposed sparsifying preconditioner ``P^T = As^T Msp^{-T}``
(``precond/sparsifying.py``).

Conjugation: the JAX package's ``custom_linear_solve`` transposes, while
PyTorch's complex autograd carries the conjugate Wirtinger gradient and so
wants the adjoint ``M^H``.  For an incoming gradient ``g`` of ``u`` the
backward pass solves ``M^T mu = conj(g)`` and returns

* ``grad_rhs = conj(mu)`` (``= M^{-H} g``), the conjugate of what
  ``jax.grad`` gives for the same real loss;
* ``grad_nu = -omega^2 Re((G conv mu) * u)`` for the real medium, equal to
  ``jax.grad``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres


def apply_transpose(op, x: torch.Tensor) -> torch.Tensor:
    """``M^T x = x + omega^2 nu .* (G conv x)`` for a 2D or 3D fast operator.

    (``G^T = G``: the circulant kernel is even, cf. the symbol construction
    in ``ops/greens.py``; the reference exploits the same symmetry when
    sampling rows as columns, ``src/FastConvolution.jl:278-306``.)
    """
    conv = op.convolve(x.to(op.symbol.dtype))
    return x + (op.omega ** 2) * op.nu.reshape(x.shape) * conv


class _Solve(torch.autograd.Function):
    """``u = M(nu)^{-1} rhs`` with the adjoint backward pass."""

    @staticmethod
    def forward(ctx, nu, rhs, op, preconditioner, preconditioner_t, gmres_kw):
        op = dataclasses.replace(op, nu=nu.detach())
        u, _ = gmres(op.apply, rhs.detach(), preconditioner=preconditioner, **gmres_kw)
        ctx.op, ctx.preconditioner_t, ctx.gmres_kw = op, preconditioner_t, gmres_kw
        ctx.save_for_backward(u)
        return u

    @staticmethod
    def backward(ctx, grad_u):
        (u,) = ctx.saved_tensors
        op = ctx.op
        mu, _ = gmres(lambda x: apply_transpose(op, x), grad_u.conj().resolve_conj(),
                      preconditioner=ctx.preconditioner_t, **ctx.gmres_kw)
        grad_nu = grad_rhs = None
        if ctx.needs_input_grad[0]:
            conv = op.convolve(mu)
            grad_nu = (-(op.omega ** 2) * (conv * u).real).reshape(op.nu.shape).to(op.nu.dtype)
        if ctx.needs_input_grad[1]:
            grad_rhs = mu.conj().resolve_conj()
        return grad_nu, grad_rhs, None, None, None, None


def differentiable_solve(
    op,
    rhs: torch.Tensor,
    preconditioner: Optional[Callable] = None,
    preconditioner_t: Optional[Callable] = None,
    rtol: float = 1e-8,
    restart: int = 20,
    maxiter: int = 200,
) -> torch.Tensor:
    """Solve ``M(nu) u = rhs`` so that autograd flows to ``op.nu`` (real) and
    ``rhs``.

    Gradients are exact up to the GMRES tolerance: the backward pass runs one
    transposed solve (implicit function theorem), never differentiating
    through the Krylov iteration.  ``preconditioner``/``preconditioner_t``
    precondition the forward and transposed solves (for example
    ``SparsifyingPreconditioner`` and ``SparsifyingPreconditionerT``).
    Returns ``u`` only (the residual history is not differentiable state;
    call :func:`solver.gmres.gmres` directly for diagnostics).  Give ``op`` a
    medium that requires grad with ``dataclasses.replace(op, nu=nu)``.
    """
    gmres_kw = dict(rtol=rtol, restart=restart, maxiter=maxiter)
    return _Solve.apply(op.nu, rhs, op, preconditioner, preconditioner_t, gmres_kw)
