"""2D Gaussian-bump scattering problem with the sparsifying preconditioner.

Counterpart of the JAX package's ``models/bump2d.py``, the end-to-end
equivalent of the reference's canonical example script ``examples/example.jl``
(h = 0.005, k = 1/h, Gaussian bump nu, Greengard-Vico quadrature, sparsifying
preconditioner, GMRES on the scattered field):

1. build the fast operator,
2. build the annihilator stencils A and AG (Duan-Rokhlin direct sampling
   through the native Hankel sampler, as ``buildSparseA``/``buildSparseAG``
   at ``examples/example.jl:64-67``),
3. Msp = A + k^2 AG diag(nu), factored on the device,
4. rhs = -k^2 G conv (nu u_inc)  (``examples/example.jl:76-77``),
5. GMRES with or without the preconditioner.

No hand-written kernel runs on this path: the preconditioner is the plain
block-Thomas substitution on dense pivots (as the JAX package runs it through
its compiler), the operator cuFFT.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
    LippmannSchwinger2D,
    build_fast_convolution_2d,
)
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import factor_stencil_2d


@dataclasses.dataclass
class Bump2DProblem:
    grid: Grid2D
    k: float
    op: LippmannSchwinger2D
    precond: Optional[SparsifyingPreconditioner]
    rhs: torch.Tensor
    u_inc: torch.Tensor
    # wall seconds of each setup phase (symbol, and with the preconditioner
    # stencils, msp, factorization), synchronised on the device at each
    # boundary
    setup_seconds: dict = dataclasses.field(default_factory=dict)


def incident_rhs(op: LippmannSchwinger2D, grid: Grid2D, k: float, direction):
    """``(rhs, u_inc)`` for the plane wave ``u_inc = exp(i k d . x)`` along
    ``direction`` (formed in double precision, cast to the operator's dtype):
    ``rhs = -k^2 G conv (nu u_inc)`` (``examples/example.jl:76-77``)."""
    dtype, device = op.symbol.dtype, op.symbol.device
    X, Y = grid.mesh()
    dx, dy = direction
    phase = torch.as_tensor(dx * X.ravel() + dy * Y.ravel(), device=device)
    u_inc = torch.exp(1j * k * phase).to(dtype)
    return -(k ** 2) * op.convolve(op.nu.reshape(-1).to(dtype) * u_inc), u_inc


def build_problem(
    h: float = 0.005,
    quad_rule: str = "greengard_vico",
    dtype: torch.dtype = torch.complex64,
    with_preconditioner: bool = True,
    incident_direction=(1.0, 0.0),
    device=None,
) -> Bump2DProblem:
    """Set the problem up on ``device`` (the CUDA card when ``None``; raises
    without one).  The defaults are ``examples/example.jl``'s: h = 0.005
    (k = 200, a 201 x 201 grid) and the Greengard-Vico quadrature."""
    device = resolve_device(device)

    def lap(t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    seconds = {}
    grid = Grid2D(a=1.0, h=h)
    k = 1.0 / h
    X, Y = grid.mesh()
    nu = media.gaussian_bump_2d(X, Y)

    t0 = time.perf_counter()
    op = build_fast_convolution_2d(grid.x, grid.y, h, k, nu, quad_rule=quad_rule, dtype=dtype,
                                   device=device)
    seconds["symbol"] = lap(t0)

    precond = None
    if with_preconditioner:
        t0 = time.perf_counter()
        a_st, ag_st = stencils.build_sparse_a_ag_2d(k, grid.x, grid.y, h, dtype=dtype,
                                                    device=device)
        seconds["stencils"] = lap(t0)
        t0 = time.perf_counter()
        msp = stencils.build_msp_2d(a_st, ag_st, nu, k)
        seconds["msp"] = lap(t0)
        t0 = time.perf_counter()
        precond = SparsifyingPreconditioner(factorization=factor_stencil_2d(msp), a_s=a_st)
        seconds["factorization"] = lap(t0)

    rhs, u_inc = incident_rhs(op, grid, k, incident_direction)
    return Bump2DProblem(grid=grid, k=k, op=op, precond=precond, rhs=rhs, u_inc=u_inc,
                         setup_seconds=seconds)


def solve(problem: Bump2DProblem, rtol: float = 1e-8, restart: int = 20,
          maxiter: int = 200, preconditioned: bool = True):
    """Run GMRES; returns ``(scattered field u, GMRESInfo)``."""
    pc = problem.precond.apply if preconditioned and problem.precond is not None else None
    return gmres(problem.op.apply, problem.rhs, preconditioner=pc,
                 rtol=rtol, restart=restart, maxiter=maxiter)
