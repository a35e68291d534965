"""3D Gaussian-bump scattering with the sparsifying preconditioner.

Counterpart of the JAX package's ``models/bump3d.py``, the equivalent of the
reference's ``examples/example3D.jl`` (h = 1/48, k = 48, half-open grid,
Greengard-Vico quadrature, impulse-sampled sparsifying preconditioner with
PARDISO there; here the z-plane block-Thomas factorization).  With
``pivot_dtype`` ending in ``"_pallas"`` the pivots are bf16 planes and every
plane substitution runs through the CUDA plane kernels
(``sparse/plane_kernels.py``); otherwise they are dense in the working dtype.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid3D
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
    LippmannSchwinger3D,
    build_fast_convolution_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import factor_stencil_3d
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import plane_view


@dataclasses.dataclass
class Bump3DProblem:
    grid: Grid3D
    k: float
    op: LippmannSchwinger3D
    precond: Optional[SparsifyingPreconditioner3D]
    rhs: torch.Tensor
    u_inc: torch.Tensor
    # wall seconds of each setup phase (symbol, stencils, msp, factorization,
    # packing), synchronised on the device at each boundary
    setup_seconds: dict = dataclasses.field(default_factory=dict)


def build_problem(
    h: float = 1.0 / 48.0,
    dtype: torch.dtype = torch.complex64,
    with_preconditioner: bool = True,
    precond: str = "sparsifying",
    n_subdomains: int = 4,
    npml: int = 5,
    pivot_dtype: str = "full",
    cache_dir: str | None = None,
    device=None,
) -> Bump3DProblem:
    """Set the 3D bump problem up on ``device`` (the CUDA card when ``None``;
    raises without one).

    ``precond="sparsifying"`` is the full-grid factorization of the
    reference's ``examples/example3D.jl``.  ``pivot_dtype`` ending in
    ``"_pallas"`` keeps bf16 plane pivots for the plane kernels (always bf16,
    as in the JAX package, whatever the prefix); any other value keeps dense
    pivots in ``dtype``.  The z-slab sweeps (``"gs"``) and polarized traces
    (``"polarized_traces"``), with ``n_subdomains`` and ``npml``, and
    ``cache_dir`` are not ported yet and raise.
    """
    if precond in ("gs", "polarized_traces"):
        raise NotImplementedError(
            f"precond={precond!r} is not ported yet (ROADMAP.md, Queue 1: slice 5 "
            "for the 3D sweeps, slice 6 for polarized traces)"
        )
    if precond != "sparsifying":
        raise ValueError(f"unknown precond {precond!r}")
    if cache_dir is not None:
        raise NotImplementedError(
            "cache_dir checkpointing is not ported yet (ROADMAP.md, Queue 1 slice 9)"
        )
    device = resolve_device(device)

    def lap(t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    seconds = {}
    grid = Grid3D(a=1.0, h=h)
    k = 1.0 / h
    X, Y, Z = grid.mesh()
    nu = media.gaussian_bump_3d(X, Y, Z)

    t0 = time.perf_counter()
    op = build_fast_convolution_3d(grid.x, grid.x, grid.x, h, k, nu, dtype=dtype,
                                   device=device)
    seconds["symbol"] = lap(t0)

    pc = None
    if with_preconditioner:
        t0 = time.perf_counter()
        a_st, ag_st = stencils.build_sparse_a_ag_3d(k, op, dtype=dtype, device=device)
        seconds["stencils"] = lap(t0)
        t0 = time.perf_counter()
        msp = stencils.build_msp_3d(a_st, ag_st, nu, k)
        seconds["msp"] = lap(t0)
        # SparsifyingPreconditioner3D.build, phase by phase
        use_pallas = pivot_dtype.endswith("_pallas")
        t0 = time.perf_counter()
        fac = factor_stencil_3d(msp, pivot_dtype="bf16" if use_pallas else "full")
        seconds["factorization"] = lap(t0)
        t0 = time.perf_counter()
        if use_pallas:
            fac = plane_view(fac)
        seconds["packing"] = lap(t0)
        pc = SparsifyingPreconditioner3D(factorization=fac, a_s=a_st)

    u_inc = torch.exp(1j * k * torch.as_tensor(X.ravel(), device=device)).to(dtype)
    rhs = -(op.apply(u_inc) - u_inc)
    return Bump3DProblem(grid=grid, k=k, op=op, precond=pc, rhs=rhs, u_inc=u_inc,
                         setup_seconds=seconds)


def solve(problem: Bump3DProblem, rtol: float = 1e-8, restart: int = 20,
          maxiter: int = 100, preconditioned: bool = True):
    """Left-preconditioned GMRES on ``problem.rhs``; returns ``(x,
    GMRESInfo)`` with ``true_residual``."""
    pc = problem.precond.apply if preconditioned and problem.precond is not None else None
    return gmres(problem.op.apply, problem.rhs, preconditioner=pc,
                 rtol=rtol, restart=restart, maxiter=maxiter)
