"""2D plasma with the polarized-traces (trace-space) preconditioner.

Counterpart of the JAX package's ``models/plasma_integral2d.py``, the
equivalent of ``tests/plasma_integral_system_example.jl`` (h = 1/400,
k = 400, 8 slabs, npml = 10, trapezoidal operator, inner GMRES on the
polarized trace system with nIt = 2 block Gauss-Seidel).  Its local solves
run the substitution kernels with a kernel pivot mode (``pivot_dtype="pallas"``,
``"pallas_int8"`` or ``"pallas_banded_tail"``), and the plain substitution
loops of ``sparse/direct.py`` with ``"full"`` (the default, as in the JAX
package), ``"bf16"``, ``"banded"``, ``"banded_tail"`` or ``"banded_lr"``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized import (
    PolarizedTracesPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import build_slab_system
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.models.plasma2d import incident_rhs
from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
    LippmannSchwinger2D,
    build_fast_convolution_2d,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres, gmres_batched
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils


@dataclasses.dataclass
class PlasmaIntegral2DProblem:
    grid: Grid2D
    k: float
    op: LippmannSchwinger2D
    precond: PolarizedTracesPreconditioner
    # wall seconds of each setup phase (symbol, stencils, slab system: the
    # factorization with its packing), synchronised on the device at each
    # boundary
    setup_seconds: dict = dataclasses.field(default_factory=dict)


def build_problem(
    h: float = 1.0 / 400.0,
    n_subdomains: int = 8,
    npml: int = 10,
    n_it: int = 2,
    quad_rule: str = "trapezoidal",
    dtype: torch.dtype = torch.complex64,
    pivot_dtype: str = "full",
    pivot_band: int | None = None,
    device=None,
) -> PlasmaIntegral2DProblem:
    """Set the problem up on ``device`` (the CUDA card when ``None``; raises
    without one).  ``pivot_dtype`` and ``pivot_band`` are those of
    ``subdomain.build_slab_system`` (``"banded_lr"`` takes its default rank,
    as in the JAX package)."""
    device = resolve_device(device)

    def lap(t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    seconds = {}
    grid = Grid2D(a=1.0, h=h)
    k = 1.0 / h
    X, Y = grid.mesh()
    nu = media.plasma_2d(X, Y)

    t0 = time.perf_counter()
    op = build_fast_convolution_2d(grid.x, grid.y, h, k, nu, quad_rule=quad_rule,
                                   dtype=dtype, device=device)
    seconds["symbol"] = lap(t0)

    t0 = time.perf_counter()
    a_st, ag_st, a_np, ag_np = stencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, h, dtype=dtype, return_host=True, device=device,
    )
    seconds["stencils"] = lap(t0)

    t0 = time.perf_counter()
    slabs = build_slab_system(
        a_st, ag_st, nu, grid.x, grid.y, h, k, n_subdomains, npml=npml,
        a_host=a_np, ag_host=ag_np, pivot_dtype=pivot_dtype, pivot_band=pivot_band,
        device=device,
    )
    seconds["slab_system"] = lap(t0)
    precond = PolarizedTracesPreconditioner(slabs=slabs, a_s=a_st, n_it=n_it)
    return PlasmaIntegral2DProblem(grid=grid, k=k, op=op, precond=precond,
                                   setup_seconds=seconds)


def solve(problem: PlasmaIntegral2DProblem, incident_direction=(1.0, 0.0),
          rtol: float = 1e-8, restart: int = 20, maxiter: int = 100):
    """Scattering solve for a plane-wave incident field.  Returns
    ``(x, GMRESInfo)``."""
    rhs = incident_rhs(problem, [incident_direction])[0]
    return gmres(problem.op.apply, rhs, preconditioner=problem.precond.apply,
                 rtol=rtol, restart=restart, maxiter=maxiter)


def solve_batched(problem: PlasmaIntegral2DProblem, incident_directions,
                  rtol: float = 1e-8, restart: int = 20, maxiter: int = 100):
    """Joint multi-direction solve: one ``gmres_batched`` whose trace-space
    preconditioner (``PolarizedTracesPreconditioner.apply_batch``) carries
    all R directions through each slab solve at once (the reference script
    loops directions serially,
    ``tests/plasma_integral_system_example.jl:115-134``).  Returns
    ``(x, info)`` with a leading batch axis on every field."""
    rhs = incident_rhs(problem, incident_directions)
    return gmres_batched(problem.op.apply, rhs, preconditioner=problem.precond.apply_batch,
                         rtol=rtol, restart=restart, maxiter=maxiter)
