"""3D Gaussian-bump scattering with the sparsifying preconditioner, the
z-slab Gauss-Seidel sweep or the 3D polarized traces.

Counterpart of the JAX package's ``models/bump3d.py``, the equivalent of the
reference's ``examples/example3D.jl`` (h = 1/48, k = 48, half-open grid,
Greengard-Vico quadrature, impulse-sampled sparsifying preconditioner with
PARDISO there; here the z-plane block-Thomas factorization), and the JAX
package's two z-slab preconditioners: the sweep (``precond="gs"``,
``ddm/subdomain3d.py``), which is what it runs at 96^3, and the plane-trace
integral system (``precond="polarized_traces"``, ``ddm/polarized3d.py``).
With ``pivot_dtype`` ending in ``"_pallas"`` every plane substitution runs
through the CUDA plane kernels (``sparse/plane_kernels.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid3D
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized3d import (
    PolarizedTracesPreconditioner3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain3d import (
    SingleSweepPreconditioner3D,
    build_slab_system_3d,
)
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
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix3D


@dataclasses.dataclass
class Bump3DProblem:
    grid: Grid3D
    k: float
    op: LippmannSchwinger3D
    precond: Optional[SparsifyingPreconditioner3D | SingleSweepPreconditioner3D
                      | PolarizedTracesPreconditioner3D]
    rhs: torch.Tensor
    u_inc: torch.Tensor
    # wall seconds of each setup phase, synchronised on the device at each
    # boundary: symbol, stencils, then msp, factorization, packing
    # (sparsifying) or slabs, made of slab_fields, factorization, packing (gs
    # and polarized_traces)
    setup_seconds: dict = dataclasses.field(default_factory=dict)
    # the sparsifying stencils A and AG, kept so that a sweep can be rebuilt
    # on another pivot storage (``build_slab_system_3d``) without setting the
    # operator and the stencils up again
    a_s: Optional[StencilMatrix3D] = None
    ag_s: Optional[StencilMatrix3D] = None


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

    ``precond``:

    * ``"sparsifying"``: the full-grid factorization of the reference's
      ``examples/example3D.jl``.  ``pivot_dtype`` ending in ``"_pallas"``
      keeps bf16 plane pivots for the plane kernels (always bf16, as in the
      JAX package, whatever the prefix); any other value keeps dense pivots
      in ``dtype``.
    * ``"gs"``: one Gauss-Seidel sweep over ``n_subdomains`` z-slabs with
      ``npml`` absorbing planes (``ddm/subdomain3d.py``).  ``pivot_dtype`` is
      one of ``"full"``, ``"bf16"``, ``"bf16_pallas"`` (z-plane pivots),
      ``"yblock"``, ``"yblock_bf16"``, ``"yblock_bf16_pallas"``,
      ``"yblock_int8"``, ``"yblock_int8_pallas"`` (y-plane pivots), or
      ``"int8"``/``"int8_pallas"``; a ``"_pallas"`` suffix runs the plane
      kernels on bf16 or int8 planes.  The JAX package's 96^3 benchmark is
      ``h=1/96, n_subdomains=6, npml=8, pivot_dtype="yblock_int8_pallas"``.
    * ``"polarized_traces"``: the plane-trace integral system on the same
      slab system as ``"gs"`` (the same ``n_subdomains``, ``npml`` and
      ``pivot_dtype``), with the JAX package's inner settings (``n_it=2``,
      ``inner_tol=1e-2``, ``inner_maxiter=40``).  The JAX package's record
      is ``h=1/48, n_subdomains=4, npml=6, pivot_dtype="bf16_pallas"``.

    ``cache_dir`` checkpoints the stencil fields and, for the slab
    preconditioners, the slab factorization in its pivot storage
    (``utils/checkpoint.py``), as the JAX package's ``bump3d`` does; the
    symbol and the sparsifying preconditioner's full-grid factorization are
    recomputed.
    """
    if precond not in ("sparsifying", "gs", "polarized_traces"):
        raise ValueError(f"unknown precond {precond!r}")
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

    pc = a_st = ag_st = None
    if with_preconditioner:
        t0 = time.perf_counter()
        a_st, ag_st = stencils.build_sparse_a_ag_3d(k, op, dtype=dtype, cache_dir=cache_dir,
                                                    device=device)
        seconds["stencils"] = lap(t0)
        if precond in ("gs", "polarized_traces"):
            pc = _slab_preconditioner(precond, a_st, ag_st, nu, grid, k, n_subdomains, npml,
                                      pivot_dtype, cache_dir, seconds, lap)
        else:
            pc = _sparsifying(a_st, ag_st, nu, k, pivot_dtype, seconds, lap)

    u_inc = torch.exp(1j * k * torch.as_tensor(X.ravel(), device=device)).to(dtype)
    rhs = -(op.apply(u_inc) - u_inc)
    return Bump3DProblem(grid=grid, k=k, op=op, precond=pc, rhs=rhs, u_inc=u_inc,
                         setup_seconds=seconds, a_s=a_st, ag_s=ag_st)


def _slab_preconditioner(precond, a_st, ag_st, nu, grid, k, n_subdomains, npml, pivot_dtype,
                         cache_dir, seconds, lap):
    """The z-slab sweep or polarized-traces preconditioner on one slab
    system; ``seconds`` receives ``slabs`` and its parts
    (``build_slab_system_3d``'s ``timings``)."""
    t0 = time.perf_counter()
    parts = {}
    slabs = build_slab_system_3d(a_st, ag_st, nu, grid.x, grid.h, k, n_subdomains, npml=npml,
                                 pivot_dtype=pivot_dtype, cache_dir=cache_dir, timings=parts)
    seconds["slabs"] = lap(t0)
    seconds.update(parts)
    if precond == "polarized_traces":
        return PolarizedTracesPreconditioner3D(slabs=slabs, a_s=a_st)
    return SingleSweepPreconditioner3D(slabs=slabs, a_s=a_st)


def _sparsifying(a_st, ag_st, nu, k, pivot_dtype, seconds, lap):
    """``SparsifyingPreconditioner3D.build``, phase by phase."""
    t0 = time.perf_counter()
    msp = stencils.build_msp_3d(a_st, ag_st, nu, k)
    seconds["msp"] = lap(t0)
    use_pallas = pivot_dtype.endswith("_pallas")
    t0 = time.perf_counter()
    fac = factor_stencil_3d(msp, pivot_dtype="bf16" if use_pallas else "full")
    seconds["factorization"] = lap(t0)
    t0 = time.perf_counter()
    if use_pallas:
        fac = plane_view(fac)
    seconds["packing"] = lap(t0)
    return SparsifyingPreconditioner3D(factorization=fac, a_s=a_st)


def solve(problem: Bump3DProblem, rtol: float = 1e-8, restart: int = 20,
          maxiter: int = 100, preconditioned: bool = True):
    """Left-preconditioned GMRES on ``problem.rhs``; returns ``(x,
    GMRESInfo)`` with ``true_residual``."""
    pc = problem.precond.apply if preconditioned and problem.precond is not None else None
    return gmres(problem.op.apply, problem.rhs, preconditioner=pc,
                 rtol=rtol, restart=restart, maxiter=maxiter)
