"""Config-driven top-level API.

Counterpart of the JAX package's ``api.py``.  The reference's only "API" is
editing constants inside its example scripts (``examples/example.jl:30-45``,
``tests/plasma_example.jl:20-41``); here :func:`build_problem` builds any of
its configurations from a typed :class:`ProblemConfig` (``config.py``) and
:func:`solve_problem` / :func:`solve_problem_batched` solve it.  Also the
engine behind ``python -m fast_solver_lippmann_schwinger_tpu_torch``.

Where the JAX package caches one jitted solve per solver budget, the port
calls GMRES directly: there is nothing to trace.  Everything runs on the
CUDA card unless ``build_problem`` is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import ProblemConfig, resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D, Grid3D
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized import (
    PolarizedTracesPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized3d import (
    PolarizedTracesPreconditioner3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import build_slab_system
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain3d import (
    SingleSweepPreconditioner3D,
    build_slab_system_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.sweeps import (
    DoubleSweepPreconditioner,
    GSPreconditioner,
    InnerGMRESPreconditioner,
    SingleSweepPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
    build_fast_convolution_2d,
    build_fast_convolution_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner,
    SparsifyingPreconditioner3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres, gmres_batched
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils

_MEDIA_2D = {
    "gaussian_bump": media.gaussian_bump_2d,
    "plasma": media.plasma_2d,
}
_MEDIA_3D = {
    "gaussian_bump": media.gaussian_bump_3d,
}


@dataclasses.dataclass
class Problem:
    """Everything needed to run solves for one configuration."""

    config: ProblemConfig
    grid: object
    k: float
    op: object
    precond: Optional[object]      # object with .apply, or None


def build_problem(cfg: ProblemConfig, device=None) -> Problem:
    """The operator and the preconditioner of ``cfg`` on ``device`` (the
    CUDA card when ``None``; raises without one).  ``cfg.cache_dir``
    checkpoints the symbol, the stencil fields and the slab factorizations
    (``utils/checkpoint.py``)."""
    device = resolve_device(device)
    k = cfg.k if cfg.k is not None else 1.0 / cfg.h
    dtype = cfg.solver.dtype

    if cfg.dim == 2:
        grid = Grid2D(a=cfg.a, h=cfg.h)
        X, Y = grid.mesh()
        nu = _MEDIA_2D[cfg.medium](X, Y)
        op = build_fast_convolution_2d(
            grid.x, grid.y, cfg.h, k, nu, quad_rule=cfg.quad_rule, dtype=dtype,
            prefer_pow2=cfg.prefer_pow2, cache_dir=cfg.cache_dir, device=device,
        )
    elif cfg.dim == 3:
        grid = Grid3D(a=cfg.a, h=cfg.h)
        X, Y, Z = grid.mesh()
        nu = _MEDIA_3D[cfg.medium](X, Y, Z)
        op = build_fast_convolution_3d(
            grid.x, grid.x, grid.x, cfg.h, k, nu, dtype=dtype,
            prefer_pow2=cfg.prefer_pow2, cache_dir=cfg.cache_dir, device=device,
        )
    else:
        raise ValueError(f"dim must be 2 or 3, got {cfg.dim}")

    precond = None
    if cfg.precond == "none":
        pass
    elif cfg.dim == 3:
        if cfg.precond not in ("sparsifying", "gs", "polarized_traces"):
            raise ValueError(
                "3D supports precond='sparsifying', 'gs' (z-slab sweep), "
                "'polarized_traces' (plane-trace integral system) or 'none' "
                "(the 'gs' and 'polarized_traces' DDM layers are "
                "capabilities this framework adds beyond the reference, "
                "whose 3D polarized traces is advertised but absent - "
                "SURVEY.md section 2)"
            )
        a_st, ag_st = stencils.build_sparse_a_ag_3d(
            k, op, dtype=dtype, cache_dir=cfg.cache_dir, device=device
        )
        if cfg.precond in ("gs", "polarized_traces"):
            # the JAX package reads a 2D kernel mode ("pallas*") as "full";
            # a 3D "*_pallas" mode passes through and runs the plane kernels
            slabs3 = build_slab_system_3d(
                a_st, ag_st, nu, grid.x, cfg.h, k,
                cfg.ddm.n_subdomains, npml=cfg.ddm.npml,
                shift_factor=cfg.ddm.shift_factor,
                pivot_dtype=(cfg.pivot_dtype
                             if not cfg.pivot_dtype.startswith("pallas")
                             else "full"),
                cache_dir=cfg.cache_dir,
            )
            if cfg.precond == "gs":
                precond = SingleSweepPreconditioner3D(slabs=slabs3, a_s=a_st)
            else:
                precond = PolarizedTracesPreconditioner3D(
                    slabs=slabs3, a_s=a_st, n_it=cfg.ddm.n_inner_iters,
                    inner_tol=cfg.ddm.inner_tol,
                    inner_maxiter=cfg.ddm.inner_maxiter,
                )
        else:
            msp = stencils.build_msp_3d(a_st, ag_st, nu, k)
            precond = SparsifyingPreconditioner3D.build(msp, a_st)
    elif cfg.precond == "sparsifying":
        a_st, ag_st = stencils.build_sparse_a_ag_2d(
            k, grid.x, grid.y, cfg.h, dtype=dtype, cache_dir=cfg.cache_dir, device=device
        )
        msp = stencils.build_msp_2d(a_st, ag_st, nu, k)
        precond = SparsifyingPreconditioner.build(msp, a_st)
    elif cfg.precond in ("gs", "gs_inner", "double_sweep",
                         "double_sweep_inner", "polarized_traces"):
        a_st, ag_st, a_np, ag_np = stencils.build_sparse_a_ag_2d(
            k, grid.x, grid.y, cfg.h, dtype=dtype, return_host=True,
            cache_dir=cfg.cache_dir, device=device,
        )
        msp = stencils.build_msp_2d(a_st, ag_st, nu, k)
        slabs = build_slab_system(
            a_st, ag_st, nu, grid.x, grid.y, cfg.h, k,
            cfg.ddm.n_subdomains, npml=cfg.ddm.npml,
            shift_factor=cfg.ddm.shift_factor,
            a_host=a_np, ag_host=ag_np, pivot_dtype=cfg.pivot_dtype,
            pivot_band=cfg.pivot_band, pivot_rank=cfg.pivot_rank,
            cache_dir=cfg.cache_dir,
        )
        if cfg.precond == "gs":
            precond = SingleSweepPreconditioner(slabs=slabs, a_s=a_st)
        elif cfg.precond == "gs_inner":
            precond = InnerGMRESPreconditioner(
                msp=msp, a_s=a_st, sweep=GSPreconditioner(slabs=slabs),
                max_iter=cfg.ddm.inner_gmres_maxiter,
                tol=cfg.ddm.inner_gmres_tol,
            )
        elif cfg.precond == "polarized_traces":
            precond = PolarizedTracesPreconditioner(
                slabs=slabs, a_s=a_st, n_it=cfg.ddm.n_inner_iters,
                inner_tol=cfg.ddm.inner_tol,
                inner_maxiter=cfg.ddm.inner_maxiter,
            )
        else:
            # the x-direction sweep on the transposed fields and medium
            # (tests/plasma_example.jl:103-114); the y-direction above is
            # already packed into its pivot mode, its dense pivots freed
            slabs_t = build_slab_system(
                a_st.transpose(), ag_st.transpose(), np.asarray(nu).T,
                grid.y, grid.x, cfg.h, k,
                cfg.ddm.n_subdomains, npml=cfg.ddm.npml,
                shift_factor=cfg.ddm.shift_factor,
                a_host=a_np.transpose(1, 0, 3, 2),
                ag_host=ag_np.transpose(1, 0, 3, 2),
                pivot_dtype=cfg.pivot_dtype,
                pivot_band=cfg.pivot_band, pivot_rank=cfg.pivot_rank,
                cache_dir=cfg.cache_dir,
            )
            double = DoubleSweepPreconditioner(
                slabs=slabs, slabs_t=slabs_t, msp=msp, a_s=a_st
            )
            if cfg.precond == "double_sweep_inner":
                precond = InnerGMRESPreconditioner(
                    msp=msp, a_s=a_st, sweep=double,
                    max_iter=cfg.ddm.inner_gmres_maxiter,
                    tol=cfg.ddm.inner_gmres_tol,
                )
            else:
                precond = double
    else:
        raise ValueError(
            f"unknown precond {cfg.precond!r}; expected one of "
            "sparsifying | gs | gs_inner | double_sweep | "
            "double_sweep_inner | polarized_traces | none"
        )
    return Problem(config=cfg, grid=grid, k=k, op=op, precond=precond)


def _plane_waves(problem: Problem, directions) -> torch.Tensor:
    """``exp(i k d . x)`` for each direction of ``directions`` (R, <= dim),
    zero-padded to the grid's dimension: (R, N) in the working dtype on the
    operator's device, formed in float64 on the host as in the JAX package."""
    d = np.asarray(directions, dtype=np.float64)
    mesh = problem.grid.mesh()
    d = np.pad(d, ((0, 0), (0, len(mesh) - d.shape[1])))
    phase = sum(d[:, i : i + 1] * ax.ravel()[None] for i, ax in enumerate(mesh))
    sym = problem.op.symbol
    return torch.as_tensor(np.exp(1j * problem.k * phase)).to(device=sym.device, dtype=sym.dtype)


def incident_field(problem: Problem) -> torch.Tensor:
    """The plane wave along ``config.incident_direction``, flat (N,)."""
    return _plane_waves(problem, [problem.config.incident_direction])[0]


def solve_problem(problem: Problem, u_inc: Optional[torch.Tensor] = None):
    """Scattering solve ``M u = -k^2 G conv (nu u_inc)`` == ``-(M-I) u_inc``.

    Returns ``(u, GMRESInfo)``.
    """
    cfg = problem.config.solver
    if u_inc is None:
        u_inc = incident_field(problem)
    rhs = -(problem.op.apply(u_inc) - u_inc)
    pre = problem.precond.apply if problem.precond is not None else None
    return gmres(problem.op.apply, rhs, preconditioner=pre,
                 rtol=cfg.rtol, restart=cfg.restart, maxiter=cfg.maxiter)


def solve_problem_batched(problem: Problem, directions):
    """Joint multi-direction scattering solve: one batched GMRES over all
    plane-wave ``directions`` ((R, dim) array-like).

    Preconditioners with ``apply_batch`` (the sweeps, the polarized traces,
    the sparsifying ones) carry the whole batch through each pass, so every
    pivot plane is read once for all R right-hand sides; the others
    (``InnerGMRESPreconditioner``) apply column by column.  Returns ``(u,
    GMRESInfo)`` with leading batch axes.
    """
    cfg = problem.config.solver
    u_inc = _plane_waves(problem, directions)
    rhs = -(problem.op.apply(u_inc) - u_inc)
    pc = problem.precond
    if pc is None:
        pre = None
    elif hasattr(pc, "apply_batch"):
        pre = pc.apply_batch
    else:
        def pre(b):
            return torch.stack([pc.apply(col) for col in b])
    return gmres_batched(problem.op.apply, rhs, preconditioner=pre,
                         rtol=cfg.rtol, restart=cfg.restart, maxiter=cfg.maxiter)
