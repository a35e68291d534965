"""2D plasma scattering with the alternating bi-directional sweep.

Counterpart of the JAX package's ``models/plasma2d.py``, the equivalent of
the reference's headline example script ``tests/plasma_example.jl`` (h = 1/800,
k = 800, 16 slabs, npml = 10, Greengard-Vico operator,
``doublePreconditioner`` with ``maxIter = 0``), parameterized so tests run it
scaled down.  ``double_sweep=False`` gives the single-direction sweep, which
with ``n_subdomains=1`` is the exact block-Thomas solve of the sparsified
system.  Pivots are ``"full"`` (dense pivots in the working dtype, the
default), ``"bf16"`` (bf16 planes), ``"banded"``, ``"banded_tail"`` and
``"banded_lr"`` (the central band of each pivot inverse; with dense bf16
planes on the interface lines; with a low-rank term), all four through the
plain substitution loops of ``sparse/direct.py`` as the JAX package runs them
outside its kernels, ``"pallas"`` / ``"pallas_int8"`` (bf16 / int8 pivot
planes through the CUDA substitution kernels), or ``"pallas_banded_tail"``
(banded head windows and dense bf16 tail planes through the hybrid
substitution kernels and the fused sweep kernels).  ``use_pallas=True`` attaches bf16 kernel planes beside full or bf16 pivots and
runs the As b step of every single-RHS preconditioner apply through the
stencil matvec kernel (``ops/stencil_kernels.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import (
    PIVOT_MODES,
    attach_pallas,
    build_slab_system,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.sweeps import (
    DoubleSweepPreconditioner,
    SingleSweepPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
    LippmannSchwinger2D,
    build_fast_convolution_2d,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres, gmres_batched
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils


@dataclasses.dataclass
class Plasma2DProblem:
    grid: Grid2D
    k: float
    op: LippmannSchwinger2D
    precond: SingleSweepPreconditioner | DoubleSweepPreconditioner
    nu: np.ndarray
    # wall seconds of each setup phase (symbol, stencils, factorization,
    # packing, with a cache_dir checkpoint, and with the double sweep the same
    # of the transposed slab system with a suffix _t), synchronised on the
    # device at each boundary
    setup_seconds: dict = dataclasses.field(default_factory=dict)


def build_problem(
    h: float = 1.0 / 800.0,
    n_subdomains: int = 16,
    npml: int = 10,
    dtype: torch.dtype = torch.complex64,
    double_sweep: bool = True,
    pivot_dtype: str = "full",
    pivot_dtype_t: str | None = None,
    pivot_band: int | None = None,
    pivot_rank: int | None = None,
    use_pallas: bool = False,
    cache_dir: str | None = None,
    device=None,
) -> Plasma2DProblem:
    """Set the plasma problem up on ``device`` (the CUDA card when ``None``;
    raises without one).

    ``double_sweep=False`` uses the single-direction GS sweep composite
    (reference ``Preconditioner``/``GSPreconditioner`` family): half the
    factorization memory, a few more GMRES iterations.  ``pivot_dtype_t`` sets
    a different pivot storage for the transposed (x-direction) sweep; ``None``
    means ``pivot_dtype``.  ``pivot_band`` is the kept band width of the
    banded modes (``None``: the w(n) rule, ``direct.default_band_width``),
    ``pivot_rank`` the rank of ``"banded_lr"`` (``None``: 24).  ``cache_dir``
    checkpoints the symbol, the stencil fields and each direction's slab
    factorization in its pivot mode (``utils/checkpoint.py``); the kernel
    planes of ``use_pallas`` are packed from the pivots after a load too.

    ``use_pallas=True``, as in the JAX package, attaches bf16 kernel planes
    packed from each direction's pivots (which stay) and runs the As b step
    of every single-RHS preconditioner apply through the stencil matvec
    kernel; ``msp`` and multi-RHS input keep the plain 9 taps.  It needs full
    or ``"bf16"`` pivots: a kernel pivot mode keeps only the bands beside its
    layout, and a banded mode no dense planes; the JAX package would pack
    the kernel planes from those and fail or re-pack empty placeholders, so
    the port raises ``ValueError``.

    Each direction is factored with dense pivots in the working dtype first
    and then packed into its pivot mode right away, so that the dense pivots
    of one direction are freed before the other is factored.
    ``setup_seconds`` splits the setup into ``symbol``, ``stencils`` and, per
    direction, ``factorization`` and ``packing`` (with ``checkpoint`` where
    ``cache_dir`` is given); the transposed direction's carry ``_t``.
    """
    if pivot_dtype_t is None:
        pivot_dtype_t = pivot_dtype
    for mode in (pivot_dtype, pivot_dtype_t):
        if mode not in PIVOT_MODES:
            raise ValueError(f"unknown pivot_dtype {mode!r}; one of {PIVOT_MODES}")
        if use_pallas and mode.startswith("pallas"):
            raise ValueError(
                f"use_pallas=True with pivot_dtype={mode!r}: that mode keeps only "
                "placeholder pivots beside its kernel layout, and the JAX package "
                "would re-pack the empty placeholder pivots into bf16 planes"
            )
        if use_pallas and mode.startswith("banded"):
            raise ValueError(
                f"use_pallas=True with pivot_dtype={mode!r}: the kernel planes are "
                "packed from full or bf16 pivots, and a banded mode keeps neither"
            )
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
    op = build_fast_convolution_2d(
        grid.x, grid.y, h, k, nu, quad_rule="greengard_vico", dtype=dtype,
        cache_dir=cache_dir, device=device,
    )
    seconds["symbol"] = lap(t0)

    t0 = time.perf_counter()
    a_st, ag_st, a_np, ag_np = stencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, h, dtype=dtype, return_host=True, cache_dir=cache_dir,
        device=device,
    )
    seconds["stencils"] = lap(t0)

    def slab_system(a, ag, nu_dir, x, y, a_host, ag_host, mode, suffix):
        parts = {}
        slabs = build_slab_system(
            a, ag, nu_dir, x, y, h, k, n_subdomains, npml=npml,
            a_host=a_host, ag_host=ag_host, pivot_dtype=mode, pivot_band=pivot_band,
            pivot_rank=pivot_rank, cache_dir=cache_dir, device=device, timings=parts,
        )
        t0 = time.perf_counter()
        if use_pallas:
            slabs = attach_pallas(slabs)
        parts["packing"] += lap(t0)
        for part, sec in parts.items():
            seconds[part + suffix] = sec
        return slabs

    # the preconditioner's As b step takes the kernel; msp (below) is built
    # from the plain field, as the JAX package builds it before the flag
    a_s = dataclasses.replace(a_st, use_pallas=True) if use_pallas else a_st
    slabs = slab_system(a_st, ag_st, nu, grid.x, grid.y, a_np, ag_np, pivot_dtype, "")
    if not double_sweep:
        precond = SingleSweepPreconditioner(slabs=slabs, a_s=a_s)
    else:
        # the x-direction sweep: the same construction on the transposed
        # stencil fields and medium (tests/plasma_example.jl:103-114)
        slabs_t = slab_system(
            a_st.transpose(), ag_st.transpose(), nu.T, grid.y, grid.x,
            a_np.transpose(1, 0, 3, 2), ag_np.transpose(1, 0, 3, 2), pivot_dtype_t, "_t",
        )
        precond = DoubleSweepPreconditioner(
            slabs=slabs, slabs_t=slabs_t,
            msp=stencils.build_msp_2d(a_st, ag_st, nu, k), a_s=a_s,
        )
    return Plasma2DProblem(grid=grid, k=k, op=op, precond=precond, nu=nu,
                           setup_seconds=seconds)


def incident_rhs(problem: Plasma2DProblem, directions) -> torch.Tensor:
    """``-(M u_inc - u_inc)`` for plane waves along ``directions`` (R, 2);
    returns (R, N).  The incident field is formed on the operator's device,
    in double precision, then cast to the working dtype."""
    op = problem.op
    device = op.symbol.device
    dirs = torch.as_tensor(np.asarray(directions, dtype=np.float64), device=device)
    x = torch.as_tensor(problem.grid.x, device=device)
    y = torch.as_tensor(problem.grid.y, device=device)
    # flat x-fastest order: phase[r, j * n + i] = dx_r x_i + dy_r y_j
    phases = (dirs[:, 1, None, None] * y[None, :, None]
              + dirs[:, 0, None, None] * x[None, None, :]).reshape(len(dirs), -1)
    u_inc = torch.exp(1j * problem.k * phases).to(op.symbol.dtype)
    return -(op.apply(u_inc) - u_inc)


def solve(problem: Plasma2DProblem, incident_direction=(1.0, 0.0),
          rtol: float = 1e-8, restart: int = 20, maxiter: int = 100):
    """Scattering solve for a plane-wave incident field
    (``tests/plasma_example.jl:160-170``).  Returns ``(x, GMRESInfo)``."""
    rhs = incident_rhs(problem, [incident_direction])[0]
    return gmres(
        problem.op.apply, rhs, preconditioner=problem.precond.apply,
        rtol=rtol, restart=restart, maxiter=maxiter,
    )


def solve_batched(problem: Plasma2DProblem,
                  incident_directions=((1.0, 0.0), (0.0, 1.0)),
                  rtol: float = 1e-8, restart: int = 20, maxiter: int = 100):
    """All incident directions in ONE joint batched GMRES solve.

    The reference loops directions serially
    (``tests/plasma_example.jl:160,172``).  The substitution passes are
    memory bound on streaming the per-line pivot inverses, and the batched
    preconditioner (``apply_batch``) carries all R
    right-hand sides through each pass at once: every pivot plane is read
    once per pass for the WHOLE batch instead of once per direction.

    Returns ``(x, info)`` with a leading batch axis on every field.
    """
    rhs = incident_rhs(problem, incident_directions)
    return gmres_batched(
        problem.op.apply, rhs, preconditioner=problem.precond.apply_batch,
        rtol=rtol, restart=restart, maxiter=maxiter,
    )
