"""Bi-directional Gauss-Seidel sweeping preconditioners on volume unknowns.

Counterpart of the JAX package's ``ddm/sweeps.py``: the optimized
polarized-traces sweep ``precondGSOptimized``
(``src/preconditioner.jl:557-630``) and the alternating x/y double sweep
``doubleGSPreconditioner`` / ``doublePreconditioner``
(``src/preconditioner.jl:4-24,92-130,228-249``).

Each sweep is two Python loops over the slabs (down, then up); the only
inter-slab data are four n-vectors of interface traces.  The local solves go
through the substitution kernels (``sparse/thomas_kernels.py``) when the slab
system carries their layout, else through the dense full-precision
factorization (``sparse/direct.py``).  The loops index and branch on the host
copies of the trace lines (``SlabSystem.host``), so a sweep reads nothing back
from the device.  On the banded+tail pivot layout ``gs_sweep`` is instead two
launches of the fused whole-sweep kernels (``sparse/sweep_kernels.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import (
    SlabSystem,
    gather_interior,
    partition_source,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse import sweep_kernels, thomas_kernels
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    band_matvec,
    block_thomas_solve,
    block_thomas_solve_cached,
    block_thomas_solve_resume,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix2D


def _add_top_traces(slabs: SlabSystem, s: int, rhs, u_n_above, u_np_above):
    """Equivalent sources of the slab above's outgoing traces (one-sided
    Green's representation), added in place at slab ``s``'s top trace lines."""
    hs = slabs.host
    rhs[hs.l0[s]].add_(band_matvec(slabs.cpl_01[s], u_np_above))
    rhs[hs.l1[s]].sub_(band_matvec(slabs.cpl_10[s], u_n_above))


def _add_bottom_traces(slabs: SlabSystem, s: int, rhs, u_0_below, u_1_below):
    """Equivalent sources of the slab below's traces, added in place at slab
    ``s``'s bottom trace lines."""
    hs = slabs.host
    rhs[hs.lnp[s]].add_(band_matvec(slabs.cpl_np_n[s], u_0_below))
    rhs[hs.ln[s]].sub_(band_matvec(slabs.cpl_n_np[s], u_1_below))


def gs_sweep(slabs: SlabSystem, b: torch.Tensor) -> torch.Tensor:
    """One optimized Gauss-Seidel down/up sweep: ``u ~ Msp^{-1} b``.

    Semantics of ``precondGSOptimized`` (``src/preconditioner.jl:557-630``):

    * DOWN: local solves in slab order; slab s receives equivalent sources
      built from slab s-1's outgoing traces; record outgoing traces
      (u_n, u_np).  Only the bottom traces are consumed, so the backward pass
      is truncated to ``trace_tail`` lines, and the forward pass's stacks are
      cached.
    * UP: revisit slabs in reverse; add equivalent sources from slab s+1's
      (u_0, u_1).  The rhs differs from the down solve's only at the bottom
      trace lines, so the forward pass resumes from the cache there.  Record
      incoming traces with the reflection correction
      ``u_1 <- u[ind_1] - u_np`` and keep the volume solution.

    ``b`` may carry trailing RHS columns (m*n, r): the local solves then
    contract each streamed pivot plane against all r columns at once (the
    substitution is memory bound on exactly that traffic, so r right-hand
    sides cost barely more than one).

    On the banded+tail pivot layout with a truncated sweep
    (0 < trace_tail < m1_max) the whole sweep is the two fused kernels
    (:func:`_gs_sweep_fused`), as in the JAX package.
    """
    if (isinstance(slabs.pfac, thomas_kernels.BandedTailFactorization)
            and 0 < slabs.trace_tail < slabs.m1_max):
        return _gs_sweep_fused(slabs, b)
    return _gs_sweep_per_slab(slabs, b)


def _gs_sweep_fused(slabs: SlabSystem, b: torch.Tensor) -> torch.Tensor:
    """:func:`gs_sweep` as two launches, down and up, of the fused sweep
    kernels (the JAX package's ``pallas_sweep.gs_sweep_fused``)."""
    pfac, tt, tables = slabs.pfac, slabs.trace_tail, slabs.sweep_tables
    rhs0 = partition_source(slabs, b)                      # (S, m1_max, n[, r])
    b4 = thomas_kernels._to_rows_b(pfac, rhs0)
    y4, t4, unp = sweep_kernels.sweep_down(pfac, tables.meta, b4, tables.c01, tables.c10, tt)
    u4 = sweep_kernels.sweep_up(pfac, tables.meta, b4, tables.cnpn, tables.cnnp,
                                y4, t4, unp, tt)
    u = thomas_kernels._from_rows_b(u4, pfac.n, rhs0.dtype, pfac.m).reshape(rhs0.shape)
    return gather_interior(slabs, u)


def _gs_sweep_per_slab(slabs: SlabSystem, b: torch.Tensor) -> torch.Tensor:
    """:func:`gs_sweep` as Python loops of one-slab solves, on any pivot
    layout (on the banded+tail one too: tests and ``chip_smoke.py`` hold the
    fused kernels against it)."""
    rhs = partition_source(slabs, b)       # (S, m1_max, n[, r]); updated in place
    S, tail = slabs.n_subs, slabs.trace_tail
    if S == 1:
        # no interfaces: the sweep IS the exact Msp solve, one plain forward
        # and backward substitution
        if slabs.pfac is not None:
            u = thomas_kernels.solve_all(slabs.pfac, slabs.pfac.slab_ids, rhs)
        else:
            u = block_thomas_solve(slabs.fac.slab(0), rhs[0])[None]
        return gather_interior(slabs, u)

    hs = slabs.host
    caches, u_np_down = [], []
    u_n = u_np = None
    for s in range(S):
        if hs.has_top[s]:
            _add_top_traces(slabs, s, rhs[s], u_n, u_np)
        if slabs.pfac is not None:
            v, y_c, t_c = thomas_kernels.solve_cached(slabs.pfac, s, rhs[s], tail)
        else:
            v, y_c, t_c = block_thomas_solve_cached(slabs.fac.slab(s), rhs[s], tail)
        caches.append((y_c, t_c))
        if hs.has_bot[s]:
            u_n, u_np = v[hs.ln[s]], v[hs.lnp[s]]
        u_np_down.append(u_np)

    u = torch.empty_like(rhs)
    u_0 = u_1 = None
    for s in reversed(range(S)):
        if hs.has_bot[s]:
            _add_bottom_traces(slabs, s, rhs[s], u_0, u_1)
        if slabs.pfac is not None:
            u[s] = thomas_kernels.solve_resume(slabs.pfac, s, rhs[s], *caches[s], tail)
        else:
            u[s] = block_thomas_solve_resume(slabs.fac.slab(s), rhs[s], *caches[s], tail)
        if hs.has_top[s]:
            u_0 = u[s, hs.l0[s]]
            u_1 = u[s, hs.l1[s]] - u_np_down[s - 1]
    return gather_interior(slabs, u)


def jacobi_sweep(slabs: SlabSystem, b: torch.Tensor) -> torch.Tensor:
    """Block-Jacobi sweep: the down and up trace recursions both build on
    the *initial* local solves, independently of each other; a final local
    solve per slab combines source + both trace families.  Semantics of
    ``precondJacobi`` (``src/preconditioner.jl:421-550``).

    ``b`` may carry trailing RHS columns (m*n, r): every slab solve then
    streams its pivots once for all r columns.  A trace recursion step whose
    right-hand side is identically zero (the first slab going down, the last
    going up) has the zero solution and is not solved.
    """
    rhs0 = partition_source(slabs, b)      # (S, m1_max, n[, r])
    S, hs = slabs.n_subs, slabs.host

    if slabs.pfac is not None:
        def solve_every(rhs_all):
            # one batched launch pair over all slabs
            return thomas_kernels.solve_all(slabs.pfac, slabs.pfac.slab_ids, rhs_all)

        def solve_one(s, rhs, tail=0):
            return thomas_kernels.solve(slabs.pfac, s, rhs, tail=tail)
    else:
        def solve_every(rhs_all):
            return torch.stack([block_thomas_solve(slabs.fac.slab(s), rhs_all[s])
                                for s in range(S)])

        def solve_one(s, rhs, tail=0):
            return block_thomas_solve(slabs.fac.slab(s), rhs, tail=tail)

    v_init = solve_every(rhs0)

    # down recursion on the bottom traces
    down = []
    u_n = u_np = None
    for s in range(S):
        if hs.has_bot[s]:
            new_n, new_np = v_init[s, hs.ln[s]], v_init[s, hs.lnp[s]]
            if hs.has_top[s]:
                rhs = torch.zeros_like(rhs0[s])
                _add_top_traces(slabs, s, rhs, u_n, u_np)
                t = solve_one(s, rhs, tail=slabs.trace_tail)
                new_n, new_np = new_n + t[hs.ln[s]], new_np + t[hs.lnp[s]]
            u_n, u_np = new_n, new_np
        down.append((u_n, u_np))

    # up recursion on the top traces
    up = [None] * S
    u_0 = u_1 = None
    for s in reversed(range(S)):
        if hs.has_top[s]:
            new_0, new_1 = v_init[s, hs.l0[s]], v_init[s, hs.l1[s]]
            if hs.has_bot[s]:
                rhs = torch.zeros_like(rhs0[s])
                _add_bottom_traces(slabs, s, rhs, u_0, u_1)
                t = solve_one(s, rhs)
                new_0, new_1 = new_0 + t[hs.l0[s]], new_1 + t[hs.l1[s]]
            u_0, u_1 = new_0, new_1
        up[s] = (u_0, u_1)

    # final reconstruction: source + down traces from above + up traces from
    # below, one batched solve over all slabs
    for s in range(S):
        if hs.has_top[s]:
            _add_top_traces(slabs, s, rhs0[s], *down[s - 1])
        if hs.has_bot[s]:
            _add_bottom_traces(slabs, s, rhs0[s], *up[s + 1])
    return gather_interior(slabs, solve_every(rhs0))


@dataclasses.dataclass(frozen=True)
class GSPreconditioner:
    """Single-direction sweep preconditioner for the sparsified system
    (reference ``GSPreconditioner``, ``src/preconditioner.jl:78-89,178-184``)."""

    slabs: SlabSystem

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return gs_sweep(self.slabs, b)

    def __call__(self, b):
        return self.apply(b)


@dataclasses.dataclass(frozen=True)
class SingleSweepPreconditioner:
    """``b -> GS_sweep(As b)``: one-directional sweep applied to the full
    LS system (the reference's ``Preconditioner`` with zero inner
    iterations)."""

    slabs: SlabSystem
    a_s: StencilMatrix2D

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return gs_sweep(self.slabs, self.a_s.matvec(b))

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, m*n) joint batch apply (``gmres_batched`` convention)."""
        return self.apply(b_batch.T).T

    def __call__(self, b):
        return self.apply(b)


@dataclasses.dataclass(frozen=True)
class InnerGMRESPreconditioner:
    """Composite preconditioner: inner GMRES on the sparsified system,
    itself preconditioned by a sweep.

    Covers the reference's ``Preconditioner`` (GS sweep inner,
    ``src/preconditioner.jl:107-116,186-204``) and the ``maxIter != 0``
    branch of ``doublePreconditioner`` (``:228-244``): one restart cycle of
    length ``max_iter`` at tolerance ``tol`` on ``Msp y = As b``.
    """

    msp: StencilMatrix2D
    a_s: StencilMatrix2D
    sweep: Any
    max_iter: int = 20
    tol: float = 1e-4

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres

        inner = (
            self.sweep.apply_sparsified
            if hasattr(self.sweep, "apply_sparsified")
            else self.sweep.apply
        )
        y, _ = gmres(
            self.msp.matvec, self.a_s.matvec(b), preconditioner=inner,
            rtol=self.tol, restart=self.max_iter, maxiter=self.max_iter,
        )
        return y

    def __call__(self, b):
        return self.apply(b)


@dataclasses.dataclass(frozen=True)
class DoubleSweepPreconditioner:
    """Alternating bi-directional (y then x) sweep for the full LS system.

    ``b -> u - T' GS_x(T (Msp u - As b))`` with ``u = GS_y(As b)``: the
    ``doublePreconditioner`` ``maxIter = 0`` path
    (``src/preconditioner.jl:121-130,228-249``).  ``slabs_t`` must be built
    from the transposed stencil fields and medium
    (``tests/plasma_example.jl:103-114``).
    """

    slabs: SlabSystem
    slabs_t: SlabSystem
    msp: StencilMatrix2D
    a_s: StencilMatrix2D

    def _transpose_flat(self, v: torch.Tensor) -> torch.Tensor:
        """Grid transpose of a flat (m*n[, r]) vector (trailing RHS columns
        ride along)."""
        extra = tuple(v.shape[1:])
        vg = v.reshape((self.msp.m, self.msp.n) + extra)
        return vg.transpose(0, 1).reshape((self.msp.m * self.msp.n,) + extra)

    def apply_sparsified(self, b: torch.Tensor) -> torch.Tensor:
        """The double sweep on the sparsified system
        (``doubleGSPreconditioner``); ``b`` (m*n,) or (m*n, r): the sweeps'
        local solves amortize their pivot streaming over the r columns."""
        u = gs_sweep(self.slabs, b)
        err = self.msp.matvec(u) - b
        u2 = self._transpose_flat(gs_sweep(self.slabs_t, self._transpose_flat(err)))
        return u - u2

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply_sparsified(self.a_s.matvec(b))

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, m*n) batch apply in the ``gmres_batched`` convention: one
        joint double sweep whose pivot planes are read once per R right-hand
        sides (the reference solves its two incident directions serially,
        ``tests/plasma_example.jl:160,172``)."""
        return self.apply(b_batch.T).T

    def __call__(self, b):
        return self.apply(b)
