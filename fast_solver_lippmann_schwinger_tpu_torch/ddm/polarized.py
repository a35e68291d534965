"""Polarized-traces integral system on interface unknowns.

Counterpart of the JAX package's ``ddm/polarized.py``, the reference's
trace-space formulation: the preconditioner solves a block system
``MM [u_down; u_up] = f_pol`` on interface traces, preconditioned by block
Gauss-Seidel whose diagonal inverses are sequential down/up recursions, then
reconstructs the volume field with one local solve per slab
(``src/subdomains.jl:193-549,697-1072``, ``src/integral_preconditioner.jl``,
``\\(::PolarizedTracesPreconditioner)`` at ``src/preconditioner.jl:207-225``).

Trace vector layouts (all 0-based; S slabs, S-1 interfaces, n points per
trace):

* plain / polarized halves (``vectorizeBdyData``): ``(S-1, 2, n)`` blocks;
  interface q holds ``(u_n-slot of slab q, u_1-slot of slab q+1)`` for the
  "down" half and the ``(u_np, u_0)`` pair for the "up" half.
* permuted (``generatePermutationMatrix``): down pairs ``(u_n, u_np)`` per
  interface, up pairs ``(u_0, u_1)``: the layout the D-inverse recursions
  consume.

The per-slab block operator (a local solve driven by interface sources,
``applyBlockOperator``, ``src/subdomains.jl:212-271``) runs over all slabs at
once (:func:`block_apply`); the MM apply needs only two distinct right-hand
sides per slab.  The D-inverse recursions are Python loops over the inner
slabs, one local solve each (:func:`_block_apply_single`), that index and
branch on the host copies of the trace lines (``SlabSystem.host``), as the
sweeps of ``ddm/sweeps.py`` do, so an apply reads nothing back from the device
but the inner GMRES's one number per iteration.

Local solves: on a slab system whose only pivots are a kernel layout
(:func:`pallas_only`) they run the substitution kernels of
``sparse/thomas_kernels.py`` (``solve_all`` over all slabs with the exact head
start at ``trace_head``, ``solve_support`` for one slab with its head start
and tail); otherwise the dense factorization of ``sparse/direct.py``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import (
    SlabSystem,
    gather_interior,
    partition_source,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres, gmres_batched
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    band_matvec,
    block_thomas_solve,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix2D


def pallas_only(slabs: SlabSystem) -> bool:
    """True when the kernel layout is the SOLE pivot storage
    (``pivot_dtype="pallas*"``: ``fac`` carries an empty placeholder pivot
    stack).  A system built with full pivots and given bf16 kernel planes
    beside them (``attach_pallas``) keeps its full-precision local solves
    here, as in the JAX package; the plain bf16 and banded pivots
    (``"bf16"``, ``"banded"``, ``"banded_tail"``, ``"banded_lr"``) have no
    kernel layout and no ``cinv``, and run the plain solves too."""
    cinv = getattr(slabs.fac, "cinv", None)
    return slabs.pfac is not None and cinv is not None and cinv.shape[-1] == 0


def _solve_batched(slabs: SlabSystem, rhs: torch.Tensor, start: int = 0) -> torch.Tensor:
    """One solve per slab, all slabs at once; rhs (S, m1_max, n[, r]).
    ``start`` asserts the rhs is zero on lines < start (exact head start)."""
    if pallas_only(slabs):
        return thomas_kernels.solve_all(slabs.pfac, slabs.pfac.slab_ids, rhs, start=start)
    return torch.stack([block_thomas_solve(slabs.fac.slab(s), rhs[s], start=start)
                        for s in range(slabs.n_subs)])


def _band_matvec_slabs(band: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`band_matvec` of every slab at once: ``band`` (S, n, 3), ``v``
    (S, n, ...) with trailing RHS axes."""
    S, n = v.shape[:2]
    windows = F.pad(v, (0, 0) * (v.ndim - 2) + (1, 1)).unfold(1, 3, 1)
    return (band.reshape((S, n) + (1,) * (v.ndim - 2) + (3,)) * windows).sum(-1)


def _devectorize(slabs: SlabSystem, u_gamma: torch.Tensor):
    """(2(S-1)n[, ...]) trace vector -> per-slab (v0, v1, vN, vNp) each
    (S, n[, ...]); trailing axes are RHS/direction batches that ride along.

    ``devectorizeBdyData`` semantics (``src/subdomains.jl:362-434``): slab s
    reads its upper traces from interface s-1 and lower from interface s.
    """
    S, n = slabs.n_subs, slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, n) + extra)
    zero = u_gamma.new_zeros((1, n) + extra)
    v0 = torch.cat([zero, g[:, 0]])
    v1 = torch.cat([zero, g[:, 1]])
    vN = torch.cat([g[:, 0], zero])
    vNp = torch.cat([g[:, 1], zero])
    return v0, v1, vN, vNp


def _interface_vector(slabs: SlabSystem, upper_slot, lower_slot) -> torch.Tensor:
    """Assemble (2(S-1)n[, ...]) from per-slab (S, n[, ...]) arrays:
    interface q gets (upper_slot[q], lower_slot[q+1])."""
    out = torch.stack([upper_slot[:-1], lower_slot[1:]], dim=1)
    return out.reshape((-1,) + tuple(upper_slot.shape[2:]))


def _block_rhs(slabs: SlabSystem, v0, v1, vN, vNp) -> torch.Tensor:
    """The (S, m1_max, n[, ...]) right-hand sides of :func:`block_apply`: the
    equivalent sources of the interface traces SET on each slab's trace lines
    in the order l1, l0, lnp, ln, zeros where a neighbour is absent (its
    trace lines are 0 there), as in the JAX package."""
    dtype = slabs.cpl_01.dtype
    S = slabs.n_subs
    extra = tuple(v0.shape[2:])
    rhs = torch.zeros((S, slabs.m1_max, slabs.n) + extra, dtype=dtype, device=v0.device)
    flag = (S,) + (1,) * (1 + len(extra))
    top, bot = slabs.has_top.reshape(flag), slabs.has_bot.reshape(flag)
    zero = rhs.new_zeros(())
    slab = torch.arange(S, device=rhs.device)

    def source(has, band, v, sign):
        val = _band_matvec_slabs(band, v.to(dtype))
        return torch.where(has, val if sign > 0 else -val, zero)

    rhs[slab, slabs.l1] = source(top, slabs.cpl_10, v0, -1)
    rhs[slab, slabs.l0] = source(top, slabs.cpl_01, v1, 1)
    rhs[slab, slabs.lnp] = source(bot, slabs.cpl_np_n, vN, 1)
    rhs[slab, slabs.ln] = source(bot, slabs.cpl_n_np, vNp, -1)
    return rhs


def block_apply(slabs: SlabSystem, v0, v1, vN, vNp):
    """Batched ``applyBlockOperator``: one local solve per slab driven by
    interface sources (:func:`_block_rhs`); returns traces (u0, u1, uN, uNp)
    each (S, n[, ...])."""
    extra = tuple(v0.shape[2:])
    rhs = _block_rhs(slabs, v0, v1, vN, vNp)
    # the solvers batch ONE trailing RHS axis: fold any extra batch axes
    # (the (R, 2) of the batched MM apply) into it
    if len(extra) > 1:
        rhs = rhs.reshape(rhs.shape[:3] + (-1,))
    # trace-driven rhs: zero above the first trace line, so the forward
    # substitution head-starts there (exact)
    u = _solve_batched(slabs, rhs, start=slabs.trace_head)
    if len(extra) > 1:
        u = u.reshape(u.shape[:3] + extra)
    slab = torch.arange(slabs.n_subs, device=u.device)
    return u[slab, slabs.l0], u[slab, slabs.l1], u[slab, slabs.ln], u[slab, slabs.lnp]


def _slab_rhs(slabs: SlabSystem, idx: int, v0, v1, vN, vNp) -> torch.Tensor:
    """The (m1_max, n[, ...]) right-hand side of slab ``idx`` (a Python int)
    in :func:`_block_apply_single`; a source given as ``None`` is zero.  The
    sources are set in the order of :func:`_block_rhs`, from the host copies
    of the trace lines and flags; a zero one is written only where an earlier
    source of this slab landed on the same line."""
    hs = slabs.host
    dtype = slabs.cpl_01.dtype
    given = next(v for v in (v0, v1, vN, vNp) if v is not None)
    rhs = torch.zeros((slabs.m1_max, slabs.n) + tuple(given.shape[1:]), dtype=dtype,
                      device=given.device)
    written = set()
    for line, has, band, v, sign in (
        (hs.l1[idx], hs.has_top[idx], slabs.cpl_10, v0, -1),
        (hs.l0[idx], hs.has_top[idx], slabs.cpl_01, v1, 1),
        (hs.lnp[idx], hs.has_bot[idx], slabs.cpl_np_n, vN, 1),
        (hs.ln[idx], hs.has_bot[idx], slabs.cpl_n_np, vNp, -1),
    ):
        if has and v is not None:
            val = band_matvec(band[idx], v.to(dtype))
            rhs[line] = val if sign > 0 else -val
            written.add(line)
        elif line in written:
            rhs[line] = 0
    return rhs


def _block_apply_single(slabs: SlabSystem, idx: int, v0, v1, vN, vNp,
                        start: int = 0, tail: int = 0):
    """Block apply of slab ``idx`` (a Python int) alone, used inside the
    sequential D-inverse recursions; a source given as ``None`` is zero
    (:func:`_slab_rhs`).

    ``start``/``tail`` exploit the rhs/consumption structure of the caller
    (both exact): the down recursion drives only top-trace sources and reads
    only bottom traces; the up recursion is the mirror image.  Trailing axes
    of the traces (direction batches) ride through the multi-RHS slab solves:
    one pivot stream for the whole batch.
    """
    hs = slabs.host
    rhs = _slab_rhs(slabs, idx, v0, v1, vN, vNp)
    if pallas_only(slabs):
        u = thomas_kernels.solve_support(slabs.pfac, idx, rhs, start=start, tail=tail)
    else:
        u = block_thomas_solve(slabs.fac.slab(idx), rhs, start=start, tail=tail)
    return u[hs.l0[idx]], u[hs.l1[idx]], u[hs.ln[idx]], u[hs.lnp[idx]]


def apply_mm(slabs: SlabSystem, u_pol: torch.Tensor) -> torch.Tensor:
    """The polarized integral operator ``MM`` (``applyMMOptUmf`` semantics,
    ``src/subdomains.jl:1015-1072``) via one batched 2-RHS solve per slab."""
    half = 2 * (slabs.n_subs - 1) * slabs.n
    d0, d1, dN, dNp = _devectorize(slabs, u_pol[:half])
    p0, p1, pN, pNp = _devectorize(slabs, u_pol[half:])

    # RHS a: (u0D, u1D, uNU+uND, uNpU+uNpD); RHS b: (u0D+u0U, u1D+u1U, uNU, uNpU)
    v0 = torch.stack([d0, d0 + p0], dim=-1)
    v1 = torch.stack([d1, d1 + p1], dim=-1)
    vN = torch.stack([pN + dN, pN], dim=-1)
    vNp = torch.stack([pNp + dNp, pNp], dim=-1)
    u0_t, u1_t, uN_t, uNp_t = block_apply(slabs, v0, v1, vN, vNp)
    u0_a, u1_a = u0_t[..., 0], u1_t[..., 0]
    uN_b, uNp_b = uN_t[..., 1], uNp_t[..., 1]

    # Mu1 (down rows): interface q gets (-uNU-uND+uN_b of slab q,
    #                                    -u1U-u1D+u1_a of slab q+1)
    mu1 = _interface_vector(slabs, -pN - dN + uN_b, -p1 - d1 + u1_a)
    # Mu (up rows): interface q gets (-uNpD+uNp_b of slab q,
    #                                 -u0U+u0_a of slab q+1)
    mu0 = _interface_vector(slabs, -dNp + uNp_b, -p0 + u0_a)
    return torch.cat([mu1, mu0])


def apply_m_down(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Down-polarized block (``applyMdown``, ``src/subdomains.jl:587-616``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    zero = torch.zeros_like(v0)
    _, u1_full, _, _ = block_apply(slabs, v0, v1, vN, vNp)
    _, _, uN_zero, _ = block_apply(slabs, v0, v1, zero, zero)
    upper = torch.cat([-vN[:1], (uN_zero - vN)[1:]])
    return _interface_vector(slabs, upper, u1_full - v1)


def apply_m_up(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Up-polarized block (``applyMup``, ``src/subdomains.jl:555-585``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    zero = torch.zeros_like(v0)
    _, u1_zero, _, _ = block_apply(slabs, zero, zero, vN, vNp)
    _, _, uN_full, _ = block_apply(slabs, v0, v1, vN, vNp)
    lower = torch.cat([(u1_zero - v1)[:-1], -v1[-1:]])
    return _interface_vector(slabs, uN_full - vN, lower)


def apply_m0_down(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Down block of the second polarized row (``applyM0down``,
    ``src/subdomains.jl:652-681``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    zero = torch.zeros_like(v0)
    u0_full, _, _, _ = block_apply(slabs, v0, v1, vN, vNp)
    _, _, _, uNp_zero = block_apply(slabs, v0, v1, zero, zero)
    return _interface_vector(slabs, uNp_zero - vNp, u0_full)


def apply_m0_up(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Up block of the second polarized row (``applyM0up``,
    ``src/subdomains.jl:618-650``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    zero = torch.zeros_like(v0)
    u0_zero, _, _, _ = block_apply(slabs, zero, zero, vN, vNp)
    _, _, _, uNp_full = block_apply(slabs, v0, v1, vN, vNp)
    lower = torch.cat([(u0_zero - v0)[:-1], -v0[-1:]])
    return _interface_vector(slabs, uNp_full, lower)


def apply_mm_plain(slabs: SlabSystem, u_pol: torch.Tensor) -> torch.Tensor:
    """The polarized system from its four quadrants (``applyMM``,
    ``src/subdomains.jl:683-693``); agrees with :func:`apply_mm`."""
    half = u_pol.shape[0] // 2
    u_down, u_up = u_pol[:half], u_pol[half:]
    return torch.cat([
        apply_m_down(slabs, u_down) + apply_m_up(slabs, u_up),
        apply_m0_down(slabs, u_down) + apply_m0_up(slabs, u_up),
    ])


def apply_u_coupling(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """``applyU`` (``src/subdomains.jl:817-845``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    _, _, uN_t, uNp_t = block_apply(slabs, v0, v1, vN, vNp)
    out = torch.stack([(uN_t - vN)[:-1], uNp_t[:-1]], dim=1)
    return out.reshape((-1,) + tuple(u_gamma.shape[1:]))


def apply_l_coupling(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """``applyL`` (``src/subdomains.jl:848-876``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    u0_t, u1_t, _, _ = block_apply(slabs, v0, v1, vN, vNp)
    out = torch.stack([u0_t[1:], (u1_t - v1)[1:]], dim=1)
    return out.reshape((-1,) + tuple(u_gamma.shape[1:]))


def apply_dinv_down(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Sequential downward D^{-1} recursion (``applyDinvDown``,
    ``src/subdomains.jl:725-753``): interface 0 is negated; each next
    interface's value is the transmitted trace through the slab in between
    minus the input.  Slabs 1..S-2, one local solve each: top-trace sources
    only and bottom traces consumed, so the forward pass head-starts at
    ``trace_head`` and the backward pass is truncated to ``trace_tail`` lines
    (both exact)."""
    S, n = slabs.n_subs, slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, n) + extra)
    outs = [-g[0]]
    for s in range(1, S - 1):
        _, _, tN, tNp = _block_apply_single(
            slabs, s, outs[-1][0], outs[-1][1], None, None,
            start=slabs.trace_head, tail=slabs.trace_tail,
        )
        outs.append(torch.stack([tN - g[s, 0], tNp - g[s, 1]]))
    return torch.stack(outs).reshape((-1,) + extra)


def apply_dinv_up(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Sequential upward D^{-1} recursion (``applyDinvUp``,
    ``src/subdomains.jl:785-814``): interfaces S-3 .. 0 through slabs
    S-2 .. 1; bottom-trace sources only and top traces consumed, so the
    forward pass head-starts at the first bottom-trace line (exact)."""
    S, n = slabs.n_subs, slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, n) + extra)
    outs = [-g[S - 2]]
    for s in range(S - 2, 0, -1):
        t0, t1, _, _ = _block_apply_single(
            slabs, s, None, None, outs[-1][0], outs[-1][1],
            start=max(slabs.m1_max - slabs.trace_tail, 0),
        )
        outs.append(torch.stack([t0 - g[s - 1, 0], t1 - g[s - 1, 1]]))
    return torch.stack(outs[::-1]).reshape((-1,) + extra)


def apply_d_down(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Downward block-diagonal operator (``applyDdown``,
    ``src/subdomains.jl:697-723``); exact inverse of :func:`apply_dinv_down`."""
    S, n = slabs.n_subs, slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, n) + extra)
    v0, v1, _, _ = _devectorize(slabs, u_gamma)
    zero = torch.zeros_like(v0)
    _, _, tN, tNp = block_apply(slabs, v0, v1, zero, zero)
    rest = torch.stack([tN[1 : S - 1], tNp[1 : S - 1]], dim=1) - g[1:]
    return torch.cat([-g[:1], rest]).reshape((-1,) + extra)


def apply_d_up(slabs: SlabSystem, u_gamma: torch.Tensor) -> torch.Tensor:
    """Upward block-diagonal operator (``applyDup``,
    ``src/subdomains.jl:756-783``); exact inverse of :func:`apply_dinv_up`."""
    S, n = slabs.n_subs, slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, n) + extra)
    _, _, vN, vNp = _devectorize(slabs, u_gamma)
    zero = torch.zeros_like(vN)
    t0, t1, _, _ = block_apply(slabs, zero, zero, vN, vNp)
    rest = torch.stack([t0[1 : S - 1], t1[1 : S - 1]], dim=1) - g[: S - 2]
    return torch.cat([rest, -g[S - 2 :]]).reshape((-1,) + extra)


def permute_to_pairs(slabs: SlabSystem, b_pol: torch.Tensor) -> torch.Tensor:
    """The ``generatePermutationMatrix`` shuffle (``src/subdomains.jl:881-890``):
    ``[f1; f0]`` (down: (u_n, u_1) pairs / up: (u_np, u_0) pairs) into the
    recursion layout (down: (u_n, u_np), up: (u_0, u_1))."""
    S, n = slabs.n_subs, slabs.n
    half = 2 * (S - 1) * n
    extra = tuple(b_pol.shape[1:])
    f1 = b_pol[:half].reshape((S - 1, 2, n) + extra)
    f0 = b_pol[half:].reshape((S - 1, 2, n) + extra)
    down = torch.stack([f1[:, 0], f0[:, 0]], dim=1)
    up = torch.stack([f0[:, 1], f1[:, 1]], dim=1)
    flat = (-1,) + extra
    return torch.cat([down.reshape(flat), up.reshape(flat)])


def precond_gauss_seidel(slabs: SlabSystem, v: torch.Tensor, n_it: int) -> torch.Tensor:
    """Block Gauss-Seidel on the polarized system (``PrecondGaussSeidel``,
    ``src/integral_preconditioner.jl:57-94``)."""
    half = v.shape[0] // 2
    vdown_rhs, vup_rhs = v[:half], v[half:]
    u_down = apply_dinv_down(slabs, vdown_rhs)
    u_up = apply_dinv_up(slabs, vup_rhs - apply_l_coupling(slabs, u_down))
    for _ in range(n_it - 1):
        u_down = apply_dinv_down(slabs, vdown_rhs - apply_u_coupling(slabs, u_up))
        u_up = apply_dinv_up(slabs, vup_rhs - apply_l_coupling(slabs, u_down))
    return torch.cat([u_down, u_up])


def precond_jacobi(slabs: SlabSystem, v: torch.Tensor, n_it: int) -> torch.Tensor:
    """Block-Jacobi on the polarized system (``PrecondJacobi``,
    ``src/integral_preconditioner.jl:32-55``): both halves are relaxed
    against the PREVIOUS iterate instead of chaining down->up."""
    half = v.shape[0] // 2
    vdown_rhs, vup_rhs = v[:half], v[half:]
    u_down = apply_dinv_down(slabs, vdown_rhs)
    u_up = apply_dinv_up(slabs, vup_rhs)
    for _ in range(n_it - 1):
        new_down = apply_dinv_down(slabs, vdown_rhs - apply_u_coupling(slabs, u_up))
        new_up = apply_dinv_up(slabs, vup_rhs - apply_l_coupling(slabs, u_down))
        u_down, u_up = new_down, new_up
    return torch.cat([u_down, u_up])


def extract_rhs_traces(slabs: SlabSystem, b: torch.Tensor):
    """Local solves of the partitioned source + boundary-trace extraction
    (``extractRHS``/``extractFullBoundaryData``, ``src/subdomains.jl:309-359``).
    Returns (u_0, u_1, u_n, u_np) each (S, n[, r]), zeroed where absent."""
    u = _solve_batched(slabs, partition_source(slabs, b))
    S = slabs.n_subs
    slab = torch.arange(S, device=u.device)
    flag = (S,) + (1,) * (u.ndim - 2)
    top, bot = slabs.has_top.reshape(flag), slabs.has_bot.reshape(flag)
    zero = u.new_zeros(())
    return (torch.where(top, u[slab, slabs.l0], zero), torch.where(top, u[slab, slabs.l1], zero),
            torch.where(bot, u[slab, slabs.ln], zero), torch.where(bot, u[slab, slabs.lnp], zero))


def reconstruction(slabs: SlabSystem, b: torch.Tensor, v0, v1, vn, vnp) -> torch.Tensor:
    """Volume reconstruction from interface traces (``reconstruction``,
    ``src/subdomains.jl:893-943``): :func:`reconstruction_fields` gathered
    to the global vector."""
    return gather_interior(slabs, reconstruction_fields(slabs, b, v0, v1, vn, vnp))


def reconstruction_fields(slabs: SlabSystem, b: torch.Tensor, v0, v1, vn, vnp) -> torch.Tensor:
    """The per-slab (S, m1_max, n[, r]) solutions of :func:`reconstruction`:
    one local solve per slab with the trace-driven equivalent sources ADDED
    to the partitioned source."""
    rhs = partition_source(slabs, b)
    dtype = rhs.dtype
    S = slabs.n_subs
    flag = (S,) + (1,) * (v0.ndim - 1)
    top, bot = slabs.has_top.reshape(flag), slabs.has_bot.reshape(flag)
    zero = rhs.new_zeros(())
    slab = torch.arange(S, device=rhs.device)

    def source(has, band, v, sign):
        val = _band_matvec_slabs(band, v.to(dtype))
        return torch.where(has, val if sign > 0 else -val, zero)

    rhs[slab, slabs.l1] += source(top, slabs.cpl_10, v0, -1)
    rhs[slab, slabs.l0] += source(top, slabs.cpl_01, v1, 1)
    rhs[slab, slabs.lnp] += source(bot, slabs.cpl_np_n, vn, 1)
    rhs[slab, slabs.ln] += source(bot, slabs.cpl_n_np, vnp, -1)
    return _solve_batched(slabs, rhs)


@dataclasses.dataclass(frozen=True)
class PolarizedTracesPreconditioner:
    """Full-system preconditioner through the trace-space inner solve
    (reference ``PolarizedTracesPreconditioner``,
    ``src/preconditioner.jl:62-75,207-225``): ``As b``, the traces of the
    local solves of the partitioned source, an inner GMRES on the polarized
    system ``MM`` (``rtol=inner_tol``, restart ``min(20, M)``,
    ``maxiter=inner_maxiter``) preconditioned by ``n_it`` sweeps of block
    Gauss-Seidel (``precond_type="GS"``) or block Jacobi, then the volume
    reconstruction."""

    slabs: SlabSystem
    a_s: StencilMatrix2D
    n_it: int = 2
    inner_tol: float = 1e-2
    inner_maxiter: int = 40
    precond_type: str = "GS"

    def _inner_precond(self):
        return precond_gauss_seidel if self.precond_type == "GS" else precond_jacobi

    def _polarized_rhs(self, asb: torch.Tensor) -> torch.Tensor:
        """``f_pol`` (M[, R]) of ``As b`` (N[, R])."""
        slabs = self.slabs
        u_0, u_1, u_n, u_np = extract_rhs_traces(slabs, asb)
        f1 = _interface_vector(slabs, u_n, u_1)
        f0 = _interface_vector(slabs, u_np, u_0)
        return -torch.cat([f1, f0])

    def _reconstruct(self, asb: torch.Tensor, u_pol: torch.Tensor) -> torch.Tensor:
        half = 2 * (self.slabs.n_subs - 1) * self.slabs.n
        u = u_pol[:half] + u_pol[half:]
        return reconstruction(self.slabs, asb, *_devectorize(self.slabs, u))

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        slabs = self.slabs
        asb = self.a_s.matvec(b)
        f_pol = self._polarized_rhs(asb)
        inner = self._inner_precond()
        u_pol, _ = gmres(
            lambda v: apply_mm(slabs, v),
            f_pol,
            preconditioner=lambda v: inner(slabs, permute_to_pairs(slabs, v), self.n_it),
            rtol=self.inner_tol,
            restart=min(20, f_pol.shape[0]),
            maxiter=self.inner_maxiter,
        )
        return self._reconstruct(asb, u_pol)

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, m*n) joint batch apply (``gmres_batched`` convention).

        The R directions ride the whole trace pipeline as a trailing axis:
        ONE batched local-solve pass for the partitioned sources, ONE
        ``gmres_batched`` inner solve on the trace system whose MM applies and
        D-inverse recursions stream each slab's pivots once per step for all
        R columns (up to eight a launch on the card), and ONE batched
        reconstruction (the reference solves directions serially,
        ``tests/plasma_integral_system_example.jl:115-134``)."""
        slabs = self.slabs
        asb = self.a_s.matvec(b_batch.T)                   # (N, R)
        f_pol = self._polarized_rhs(asb)                   # (M, R)
        inner = self._inner_precond()
        u_pol, _ = gmres_batched(
            lambda V: apply_mm(slabs, V.T).T,
            f_pol.T,
            preconditioner=lambda V: inner(slabs, permute_to_pairs(slabs, V.T), self.n_it).T,
            rtol=self.inner_tol,
            restart=min(20, f_pol.shape[0]),
            maxiter=self.inner_maxiter,
        )
        return self._reconstruct(asb, u_pol.T).T

    def __call__(self, b):
        return self.apply(b)
