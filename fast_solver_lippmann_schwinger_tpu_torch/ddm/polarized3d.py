"""3D polarized-traces integral system on interface PLANES.

Counterpart of the JAX package's ``ddm/polarized3d.py``.  The reference only
advertises this capability (its ``examples/example3D_Polarized_traces.jl``
duplicates ``examples/example3D.jl``); the JAX package supplies it with the
algebra of the 2D trace system (``ddm/polarized.py``, reference
``src/subdomains.jl:193-549,697-1072`` and ``src/integral_preconditioner.jl``)
and lines replaced by planes on :class:`~.subdomain3d.SlabSystem3D`: the
interface unknowns are (m, n) planes, the inter-plane couplings 9-point
in-plane stencils, and the local solves go through ``slab_solve_3d``, so both
the z-plane and the y-plane pivot layouts work.

Trace vector layouts are the 2D ones with a plane of mn points per trace:
``(S-1, 2, mn)`` blocks per polarized half; the permuted layout pairs
(u_n, u_np) / (u_0, u_1) for the D-inverse recursions.

The block apply over all slabs (:func:`block_apply`) solves slab by slab
through ``SlabSystem3D.slab_facs``: with a plane stack (``pivot_dtype``
ending in ``"_pallas"``) each solve runs the fused plane kernels of
``sparse/plane_kernels.py`` on that slab's view, never the empty placeholder
pivots of ``fac``.  The D-inverse recursions are Python loops over the inner
slabs, one local solve each (:func:`_block_apply_single`), that index and
branch on the host copies of the trace planes (``SlabSystem3D.host``), so an
apply reads nothing back from the device but the inner GMRES's one number per
iteration.  In the z layout the down recursion starts its forward pass at
``trace_head`` and truncates its backward pass to ``trace_tail`` planes, the
up recursion starts its forward pass at ``l1_max - trace_tail`` (all exact);
the y layout takes neither.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain3d import (
    SlabSystem3D,
    _cpl_apply,
    gather_interior_3d,
    partition_source_3d,
    slab_solve_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres, gmres_batched
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix3D


def _cpl_multi(sten: torch.Tensor, plane: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Apply an (m, n, 3, 3) coupling stencil to a flat plane (mn[, r]): the
    JAX package's helper of this name, which its sharded 3D trace algebra
    imports (``ddm.subdomain3d._cpl_apply``)."""
    return _cpl_apply(sten, plane, m, n)


# the coupling stencils of every slab at once: sten (S, m, n, 3, 3), planes
# (S, mn[, ...]) (the JAX package's ``_cpl_multi`` under ``vmap``)
_cpl_slabs = torch.func.vmap(_cpl_multi, in_dims=(0, 0, None, None))


def _devectorize(slabs: SlabSystem3D, u_gamma: torch.Tensor):
    """(2(S-1)mn[, ...]) trace vector -> per-slab (v0, v1, vN, vNp), each
    (S, mn[, ...]) (``devectorizeBdyData`` semantics, line -> plane): slab s
    reads its upper traces from interface s-1 and its lower from interface
    s; trailing axes are direction batches that ride along."""
    S, mn = slabs.n_subs, slabs.m * slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, mn) + extra)
    zero = u_gamma.new_zeros((1, mn) + extra)
    v0 = torch.cat([zero, g[:, 0]])
    v1 = torch.cat([zero, g[:, 1]])
    vN = torch.cat([g[:, 0], zero])
    vNp = torch.cat([g[:, 1], zero])
    return v0, v1, vN, vNp


def _interface_vector(slabs: SlabSystem3D, upper_slot, lower_slot) -> torch.Tensor:
    """Assemble (2(S-1)mn[, ...]) from per-slab (S, mn[, ...]) arrays:
    interface q gets (upper_slot[q], lower_slot[q+1])."""
    out = torch.stack([upper_slot[:-1], lower_slot[1:]], dim=1)
    return out.reshape((-1,) + tuple(upper_slot.shape[2:]))


def _solve_batched_3d(slabs: SlabSystem3D, rhs: torch.Tensor, start: int = 0,
                      tail: int = 0) -> torch.Tensor:
    """One local solve per slab, rhs (S, l1_max, mn[, r]), slab by slab
    through ``slabs.slab_facs``: a plane view per slab with a plane stack
    (the fused plane kernels), else the slab's slice of the batched
    factorization.  ``start``/``tail`` as in ``slab_solve_3d``."""
    return torch.stack([slab_solve_3d(slabs, fac, rhs[s], start=start, tail=tail)
                        for s, fac in enumerate(slabs.slab_facs)])


def _trace_sources(slabs: SlabSystem3D, rhs: torch.Tensor, v0, v1, vN, vNp, add: bool):
    """The equivalent sources of the interface traces on each slab's trace
    planes of ``rhs`` (S, l1_max, mn[, ...]), in the order l1, l0, lnp, ln,
    zero where a neighbour is absent (its trace planes are 0 there): SET by
    :func:`block_apply`, ADDED to the partitioned source by
    :func:`reconstruction`, as in the JAX package."""
    dtype = rhs.dtype
    S, m, n = slabs.n_subs, slabs.m, slabs.n
    flag = (S,) + (1,) * (rhs.ndim - 2)
    top, bot = slabs.has_top.reshape(flag), slabs.has_bot.reshape(flag)
    zero = rhs.new_zeros(())
    slab = torch.arange(S, device=rhs.device)
    for plane, has, sten, v, sign in (
        (slabs.l1, top, slabs.cpl_10, v0, -1),
        (slabs.l0, top, slabs.cpl_01, v1, 1),
        (slabs.lnp, bot, slabs.cpl_np_n, vN, 1),
        (slabs.ln, bot, slabs.cpl_n_np, vNp, -1),
    ):
        val = _cpl_slabs(sten, v.to(dtype), m, n)
        val = torch.where(has, val if sign > 0 else -val, zero)
        if add:
            rhs[slab, plane] += val
        else:
            rhs[slab, plane] = val
    return rhs


def block_apply(slabs: SlabSystem3D, v0, v1, vN, vNp):
    """Batched ``applyBlockOperator`` on plane traces (reference
    ``src/subdomains.jl:212-271``): one local solve per slab driven by the
    interface sources (:func:`_trace_sources`); returns (u0, u1, uN, uNp),
    each (S, mn[, ...])."""
    extra = tuple(v0.shape[2:])
    rhs = torch.zeros((slabs.n_subs, slabs.l1_max, slabs.m * slabs.n) + extra,
                      dtype=slabs.cpl_01.dtype, device=v0.device)
    rhs = _trace_sources(slabs, rhs, v0, v1, vN, vNp, add=False)
    # the solvers batch ONE trailing RHS axis: fold any extra batch axes
    # (the (R, 2) of the batched MM apply) into it
    if len(extra) > 1:
        rhs = rhs.reshape(rhs.shape[:3] + (-1,))
    # trace-driven rhs: zero above the first trace plane, so the forward
    # substitution head-starts there (exact; z layout only)
    u = _solve_batched_3d(slabs, rhs, start=slabs.trace_head)
    if len(extra) > 1:
        u = u.reshape(u.shape[:3] + extra)
    slab = torch.arange(slabs.n_subs, device=u.device)
    return u[slab, slabs.l0], u[slab, slabs.l1], u[slab, slabs.ln], u[slab, slabs.lnp]


def apply_mm(slabs: SlabSystem3D, u_pol: torch.Tensor) -> torch.Tensor:
    """The 3D polarized integral operator ``MM`` via one batched 2-RHS solve
    per slab (reference ``applyMMOptUmf``, ``src/subdomains.jl:1015-1072``)."""
    half = 2 * (slabs.n_subs - 1) * slabs.m * slabs.n
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

    mu1 = _interface_vector(slabs, -pN - dN + uN_b, -p1 - d1 + u1_a)
    mu0 = _interface_vector(slabs, -dNp + uNp_b, -p0 + u0_a)
    return torch.cat([mu1, mu0])


def apply_u_coupling(slabs: SlabSystem3D, u_gamma: torch.Tensor) -> torch.Tensor:
    """``applyU`` on plane traces (``src/subdomains.jl:817-845``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    _, _, uN_t, uNp_t = block_apply(slabs, v0, v1, vN, vNp)
    out = torch.stack([(uN_t - vN)[:-1], uNp_t[:-1]], dim=1)
    return out.reshape((-1,) + tuple(u_gamma.shape[1:]))


def apply_l_coupling(slabs: SlabSystem3D, u_gamma: torch.Tensor) -> torch.Tensor:
    """``applyL`` on plane traces (``src/subdomains.jl:848-876``)."""
    v0, v1, vN, vNp = _devectorize(slabs, u_gamma)
    u0_t, u1_t, _, _ = block_apply(slabs, v0, v1, vN, vNp)
    out = torch.stack([u0_t[1:], (u1_t - v1)[1:]], dim=1)
    return out.reshape((-1,) + tuple(u_gamma.shape[1:]))


def _slab_rhs(slabs: SlabSystem3D, idx: int, v0, v1, vN, vNp) -> torch.Tensor:
    """The (l1_max, mn[, ...]) right-hand side of slab ``idx`` (a Python
    int) in :func:`_block_apply_single`; a source given as ``None`` is zero.
    The sources are set in the order of :func:`_trace_sources`, from the host
    copies of the trace planes and flags; a zero one is written only where an
    earlier source of this slab landed on the same plane."""
    hs = slabs.host
    m, n = slabs.m, slabs.n
    dtype = slabs.cpl_01.dtype
    given = next(v for v in (v0, v1, vN, vNp) if v is not None)
    rhs = torch.zeros((slabs.l1_max, m * n) + tuple(given.shape[1:]), dtype=dtype,
                      device=given.device)
    written = set()
    for plane, has, sten, v, sign in (
        (hs.l1[idx], hs.has_top[idx], slabs.cpl_10, v0, -1),
        (hs.l0[idx], hs.has_top[idx], slabs.cpl_01, v1, 1),
        (hs.lnp[idx], hs.has_bot[idx], slabs.cpl_np_n, vN, 1),
        (hs.ln[idx], hs.has_bot[idx], slabs.cpl_n_np, vNp, -1),
    ):
        if has and v is not None:
            val = _cpl_apply(sten[idx], v.to(dtype), m, n)
            rhs[plane] = val if sign > 0 else -val
            written.add(plane)
        elif plane in written:
            rhs[plane] = 0
    return rhs


def _block_apply_single(slabs: SlabSystem3D, idx: int, v0, v1, vN, vNp,
                        start: int = 0, tail: int = 0):
    """Block apply of slab ``idx`` (a Python int) alone, inside the D-inverse
    recursions; a source given as ``None`` is zero (:func:`_slab_rhs`).
    ``start``/``tail`` as in ``slab_solve_3d``.  Trailing axes of the traces
    (direction batches) ride the multi-RHS solve: one pivot stream for the
    whole batch."""
    hs = slabs.host
    rhs = _slab_rhs(slabs, idx, v0, v1, vN, vNp)
    u = slab_solve_3d(slabs, slabs.slab_facs[idx], rhs, start=start, tail=tail)
    return u[hs.l0[idx]], u[hs.l1[idx]], u[hs.ln[idx]], u[hs.lnp[idx]]


def apply_dinv_down(slabs: SlabSystem3D, u_gamma: torch.Tensor) -> torch.Tensor:
    """Sequential downward D^{-1} recursion on plane traces
    (``applyDinvDown``, ``src/subdomains.jl:725-753``): interface 0 is
    negated; each next interface's value is the trace transmitted through the
    slab in between minus the input.  Slabs 1..S-2, one local solve each:
    top-trace sources only and bottom traces consumed, so in the z layout
    the forward pass starts at ``trace_head`` and the backward pass covers
    the last ``trace_tail`` planes (both exact)."""
    S, mn = slabs.n_subs, slabs.m * slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, mn) + extra)
    z = slabs.pivot_layout == "z"
    outs = [-g[0]]
    for s in range(1, S - 1):
        _, _, tN, tNp = _block_apply_single(
            slabs, s, outs[-1][0], outs[-1][1], None, None,
            start=slabs.trace_head if z else 0, tail=slabs.trace_tail if z else 0,
        )
        outs.append(torch.stack([tN - g[s, 0], tNp - g[s, 1]]))
    return torch.stack(outs).reshape((-1,) + extra)


def apply_dinv_up(slabs: SlabSystem3D, u_gamma: torch.Tensor) -> torch.Tensor:
    """Sequential upward D^{-1} recursion on plane traces (``applyDinvUp``,
    ``src/subdomains.jl:785-814``): interfaces S-3 .. 0 through slabs
    S-2 .. 1; bottom-trace sources only and top traces consumed, so in the z
    layout the forward pass starts at ``l1_max - trace_tail`` (exact) and the
    backward pass is whole."""
    S, mn = slabs.n_subs, slabs.m * slabs.n
    extra = tuple(u_gamma.shape[1:])
    g = u_gamma.reshape((S - 1, 2, mn) + extra)
    start = max(slabs.l1_max - slabs.trace_tail, 0) if slabs.pivot_layout == "z" else 0
    outs = [-g[S - 2]]
    for s in range(S - 2, 0, -1):
        t0, t1, _, _ = _block_apply_single(
            slabs, s, None, None, outs[-1][0], outs[-1][1], start=start,
        )
        outs.append(torch.stack([t0 - g[s - 1, 0], t1 - g[s - 1, 1]]))
    return torch.stack(outs[::-1]).reshape((-1,) + extra)


def permute_to_pairs(slabs: SlabSystem3D, b_pol: torch.Tensor) -> torch.Tensor:
    """The ``generatePermutationMatrix`` shuffle on plane traces
    (``src/subdomains.jl:881-890``): ``[f1; f0]`` into the recursion layout
    (down: (u_n, u_np) pairs, up: (u_0, u_1))."""
    S, mn = slabs.n_subs, slabs.m * slabs.n
    half = 2 * (S - 1) * mn
    extra = tuple(b_pol.shape[1:])
    f1 = b_pol[:half].reshape((S - 1, 2, mn) + extra)
    f0 = b_pol[half:].reshape((S - 1, 2, mn) + extra)
    down = torch.stack([f1[:, 0], f0[:, 0]], dim=1)
    up = torch.stack([f0[:, 1], f1[:, 1]], dim=1)
    flat = (-1,) + extra
    return torch.cat([down.reshape(flat), up.reshape(flat)])


def precond_gauss_seidel(slabs: SlabSystem3D, v: torch.Tensor, n_it: int) -> torch.Tensor:
    """Block Gauss-Seidel on the 3D polarized system (``PrecondGaussSeidel``,
    ``src/integral_preconditioner.jl:57-94``)."""
    half = v.shape[0] // 2
    vdown_rhs, vup_rhs = v[:half], v[half:]
    u_down = apply_dinv_down(slabs, vdown_rhs)
    u_up = apply_dinv_up(slabs, vup_rhs - apply_l_coupling(slabs, u_down))
    for _ in range(n_it - 1):
        u_down = apply_dinv_down(slabs, vdown_rhs - apply_u_coupling(slabs, u_up))
        u_up = apply_dinv_up(slabs, vup_rhs - apply_l_coupling(slabs, u_down))
    return torch.cat([u_down, u_up])


def extract_rhs_traces(slabs: SlabSystem3D, b: torch.Tensor):
    """Local solves of the partitioned source and plane-trace extraction
    (``extractRHS``, ``src/subdomains.jl:309-359``).  Returns (u_0, u_1, u_n,
    u_np), each (S, mn[, r]), zero where absent."""
    u = _solve_batched_3d(slabs, partition_source_3d(slabs, b))
    S = slabs.n_subs
    slab = torch.arange(S, device=u.device)
    flag = (S,) + (1,) * (u.ndim - 2)
    top, bot = slabs.has_top.reshape(flag), slabs.has_bot.reshape(flag)
    zero = u.new_zeros(())
    return (torch.where(top, u[slab, slabs.l0], zero), torch.where(top, u[slab, slabs.l1], zero),
            torch.where(bot, u[slab, slabs.ln], zero), torch.where(bot, u[slab, slabs.lnp], zero))


def reconstruction_fields(slabs: SlabSystem3D, b: torch.Tensor, v0, v1, vn, vnp) -> torch.Tensor:
    """The per-slab (S, l1_max, mn[, r]) solutions of :func:`reconstruction`:
    one local solve per slab with the trace-driven equivalent sources ADDED
    to the partitioned source."""
    rhs = _trace_sources(slabs, partition_source_3d(slabs, b), v0, v1, vn, vnp, add=True)
    return _solve_batched_3d(slabs, rhs)


def reconstruction(slabs: SlabSystem3D, b: torch.Tensor, v0, v1, vn, vnp) -> torch.Tensor:
    """Volume reconstruction from plane traces (``reconstruction``,
    ``src/subdomains.jl:893-943``): :func:`reconstruction_fields` gathered
    to the global vector."""
    return gather_interior_3d(slabs, reconstruction_fields(slabs, b, v0, v1, vn, vnp))


@dataclasses.dataclass(frozen=True)
class PolarizedTracesPreconditioner3D:
    """Full-system 3D preconditioner through the plane-trace inner solve (2D
    counterpart: ``PolarizedTracesPreconditioner``; reference
    ``src/preconditioner.jl:62-75,207-225``, 2D only there): ``As b``, the
    traces of the local solves of the partitioned source, an inner GMRES on
    the polarized system ``MM`` (``rtol=inner_tol``, restart ``min(20, M)``,
    ``maxiter=inner_maxiter``) preconditioned by ``n_it`` sweeps of block
    Gauss-Seidel, then the volume reconstruction."""

    slabs: SlabSystem3D
    a_s: StencilMatrix3D
    n_it: int = 2
    inner_tol: float = 1e-2
    inner_maxiter: int = 40

    def _polarized_rhs(self, asb: torch.Tensor) -> torch.Tensor:
        """``f_pol`` (M[, R]) of ``As b`` (N[, R])."""
        slabs = self.slabs
        u_0, u_1, u_n, u_np = extract_rhs_traces(slabs, asb)
        f1 = _interface_vector(slabs, u_n, u_1)
        f0 = _interface_vector(slabs, u_np, u_0)
        return -torch.cat([f1, f0])

    def _reconstruct(self, asb: torch.Tensor, u_pol: torch.Tensor) -> torch.Tensor:
        slabs = self.slabs
        half = 2 * (slabs.n_subs - 1) * slabs.m * slabs.n
        u = u_pol[:half] + u_pol[half:]
        return reconstruction(slabs, asb, *_devectorize(slabs, u))

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        slabs = self.slabs
        asb = self.a_s.matvec(b)
        f_pol = self._polarized_rhs(asb)
        u_pol, _ = gmres(
            lambda v: apply_mm(slabs, v),
            f_pol,
            preconditioner=lambda v: precond_gauss_seidel(slabs, permute_to_pairs(slabs, v),
                                                          self.n_it),
            rtol=self.inner_tol,
            restart=min(20, f_pol.shape[0]),
            maxiter=self.inner_maxiter,
        )
        return self._reconstruct(asb, u_pol)

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, l*m*n) joint batch apply (``gmres_batched`` convention): the R
        directions ride every plane solve of the trace pipeline as a trailing
        axis (up to eight columns a launch on the card) and the inner trace solve
        runs as one ``gmres_batched``."""
        slabs = self.slabs
        asb = self.a_s.matvec(b_batch.T)                   # (N, R)
        f_pol = self._polarized_rhs(asb)                   # (M, R)
        u_pol, _ = gmres_batched(
            lambda V: apply_mm(slabs, V.T).T,
            f_pol.T,
            preconditioner=lambda V: precond_gauss_seidel(
                slabs, permute_to_pairs(slabs, V.T), self.n_it).T,
            rtol=self.inner_tol,
            restart=min(20, f_pol.shape[0]),
            maxiter=self.inner_maxiter,
        )
        return self._reconstruct(asb, u_pol.T).T

    def __call__(self, b):
        return self.apply(b)
