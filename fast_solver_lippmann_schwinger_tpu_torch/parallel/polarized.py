"""Multi-device polarized-traces preconditioner over a ``torch.distributed``
device mesh.

Counterpart of the JAX package's ``parallel/polarized.py``, the distributed
``ddm.polarized.PolarizedTracesPreconditioner`` (the reference's trace-space
formulation, ``src/integral_preconditioner.jl`` and
``\\(::PolarizedTracesPreconditioner)`` at ``src/preconditioner.jl:207-225``)
over the slab mesh of ``parallel/sharded.py``:

* every slab's factorization lives on its owner rank; the local solves over
  all slabs (the traces of the partitioned source, the 2-RHS MM applies, the
  reconstruction) run on each rank's ``k = S / D`` slabs through the
  single-device module's own functions, and the four interface trace
  families are assembled with one ``all_gather``;
* the block Gauss-Seidel's sequential D-inverse recursions walk every stage
  on every rank; the owner of a stage solves and broadcasts the two carried
  traces;
* the trace vectors (2 (S-1) n per polarized half) are small and stay
  replicated, so the inner ``gmres_batched`` runs identically on every rank,
  its host decisions taken from values equal on every rank.

The R directions ride every local solve as a trailing axis.  The same
algebra serves the 3D planes (``parallel/polarized3d.py``): it is written
against the single-device module (``ddm.polarized`` or ``ddm.polarized3d``)
and the width of a trace (n, or mn).
"""

from __future__ import annotations

import torch

from fast_solver_lippmann_schwinger_tpu_torch.ddm import polarized as polarized2d
from fast_solver_lippmann_schwinger_tpu_torch.parallel.sharded import (
    SlabShard,
    _broadcast,
    _gather_slabs,
    _owned_sum,
    shard_slab_system,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres_batched


def check_trace_geometry(shard: SlabShard, what: str = "lines") -> None:
    """The trace system needs disjoint top and bottom trace lines (planes) in
    every slab with both neighbours: slabs shorter than about 2 npml collide
    them and the block applies would overwrite sources."""
    hs = shard.host
    for s in range(shard.n_subs):
        if hs.has_top[s] and hs.has_bot[s] and not hs.ln[s] > hs.l1[s]:
            raise ValueError(
                f"degenerate slab geometry for polarized traces: top/bottom trace {what} "
                "overlap (slabs shorter than ~2*npml); use fewer slabs or a taller grid")


class ShardedTraces:
    """The trace algebra of one rank: ``ops`` is the single-device module
    (``ddm.polarized`` or ``ddm.polarized3d``), ``width`` the points of a
    trace, ``cuts`` the exact shortcuts of the D-inverse recursions,
    (down start, down tail, up start)."""

    def __init__(self, shard: SlabShard, ops, width: int, cuts: tuple):
        self.shard, self.ops, self.width, self.cuts = shard, ops, width, cuts
        self.mine = slice(shard.base, shard.base + shard.k)

    def block_apply(self, v0, v1, vN, vNp):
        """``applyBlockOperator`` of this rank's slabs driven by the
        replicated (S, W[, ...]) traces; the four trace families gathered
        back to (S, W[, ...]) on every rank."""
        m = self.mine
        traces = self.ops.block_apply(self.shard.local, v0[m], v1[m], vN[m], vNp[m])
        return _gather_slabs(self.shard, torch.stack(traces, dim=1)).unbind(1)

    def apply_mm(self, u_pol):
        """``applyMMOptUmf``: one 2-RHS solve per local slab."""
        ops, sh = self.ops, self.shard
        half = u_pol.shape[0] // 2
        d0, d1, dN, dNp = ops._devectorize(sh, u_pol[:half])
        p0, p1, pN, pNp = ops._devectorize(sh, u_pol[half:])
        v0 = torch.stack([d0, d0 + p0], dim=-1)
        v1 = torch.stack([d1, d1 + p1], dim=-1)
        vN = torch.stack([pN + dN, pN], dim=-1)
        vNp = torch.stack([pNp + dNp, pNp], dim=-1)
        u0_t, u1_t, uN_t, uNp_t = self.block_apply(v0, v1, vN, vNp)
        mu1 = ops._interface_vector(sh, -pN - dN + uN_t[..., 1], -p1 - d1 + u1_t[..., 0])
        mu0 = ops._interface_vector(sh, -dNp + uNp_t[..., 1], -p0 + u0_t[..., 0])
        return torch.cat([mu1, mu0])

    def coupling(self, u_gamma, which: str):
        """``applyU`` (``which="U"``) / ``applyL``."""
        v0, v1, vN, vNp = self.ops._devectorize(self.shard, u_gamma)
        u0_t, u1_t, uN_t, uNp_t = self.block_apply(v0, v1, vN, vNp)
        if which == "U":
            out = torch.stack([(uN_t - vN)[:-1], uNp_t[:-1]], dim=1)
        else:
            out = torch.stack([u0_t[1:], (u1_t - v1)[1:]], dim=1)
        return out.reshape((-1,) + tuple(u_gamma.shape[1:]))

    def dinv(self, u_gamma, down: bool):
        """The sequential D-inverse recursion (``applyDinvDown`` /
        ``applyDinvUp``): the owner of each stage's slab solves, with the
        exact head start and tail of the single-device recursion, and
        broadcasts the two transmitted traces."""
        sh, W = self.shard, self.width
        S = sh.n_subs
        extra = tuple(u_gamma.shape[1:])
        g = u_gamma.reshape((S - 1, 2, W) + extra)
        down_start, down_tail, up_start = self.cuts
        dtype = sh.local.cpl_01.dtype
        outs = [-g[0] if down else -g[S - 2]]
        for s in (range(1, S - 1) if down else range(S - 2, 0, -1)):
            owner, li = divmod(s, sh.k)
            t = None
            if sh.rank == owner:
                if down:
                    _, _, ta, tb = self.ops._block_apply_single(
                        sh.local, li, outs[-1][0], outs[-1][1], None, None,
                        start=down_start, tail=down_tail)
                else:
                    ta, tb, _, _ = self.ops._block_apply_single(
                        sh.local, li, None, None, outs[-1][0], outs[-1][1], start=up_start)
                t = torch.stack([ta, tb])
            t = _broadcast(sh, owner, t, (2, W) + extra, dtype)
            outs.append(t - g[s if down else s - 1])
        if not down:
            outs = outs[::-1]
        return torch.stack(outs).reshape((-1,) + extra)

    def precond_gs(self, v, n_it: int):
        """Block Gauss-Seidel on the polarized system (``PrecondGaussSeidel``)."""
        half = v.shape[0] // 2
        vdown_rhs, vup_rhs = v[:half], v[half:]
        u_down = self.dinv(vdown_rhs, down=True)
        u_up = self.dinv(vup_rhs - self.coupling(u_down, "L"), down=False)
        for _ in range(n_it - 1):
            u_down = self.dinv(vdown_rhs - self.coupling(u_up, "U"), down=True)
            u_up = self.dinv(vup_rhs - self.coupling(u_down, "L"), down=False)
        return torch.cat([u_down, u_up])

    def apply(self, a_s, b_batch, n_it, inner_tol, inner_maxiter):
        """(R, N) -> (R, N): ``As b``, the traces of this rank's local solves
        of the partitioned source (gathered), the replicated inner
        ``gmres_batched`` on ``MM``, the reconstruction of this rank's slabs
        and one ``all_reduce``."""
        ops, sh = self.ops, self.shard
        asb = a_s.matvec(b_batch.T)                                  # (N, R)
        traces = ops.extract_rhs_traces(sh.local, asb)               # 4 x (k, W, R)
        u0, u1, un, unp = _gather_slabs(sh, torch.stack(traces, dim=1)).unbind(1)
        f_pol = -torch.cat([ops._interface_vector(sh, un, u1),
                            ops._interface_vector(sh, unp, u0)])     # (M, R)
        u_pol, _ = gmres_batched(
            lambda V: self.apply_mm(V.T).T,
            f_pol.T,
            preconditioner=lambda V: self.precond_gs(ops.permute_to_pairs(sh, V.T), n_it).T,
            rtol=inner_tol,
            restart=min(20, f_pol.shape[0]),
            maxiter=inner_maxiter,
        )
        u_pol = u_pol.T
        half = u_pol.shape[0] // 2
        v = ops._devectorize(sh, u_pol[:half] + u_pol[half:])
        u = ops.reconstruction_fields(sh.local, asb, *(x[self.mine] for x in v))
        return _owned_sum(sh, u).T


def make_sharded_polarized_preconditioner(slabs, a_s, mesh, axis: str = "slab", n_it: int = 2,
                                          inner_tol: float = 1e-2, inner_maxiter: int = 40):
    """Batched ``(R, m*n) -> (R, m*n)`` polarized-traces preconditioner over
    a slab mesh; feed it to ``gmres_batched`` for the multi-device trace-path
    solve (the 2D counterpart of the sweep path's
    ``make_sharded_double_sweep_pipelined``).

    Needs plain slab pivots (full, bf16, banded); a system whose only pivots
    are a kernel layout is refused, as is a slab geometry whose top and
    bottom trace lines collide.
    """
    shard = shard_slab_system(slabs, mesh, axis)
    check_trace_geometry(shard, "lines")
    traces = ShardedTraces(shard, polarized2d, shard.n,
                           (shard.trace_head, shard.trace_tail,
                            max(shard.m1_max - shard.trace_tail, 0)))

    def apply_(b_batch):
        return traces.apply(a_s, b_batch, n_it, inner_tol, inner_maxiter)

    return apply_
