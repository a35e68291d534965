"""Multi-device z-slab-parallel 3D sweeps over a ``torch.distributed`` mesh.

Counterpart of the JAX package's ``parallel/sharded3d.py``: the sweeps of
``parallel/sharded.py`` with lines replaced by planes.  Each z-slab's
factorization lives on its owner rank, the two interface trace PLANES ((m, n)
each) move by broadcast between stages (masked sweep) or to the
neighbouring rank (wavefront), and the interiors are summed with one
``all_reduce``.  The local solves go through the port's plain plane passes
(``ddm.subdomain3d.slab_solve_3d`` and, in the z layout, the cached and
resumed passes of ``sparse/direct.py``), so both the z-plane and the
y-blocked pivot layouts shard; a system whose only pivots are the plane
kernels' stack is refused.
"""

from __future__ import annotations

from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized3d import _cpl_multi
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain3d import (
    partition_source_3d,
    slab_solve_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.parallel.sharded import (
    SweepOps,
    _local_slab,
    masked_sweep,
    pipelined_sweep,
    shard_slab_system,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    block_thomas_solve_cached_3d,
    block_thomas_solve_resume_3d,
)


def _add_top_traces_3d(local, li, rhs, u_n, u_np):
    hs = local.host
    rhs[hs.l0[li]] += _cpl_multi(local.cpl_01[li], u_np, local.m, local.n)
    rhs[hs.l1[li]] -= _cpl_multi(local.cpl_10[li], u_n, local.m, local.n)


def _add_bottom_traces_3d(local, li, rhs, u_0, u_1):
    hs = local.host
    rhs[hs.lnp[li]] += _cpl_multi(local.cpl_np_n[li], u_0, local.m, local.n)
    rhs[hs.ln[li]] -= _cpl_multi(local.cpl_n_np[li], u_1, local.m, local.n)


def _solve_cached_3d(shard, li, rhs):
    """z layout: the down solve keeps its forward stacks and truncates its
    backward pass to ``trace_tail`` planes; y layout: a whole solve."""
    if shard.pivot_layout == "y":
        return slab_solve_3d(shard.local, _local_slab(shard, li), rhs), None
    v, y, t = block_thomas_solve_cached_3d(_local_slab(shard, li), rhs, shard.trace_tail)
    return v, (y, t)


def _solve_resume_3d(shard, li, rhs, cache):
    if cache is None:
        return slab_solve_3d(shard.local, _local_slab(shard, li), rhs)
    return block_thomas_solve_resume_3d(_local_slab(shard, li), rhs, *cache, shard.trace_tail)


SWEEP_OPS_3D = SweepOps(partition_source_3d, _add_top_traces_3d, _add_bottom_traces_3d,
                        _solve_cached_3d, _solve_resume_3d)


def sharded_gs_sweep_3d(slabs, b, mesh, axis: str = "slab"):
    """Distributed 3D Gauss-Seidel sweep, numerically identical to
    ``ddm.subdomain3d.gs_sweep_3d``, on either pivot layout.  ``b`` is the
    replicated (l*m*n,) or (l*m*n, r) source."""
    return masked_sweep(shard_slab_system(slabs, mesh, axis), SWEEP_OPS_3D, b)


def sharded_gs_sweep_3d_pipelined(slabs, b_batch, mesh, axis: str = "slab",
                                  rhs_block: int = 1):
    """Wavefront-pipelined multi-source 3D sweep (the 3D counterpart of
    ``parallel.sharded.sharded_gs_sweep_pipelined``): k z-slabs per rank, R
    sources as ceil(R/B) blocks of ``rhs_block`` columns, 2 (D + RB - 1)
    rounds with the two interface trace planes handed to the neighbouring
    rank.  Needs the z-plane pivot layout (cached and resumed passes), as in
    the JAX package; ``b_batch`` (R, l*m*n) -> (R, l*m*n)."""
    shard = shard_slab_system(slabs, mesh, axis)
    if shard.pivot_layout == "y":
        raise ValueError("pipelined 3D sweep needs the z-plane pivot layout; use "
                         "sharded_gs_sweep_3d for the y-blocked layout")
    return pipelined_sweep(shard, SWEEP_OPS_3D, b_batch, rhs_block)


def make_sharded_sweep_preconditioner_3d(slabs, a_s, mesh, axis="slab"):
    """``b -> GS_sweep_3d(As b)`` distributed: the 3D single-sweep
    preconditioner over a z-slab mesh."""
    shard = shard_slab_system(slabs, mesh, axis)

    def apply_(b):
        return masked_sweep(shard, SWEEP_OPS_3D, a_s.matvec(b))

    return apply_


def make_sharded_sweep_preconditioner_3d_pipelined(slabs, a_s, mesh, axis="slab",
                                                   rhs_block: int = 1):
    """Batched ``(R, N) -> (R, N)`` 3D sweep preconditioner on the pipelined
    wavefront; feed it to ``gmres_batched`` for a multi-source solve."""
    shard = shard_slab_system(slabs, mesh, axis)
    if shard.pivot_layout == "y":
        raise ValueError("pipelined 3D sweep needs the z-plane pivot layout")

    def apply_(b_batch):
        return pipelined_sweep(shard, SWEEP_OPS_3D, a_s.matvec(b_batch.T).T, rhs_block)

    return apply_
