"""Multi-device 3D polarized-traces preconditioner over a ``torch.distributed``
device mesh.

Counterpart of the JAX package's ``parallel/polarized3d.py``, the distributed
``ddm.polarized3d.PolarizedTracesPreconditioner3D`` over the z-slab mesh of
``parallel/sharded3d.py``: the trace algebra of ``parallel/polarized.py``
(local solves of each rank's slabs, the trace PLANES gathered with one
``all_gather``, the D-inverse recursions solved by each stage's owner and
broadcast, the inner ``gmres_batched`` replicated) on the single-device
module ``ddm.polarized3d``, traces of m n points.  The z layout keeps its
exact head starts and tails; the y layout solves whole slabs.
"""

from __future__ import annotations

from fast_solver_lippmann_schwinger_tpu_torch.ddm import polarized3d
from fast_solver_lippmann_schwinger_tpu_torch.parallel.polarized import (
    ShardedTraces,
    check_trace_geometry,
)
from fast_solver_lippmann_schwinger_tpu_torch.parallel.sharded import shard_slab_system


def make_sharded_polarized_preconditioner_3d(slabs, a_s, mesh, axis: str = "slab",
                                             n_it: int = 2, inner_tol: float = 1e-2,
                                             inner_maxiter: int = 40):
    """Batched ``(R, l*m*n) -> (R, l*m*n)`` 3D polarized-traces
    preconditioner over a z-slab mesh; feed it to ``gmres_batched`` for the
    multi-device 3D trace-path solve.  Needs plain plane pivots (full, bf16,
    int8, yblock*); the plane kernels' stack alone is refused."""
    shard = shard_slab_system(slabs, mesh, axis)
    check_trace_geometry(shard, "planes")
    z = shard.pivot_layout == "z"
    cuts = ((shard.trace_head, shard.trace_tail, max(shard.l1_max - shard.trace_tail, 0))
            if z else (0, 0, 0))
    traces = ShardedTraces(shard, polarized3d, shard.m * shard.n, cuts)

    def apply_(b_batch):
        return traces.apply(a_s, b_batch, n_it, inner_tol, inner_maxiter)

    return apply_
