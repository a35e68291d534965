"""Multi-device slab-parallel sweeps over a ``torch.distributed`` device mesh.

Counterpart of the JAX package's ``parallel/sharded.py``, which runs the
slab sweeps as SPMD code inside ``jax.shard_map`` over a 1-D mesh axis
``"slab"``.  Here every device is one process of a 1-D
``torch.distributed.device_mesh.DeviceMesh`` (``init_device_mesh(device_type,
(D,), mesh_dim_names=("slab",))``), and each process calls the same function
with the same replicated right-hand side:

* every slab's factorization lives on its owner process
  (:func:`shard_slab_system` keeps this rank's ``k = S / D`` slabs);
* the down/up Gauss-Seidel recursions of :func:`sharded_gs_sweep` walk every
  stage on every rank; the owner of a stage alone does its local solve, and
  the two interface trace vectors are broadcast from it where the next stage
  belongs to another rank (the JAX package's ``psum``-broadcast of a masked
  value, without the masked solves);
* :func:`sharded_gs_sweep_pipelined` is the wavefront: in round ``t`` rank
  ``d`` sweeps its k slabs for right-hand-side block ``t - d`` and hands the
  outgoing traces to rank ``d + 1`` (``ppermute`` there,
  ``dist.batch_isend_irecv`` here; the first rank going down and the last
  going up receive nothing, the zeros of ``ppermute``);
* each rank contributes its slabs' interior lines and one ``all_reduce``
  (the JAX ``psum``) makes the result replicated.  Exactly one rank
  contributes each entry, so every rank holds the same bits.

Every host decision (which stage a rank solves, which block a round takes)
comes from values that are equal on every rank, so the ranks issue the same
collectives in the same order.  The local solves are the plain block-Thomas
passes of ``sparse/direct.py`` (the counterparts of the XLA block-Thomas the
JAX sweep calls): no hand-written kernel runs here, and a slab system whose
only pivots are a kernel layout is refused.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized import pallas_only
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import (
    SlabTraceLines,
    partition_source,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.sweeps import (
    _add_bottom_traces,
    _add_top_traces,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    block_thomas_solve_cached,
    block_thomas_solve_resume,
)

# fields of a slab system that are replicated: the global reconstruction
# maps; every other tensor has the slab axis first
_REPLICATED = ("owner", "owner_line", "owner_plane")


def slab_sharding_specs(slabs, axis: str = "slab") -> dict:
    """Which fields of a 2D or 3D slab system are slab-leading: field name ->
    ``axis`` (split over the mesh axis) or ``None`` (replicated, or not a
    tensor); ``"fac"`` maps to the same account of the factorization's
    fields.  The kernel layout ``pfac`` is not sharded (``None``): the
    sharded sweeps run the plain solves on ``fac``."""
    specs = {}
    for f in dataclasses.fields(slabs):
        value = getattr(slabs, f.name)
        if f.name == "fac":
            specs["fac"] = {g.name: axis if isinstance(getattr(value, g.name), torch.Tensor)
                            else None for g in dataclasses.fields(value)}
        elif f.name == "pfac" or f.name in _REPLICATED:
            specs[f.name] = None
        else:
            specs[f.name] = axis if isinstance(value, torch.Tensor) else None
    return specs


def _kernel_mode(slabs) -> str:
    """The ``pivot_dtype`` of a system whose only pivots are a kernel layout."""
    p = slabs.pfac
    if isinstance(p, thomas_kernels.BandedTailFactorization):
        return "pallas_banded_tail"
    if isinstance(p, thomas_kernels.ThomasFactorization):
        return "pallas_int8" if p.storage == "int8" else "pallas"
    layout = "yblock_" if getattr(slabs, "pivot_layout", "z") == "y" else ""
    return f"{layout}{p.storage}_pallas"


def shard_device(mesh, axis: str = "slab") -> torch.device:
    """This rank's device: the CPU on a CPU mesh; on a CUDA mesh the card of
    the local rank (``LOCAL_RANK``, as ``torchrun`` sets it, else the mesh
    coordinate), which must exist."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", mesh.get_local_rank(axis)))
    return resolve_device(f"{mesh.device_type}:{local}")


@dataclasses.dataclass(frozen=True)
class SlabShard:
    """This rank's part of a slab system placed on a mesh: ``local`` is the
    system cut to the rank's ``k`` slabs (``n_subs = k``, no kernel layout),
    ``host`` the trace lines and flags of all ``n_subs`` slabs, and
    ``own_slab`` / ``own_line`` / ``own_mask`` the local slab and line (or
    plane) of every global line the rank reconstructs."""

    local: object
    n_subs: int
    rank: int
    n_ranks: int
    axis: str
    group: object
    host: SlabTraceLines
    own_slab: torch.Tensor
    own_line: torch.Tensor
    own_mask: torch.Tensor

    @property
    def k(self) -> int:
        return self.local.n_subs

    @property
    def base(self) -> int:
        """Global index of this rank's first slab."""
        return self.rank * self.k

    # the geometry of the whole system, as the trace algebra reads it
    n = property(lambda self: self.local.n)
    m = property(lambda self: self.local.m)
    l = property(lambda self: self.local.l)  # noqa: E741
    m1_max = property(lambda self: self.local.m1_max)
    l1_max = property(lambda self: self.local.l1_max)
    trace_head = property(lambda self: self.local.trace_head)
    trace_tail = property(lambda self: self.local.trace_tail)
    pivot_layout = property(lambda self: self.local.pivot_layout)


def shard_slab_system(slabs, mesh, axis: str = "slab") -> SlabShard:
    """Place a 2D or 3D slab system on the mesh: this rank keeps its ``k =
    S / D`` slabs of every slab-leading field (:func:`slab_sharding_specs`)
    on its device, the replicated maps whole.  A system already sharded on
    this mesh is returned as it is.  Every rank must pass the same system.

    A system whose only pivots are a kernel layout (``pivot_dtype="pallas*"``,
    ``"*_pallas"``) is refused with ``ValueError``: its ``fac`` holds an
    empty placeholder, and the sharded solves run on ``fac``.  (The JAX
    package's sweeps accept such a system and fail inside the local solve.)"""
    group = mesh.get_group(axis)
    D, me = dist.get_world_size(group), mesh.get_local_rank(axis)
    if isinstance(slabs, SlabShard):
        if (slabs.n_ranks, slabs.rank) != (D, me):
            raise ValueError(f"slab shard of rank {slabs.rank} of {slabs.n_ranks} used on "
                             f"rank {me} of {D}")
        return slabs
    if pallas_only(slabs):
        raise ValueError(
            f"the sharded solves need plain pivots (full, bf16, banded, yblock*); this slab "
            f"system keeps only the kernel layout of pivot_dtype={_kernel_mode(slabs)!r}")
    S = slabs.n_subs
    if S % D:
        raise ValueError(f"{S} slabs must divide over {D} devices")
    k = S // D
    device = shard_device(mesh, axis)
    specs = slab_sharding_specs(slabs, axis)

    def cut(value, spec):
        if not isinstance(value, torch.Tensor):
            return value
        return (value[me * k:(me + 1) * k] if spec else value).to(device)

    fac = dataclasses.replace(slabs.fac, **{
        name: cut(getattr(slabs.fac, name), spec) for name, spec in specs["fac"].items()})
    local = dataclasses.replace(slabs, fac=fac, pfac=None, n_subs=k, **{
        name: cut(getattr(slabs, name), spec) for name, spec in specs.items()
        if isinstance(getattr(slabs, name), torch.Tensor)})
    owner = slabs.owner.to(device)
    line = (slabs.owner_plane if hasattr(slabs, "owner_plane") else slabs.owner_line).to(device)
    local_slab = owner - me * k
    shard = SlabShard(
        local=local, n_subs=S, rank=me, n_ranks=D, axis=axis, group=group, host=slabs.host,
        own_slab=local_slab.clamp(0, k - 1), own_line=line,
        own_mask=(local_slab >= 0) & (local_slab < k),
    )
    # every rank must hold the same slab count: one small collective, which
    # is also the group's first (before any point-to-point exchange)
    count = torch.tensor([float(S)], device=device)
    _all_reduce(shard, count)
    if int(count.item()) != S * D:
        raise ValueError(f"the ranks hold slab systems of different sizes (rank {me}: {S})")
    return shard


def _local_slab(shard: SlabShard, li: int):
    """The factorization of this rank's local slab ``li`` (2D: a slice of the
    batched factorization; 3D: its entry of ``slab_facs``)."""
    local = shard.local
    return local.slab_facs[li] if hasattr(local, "slab_facs") else local.fac.slab(li)


# ---------------------------------------------------------------------------
# collectives (complex tensors travel as their real views)
# ---------------------------------------------------------------------------

def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _peer(shard: SlabShard, rank: int) -> int:
    return dist.get_global_rank(shard.group, rank)


def _all_reduce(shard: SlabShard, t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the mesh axis of a contiguous tensor."""
    dist.all_reduce(_real(t), group=shard.group)
    return t


def _broadcast(shard: SlabShard, owner: int, t, shape, dtype) -> torch.Tensor:
    """``t`` from rank ``owner`` (``None`` elsewhere) on every rank."""
    if shard.n_ranks == 1:
        return t
    buf = t.contiguous() if shard.rank == owner else torch.empty(
        shape, dtype=dtype, device=shard.own_line.device)
    dist.broadcast(_real(buf), src=_peer(shard, owner), group=shard.group)
    return buf


def all_gather_rows(group, t: torch.Tensor) -> torch.Tensor:
    """Each rank's (rows, ...) block -> the (D * rows, ...) whole in rank
    order, on every rank."""
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],) + tuple(t.shape[1:]))
    with warnings.catch_warnings():
        # PyTorch 2.13 renames it all_gather_single and warns; 2.11 has no new name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(_real(out), _real(t), group=group)
    return out


def _gather_slabs(shard: SlabShard, t: torch.Tensor) -> torch.Tensor:
    """(k, ...) of every rank -> (S, ...) in slab order, on every rank."""
    return all_gather_rows(shard.group, t)


def _shift(shard: SlabShard, send, to: int | None, recv_from: int | None, shape, dtype):
    """One ``ppermute`` step: send ``send`` to rank ``to`` and receive a
    ``shape`` tensor from rank ``recv_from`` (``None``: no such transfer).
    Returns the received tensor or ``None``."""
    ops, buf = [], None
    if to is not None:
        ops.append(dist.P2POp(dist.isend, _real(send.contiguous()), _peer(shard, to),
                              shard.group))
    if recv_from is not None:
        buf = torch.empty(shape, dtype=dtype, device=shard.own_line.device)
        ops.append(dist.P2POp(dist.irecv, _real(buf), _peer(shard, recv_from), shard.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return buf


def _owned_sum(shard: SlabShard, fields: torch.Tensor) -> torch.Tensor:
    """Per-slab (k, L1, W[, r]) fields -> the replicated global (L*W[, r])
    vector: each rank places its slabs' interior lines (planes), zeros
    elsewhere, and one ``all_reduce`` sums them."""
    extra = tuple(fields.shape[3:])
    vals = fields[shard.own_slab, shard.own_line]              # (L, W) + extra
    mask = shard.own_mask.reshape((-1,) + (1,) * (vals.ndim - 1))
    vals = torch.where(mask, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return _all_reduce(shard, vals.contiguous()).reshape((-1,) + extra)


# ---------------------------------------------------------------------------
# the sweeps, for 2D lines and (parallel/sharded3d.py) 3D planes
# ---------------------------------------------------------------------------

class SweepOps(NamedTuple):
    """What a sweep does on one local slab ``li`` of ``local``."""

    partition: Callable    # (local, b) -> (k, L1, W[, r]) partitioned source
    add_top: Callable      # (local, li, rhs, u_n, u_np): sources of the slab above, in place
    add_bottom: Callable   # (local, li, rhs, u_0, u_1): sources of the slab below, in place
    solve_cached: Callable  # (shard, li, rhs) -> (solution, cache for solve_resume)
    solve_resume: Callable  # (shard, li, rhs, cache) -> solution


def _solve_cached_2d(shard, li, rhs):
    v, y, t = block_thomas_solve_cached(_local_slab(shard, li), rhs, shard.trace_tail)
    return v, (y, t)


def _solve_resume_2d(shard, li, rhs, cache):
    return block_thomas_solve_resume(_local_slab(shard, li), rhs, *cache, shard.trace_tail)


SWEEP_OPS_2D = SweepOps(partition_source, _add_top_traces, _add_bottom_traces,
                        _solve_cached_2d, _solve_resume_2d)


def masked_sweep(shard: SlabShard, ops: SweepOps, b: torch.Tensor) -> torch.Tensor:
    """The Gauss-Seidel down/up sweep (``ddm.sweeps.gs_sweep``) with every
    stage walked on every rank and solved by its owner."""
    local, hs, k, me = shard.local, shard.host, shard.k, shard.rank
    rhs = ops.partition(local, b)                     # (k, L1, W[, r])
    trace = ((2,) + tuple(rhs.shape[2:]), rhs.dtype)
    caches = [None] * k
    u_np_down = [None] * shard.n_subs
    carry = None                                      # stacked (u_n, u_np)
    for s in range(shard.n_subs):
        owner, li = divmod(s, k)
        if me == owner:
            if hs.has_top[s]:
                ops.add_top(local, li, rhs[li], carry[0], carry[1])
            v, caches[li] = ops.solve_cached(shard, li, rhs[li])
            if hs.has_bot[s]:
                carry = torch.stack([v[hs.ln[s]], v[hs.lnp[s]]])
        if hs.has_bot[s] and (s + 1) // k != owner:
            carry = _broadcast(shard, owner, carry, *trace)
        u_np_down[s] = None if carry is None else carry[1]

    u = torch.zeros_like(rhs)
    carry = None                                      # stacked (u_0, u_1)
    for s in reversed(range(shard.n_subs)):
        owner, li = divmod(s, k)
        if me == owner:
            if hs.has_bot[s]:
                ops.add_bottom(local, li, rhs[li], carry[0], carry[1])
            u[li] = ops.solve_resume(shard, li, rhs[li], caches[li])
            if hs.has_top[s]:
                # reflection correction with the slab above's down-sweep u_np
                carry = torch.stack([u[li, hs.l0[s]], u[li, hs.l1[s]] - u_np_down[s - 1]])
        if hs.has_top[s] and (s - 1) // k != owner:
            carry = _broadcast(shard, owner, carry, *trace)
    return _owned_sum(shard, u)


def pipelined_sweep(shard: SlabShard, ops: SweepOps, b_batch: torch.Tensor,
                    rhs_block: int) -> torch.Tensor:
    """The wavefront-pipelined sweep of an (R, N) batch in blocks of
    ``rhs_block`` columns (the last block padded with zero columns): 2 (D +
    RB - 1) rounds, the traces handed between neighbouring ranks."""
    local, hs, k, me, D = shard.local, shard.host, shard.k, shard.rank, shard.n_ranks
    R = b_batch.shape[0]
    B = max(1, min(rhs_block, R))
    RB = -(-R // B)
    if RB * B != R:
        pad = b_batch.new_zeros((RB * B - R, b_batch.shape[1]))
        b_batch = torch.cat([b_batch, pad])
    blocks = b_batch.reshape(RB, B, -1)
    rhs = [ops.partition(local, blocks[q].T) for q in range(RB)]   # each (k, L1, W, B)
    trace = ((2,) + tuple(rhs[0].shape[2:]), rhs[0].dtype)
    caches = [[None] * k for _ in range(RB)]
    u_np_own = [[None] * k for _ in range(RB)]

    def valid(r):
        return 0 <= r < RB

    # ---- down wavefront: rank d takes block t - d in round t ----
    recv = None
    for t in range(D + RB - 1):
        r = t - me
        carry = None
        if valid(r):
            carry = recv
            for li in range(k):
                s = me * k + li
                if hs.has_top[s]:
                    ops.add_top(local, li, rhs[r][li], carry[0], carry[1])
                v, caches[r][li] = ops.solve_cached(shard, li, rhs[r][li])
                if hs.has_bot[s]:
                    carry = torch.stack([v[hs.ln[s]], v[hs.lnp[s]]])
                    u_np_own[r][li] = carry[1]
        recv = _shift(shard, carry, me + 1 if valid(r) and me < D - 1 else None,
                      me - 1 if me > 0 and valid(t + 1 - me) else None, *trace)

    # ---- up wavefront: rank d takes block t - (D - 1 - d) in round t ----
    out = [torch.zeros_like(x) for x in rhs]
    recv = None
    for t in range(D + RB - 1):
        r = t - (D - 1 - me)
        carry = None
        if valid(r):
            carry = recv
            for li in reversed(range(k)):
                s = me * k + li
                if hs.has_bot[s]:
                    # the incoming raw u_1 corrected with this slab's own
                    # down-sweep u_np (src/preconditioner.jl:622)
                    ops.add_bottom(local, li, rhs[r][li], carry[0], carry[1] - u_np_own[r][li])
                out[r][li] = ops.solve_resume(shard, li, rhs[r][li], caches[r][li])
                if hs.has_top[s]:
                    carry = torch.stack([out[r][li, hs.l0[s]], out[r][li, hs.l1[s]]])
        recv = _shift(shard, carry, me - 1 if valid(r) and me > 0 else None,
                      me + 1 if me < D - 1 and valid(t + 1 - (D - 1 - me)) else None, *trace)

    total = _owned_sum(shard, torch.cat(out, dim=-1))     # (N, RB * B)
    return total.T[:R]


def sharded_gs_sweep(slabs, b: torch.Tensor, mesh, axis: str = "slab") -> torch.Tensor:
    """Distributed Gauss-Seidel sweep, numerically identical to
    ``ddm.sweeps.gs_sweep``.  ``slabs`` is a slab system or its
    :func:`shard_slab_system`; every rank passes the same replicated ``b``
    ((m*n,) or (m*n, r)) and gets the same result."""
    return masked_sweep(shard_slab_system(slabs, mesh, axis), SWEEP_OPS_2D, b)


def sharded_gs_sweep_pipelined(slabs, b_batch: torch.Tensor, mesh, axis: str = "slab",
                               rhs_block: int = 1) -> torch.Tensor:
    """Wavefront-pipelined multi-RHS sweep over a general slab layout: k
    slabs per rank (S = k D), any batch size R (R < D too).

    In round t, rank d sweeps its k local slabs in order for right-hand-side
    block ``t - d`` and hands the outgoing interface traces to rank d + 1.
    With ``rhs_block = B`` the R right-hand sides run as RB = ceil(R/B)
    blocks of B columns (the last padded with zeros), each local solve
    contracting its pivots against the whole block: a sweep is 2 (D + RB - 1)
    rounds of B-wide solves.  Pipeline fill is RB / (D + RB - 1).

    ``b_batch`` is (R, m*n), replicated; returns the (R, m*n) sweeps, equal
    to ``gs_sweep`` of each row.
    """
    return pipelined_sweep(shard_slab_system(slabs, mesh, axis), SWEEP_OPS_2D, b_batch,
                           rhs_block)


def _transpose_flat(msp, v: torch.Tensor) -> torch.Tensor:
    """Grid transpose of flat (m*n,) fields or an (R, m*n) batch of them."""
    if v.ndim == 1:
        return v.reshape(msp.m, msp.n).T.reshape(-1)
    return v.reshape(-1, msp.m, msp.n).transpose(1, 2).reshape(v.shape[0], -1)


def make_sharded_double_sweep(slabs, slabs_t, msp, a_s, mesh, axis="slab"):
    """Sharded alternating bi-directional preconditioner (the masked sweeps):
    ``b -> u - T' GS_x(T (Msp u - As b))`` with ``u = GS_y(As b)``, as
    ``ddm.sweeps.DoubleSweepPreconditioner.apply``."""
    shard = shard_slab_system(slabs, mesh, axis)
    shard_t = shard_slab_system(slabs_t, mesh, axis)

    def apply_(b):
        asb = a_s.matvec(b)
        u = masked_sweep(shard, SWEEP_OPS_2D, asb)
        err = msp.matvec(u) - asb
        return u - _transpose_flat(msp, masked_sweep(shard_t, SWEEP_OPS_2D,
                                                     _transpose_flat(msp, err)))

    return apply_


def make_sharded_double_sweep_pipelined(slabs, slabs_t, msp, a_s, mesh,
                                        axis="slab", rhs_block: int = 1):
    """Batched alternating bi-directional preconditioner on the pipelined
    wavefront sweeps: an (R, m*n) batch through ``u - T' GS_x(T (Msp u - As
    b))`` with both sweeps filled by the batch (``doublePreconditioner``,
    ``src/preconditioner.jl:121-130,228-249``, distributed), ``rhs_block``
    columns a round.  Feed it to ``gmres_batched`` for a multi-direction
    solve: the multi-device production path."""
    shard = shard_slab_system(slabs, mesh, axis)
    shard_t = shard_slab_system(slabs_t, mesh, axis)

    def apply_(b_batch):
        asb = a_s.matvec(b_batch.T).T        # stencil matvec on trailing RHS columns
        u = pipelined_sweep(shard, SWEEP_OPS_2D, asb, rhs_block)
        err = msp.matvec(u.T).T - asb
        u2 = pipelined_sweep(shard_t, SWEEP_OPS_2D, _transpose_flat(msp, err), rhs_block)
        return u - _transpose_flat(msp, u2)

    return apply_
