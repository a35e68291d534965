"""Whole Gauss-Seidel sweep directions in one launch each: CUDA kernels + plain twins.

Counterpart of the JAX package's ``sparse/pallas_sweep.py``.  The per-slab
sweep (``ddm/sweeps.py``) launches two kernels per slab and direction and
runs the trace algebra between slabs as small PyTorch calls; on the card the
host then needs as long to enqueue a 16-slab sweep as the device to run it.
Here ONE kernel walks a whole sweep direction: ``csrc/sweep_fused.cu``,
``sweep::down_kernel<R>`` (slab by slab, the forward pass with the
equivalent-source injections at the top trace lines, then the backward pass
over the last ``trace_tail`` lines that yields the bottom traces) and
``sweep::up_kernel<R>`` (slabs in reverse, the forward pass resumed from the
down kernel's carry with the bottom injections, then the full backward pass
that writes the volume and yields the top traces, with the reflection
correction).  Two launches per sweep, nothing between slabs.  The line step
is the flag-handoff step of the substitution kernels
(``csrc/thomas_flow.cuh``, ``run_flow``): at r = 1, 2 each step hands its t
to the next through flagged words of the stream's exchange buffer
(:class:`~fast_solver_lippmann_schwinger_tpu_torch.sparse.thomas_kernels.Exchange`),
one slot and one flag per step, and the traces travel as the words of the
backward step that produced them; at r = 4, 8, 16 (the wide step) each step
hands the next line's w over as rows on a ring of four slots, and the traces
are rows that the tiles' publishers store and read back.  The
kernels read the trace metadata and coupling rows of
``ddm.subdomain.SlabSystem.sweep_tables``; ``ddm.sweeps.gs_sweep`` drives them.

Pivots are in the banded+tail layout
(:class:`~fast_solver_lippmann_schwinger_tpu_torch.sparse.thomas_kernels.BandedTailFactorization`),
so this is also the sweep with the fewest pivot bytes.  Semantics are those of
``ddm.sweeps.gs_sweep`` (``precondGSOptimized``,
``src/preconditioner.jl:557-630``).

Each wrapper launches its kernel for CUDA tensors, or raises; it takes the
plain PyTorch version (:func:`sweep_down_plain`, :func:`sweep_up_plain`, a
Python loop over (slab, line phase)) only for tensors that lie on the CPU.
A launch takes r = 1, 2, 4, 8 or 16 right-hand sides (r = 3 padded to four,
5-7 to eight, 9-15 to sixteen), each head window and tail plane read once for
all of them; a batch that one launch does not take runs in launches of
``thomas_kernels.line_width(fac, r, inject=True)`` columns, sixteen at most
(``thomas_kernels.in_rhs_groups``).
"""

from __future__ import annotations

import torch

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from fast_solver_lippmann_schwinger_tpu_torch.sparse.thomas_kernels import (
    BandedTailFactorization,
    _band_apply_rows,
    line_pivot_plain,
)

_P, _I, _U = cuda_build.PTR, cuda_build.INT, cuda_build.UINT
# direction flag, 16 pointers (the wide step's rows last), 8 ints, the
# exchange buffer, its first flag and the stream
cuda_build.register("sweep_fused", "sweep_fused",
                    [_I] + [_P] * 16 + [_I] * 8 + [_P, _U, _P])

# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tests; yardstick on the card)
# ---------------------------------------------------------------------------


def _band(band: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One (2, 3, ld) band times one (2r, ld) row block."""
    return _band_apply_rows(band[None], v[None])[0]


def _meta_lists(meta: torch.Tensor):
    return [list(map(int, row)) for row in meta.tolist()]


def sweep_down_plain(fac: BandedTailFactorization, meta: torch.Tensor, b4: torch.Tensor,
                     c01: torch.Tensor, c10: torch.Tensor, tt: int):
    """Plain version of :func:`sweep_down`: the down kernel's line steps as a
    Python loop over (slab, line phase).  Returns ``(y4, t4, unp)``."""
    l0, l1, ln, lnp, top, bot = _meta_lists(meta)
    S, m = b4.shape[:2]
    y4, t4 = torch.zeros_like(b4), torch.zeros_like(b4)
    unp = torch.zeros_like(b4[:, 0])
    un = torch.zeros_like(b4[0, 0])
    for s in range(S):
        sl = fac.slab_ids[s : s + 1].long()
        t = torch.zeros_like(b4[0, 0])
        for j in range(m):                       # forward, top injections
            row = b4[s, j]
            if top[s] and j == l0[s]:
                row = row + _band(c01[s], unp[s - 1])
            elif top[s] and j == l1[s]:
                row = row - _band(c10[s], un)
            y = row - _band(fac.lband[s, j], t)
            t = line_pivot_plain(fac, sl, j, y[None])[0]
            y4[s, j], t4[s, j] = y, t
        x = torch.zeros_like(t)
        for j in range(m - 1, m - 1 - tt, -1):   # backward over the last tt lines
            x = line_pivot_plain(fac, sl, j, (y4[s, j] - _band(fac.uband[s, j], x))[None])[0]
            if bot[s] and j == ln[s]:
                un = x
            elif bot[s] and j == lnp[s]:
                unp[s] = x
    return y4, t4, unp


def sweep_up_plain(fac: BandedTailFactorization, meta: torch.Tensor, b4: torch.Tensor,
                   cnpn: torch.Tensor, cnnp: torch.Tensor, y4: torch.Tensor,
                   t4: torch.Tensor, unp: torch.Tensor, tt: int) -> torch.Tensor:
    """Plain version of :func:`sweep_up`: the up kernel's line steps as a
    Python loop over (slab, line phase).  Returns the volume rows ``u4``."""
    l0, l1, ln, lnp, top, bot = _meta_lists(meta)
    S, m = b4.shape[:2]
    j0 = m - tt
    u4 = torch.empty_like(b4)
    u0 = u1 = torch.zeros_like(b4[0, 0])
    for s in reversed(range(S)):
        sl = fac.slab_ids[s : s + 1].long()
        t = t4[s, j0 - 1]
        ytail = []
        for j in range(j0, m):                   # forward resumed, bottom injections
            row = b4[s, j]
            if bot[s] and j == lnp[s]:
                row = row + _band(cnpn[s], u0)
            elif bot[s] and j == ln[s]:
                row = row - _band(cnnp[s], u1)
            y = row - _band(fac.lband[s, j], t)
            ytail.append(y)
            t = line_pivot_plain(fac, sl, j, y[None])[0]
        x = torch.zeros_like(t)
        for j in range(m - 1, -1, -1):           # full backward: volume, top traces
            y = ytail[j - j0] if j >= j0 else y4[s, j]
            x = line_pivot_plain(fac, sl, j, (y - _band(fac.uband[s, j], x))[None])[0]
            u4[s, j] = x
            if top[s] and j == l0[s]:
                u0 = x
            elif top[s] and j == l1[s]:
                u1 = x - unp[s - 1]             # reflection correction
    return u4


def sweep_fused_plain(fac: BandedTailFactorization, meta: torch.Tensor, b4: torch.Tensor,
                      tables, tt: int) -> torch.Tensor:
    """Plain version of a whole fused sweep (down, then up) with the coupling
    rows of ``tables`` (``SlabSystem.sweep_tables``): ``u4``."""
    y4, t4, unp = sweep_down_plain(fac, meta, b4, tables.c01, tables.c10, tt)
    return sweep_up_plain(fac, meta, b4, tables.cnpn, tables.cnnp, y4, t4, unp, tt)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(fac, meta, b4, tt: int, cpls, *rows) -> int:
    """Validate what the sweep kernels take; returns r."""
    if not isinstance(fac, BandedTailFactorization):
        raise ValueError("the fused sweep runs on the banded+tail pivot layout")
    if b4.dtype != torch.float32 or b4.ndim != 4 or not b4.is_contiguous():
        raise ValueError("rows must be a contiguous (S, m, 2r, ld) float32 tensor")
    S, m, r2, ld = b4.shape
    if (S, m, ld) != (fac.n_slabs, fac.m, fac.ld) or r2 % 2:
        raise ValueError(f"rows {tuple(b4.shape)} do not match the factorization "
                         f"(S={fac.n_slabs}, m={fac.m}, ld={fac.ld})")
    if not 0 < tt < m:
        raise ValueError(f"trace_tail={tt} outside (0, {m})")
    if meta.dtype != torch.int32 or tuple(meta.shape) != (6, S):
        raise ValueError("meta must be a (6, S) int32 tensor")
    if any(c.dtype != torch.float32 or tuple(c.shape) != (S, 2, 3, ld) for c in cpls):
        raise ValueError(f"coupling rows must be ({S}, 2, 3, {ld}) float32 tensors")
    for t in (meta, fac.lband, fac.uband) + fac.planes + tuple(cpls) + rows:
        if t.device != b4.device or not t.is_contiguous():
            raise ValueError("factorization, tables and rows must be contiguous "
                             "tensors on one device")
    return r2 // 2


def steps(fac, tt: int) -> int:
    """Line steps of one sweep direction: (m + tt) per slab."""
    return fac.n_slabs * (fac.m + tt)


def private_floats(fac, tt: int, r: int) -> int:
    """Floats of the kernels' scratch: each CTA's private y lines, ``tt``
    lines of its slice's rows (the CTAs of a tile hold at most ld + 8 rows;
    ``csrc/sweep_fused.cu``, ``SweepArgs.scratch``)."""
    return fac.ld // tk.LEAD_MULTIPLE * tt * 2 * r * (fac.ld + 8)


def exchange_slots(fac, tt: int, r: int) -> int:
    """Exchange slots of one sweep launch at ``r`` right-hand sides: one per
    line step at r = 1, 2 (the traces are words of the backward steps); the
    ring of ``thomas_kernels.EXCHANGE_LINES`` at r >= 4 (the wide step, whose
    every step waits on the one before and whose traces are rows)."""
    return steps(fac, tt) if r <= 2 else tk.EXCHANGE_LINES


def _launch(up: int, fac, meta, b4, cpl_a, cpl_b, y4, t4, unp, u4, tt: int, r: int):
    """One launch; the down kernel at r >= 4 stores its bottom traces u_n
    into a scratch row stack passed as ``u4``."""
    fn = cuda_build.load("sweep_fused")
    scratch = b4.new_empty(private_floats(fac, tt, r))
    if u4 is None and r > 2:
        u4 = torch.empty_like(unp)
    slots = exchange_slots(fac, tt, r)
    ex = tk.exchange_for(b4)
    xchg, epoch = ex.take(1, r, fac.ld, steps(fac, tt), slots=slots)
    err = fn(
        up, b4.data_ptr(), fac.lband.data_ptr(), fac.uband.data_ptr(),
        fac.head_re.data_ptr(), fac.head_im.data_ptr(), fac.tail_re.data_ptr(),
        fac.tail_im.data_ptr(), meta.data_ptr(), cpl_a.data_ptr(), cpl_b.data_ptr(),
        y4.data_ptr(), t4.data_ptr(), unp.data_ptr(), tk._ptr(u4), scratch.data_ptr(),
        tk._ptr(ex.wide_rows(1, r, fac.ld, slots=slots)),
        fac.n_slabs, fac.m, fac.n, fac.ld, r, fac.tail_start, fac.half, tt,
        xchg.data_ptr(), epoch, torch.cuda.current_stream(b4.device).cuda_stream,
    )
    tk._raise_on(err, "sweep_fused (" + ("up" if up else "down") + ")", fac)


def sweep_down(fac: BandedTailFactorization, meta: torch.Tensor, b4: torch.Tensor,
               c01: torch.Tensor, c10: torch.Tensor, tt: int):
    """The DOWN sweep of ``gs_sweep`` in one launch (the JAX package's
    ``_down_kernel``): ``b4`` (S, m, 2r, ld) f32 rows of every slab's source,
    ``meta`` and the coupling rows of ``SlabSystem.sweep_tables``, ``tt`` the
    trace tail.  Returns ``(y4, t4, unp)``: the forward passes' y and t stacks
    and the bottom traces u_np (S, 2r, ld), zero for the last slab."""
    r = _check(fac, meta, b4, tt, (c01, c10))
    if not b4.is_cuda:
        return sweep_down_plain(fac, meta, b4, c01, c10, tt)
    width = tk.line_width(fac, r, inject=True)
    if width != r:
        return tk.in_rhs_groups(lambda b: sweep_down(fac, meta, b, c01, c10, tt), r, (b4,),
                                width=width)
    y4, t4 = torch.empty_like(b4), torch.empty_like(b4)
    unp = torch.zeros_like(b4[:, 0])
    _launch(0, fac, meta, b4, c01, c10, y4, t4, unp, None, tt, r)
    sweep_down.launches += 1
    return y4, t4, unp


def sweep_up(fac: BandedTailFactorization, meta: torch.Tensor, b4: torch.Tensor,
             cnpn: torch.Tensor, cnnp: torch.Tensor, y4: torch.Tensor, t4: torch.Tensor,
             unp: torch.Tensor, tt: int) -> torch.Tensor:
    """The UP sweep of ``gs_sweep`` in one launch (the JAX package's
    ``_up_kernel``), on what :func:`sweep_down` returned for the same ``b4``:
    returns the volume rows ``u4`` (S, m, 2r, ld)."""
    r = _check(fac, meta, b4, tt, (cnpn, cnnp), y4, t4, unp)
    if y4.shape != b4.shape or t4.shape != b4.shape or unp.shape != b4[:, 0].shape:
        raise ValueError("y4, t4 and unp must be sweep_down's outputs for these rows")
    if not b4.is_cuda:
        return sweep_up_plain(fac, meta, b4, cnpn, cnnp, y4, t4, unp, tt)
    width = tk.line_width(fac, r, inject=True)
    if width != r:
        return tk.in_rhs_groups(
            lambda b, y, t, u: sweep_up(fac, meta, b, cnpn, cnnp, y, t, u, tt),
            r, (b4, y4, t4, unp), width=width)
    u4 = torch.empty_like(b4)
    _launch(1, fac, meta, b4, cnpn, cnnp, y4, t4, unp, u4, tt, r)
    sweep_up.launches += 1
    return u4


# launch counts: one per wrapper call that launched its kernel
sweep_down.launches = 0
sweep_up.launches = 0

