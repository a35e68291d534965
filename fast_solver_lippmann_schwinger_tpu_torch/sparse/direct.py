"""Block-Thomas direct solver for stencil matrices (full precision).

Replaces the reference's native factorization backends (UMFPACK ``lu`` at
``src/preconditioner.jl:35`` / ``src/subdomains.jl:114`` and MKL PARDISO at
``src/preconditioner.jl:38-55`` / ``src/subdomains.jl:117-136``) with a
structure-exploiting block-Thomas factorization: under lexicographic order a
3x3-stencil matrix on an (m, n) grid is block tridiagonal with tridiagonal
n x n blocks.  Counterpart of the JAX package's ``sparse/direct.py`` for the
dense full-precision factorization.

The factorization is a Python loop over grid lines whose per-step work is one
dense n x n inversion (``torch.linalg.inv``; a library call in the JAX
package too) and runs once at setup.  The substitution loops here are the
full-precision oracle and the ``pivot_dtype="full"`` path of the sweeps (with
the tail, support, cached and resumed solves that the multi-slab sweeps need);
the hot path runs the bf16 kernels of ``sparse/thomas_kernels.py``.  Every function takes optional leading batch
axes on the factorization (all slabs of a sweep are factored at once).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import (
    StencilMatrix2D,
)


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorization:
    """Per-line inverted pivot blocks + off-diagonal bands.

    ``cinv[j]`` is the inverse of the j-th Schur-complement pivot block;
    ``lband``/``uband`` are the tridiagonal couplings to lines j-1 / j+1,
    stored as (m, n, 3) bands.  A slab-batched factorization carries one
    leading axis on every field.
    """

    cinv: torch.Tensor    # (m, n, n)
    lband: torch.Tensor   # (m, n, 3)
    uband: torch.Tensor   # (m, n, 3)

    def slab(self, i: int) -> "BlockTridiagFactorization":
        """Slab ``i`` of a batched factorization."""
        return BlockTridiagFactorization(
            cinv=self.cinv[i], lband=self.lband[i], uband=self.uband[i]
        )


def band_matvec(band: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Tridiagonal band times vector/matrix: out[i] = sum_d band[i,d] v[i+d-1].

    ``band`` (n, 3); ``v`` (n, ...): extra trailing dims are RHS columns.
    """
    n = v.shape[0]
    vp = F.pad(v, (0, 0) * (v.ndim - 1) + (1, 1))
    # windows[i, ..., d] = v[i + d - 1]: one product and one sum over the
    # three taps (four device calls in all; the sweeps call this per trace)
    windows = vp.unfold(0, 3, 1)
    return (band.reshape((n,) + (1,) * (v.ndim - 1) + (3,)) * windows).sum(-1)


def _band_mul_right(mat: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """(M @ U) for tridiagonal U given by ``band``: result[:, c] =
    sum_d M[:, c-d+1] band[c-d+1, d].  Leading batch axes allowed."""
    out = torch.zeros_like(mat)
    for d in range(3):
        scaled = mat * band[..., None, :, d]
        if d == 0:      # column c takes scaled column c + 1
            scaled = F.pad(scaled[..., 1:], (0, 1))
        elif d == 2:    # column c takes scaled column c - 1
            scaled = F.pad(scaled[..., :-1], (1, 0))
        out = out + scaled
    return out


def _band_to_dense(band: torch.Tensor) -> torch.Tensor:
    """(..., n, 3) band -> dense (..., n, n) tridiagonal matrix."""
    return (
        torch.diag_embed(band[..., :, 1])
        + torch.diag_embed(band[..., 1:, 0], offset=-1)
        + torch.diag_embed(band[..., :-1, 2], offset=1)
    )


def _band_mul_left(band: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(L @ M) for tridiagonal L given by ``band`` (..., n, 3) and a dense
    (..., n, n) matrix: :func:`band_matvec` with leading batch axes."""
    n = mat.shape[-2]
    mp = F.pad(mat, (0, 0, 1, 1))
    out = torch.zeros_like(mat)
    for d in range(3):
        out = out + band[..., :, d, None] * mp[..., d : d + n, :]
    return out


def factor_stencil_values(vals: torch.Tensor) -> BlockTridiagFactorization:
    """Block-Thomas factorization of stencil fields ``(..., m, n, 3, 3)``;
    leading axes batch independent systems (the slabs of a sweep)."""
    dband = vals[..., 1, :]   # (..., m, n, 3) in-line couplings
    lband = vals[..., 0, :]
    uband = vals[..., 2, :]
    m, n = vals.shape[-4], vals.shape[-3]
    batch = vals.shape[:-4]

    cinv = torch.empty(batch + (m, n, n), dtype=vals.dtype, device=vals.device)
    cinv_prev = torch.zeros(batch + (n, n), dtype=vals.dtype, device=vals.device)
    uband_prev = torch.zeros_like(uband[..., 0, :, :])
    for j in range(m):
        lcinv = _band_mul_left(lband[..., j, :, :], cinv_prev)
        c = _band_to_dense(dband[..., j, :, :]) - _band_mul_right(lcinv, uband_prev)
        cinv_prev = torch.linalg.inv(c)
        cinv[..., j, :, :] = cinv_prev
        uband_prev = uband[..., j, :, :]
    return BlockTridiagFactorization(
        cinv=cinv, lband=lband.contiguous(), uband=uband.contiguous()
    )


def factor_stencil_2d(s: StencilMatrix2D) -> BlockTridiagFactorization:
    """Block-Thomas factorization of a 2D stencil matrix.

    Schur recursion ``C_j = D_j - L_j C_{j-1}^{-1} U_{j-1}`` over grid lines,
    storing explicit pivot inverses so that the solve is matmul-only.
    """
    return factor_stencil_values(s.values)


def _as_line_stack(fac, b):
    """Reshape ``b``, flat (m*n,), gridded (m, n), or multi-RHS
    (m, n, r) / (m*n, r), to a (m, n, ...) line stack."""
    m, n = fac.lband.shape[0], fac.lband.shape[1]
    if b.ndim == 1:
        return b.reshape(m, n)
    if b.ndim == 2 and tuple(b.shape) == (m, n):
        return b
    if b.ndim == 2:             # (m*n, r)
        return b.reshape(m, n, b.shape[1])
    return b


def _fwd_scan(fac, bg, start: int = 0, t_start=None, collect_t: bool = False):
    """Forward substitution ``y_j = b_j - L_j t_{j-1}``, ``t_j = C_j^{-1} y_j``
    over lines ``start..m-1`` from the carry ``t_start`` (zero when ``None``);
    returns ``(y stack, t stack or None)`` over those lines."""
    m = fac.lband.shape[0]
    dtype = fac.lband.dtype
    t_prev = (torch.zeros(bg.shape[1:], dtype=dtype, device=bg.device)
              if t_start is None else t_start.to(dtype))
    ys, ts = [], []
    for j in range(start, m):
        y_j = bg[j].to(dtype) - band_matvec(fac.lband[j], t_prev)
        t_prev = fac.cinv[j] @ y_j
        ys.append(y_j)
        if collect_t:
            ts.append(t_prev)
    return torch.stack(ys, dim=0), (torch.stack(ts, dim=0) if collect_t else None)


def _bwd_scan(fac, y, tail: int = 0):
    """Backward substitution ``x_j = C_j^{-1}(y_j - U_j x_{j+1})``.

    With ``tail > 0`` only the last ``tail`` lines are materialized (the
    recursion starts at the true last line, so they are EXACT; lines above
    are returned as zeros).
    """
    m = fac.lband.shape[0]
    dtype = fac.lband.dtype
    full = tail <= 0 or tail >= m
    start = 0 if full else m - tail
    x_next = torch.zeros(y.shape[1:], dtype=dtype, device=y.device)
    out = torch.zeros((m,) + tuple(y.shape[1:]), dtype=dtype, device=y.device)
    for j in range(m - 1, start - 1, -1):
        x_next = fac.cinv[j] @ (y[j] - band_matvec(fac.uband[j], x_next))
        out[j] = x_next
    return out


def block_thomas_solve(fac: BlockTridiagFactorization, b: torch.Tensor,
                       start: int = 0, tail: int = 0) -> torch.Tensor:
    """Solve ``S x = b`` given the (unbatched) factorization.

    ``b`` may be flat (m*n,), gridded (m, n), or multi-RHS (m, n, r) /
    (m*n, r); the result matches the input shape.

    ``start`` asserts that the rhs is zero on lines ``< start``: the forward
    substitution then has ``y_j = t_j = 0`` there and begins at ``start`` with
    a zero carry (exact).  ``tail > 0`` materializes x only on the last
    ``tail`` lines (zeros above).  The shared body of
    :func:`block_thomas_solve_tail` and :func:`block_thomas_solve_support`.
    """
    m = fac.lband.shape[0]
    bg = _as_line_stack(fac, b)
    if start <= 0 or start >= m:
        y, _ = _fwd_scan(fac, bg)
    else:
        y_new, _ = _fwd_scan(fac, bg, start=start)
        head = y_new.new_zeros((start,) + tuple(y_new.shape[1:]))
        y = torch.cat([head, y_new], dim=0)
    return _bwd_scan(fac, y, tail).reshape(b.shape)


def block_thomas_solve_tail(fac: BlockTridiagFactorization, b: torch.Tensor,
                            tail: int) -> torch.Tensor:
    """Solve ``S x = b`` materializing x only on the LAST ``tail`` lines.

    Used by the downward sweeps, which consume only the bottom-interface
    traces of each local solve: the backward pass shrinks from m to about
    2*npml steps (the forward pass still runs over all lines).
    """
    return block_thomas_solve(fac, b, tail=tail)


def block_thomas_solve_support(fac: BlockTridiagFactorization, b: torch.Tensor,
                               start: int = 0, tail: int = 0) -> torch.Tensor:
    """Solve ``S x = b`` for a rhs KNOWN to be zero on lines ``< start``
    (exact head start); ``tail`` truncates the backward pass as in
    :func:`block_thomas_solve_tail`."""
    return block_thomas_solve(fac, b, start=start, tail=tail)


def block_thomas_solve_cached(fac: BlockTridiagFactorization, b: torch.Tensor,
                              tail: int = 0):
    """Tail-truncated solve that also returns the forward-pass stacks
    ``(y, t)``, so that a later solve whose rhs differs only on the last lines
    can resume the forward substitution (:func:`block_thomas_solve_resume`)."""
    bg = _as_line_stack(fac, b)
    y, t = _fwd_scan(fac, bg, collect_t=True)
    return _bwd_scan(fac, y, tail).reshape(b.shape), y, t


def block_thomas_solve_resume(fac: BlockTridiagFactorization, b: torch.Tensor,
                              y_cached: torch.Tensor, t_cached: torch.Tensor,
                              resume: int) -> torch.Tensor:
    """Solve ``S x = b`` where ``b`` differs from a previously cached solve's
    rhs only on the last ``resume`` lines.

    The forward substitution restarts at line ``m - resume`` from the cached
    carry, skipping about ``m - resume`` pivot applications; the result is
    bit-identical to a full solve.  This is the up-sweep fast path: the upward
    Gauss-Seidel rhs is the downward rhs plus interface traces injected at the
    two bottom trace lines.
    """
    m = fac.lband.shape[0]
    if resume <= 0 or resume >= m:
        return block_thomas_solve(fac, b)
    bg = _as_line_stack(fac, b)
    j0 = m - resume
    y_new, _ = _fwd_scan(fac, bg, start=j0, t_start=t_cached[j0 - 1])
    y = torch.cat([y_cached[:j0].to(y_new.dtype), y_new], dim=0)
    return _bwd_scan(fac, y).reshape(b.shape)
