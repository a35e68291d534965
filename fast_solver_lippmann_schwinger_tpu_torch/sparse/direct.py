"""Block-Thomas direct solver for stencil matrices.

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
full-precision oracle and the plain path of the sweeps (with the tail,
support, cached and resumed solves that the multi-slab sweeps need) on every
pivot storage the JAX package has beside its kernels: dense pivots in the
working dtype, bf16 planes, the central band of each pivot inverse, band plus
a low-rank term, and the tail-dense hybrid (``pivot_dtype`` ``"full"``,
``"bf16"``, ``"banded"``, ``"banded_lr"``, ``"banded_tail"``); the kernel
modes run the CUDA kernels of ``sparse/thomas_kernels.py``.  Every 2D
factorization and compression takes optional leading batch axes (all slabs
of a sweep are factored at once).

The 3D part blocks over z-planes: one dense (mn, mn) pivot inverse per plane
(``factor_stencil_3d``) and 9-tap in-plane couplings between planes.  Its
scans run on dense, bf16 or int8 pivots here, or, for a plane view of
``sparse/plane_kernels.py``, through the plane kernels.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import INT8_BLOCK
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


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorizationBF16:
    """Memory-compressed variant: pivot inverses stored as bfloat16 real and
    imaginary planes (half the memory of complex64), for preconditioner
    applies, which tolerate the ~3-digit pivots.  Counterpart of the JAX
    package's ``BlockTridiagFactorizationBF16`` (``pivot_dtype="bf16"``, no
    kernel: the pivot apply is two f32 matrix products per line)."""

    cinv_re: torch.Tensor  # (m, n, n) bfloat16
    cinv_im: torch.Tensor  # (m, n, n) bfloat16
    lband: torch.Tensor    # (m, n, 3) complex
    uband: torch.Tensor    # (m, n, 3) complex

    def slab(self, i: int) -> "BlockTridiagFactorizationBF16":
        """Slab ``i`` of a batched factorization."""
        return BlockTridiagFactorizationBF16(
            cinv_re=self.cinv_re[i], cinv_im=self.cinv_im[i],
            lband=self.lband[i], uband=self.uband[i],
        )


def _to_bf16(part: torch.Tensor) -> torch.Tensor:
    """A real or imaginary part rounded to bf16 through f32, as the JAX
    package's pivot planes are (bit for bit on the factorizations the tests
    carry across)."""
    return part.float().to(torch.bfloat16)


def compress_factorization(fac: BlockTridiagFactorization) -> BlockTridiagFactorizationBF16:
    """Full-precision pivots -> bf16 planes, rounded complex -> f32 -> bf16
    as the JAX package's ``compress_factorization``; the bands stay."""
    return BlockTridiagFactorizationBF16(
        cinv_re=_to_bf16(fac.cinv.real), cinv_im=_to_bf16(fac.cinv.imag),
        lband=fac.lband, uband=fac.uband,
    )


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorizationBanded:
    """Band-compressed pivot inverses (``pivot_dtype="banded"``): only the
    ``w`` central diagonals of each ``C_j^{-1}`` are kept, ``band[j, i, d] =
    Cinv_j[i, i + d - w//2]`` (zero where that column is off the line), as
    bf16 real and imaginary planes.  The pivot inverses are discrete line
    Green's functions whose entries decay away from the diagonal under the
    slabs' absorbing layers, so the band perturbs only the preconditioner.
    Counterpart of the JAX package's class of the same name; no kernel: the
    apply is one windowed product per line (:func:`_banded_pivot_apply`)."""

    band_re: torch.Tensor  # (m, n, w) bfloat16
    band_im: torch.Tensor  # (m, n, w) bfloat16
    lband: torch.Tensor    # (m, n, 3) complex
    uband: torch.Tensor    # (m, n, 3) complex

    def slab(self, i: int) -> "BlockTridiagFactorizationBanded":
        """Slab ``i`` of a batched factorization."""
        return BlockTridiagFactorizationBanded(
            band_re=self.band_re[i], band_im=self.band_im[i],
            lband=self.lband[i], uband=self.uband[i],
        )


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorizationBandedLR:
    """Band + low-rank pivot inverses (``pivot_dtype="banded_lr"``):
    ``Cinv_j ~ band_w(Cinv_j) + U_j V_j^H`` with rank-r bf16 factors, the
    rank term catching the smooth off-band part that a band alone drops.
    Counterpart of the JAX package's class of the same name."""

    band_re: torch.Tensor  # (m, n, w) bfloat16
    band_im: torch.Tensor
    u_re: torch.Tensor     # (m, n, r) bfloat16
    u_im: torch.Tensor
    v_re: torch.Tensor     # (m, n, r) bfloat16
    v_im: torch.Tensor
    lband: torch.Tensor    # (m, n, 3) complex
    uband: torch.Tensor    # (m, n, 3) complex

    def slab(self, i: int) -> "BlockTridiagFactorizationBandedLR":
        """Slab ``i`` of a batched factorization."""
        return BlockTridiagFactorizationBandedLR(
            **{f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)}
        )


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorizationBandedTail:
    """Tail-dense hybrid pivots (``pivot_dtype="banded_tail"``): lines
    ``< tail_start`` keep the ``w`` central diagonals, lines ``>= tail_start``
    the full bf16 plane.  The near-interface lines' pivot inverses are
    effectively dense interface Green's functions: banding them lets the
    substitution recursions amplify the error, so only the interior lines are
    banded.  Counterpart of the JAX package's class of the same name, in
    its layout (the kernels' banded+tail layout is
    ``thomas_kernels.BandedTailFactorization``)."""

    band_re: torch.Tensor  # (m, n, w) bfloat16 (lines >= tail_start unused)
    band_im: torch.Tensor
    tail_re: torch.Tensor  # (m - tail_start, n, n) bfloat16
    tail_im: torch.Tensor
    lband: torch.Tensor    # (m, n, 3) complex
    uband: torch.Tensor    # (m, n, 3) complex
    tail_start: int

    def slab(self, i: int) -> "BlockTridiagFactorizationBandedTail":
        """Slab ``i`` of a batched factorization."""
        return BlockTridiagFactorizationBandedTail(
            band_re=self.band_re[i], band_im=self.band_im[i],
            tail_re=self.tail_re[i], tail_im=self.tail_im[i],
            lband=self.lband[i], uband=self.uband[i], tail_start=self.tail_start,
        )


def _clamp_width(width: int | None, n: int) -> int:
    """The kept band width: the w(n) rule for ``None``, made odd and at most
    ``2 n - 1``."""
    if width is None:
        width = default_band_width(n)
    return min(int(width) | 1, 2 * n - 1)


def _central_band(cinv: torch.Tensor, width: int) -> torch.Tensor:
    """(..., n, n) pivot inverses -> (..., n, w) central diagonals,
    ``band[..., i, d] = cinv[..., i, i + d - w//2]``, zero off the line."""
    n = cinv.shape[-1]
    i = torch.arange(n, device=cinv.device)[:, None]
    d = torch.arange(width, device=cinv.device)[None, :]
    col = i + d - width // 2
    valid = (col >= 0) & (col < n)
    index = col.clamp(0, n - 1).expand(tuple(cinv.shape[:-1]) + (width,))
    return torch.where(valid, torch.gather(cinv, -1, index), torch.zeros((), dtype=cinv.dtype,
                                                                          device=cinv.device))


def compress_factorization_banded(
    fac: BlockTridiagFactorization, width: int | None = None
) -> BlockTridiagFactorizationBanded:
    """Extract the central ``width`` diagonals of each pivot inverse
    (``width=None`` applies the measured :func:`default_band_width` rule);
    leading slab axes are kept."""
    band = _central_band(fac.cinv, _clamp_width(width, fac.cinv.shape[-1]))
    return BlockTridiagFactorizationBanded(
        band_re=_to_bf16(band.real), band_im=_to_bf16(band.imag),
        lband=fac.lband, uband=fac.uband,
    )


def _golden_probe(n: int, rank: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The deterministic (n, rank) probe of the range finder, in float32
    arithmetic as the JAX package builds it: unit phases on a golden-ratio
    grid, ``exp(2 pi i frac((p + 1) (q + 1) phi)) / sqrt(rank)``."""
    p = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    q = torch.arange(rank, dtype=torch.float32, device=device)[None, :]
    phase = 2.0 * math.pi * torch.remainder((p + 1.0) * (q + 1.0) * 0.6180339887498949, 1.0)
    scale = torch.sqrt(torch.tensor(float(rank), dtype=torch.float32, device=device))
    return (torch.complex(torch.cos(phase), torch.sin(phase)) / scale).to(dtype)


def compress_factorization_banded_lr(
    fac: BlockTridiagFactorization, width: int, rank: int, oversample: int = 8,
) -> BlockTridiagFactorizationBandedLR:
    """Band + rank-``rank`` split of each pivot inverse.

    The off-band residual ``R = Cinv - band`` of every line is compressed by
    a QR range finder: ``Q = qr(R Omega)`` with the golden-ratio probe
    (:func:`_golden_probe`), ``U = Q``, ``V = R^H Q``, so ``R ~ U V^H``.  The
    QR fixes each column of Q only up to a phase, which cancels in ``U V^H``.
    ``oversample`` is accepted for the JAX signature and unused there too.
    """
    del oversample
    banded = compress_factorization_banded(fac, width)
    n = fac.cinv.shape[-1]
    half = _clamp_width(width, n) // 2
    idx = torch.arange(n, device=fac.cinv.device)
    off_band = (idx[:, None] - idx[None, :]).abs() > half
    R = torch.where(off_band, fac.cinv, torch.zeros((), dtype=fac.cinv.dtype,
                                                     device=fac.cinv.device))
    omega = _golden_probe(n, min(rank, n), fac.cinv.dtype, fac.cinv.device)
    Q, _ = torch.linalg.qr(R @ omega)                       # (..., n, r)
    V = R.mH @ Q                                            # (..., n, r)
    return BlockTridiagFactorizationBandedLR(
        band_re=banded.band_re, band_im=banded.band_im,
        u_re=_to_bf16(Q.real), u_im=_to_bf16(Q.imag),
        v_re=_to_bf16(V.real), v_im=_to_bf16(V.imag),
        lband=fac.lband, uband=fac.uband,
    )


def compress_factorization_banded_tail(
    fac: BlockTridiagFactorization, width: int | None, tail_lines: int
) -> BlockTridiagFactorizationBandedTail:
    """Band the head lines, keep full bf16 planes for the last
    ``tail_lines`` lines (``width=None``: :func:`default_band_width`).
    ``tail_lines`` is clamped to ``1 .. m - 1`` so that the banded head is
    never empty (an all-dense request is :func:`compress_factorization`)."""
    m = fac.cinv.shape[-3]
    ts = m - int(min(max(tail_lines, 1), m - 1))
    banded = compress_factorization_banded(fac, width)
    tail = fac.cinv[..., ts:, :, :]
    return BlockTridiagFactorizationBandedTail(
        band_re=banded.band_re, band_im=banded.band_im,
        tail_re=_to_bf16(tail.real), tail_im=_to_bf16(tail.imag),
        lband=fac.lband, uband=fac.uband, tail_start=ts,
    )


def _bf16_plane_apply(cinv_re: torch.Tensor, cinv_im: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """``C^{-1} y`` with one bf16 pivot plane pair: one f32 product per plane
    against the stacked [re, im] columns of y, which streams each plane
    once."""
    n = y.shape[0]
    ys = torch.stack([y.real.float(), y.imag.float()], dim=-1)   # (n, ..., 2)
    flat = ys.reshape(n, -1)
    zre = (cinv_re.float() @ flat).reshape(ys.shape)
    zim = (cinv_im.float() @ flat).reshape(ys.shape)
    return torch.complex(zre[..., 0] - zim[..., 1], zre[..., 1] + zim[..., 0]).to(y.dtype)


def _banded_pivot_apply(band_re: torch.Tensor, band_im: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """``C^{-1} y`` with a band-compressed pivot, (n, w) bf16 planes, in
    complex64 (float32 arithmetic, as the JAX package): one window view of
    the padded columns of y and one product with the band over the w
    diagonals (the JAX package's w shifted multiply-adds, which would be w
    launches a line here)."""
    n, w = band_re.shape
    cols = y.to(torch.complex64).reshape(n, -1)                  # (n, K)
    # windows[i, c, d] = cols[i + d - w//2, c] (zero off the line)
    windows = F.pad(cols, (0, 0, w // 2, w // 2)).unfold(0, w, 1)
    band = torch.complex(band_re.float(), band_im.float())
    return torch.einsum("nd,ncd->nc", band, windows).reshape(y.shape).to(y.dtype)


def _lowrank_pivot_correction(u_re, u_im, v_re, v_im, y: torch.Tensor) -> torch.Tensor:
    """``U (V^H y)``, the rank-r correction on top of the banded apply, in
    complex64 as the JAX package computes it."""
    u = torch.complex(u_re.float(), u_im.float())
    v = torch.complex(v_re.float(), v_im.float())
    n = y.shape[0]
    yc = y.to(u.dtype).reshape(n, -1)
    return (u @ (v.mH @ yc)).reshape(y.shape).to(y.dtype)


def _pivot_apply(fac, j: int, y: torch.Tensor) -> torch.Tensor:
    """``C_j^{-1} y`` for every pivot storage: dense complex, bf16 planes,
    band (+ low rank), or the tail-dense hybrid, whose line ``j`` is banded
    below ``tail_start`` and a dense bf16 plane from there on (the JAX
    package runs the two segments as two chained scans; a Python loop over
    the lines picks the storage line by line, so the carries cross the
    boundary as they are)."""
    if hasattr(fac, "tail_start"):
        ts = fac.tail_start
        if j >= ts:
            return _bf16_plane_apply(fac.tail_re[j - ts], fac.tail_im[j - ts], y)
        return _banded_pivot_apply(fac.band_re[j], fac.band_im[j], y)
    if hasattr(fac, "band_re"):
        out = _banded_pivot_apply(fac.band_re[j], fac.band_im[j], y)
        if hasattr(fac, "u_re"):
            out = out + _lowrank_pivot_correction(fac.u_re[j], fac.u_im[j], fac.v_re[j],
                                                  fac.v_im[j], y)
        return out
    if hasattr(fac, "cinv_re"):
        return _bf16_plane_apply(fac.cinv_re[j], fac.cinv_im[j], y)
    return fac.cinv[j] @ y


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


def default_band_width(n: int) -> int:
    """Measured w(n) rule for banded pivot storage (the JAX package's
    ``direct.default_band_width``): the band a line's pivot inverse keeps must
    widen with the line length (w = 101 holds iteration parity at n = 201,
    w = 201 is needed at n = 801, RESULTS.md round 4), so w ~ n/4, odd, at
    least 33.  ``width=None`` of every banded pivot mode routes here: the
    kernels' banded+tail layout (``pivot_dtype="pallas_banded_tail"``) and
    the plain ``"banded"``, ``"banded_tail"`` and ``"banded_lr"`` modes."""
    return min(max(n // 4, 33) | 1, 2 * n - 1)


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
        t_prev = _pivot_apply(fac, j, y_j)
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
        x_next = _pivot_apply(fac, j, y[j] - band_matvec(fac.uband[j], x_next))
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


# Batched variants (leading slab axis), the JAX package's ``jax.vmap``s of the
# two functions above: the factorization is one call over the batch (its
# pivot inversions are batched), the solve a loop over the slabs.
def factor_stencil_2d_batched(v: torch.Tensor) -> BlockTridiagFactorization:
    """Factor a batch of stencil fields ``v`` (B, m, n, 3, 3); every field of
    the result carries the leading batch axis."""
    return factor_stencil_values(v)


def block_thomas_solve_batched(fac: BlockTridiagFactorization, b: torch.Tensor) -> torch.Tensor:
    """:func:`block_thomas_solve` of each slab of a batched factorization on
    the matching row of ``b`` (B, ...); returns (B, ...)."""
    return torch.stack([block_thomas_solve(fac.slab(i), b[i]) for i in range(b.shape[0])])


# -----------------------------------------------------------------------------
# 3D: planes as blocks
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorization3D:
    """z-plane block factorization of a 3D stencil matrix.

    Pivot blocks are dense (mn, mn) inverses; inter-plane couplings stay in
    9-point stencil form ((l, m, n, 3, 3) fields).
    """

    cinv: torch.Tensor     # (l, mn, mn)
    lsten: torch.Tensor    # (l, m, n, 3, 3) couplings to plane k-1
    usten: torch.Tensor    # (l, m, n, 3, 3) couplings to plane k+1


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorization3DBF16:
    """bf16-compressed plane pivots: half the memory of complex64 (the dense
    plane inverses are the 3D memory wall: a 48^3 stack is 2.04 GB in
    complex64).  Preconditioner-only use: the outer Krylov solve absorbs the
    ~3-digit pivots."""

    cinv_re: torch.Tensor  # (l, mn, mn) bfloat16
    cinv_im: torch.Tensor  # (l, mn, mn) bfloat16
    lsten: torch.Tensor    # (l, m, n, 3, 3)
    usten: torch.Tensor    # (l, m, n, 3, 3)


@dataclasses.dataclass(frozen=True)
class BlockTridiagFactorization3DInt8:
    """int8 plane pivots with one f32 scale per (128-input block, output):
    half the memory of bf16 (what fits the 96^3 y-blocked factorization of
    the JAX package on its 16 GB chip).  Preconditioner-only use, as bf16.

    The planes are stored TRANSPOSED, ``q_*[k, i, o] ~ Cinv_k[o, i] /
    s_*[k, i // 128, o]``, with the input axis padded to a multiple of 128
    (``_quantize_t_int8``): the JAX package's layout, so that its fields
    carry across as they are."""

    q_re: torch.Tensor     # (l, mn_pad, mn) int8, transposed
    q_im: torch.Tensor
    s_re: torch.Tensor     # (l, nb, mn) f32 per-(input-block, output) scales
    s_im: torch.Tensor
    lsten: torch.Tensor    # (l, m, n, 3, 3)
    usten: torch.Tensor    # (l, m, n, 3, 3)


def _quantize_t_int8(a: torch.Tensor):
    """f32 (out, in) -> (int8 (in_pad, out) transposed, f32 (nb, out) scales),
    bit for bit the JAX package's ``_quantize_t_int8``: per 128-row block of
    the transposed plane and output lane, ``scale = absmax / 127`` (1 where
    the block is zero), ``q = clip(round_half_even(a / scale), -127, 127)``;
    the padded input rows are zero."""
    out_n, in_n = a.shape
    nb = -(-in_n // INT8_BLOCK)
    at = F.pad(a.T, (0, 0, 0, nb * INT8_BLOCK - in_n))          # (in_pad, out)
    ab = at.reshape(nb, INT8_BLOCK, out_n)
    absmax = ab.abs().amax(dim=1)                                # (nb, out)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.round(ab / scale[:, None, :]).clamp_(-127, 127).to(torch.int8)
    return q.reshape(nb * INT8_BLOCK, out_n), scale


def _compress_pivot_int8(cinv: torch.Tensor):
    q_re, s_re = _quantize_t_int8(cinv.real.float())
    q_im, s_im = _quantize_t_int8(cinv.imag.float())
    return q_re, q_im, s_re, s_im


def _plane_stencil_matvec(sten: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply an (m, n, 3, 3) in-plane stencil to (m, n, ...) data."""
    m, n = sten.shape[0], sten.shape[1]
    extra = v.ndim - 2
    vp = F.pad(v, (0, 0) * extra + (1, 1, 1, 1))
    out = torch.zeros(v.shape, dtype=torch.result_type(sten, v), device=v.device)
    for dj in range(3):
        for di in range(3):
            w = sten[:, :, dj, di].reshape((m, n) + (1,) * extra)
            out = out + w * vp[dj : dj + m, di : di + n]
    return out


def _plane_stencil_to_dense(sten: torch.Tensor) -> torch.Tensor:
    """Dense (mn, mn) matrix of a 9-point in-plane stencil, scattered from
    the stencil's coefficients (the JAX package applies the stencil to the
    columns of the identity; the entries are the same numbers)."""
    m, n = sten.shape[0], sten.shape[1]
    jj, ii = torch.meshgrid(torch.arange(m, device=sten.device),
                            torch.arange(n, device=sten.device), indexing="ij")
    dense = torch.zeros((m * n, m * n), dtype=sten.dtype, device=sten.device)
    for dj in range(3):
        for di in range(3):
            tj, ti = jj + dj - 1, ii + di - 1
            keep = (tj >= 0) & (tj < m) & (ti >= 0) & (ti < n)
            dense[(jj * n + ii)[keep], (tj * n + ti)[keep]] = sten[:, :, dj, di][keep]
    return dense


def factor_stencil_3d(s, pivot_dtype: str = "full", pivot_band: int | None = None):
    """Leading-axis plane block-Thomas factorization of a 3D stencil matrix
    (``StencilMatrix3D``; blocks = planes orthogonal to ``values`` axis 0).

    Schur recursion ``C_k = D_k - L_k C_{k-1}^{-1} U_{k-1}`` over the planes,
    a Python loop with one ``torch.linalg.inv`` and one dense (mn, mn)
    product per plane.  The loop carries ONE full plane; only the stored
    stack is kept (``pivot_dtype="bf16"``: bf16 real and imaginary planes;
    ``"int8"``: each plane quantized in the loop, ``_quantize_t_int8``), so
    peak memory is O(mn^2 + l * stored).  ``pivot_band`` is accepted and
    ignored, as in the JAX package (banded 3D pivots were rejected by
    measurement there).
    """
    del pivot_band
    if pivot_dtype not in ("full", "bf16", "int8"):
        raise ValueError(f"unknown pivot_dtype {pivot_dtype!r}")
    vals = s.values                       # (l, m, n, 3, 3, 3)
    l, m, n = vals.shape[:3]
    mn = m * n
    dsten = vals[:, :, :, 1]
    lsten = vals[:, :, :, 0].contiguous()
    usten = vals[:, :, :, 2].contiguous()
    if pivot_dtype == "bf16":
        cre = torch.empty((l, mn, mn), dtype=torch.bfloat16, device=vals.device)
        cim = torch.empty_like(cre)
    elif pivot_dtype == "int8":
        nb = -(-mn // INT8_BLOCK)
        q = torch.empty((2, l, nb * INT8_BLOCK, mn), dtype=torch.int8, device=vals.device)
        sc = torch.empty((2, l, nb, mn), dtype=torch.float32, device=vals.device)
    else:
        cinv_all = torch.empty((l, mn, mn), dtype=vals.dtype, device=vals.device)

    cinv = None
    for k in range(l):
        c = _plane_stencil_to_dense(dsten[k])
        if cinv is not None:
            # (L_k C_{k-1}^{-1}): the L stencil on every column of the inverse
            lcinv = _plane_stencil_matvec(lsten[k], cinv.reshape(m, n, mn)).reshape(mn, mn)
            c = c - lcinv @ _plane_stencil_to_dense(usten[k - 1])
        cinv = torch.linalg.inv(c)
        if pivot_dtype == "bf16":
            cre[k] = cinv.real.float().to(torch.bfloat16)
            cim[k] = cinv.imag.float().to(torch.bfloat16)
        elif pivot_dtype == "int8":
            q[0, k], q[1, k], sc[0, k], sc[1, k] = _compress_pivot_int8(cinv)
        else:
            cinv_all[k] = cinv
    if pivot_dtype == "bf16":
        return BlockTridiagFactorization3DBF16(cinv_re=cre, cinv_im=cim, lsten=lsten,
                                               usten=usten)
    if pivot_dtype == "int8":
        return BlockTridiagFactorization3DInt8(q_re=q[0], q_im=q[1], s_re=sc[0], s_im=sc[1],
                                               lsten=lsten, usten=usten)
    return BlockTridiagFactorization3D(cinv=cinv_all, lsten=lsten, usten=usten)


def _pivot_apply_3d(fac, k: int, y: torch.Tensor) -> torch.Tensor:
    """Apply plane pivot inverse ``C_k^{-1}`` to ``y`` (mn[, r]): dense
    complex, bf16 planes (one f32 product per part, as the JAX package's
    ``_pivot_apply``), int8 planes (``_int8_pivot_apply``), or the kernels'
    plane stack (``plane_apply``)."""
    if hasattr(fac, "stack"):
        return plane_kernels.plane_apply(fac, k, y)
    if hasattr(fac, "q_re"):
        return _int8_pivot_apply(fac.q_re[k], fac.q_im[k], fac.s_re[k], fac.s_im[k], y)
    if hasattr(fac, "cinv_re"):
        mn = y.shape[0]
        ys = torch.stack([y.real.float(), y.imag.float()], dim=-1)   # (mn, ..., 2)
        flat = ys.reshape(mn, -1)
        zre = (fac.cinv_re[k].float() @ flat).reshape(ys.shape)
        zim = (fac.cinv_im[k].float() @ flat).reshape(ys.shape)
        return torch.complex(zre[..., 0] - zim[..., 1], zre[..., 1] + zim[..., 0]).to(y.dtype)
    return fac.cinv[k] @ y


def _int8_pivot_apply(q_re, q_im, s_re, s_im, y: torch.Tensor) -> torch.Tensor:
    """``C^{-1} y`` on one transposed int8 plane (the XLA order of the JAX
    package's ``_pivot_apply``): each 128-row block of the contraction is one
    f32 product, scaled AFTER it by its per-output scales, and the blocks are
    summed; no dequantized plane is formed.  The blocks run as one batched
    product here, so the sum over blocks is taken in another order."""
    n = y.shape[0]
    nb = s_re.shape[0]
    ys = torch.stack([y.real.float(), y.imag.float()], dim=-1)     # (n, ..., 2)
    flat = F.pad(ys.reshape(n, -1), (0, 0, 0, nb * INT8_BLOCK - n))
    fb = flat.T.reshape(-1, nb, INT8_BLOCK).transpose(0, 1)         # (nb, r, B)

    def part(q, sc):
        z = torch.bmm(fb, q.reshape(nb, INT8_BLOCK, -1).float())    # (nb, r, n)
        return (z * sc[:, None, :]).sum(dim=0).T.reshape(ys.shape)

    zre, zim = part(q_re, s_re), part(q_im, s_im)
    return torch.complex(zre[..., 0] - zim[..., 1], zre[..., 1] + zim[..., 0]).to(y.dtype)


def _as_plane_stack_3d(fac, b: torch.Tensor) -> torch.Tensor:
    """Reshape ``b``, flat (l*m*n,), (l, mn), (l*m*n, r) or (l, mn, r), to an
    (l, mn, ...) plane stack."""
    l = fac.lsten.shape[0]
    mn = fac.lsten.shape[1] * fac.lsten.shape[2]
    if b.ndim == 1:
        return b.reshape(l, mn)
    if b.ndim == 2 and b.shape[0] == l * mn:
        return b.reshape(l, mn, b.shape[1])
    return b.reshape((l, mn) + tuple(b.shape[2:]))


def _n_rhs(bg: torch.Tensor) -> int:
    r = 1
    for d in bg.shape[2:]:
        r *= d
    return r


def _fused(fac, bg) -> bool:
    """Whether a scan runs as fused kernel passes: a plane view whose stack
    the fused passes take at one right-hand side at least
    (``plane_kernels.fused_width``); the batch runs in launches of the widest
    width that fits, up to ``plane_kernels.MAX_RHS`` columns each."""
    return (hasattr(fac, "stack") and fac.fused
            and plane_kernels.fused_width(fac.stack, _n_rhs(bg)) > 0)


def _fwd_scan_3d(fac, bg, start: int = 0, t_start=None, collect_t: bool = False):
    """3D forward substitution over z-planes ``start..l-1`` (see
    :func:`_fwd_scan`); ``bg`` (l, mn[, r]).  A plane view runs the whole
    pass as ONE fused kernel launch (one a group of up to eight right-hand
    sides) when its stack fits (``plane_kernels.fwd_scan_fused``), else one
    ``plane_apply`` per plane."""
    if _fused(fac, bg):
        return plane_kernels.fwd_scan_fused(fac, bg, start=start, t_start=t_start,
                                            collect_t=collect_t)
    l = fac.lsten.shape[0]
    m, n = fac.lsten.shape[1], fac.lsten.shape[2]
    dtype = fac.lsten.dtype
    t_prev = (torch.zeros(bg.shape[1:], dtype=dtype, device=bg.device)
              if t_start is None else t_start.to(dtype))
    ys, ts = [], []
    for k in range(start, l):
        tp = t_prev.reshape((m, n) + tuple(t_prev.shape[1:]))
        y_k = bg[k].to(dtype) - _plane_stencil_matvec(fac.lsten[k], tp).reshape(t_prev.shape)
        t_prev = _pivot_apply_3d(fac, k, y_k)
        ys.append(y_k)
        if collect_t:
            ts.append(t_prev)
    return torch.stack(ys), (torch.stack(ts) if collect_t else None)


def _bwd_scan_3d(fac, y, tail: int = 0):
    """3D backward substitution; ``tail > 0`` materializes only the last
    planes (see :func:`_bwd_scan`)."""
    if _fused(fac, y):
        return plane_kernels.bwd_scan_fused(fac, y, tail=tail)
    l = fac.lsten.shape[0]
    m, n = fac.lsten.shape[1], fac.lsten.shape[2]
    dtype = fac.lsten.dtype
    full = tail <= 0 or tail >= l
    start = 0 if full else l - tail
    x_next = torch.zeros(y.shape[1:], dtype=dtype, device=y.device)
    out = torch.zeros(tuple(y.shape), dtype=dtype, device=y.device)
    for k in range(l - 1, start - 1, -1):
        xn = x_next.reshape((m, n) + tuple(x_next.shape[1:]))
        w = y[k] - _plane_stencil_matvec(fac.usten[k], xn).reshape(x_next.shape)
        x_next = _pivot_apply_3d(fac, k, w)
        out[k] = x_next
    return out


def block_thomas_solve_3d(fac, b: torch.Tensor) -> torch.Tensor:
    """Solve via the 3D plane factorization; ``b`` may be flat, (l, mn), or
    multi-RHS with a trailing column axis."""
    bg = _as_plane_stack_3d(fac, b)
    y, _ = _fwd_scan_3d(fac, bg)
    return _bwd_scan_3d(fac, y).reshape(b.shape)


def block_thomas_solve_support_3d(fac, b: torch.Tensor, start: int = 0,
                                  tail: int = 0) -> torch.Tensor:
    """3D solve for a rhs KNOWN to be zero on planes ``< start``; ``tail``
    truncates the backward pass (see :func:`block_thomas_solve_support`)."""
    l = fac.lsten.shape[0]
    bg = _as_plane_stack_3d(fac, b)
    if start <= 0 or start >= l:
        y, _ = _fwd_scan_3d(fac, bg)
    else:
        y_new, _ = _fwd_scan_3d(fac, bg, start=start)
        y = torch.cat([y_new.new_zeros((start,) + tuple(y_new.shape[1:])), y_new])
    return _bwd_scan_3d(fac, y, tail).reshape(b.shape)


def block_thomas_solve_cached_3d(fac, b: torch.Tensor, tail: int = 0):
    """3D tail-truncated solve returning the forward-pass stacks
    (see :func:`block_thomas_solve_cached`)."""
    bg = _as_plane_stack_3d(fac, b)
    y, t = _fwd_scan_3d(fac, bg, collect_t=True)
    return _bwd_scan_3d(fac, y, tail).reshape(b.shape), y, t


def block_thomas_solve_resume_3d(fac, b: torch.Tensor, y_cached: torch.Tensor,
                                 t_cached: torch.Tensor, resume: int) -> torch.Tensor:
    """3D solve resuming a cached forward pass (see
    :func:`block_thomas_solve_resume`)."""
    l = fac.lsten.shape[0]
    if resume <= 0 or resume >= l:
        return block_thomas_solve_3d(fac, b)
    bg = _as_plane_stack_3d(fac, b)
    k0 = l - resume
    y_new, _ = _fwd_scan_3d(fac, bg, start=k0, t_start=t_cached[k0 - 1])
    y = torch.cat([y_cached[:k0].to(y_new.dtype), y_new])
    return _bwd_scan_3d(fac, y).reshape(b.shape)
