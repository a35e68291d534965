"""Block-Thomas substitution on bf16 or int8 pivot planes: CUDA kernels + plain twins.

Counterpart of the JAX package's ``sparse/pallas_thomas.py``.  Its dense
layout, bf16 or int8: the batched multi-RHS pair ``_fwd_b`` / ``_bwd_b`` behind
``solve_all``, and the one-slab kernels ``_fwd`` / ``_bwd`` / ``_fwd_bt``
behind ``solve``, ``solve_cached``, ``solve_resume`` and ``solve_support``
(the local solves of the multi-slab sweeps).  Its banded+tail hybrid layout
(``PallasFactorizationBandedTail``, here :class:`BandedTailFactorization`):
the pair ``_fwd_ht`` / ``_bwd_ht`` behind the same entry points.  The TPU
kernels are rewritten by hand for Hopper in CUDA C++: ``csrc/thomas_fwd.cu``
(forward pass), ``csrc/thomas_fwd_cached.cu`` (forward pass that starts from a
given carry and keeps the t stack: ``_fwd`` and ``_fwd_bt``, and ``_fwd_ht``
on the hybrid layout), ``csrc/thomas_bwd.cu`` (backward pass: ``_bwd_b``,
``_bwd`` at one batch row and one right-hand side, and ``_bwd_ht``); each
launcher picks the layout's instantiation of the kernel.  Every pass runs the
flag-handoff line step of ``csrc/thomas_flow.cuh``: each line's carry is
handed to the next through flagged words of an exchange buffer
(:class:`Exchange`), not a grid barrier, one block a tile (two, each on half
of its input rows, on long lines).  The forward and backward passes on dense
planes run it as ``flow_kernel``; the cached forward pass on every layout and
the backward pass on the banded+tail layout run the same step driven by a
step map (``run_flow`` there; the fused sweeps of ``sweep_kernels`` too).
``csrc/thomas_line.cuh`` holds the design note of the layouts.

Storage (same numbers as the JAX package): pivot inverses are kept
TRANSPOSED in bfloat16 real/imag planes, ``Cinv^T[i_in, o_out]``, so the
per-line apply is ``[Yr; Yi] @ Cinv^T`` with f32 accumulation; bands and
right-hand sides ride as f32 re/im rows stacked
``[re_0..re_{r-1}; im_0..im_{r-1}]``.  The layout is the port's own.  The
TPU's 128-lane padding is not carried over: the leading dimension is
``ld = round_up(n, 8)`` and padding entries are zero.  And each plane is
stored TILE-MAJOR, ``cinv_t[s, j, t, i_in, l]`` = ``Cinv^T[i_in, 8 t + l]``:
a kernel block owns one tile of 8 output lanes, and this way the 16-byte
runs it reads (one per input row) lie back to back in memory, so a warp's
copies coalesce into whole cache lines.  The hybrid layout keeps the same
dense planes for its tail lines, and for its head lines one window per tile:
``head[s, j, t, v, l]`` = ``Cinv^T[8 t - half + v, 8 t + l]`` for the
``wt = 8 + 2 half`` input rows that reach the tile when only
``|in - out| <= half`` is kept (zero outside ``[0, n)``).

int8 storage (``storage="int8"``, the JAX package's ``pallas_int8``): the same
dense tile-major planes at the same ``ld`` in int8, with float32 scales per
(128-row input block, output lane), ``scale[s, j, t, b, part, l]`` for input
block b, output lane ``8 t + l`` and part 0 (real) or 1 (imaginary); an entry
counts as ``q * scale``.  The quantization is the JAX package's, bit for bit:
``scale = absmax / 127`` over the block (1 where it is zero), ``q =
clip(round_half_even(c / scale), -127, 127)``.  The last block may be partial
(rows ``[128 (nb - 1), ld)``): the JAX package pads to 128 lanes with zeros,
which leave the block's absmax as it is, so the scales are the same numbers.

Right-hand sides in one launch: r = 1, 2, 4, 8 or 16 (:data:`LAUNCH_WIDTHS`)
on either layout and in the fused sweeps of ``sweep_kernels``, each pivot
plane or head window read once for all of them; other r up to 16 are padded
to the next width with zero columns, and more than ``MAX_RHS`` run as groups
of at most ``MAX_RHS`` columns, one launch each, split from and joined back
into the stacked rows (:func:`in_rhs_groups`).  The plane kernels of
``plane_kernels`` stop at 8.

A line must fit one block's shared memory: its rows and the staged plane
buffers (for the flag-handoff passes, three stage buffers of a line's rows,
or of half a line's on lines too long for one block), which grow with r.
:func:`line_fits` mirrors the kernels' sizing; a batch runs in launches of
the widest width that fits the line (:func:`line_width`).  The longest lines
the kernels take on an H100 for each width are measured by the card-only test
``test_longest_line_fits`` (``LONGEST_LINE`` there); a line too long for one
right-hand side is refused at the launch and the wrapper raises
``ValueError``.

Each wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version only for a tensor that lies on the CPU.  The kernels
are compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root on first use and loaded with ``ctypes`` (``native/cuda_build.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build

LEAD_MULTIPLE = 8      # bf16 values per 16-byte load
MAX_RHS = 16           # right-hand sides per kernel launch (csrc: kMaxRhs)
LAUNCH_WIDTHS = (1, 2, 4, 8, 16)   # the instantiated widths (csrc: launch_width)
INT8_BLOCK = 128       # input rows per int8 scale (csrc: kScaleBlock)

_P, _I, _U = cuda_build.PTR, cuda_build.INT, cuda_build.UINT
# each launcher takes its pointers, its ints (the flag-handoff passes also an
# exchange buffer, at r = 4, 8 and 16 the wide step's rows buffer, and their first
# flag) and the stream
cuda_build.register("thomas_fwd", "thomas_forward", [_P] * 9 + [_I] * 6 + [_U, _P])
cuda_build.register("thomas_bwd", "thomas_backward", [_P] * 9 + [_I] * 8 + [_P, _P, _U, _P])
cuda_build.register("thomas_fwd_cached", "thomas_forward_cached",
                    [_P] * 11 + [_I] * 8 + [_P, _P, _U, _P])


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# version of the pivot layouts of ThomasFactorization and
# BandedTailFactorization below; checkpoints of packed slab pivots are keyed
# on it, so a change of layout must bump it
LAYOUT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ThomasFactorization:
    """Slab-stacked block-Thomas factors in the kernels' layout.

    Counterpart of the JAX package's ``PallasFactorization``, bf16 storage, or
    int8 storage when ``scale`` is set.  ``ld`` is the padded line length;
    padding rows/columns are zero so carries stay zero there.
    """

    cinv_t_re: torch.Tensor   # (S, m, ld/8, ld, 8) bf16 or int8, TRANSPOSED
    cinv_t_im: torch.Tensor   #   pivot inverses, tile-major (see tile_planes)
    lband: torch.Tensor       # (S, m, 2, 3, ld) f32 [re, im]
    uband: torch.Tensor       # (S, m, 2, 3, ld) f32
    n: int                    # true line length
    # (S,) int32 ``arange`` on the factors' device: a one-slab solve passes the
    # view ``slab_ids[s:s+1]`` to its kernels instead of copying a fresh index
    # tensor to the card for every local solve of a sweep
    slab_ids: torch.Tensor | None = None
    # int8 storage: (S, m, ld/8, nb, 2, 8) f32 scales, nb = ceil(ld / 128),
    # [s, j, t, b, part, l] for input block b and output lane 8 t + l; None
    # for bf16
    scale: torch.Tensor | None = None

    def __post_init__(self):
        if self.slab_ids is None:
            object.__setattr__(self, "slab_ids", torch.arange(
                self.cinv_t_re.shape[0], dtype=torch.int32, device=self.lband.device))

    @property
    def n_slabs(self) -> int:
        return self.cinv_t_re.shape[0]

    @property
    def m(self) -> int:
        return self.cinv_t_re.shape[1]

    @property
    def ld(self) -> int:
        return self.cinv_t_re.shape[3]

    @property
    def storage(self) -> str:
        return "bf16" if self.scale is None else "int8"

    @property
    def planes(self) -> tuple:
        """The pivot tensors the kernels read (with the int8 scales)."""
        extra = () if self.scale is None else (self.scale,)
        return (self.cinv_t_re, self.cinv_t_im) + extra


@dataclasses.dataclass(frozen=True)
class BandedTailFactorization:
    """Slab-stacked factors in the banded+tail hybrid layout of the kernels.

    Counterpart of the JAX package's ``PallasFactorizationBandedTail``: lines
    ``< tail_start`` keep only the band ``|in - out| <= half`` of their
    transposed bf16 pivot inverse, as one window of ``wt = 8 + 2 half`` input
    rows per tile of 8 output lanes (see the module note); the last ``m -
    tail_start`` lines, whose inverses are effectively dense interface Green's
    functions, keep dense tile-major planes as :class:`ThomasFactorization`
    does.  Padding entries are zero.
    """

    head_re: torch.Tensor     # (S, tail_start, ld/8, wt, 8) bf16 head windows
    head_im: torch.Tensor
    tail_re: torch.Tensor     # (S, m - tail_start, ld/8, ld, 8) bf16 tail planes
    tail_im: torch.Tensor
    lband: torch.Tensor       # (S, m, 2, 3, ld) f32 [re, im]
    uband: torch.Tensor       # (S, m, 2, 3, ld) f32
    n: int                    # true line length
    half: int                 # kept band half-width: width = 2 half + 1
    slab_ids: torch.Tensor | None = None     # as ThomasFactorization.slab_ids

    def __post_init__(self):
        if self.slab_ids is None:
            object.__setattr__(self, "slab_ids", torch.arange(
                self.lband.shape[0], dtype=torch.int32, device=self.lband.device))

    @property
    def n_slabs(self) -> int:
        return self.lband.shape[0]

    @property
    def m(self) -> int:
        return self.lband.shape[1]

    @property
    def ld(self) -> int:
        return self.lband.shape[4]

    @property
    def tail_start(self) -> int:
        return self.head_re.shape[1]

    @property
    def width(self) -> int:
        return 2 * self.half + 1

    @property
    def storage(self) -> str:
        return "bf16"

    @property
    def planes(self) -> tuple:
        return (self.head_re, self.head_im, self.tail_re, self.tail_im)


def tile_planes(p: torch.Tensor) -> torch.Tensor:
    """Dense planes (..., ld, ld) ``[i_in, o_out]`` -> tile-major
    (..., ld/8, ld, 8) ``[t, i_in, l]`` with ``o_out = 8 t + l``."""
    ld = p.shape[-1]
    tiled = p.reshape(p.shape[:-1] + (ld // LEAD_MULTIPLE, LEAD_MULTIPLE))
    return tiled.transpose(-3, -2).contiguous()


def dense_planes(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`tile_planes`: (..., ld/8, ld, 8) -> (..., ld, ld)."""
    ld = p.shape[-2]
    return p.transpose(-3, -2).reshape(p.shape[:-3] + (ld, ld))


def _band_pack(band: torch.Tensor, ld: int) -> torch.Tensor:
    """(S, m, n, 3) complex -> (S, m, 2, 3, ld) f32."""
    b = band.transpose(-1, -2)                               # (S, m, 3, n)
    b = torch.stack([b.real.float(), b.imag.float()], dim=2)
    return F.pad(b, (0, ld - b.shape[-1])).contiguous()


def n_scale_blocks(ld: int) -> int:
    """int8 scale blocks of a line of ``ld`` input rows (the last may be
    partial)."""
    return -(-ld // INT8_BLOCK)


def quantize_planes(p_t: torch.Tensor, ld: int):
    """Transposed f32 planes (..., n, n) ``[i_in, o_out]`` -> tile-major int8
    planes (..., ld/8, ld, 8) and their scales (..., nb, ld) ``[block,
    o_out]``, bit for bit the JAX package's ``build_pallas_factorization(
    storage="int8")`` away from its 128-lane padding: per 128-row input block
    and output lane ``scale = absmax / 127`` (1 where the block is zero) and
    ``q = clip(round_half_even(c / scale), -127, 127)``; padding entries are
    zero with scale 1.  Subnormal numbers count as zero, as in the JAX
    package's float32 arithmetic on its CPU and TPU backends, which flush
    them: a block of subnormal entries gets scale 1 and zeros, and a block
    whose absmax / 127 is subnormal gets scale 0 and entries +-127 (0 where
    the entry is 0)."""
    n = p_t.shape[-1]
    nb = n_scale_blocks(ld)
    lead = tuple(p_t.shape[:-2])

    def flush(x):
        return torch.where(x.abs() < torch.finfo(torch.float32).tiny, 0.0, x)

    padded = F.pad(flush(p_t), (0, ld - n, 0, nb * INT8_BLOCK - n))
    blocks = padded.reshape(lead + (nb, INT8_BLOCK, ld))
    absmax = blocks.abs().amax(dim=-2)                          # (..., nb, ld)
    scale = torch.where(absmax > 0, flush(absmax / 127.0), torch.ones_like(absmax))
    q = torch.round(blocks / scale[..., None, :]).nan_to_num_(nan=0.0)
    q = q.clamp_(-127, 127).to(torch.int8)
    q = q.reshape(lead + (nb * INT8_BLOCK, ld))[..., :ld, :]
    return tile_planes(q), scale


def tile_scales(sre: torch.Tensor, sim: torch.Tensor) -> torch.Tensor:
    """Scales (..., nb, ld) of the real and imaginary planes -> the kernels'
    tile-major (..., ld/8, nb, 2, 8) ``[t, b, part, l]``."""
    sc = torch.stack([sre, sim], dim=-2)                        # (..., nb, 2, ld)
    sc = sc.reshape(sc.shape[:-1] + (sc.shape[-1] // LEAD_MULTIPLE, LEAD_MULTIPLE))
    return sc.movedim(-2, -4).contiguous()                      # (..., ld/8, nb, 2, 8)


def dense_scales(scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`tile_scales`: (..., ld/8, nb, 2, 8) -> (..., 2, nb,
    ld) ``[part, block, o_out]``."""
    sc = scale.movedim(-4, -2)                                  # (..., nb, 2, ld/8, 8)
    sc = sc.reshape(sc.shape[:-2] + (sc.shape[-2] * sc.shape[-1],))
    return sc.transpose(-3, -2)


def _pivot_parts(fac, batched: bool):
    """(real, imaginary) transposed pivot planes of a dense or bf16
    ``BlockTridiagFactorization`` as a function of the slab, in f32."""
    if hasattr(fac, "cinv_re"):      # the XLA-side bf16 storage
        cre, cim = fac.cinv_re, fac.cinv_im
        if not batched:
            cre, cim = cre[None], cim[None]
        return cre.shape, lambda s: (cre[s].transpose(-1, -2).float(),
                                     cim[s].transpose(-1, -2).float())
    cinv = fac.cinv if batched else fac.cinv[None]
    cinv_t = cinv.transpose(-1, -2)
    return cinv.shape, lambda s: (cinv_t[s].real.float(), cinv_t[s].imag.float())


def build_thomas_factorization(fac, batched: bool = True,
                               storage: str = "bf16") -> ThomasFactorization:
    """Convert a (slab-batched) ``BlockTridiagFactorization`` with
    full-precision pivots, or a ``BlockTridiagFactorizationBF16``, to the
    padded, transposed kernel layout in ``storage`` "bf16" or "int8".

    Counterpart of ``build_pallas_factorization``.  The planes are rounded
    complex -> f32 -> bf16, or quantized from the f32 planes
    (:func:`quantize_planes`), as there, so they are bit-equal to the JAX
    package's away from the padding.  Slab by slab, which bounds the
    temporaries.
    """
    if storage not in ("bf16", "int8"):
        raise ValueError(f"unknown pivot storage {storage!r}")
    lband, uband = fac.lband, fac.uband
    if not batched:
        lband, uband = lband[None], uband[None]
    shape, parts = _pivot_parts(fac, batched)
    S, m, n = shape[0], shape[1], shape[2]
    dev = lband.device
    ld = _round_up(n, LEAD_MULTIPLE)
    tiles = ld // LEAD_MULTIPLE
    dtype = torch.bfloat16 if storage == "bf16" else torch.int8
    cre = torch.empty((S, m, tiles, ld, LEAD_MULTIPLE), dtype=dtype, device=dev)
    cim = torch.empty_like(cre)
    scale = (None if storage == "bf16" else
             torch.empty((S, m, tiles, n_scale_blocks(ld), 2, LEAD_MULTIPLE),
                         dtype=torch.float32, device=dev))
    for s in range(S):
        pre, pim = parts(s)
        if storage == "int8":
            (cre[s], sre), (cim[s], sim) = quantize_planes(pre, ld), quantize_planes(pim, ld)
            scale[s] = tile_scales(sre, sim)
            continue
        for dst, part in ((cre, pre), (cim, pim)):
            dense = torch.zeros((m, ld, ld), dtype=torch.bfloat16, device=dev)
            dense[:, :n, :n] = part.to(torch.bfloat16)
            dst[s] = tile_planes(dense)
    return ThomasFactorization(
        cinv_t_re=cre, cinv_t_im=cim,
        lband=_band_pack(lband, ld), uband=_band_pack(uband, ld), n=n, scale=scale,
    )


def head_windows(dense_t: torch.Tensor, n: int, half: int) -> torch.Tensor:
    """Transposed pivots (..., n, n) ``[i_in, o_out]`` -> banded head windows
    (..., ld/8, 8 + 2 half, 8) ``[t, v, l]`` = ``[8 t - half + v, 8 t + l]``,
    zero where ``|in - out| > half`` and outside ``[0, n)``; same dtype."""
    ld = _round_up(n, LEAD_MULTIPLE)
    wt = LEAD_MULTIPLE + 2 * half
    i = torch.arange(n, device=dense_t.device)
    banded = torch.where((i[:, None] - i[None, :]).abs() <= half, dense_t,
                         torch.zeros((), dtype=dense_t.dtype, device=dense_t.device))
    # input rows padded by half on either side, output lanes to ld
    padded = F.pad(banded, (0, ld - n, half, ld - n + half))   # (..., ld + 2 half, ld)
    tiles = padded.reshape(padded.shape[:-1] + (ld // LEAD_MULTIPLE, LEAD_MULTIPLE))
    # window t of tile t: rows 8 t .. 8 t + wt of the padded input axis
    win = tiles.unfold(-3, wt, LEAD_MULTIPLE)          # (..., tiles_u, tiles, 8, wt)
    win = torch.diagonal(win, dim1=-4, dim2=-3)        # (..., 8, wt, tiles)
    return win.permute(*range(win.ndim - 3), -1, -2, -3).contiguous()


def build_banded_tail_factorization(fac, width: int | None = None, tail_lines: int = 8,
                                    batched: bool = True) -> BandedTailFactorization:
    """Convert a (slab-batched) ``BlockTridiagFactorization`` with
    full-precision pivots to the banded+tail layout, slab by slab.

    Counterpart of ``build_pallas_banded_tail``: ``width=None`` applies the
    w(n) rule of ``sparse/direct.py:default_band_width``; ``width`` is made odd and at
    most ``2 n - 1``; ``tail_lines`` (clamped to ``1 .. m - 1``) trailing lines
    keep dense planes.  Entries are rounded complex -> f32 -> bf16 as for the
    dense layout, so they are bit-equal to the JAX package's away from the
    padding.
    """
    cinv, lband, uband = fac.cinv, fac.lband, fac.uband
    if not batched:
        cinv, lband, uband = cinv[None], lband[None], uband[None]
    S, m, n = cinv.shape[0], cinv.shape[1], cinv.shape[2]
    if width is None:
        # direct imports this module (through plane_kernels): import late
        from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import default_band_width

        width = default_band_width(n)
    width = min(int(width) | 1, 2 * n - 1)
    half = width // 2
    tail_lines = int(min(max(tail_lines, 1), m - 1))
    ts = m - tail_lines
    ld = _round_up(n, LEAD_MULTIPLE)
    tiles = ld // LEAD_MULTIPLE
    wt = LEAD_MULTIPLE + 2 * half
    dev = cinv.device
    head = [torch.empty((S, ts, tiles, wt, LEAD_MULTIPLE), dtype=torch.bfloat16, device=dev)
            for _ in range(2)]
    tail = [torch.empty((S, m - ts, tiles, ld, LEAD_MULTIPLE), dtype=torch.bfloat16, device=dev)
            for _ in range(2)]
    cinv_t = cinv.transpose(-1, -2)
    for s in range(S):      # slab by slab: bounds the temporaries
        for k, part in enumerate((cinv_t[s].real, cinv_t[s].imag)):
            f32 = part.float()
            head[k][s] = head_windows(f32[:ts], n, half).to(torch.bfloat16)
            dense = torch.zeros((m - ts, ld, ld), dtype=torch.bfloat16, device=dev)
            dense[:, :n, :n] = f32[ts:].to(torch.bfloat16)
            tail[k][s] = tile_planes(dense)
    return BandedTailFactorization(
        head_re=head[0], head_im=head[1], tail_re=tail[0], tail_im=tail[1],
        lband=_band_pack(lband, ld), uband=_band_pack(uband, ld), n=n, half=half,
    )


def _check_rows(fac, s_idx: torch.Tensor, rows: torch.Tensor):
    """Validate what the kernels take; returns (batch, r)."""
    if rows.dtype != torch.float32 or rows.ndim != 4 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (B, m, 2r, ld) float32 tensor")
    B, m, r2, ld = rows.shape
    if m != fac.m or ld != fac.ld or r2 % 2:
        raise ValueError(
            f"rows {tuple(rows.shape)} do not match factorization "
            f"(m={fac.m}, ld={fac.ld})"
        )
    if s_idx.dtype != torch.int32 or tuple(s_idx.shape) != (B,):
        raise ValueError("s_idx must be an int32 tensor of shape (B,)")
    for t in (s_idx, fac.lband, fac.uband) + fac.planes:
        if t.device != rows.device or not t.is_contiguous():
            raise ValueError("factorization, s_idx and rows must be contiguous "
                             "tensors on one device")
    if fac.storage == "int8":
        want = (fac.n_slabs, fac.m, fac.ld // LEAD_MULTIPLE, n_scale_blocks(fac.ld), 2,
                LEAD_MULTIPLE)
        if (fac.cinv_t_re.dtype != torch.int8 or fac.cinv_t_im.dtype != torch.int8
                or fac.scale.dtype != torch.float32 or tuple(fac.scale.shape) != want):
            raise ValueError(f"int8 pivots need int8 planes and float32 scales of shape {want}")
    elif any(p.dtype != torch.bfloat16 for p in fac.planes):
        raise ValueError("pivot planes must be bfloat16")
    return B, r2 // 2


# ---------------------------------------------------------------------------
# More right-hand sides than a launch takes: groups of at most MAX_RHS columns
# of the stacked rows [re_0..re_{r-1}; im_0..im_{r-1}] (axis -2), each padded
# with zero columns to a launch width
# ---------------------------------------------------------------------------


def launch_width(r: int) -> int:
    """The narrowest launch width that takes ``r <= MAX_RHS`` right-hand
    sides (r = 3 runs as 4, r = 5..7 as 8, r = 9..15 as 16)."""
    return next(w for w in LAUNCH_WIDTHS if w >= r)


def rhs_groups(r: int, width: int = MAX_RHS) -> list:
    """Column ranges ``[c0, c1)`` of the launches that carry ``r`` right-hand
    sides in groups of at most ``width``."""
    return [(c0, min(c0 + width, r)) for c0 in range(0, r, width)]


def _group_rows(t: torch.Tensor, r: int, c0: int, c1: int) -> tuple:
    """The real and the imaginary rows of columns ``[c0, c1)`` of stacked
    rows (..., 2r, ld), as two views (slices, so that a CUDA graph can
    capture their copies)."""
    return t[..., c0:c1, :], t[..., r + c0 : r + c1, :]


def _rhs_rows(t: torch.Tensor | None, r: int, c0: int, c1: int, width: int | None = None):
    """The stacked rows of columns ``[c0, c1)`` of a (..., 2r, ld) tensor as a
    contiguous (..., 2 width, ld) copy (``width`` defaults to ``c1 - c0``),
    zero in the padding columns ``c1 - c0 .. width - 1``; ``None`` stays
    ``None``."""
    if t is None:
        return None
    k = c1 - c0
    width = k if width is None else width
    re, im = _group_rows(t, r, c0, c1)
    if width == k:
        return torch.cat([re, im], dim=-2)
    padded = t.new_zeros(t.shape[:-2] + (2 * width, t.shape[-1]))
    padded[..., :k, :] = re
    padded[..., width : width + k, :] = im
    return padded


def _unpad(t: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` columns of stacked rows (..., 2 width, ld)."""
    width = t.shape[-2] // 2
    return t if width == k else torch.cat(_group_rows(t, width, 0, k), dim=-2)


def _join_rhs(parts: list) -> torch.Tensor:
    """Stacked rows of consecutive column groups -> one (..., 2r, ld) stack."""
    halves = [(p[..., : p.shape[-2] // 2, :], p[..., p.shape[-2] // 2 :, :]) for p in parts]
    return torch.cat([re for re, _ in halves] + [im for _, im in halves], dim=-2)


def in_rhs_groups(launch, r: int, rows: tuple, out=None, width: int = MAX_RHS):
    """Run ``launch`` once per group of :func:`rhs_groups` (``width`` columns
    at most), on each group's rows of the (..., 2r, ld) tensors ``rows``
    (``None`` passes as ``None``), padded with zero columns to the group's
    :func:`launch_width`.

    Without ``out`` the groups' results, a tensor or a tuple of them, are
    joined back into 2r rows.  With ``out`` (a stack or a tuple of stacks,
    some ``None``), ``launch`` also takes ``out=`` the group's copies of those
    stacks; what it returns for them is written back in place and ``out`` is
    returned."""
    single = isinstance(out, torch.Tensor)
    stacks = (out,) if single else out
    parts = []
    for c0, c1 in rhs_groups(r, width):
        k = c1 - c0
        pad = launch_width(k)
        args = [_rhs_rows(t, r, c0, c1, pad) for t in rows]
        if stacks is None:
            got = launch(*args)
            parts.append(tuple(_unpad(g, k) for g in got) if isinstance(got, tuple)
                         else _unpad(got, k))
            continue
        got = launch(*args, out=_rhs_rows(out, r, c0, c1, pad) if single else
                     tuple(_rhs_rows(t, r, c0, c1, pad) for t in stacks))
        for dst, src in zip(stacks, (got,) if single else got):
            if dst is not None:
                re, im = _group_rows(dst, r, c0, c1)
                re.copy_(src[..., :k, :])
                im.copy_(src[..., pad : pad + k, :])
    if stacks is not None:
        return out
    if isinstance(parts[0], tuple):
        return tuple(_join_rhs(list(p)) for p in zip(*parts))
    return _join_rhs(parts)


# ---------------------------------------------------------------------------
# What a line kernel's block holds in shared memory (csrc/thomas_flow.cuh,
# flow_smem_bytes and map_smem_bytes): the Python mirror that picks a launch
# width from shapes alone
# ---------------------------------------------------------------------------

SMEM_PER_BLOCK = 232_448   # shared memory an H100 grants one block (opt-in)
LINE_STAGES = 3            # stage buffers of the flag-handoff step (csrc: kStages)
WIDE_STAGES = 2            # stage buffers of the wide step (csrc: kWideStages)


def _slice_rows(ld: int, split: int) -> int:
    """Rows of the largest slice of a tile's input rows with ``split`` CTAs a
    tile (csrc: slice_rows)."""
    return LEAD_MULTIPLE * -(-(ld // LEAD_MULTIPLE) // split)


def wide_ksteps(cmax: int) -> int:
    """k-steps (16 input rows) of the wide step on a slice of ``cmax`` rows,
    the first aligned to 16 rows (csrc: wide_ksteps)."""
    return (cmax + 23) // 16


def wide_pub_bytes(r: int) -> int:
    """The wide step's publisher's operands of the next line: 2r + 2 floats a
    lane of one warp, kept at 20 for r <= 8 (csrc: wide_pub_bytes)."""
    return 4 * 32 * (34 if r == 16 else 20)


def line_smem_bytes(ld: int, r: int, storage: str = "bf16", split: int = 1,
                    inject: bool = False) -> int:
    """Shared memory of one block of a line kernel on lines of ``ld`` lanes at
    ``r`` right-hand sides with ``split`` CTAs a tile (``inject``: the fused
    sweeps, which keep the trace rows beside the carry at r <= 2 and add
    nothing to the wide step): the mbarriers and the
    warps' sums; at r <= 2 the carry rows (and trace rows) and the stage ring
    of :data:`LINE_STAGES` buffers (plane runs, scales, band and right-hand
    rows); at r = 4, 8 and 16 (the wide step, csrc/thomas_flow.cuh:
    wide_smem_bytes) the publisher's operands of the next line
    (:func:`wide_pub_bytes`), w of the slice's k-steps (2r rows at a pitch of
    8 more than a multiple of 32 floats), their A fragments, 16 bytes a lane
    and group (three groups at r = 8, two at r = 4, none at r = 16, which
    splits w again for each tile), and a stage ring of :data:`WIDE_STAGES`
    buffers of plane runs and scales only, each run 24 rows longer than the
    slice; at r = 16 a buffer is at least the edge terms the rows' copy
    stages in it (2r rows of 2 floats a tile: ld / 8 rounded up to even tiles
    with one CTA a tile, cmax / 8 + 4 with two)."""
    cmax = _slice_rows(ld, split)
    pitch = (512 if split == 1 else 256) // 32 + 4
    red = 4 * 2 * (2 * r * LEAD_MULTIPLE) * pitch
    scales = 4 * 2 * LEAD_MULTIPLE * n_scale_blocks(ld) if storage == "int8" else 0
    row_bytes = 8 if storage == "int8" else 16
    if r > 2:
        ksteps = wide_ksteps(cmax)
        w = 4 * 2 * r * (-(-16 * ksteps // 32) * 32 + 8)
        frags = ksteps * {4: 2, 8: 3, 16: 0}[r] * 32 * 16
        stage = 2 * (cmax + 24) * row_bytes + scales
        if r == 16:
            tiles = ld // LEAD_MULTIPLE
            edge_tiles = tiles + tiles % 2 if split == 1 else cmax // LEAD_MULTIPLE + 4
            stage = max(stage, 8 * 2 * r * edge_tiles)
        return 64 + red + wide_pub_bytes(r) + w + frags + WIDE_STAGES * stage
    prev = (2 if inject else 1) * 4 * 2 * r * (cmax + 16)
    rows = 4 * (6 + 2 * r) * cmax            # the band and right-hand rows of the slice
    return 64 + red + prev + LINE_STAGES * (2 * cmax * row_bytes + scales + rows)


def line_fits(ld: int, r: int, storage: str = "bf16", inject: bool = False) -> bool:
    """Whether a line kernel takes lines of ``ld`` lanes at ``r`` right-hand
    sides: one CTA a tile (512 threads, 3 rows a thread) or two (256, 5)."""
    return any(line_smem_bytes(ld, r, storage, split, inject) <= SMEM_PER_BLOCK
               and _slice_rows(ld, split) <= groups * threads
               for split, threads, groups in ((1, 512, 3), (2, 256, 5)))


def line_width(fac, r: int, inject: bool = False) -> int:
    """Right-hand sides of one launch for a batch of ``r`` on ``fac``'s
    lines (``inject``: of a fused sweep): the launch width of ``min(r,
    MAX_RHS)``, halved while the line does not fit it (a line that does not
    fit one right-hand side is refused at the launch)."""
    width = launch_width(min(r, MAX_RHS))
    while width > 1 and not line_fits(fac.ld, width, fac.storage, inject):
        width //= 2
    return width


# ---------------------------------------------------------------------------
# The carry exchange of the flag-handoff passes (csrc/thomas_flow.cuh)
# ---------------------------------------------------------------------------

FLAG_LIMIT = 2**32 - 1     # flags are 32-bit; 0 marks a word never written
EXCHANGE_LINES = 4         # lines of the dense passes' exchange ring (csrc: kSlots)
LINE_HALVES = 2            # most CTAs a tile, each publishing its own sums (csrc: SPLIT)
WIDE_SLOT_BYTES = 64       # x r x ld: a slot of the wide step's rows (csrc: wide_slot_bytes)


class Exchange:
    """The exchange buffer of the flag-handoff passes on one CUDA stream, and
    the counter that hands each launch its flags.

    A carried value travels as one 8-byte word (its bits, its flag) from
    each CTA of a tile (one, or :data:`LINE_HALVES` on long lines); a launch
    with B batch rows of r right-hand sides on lines of ``ld`` lanes needs
    ``slots`` slots of (B, ld, 2r, halves) words, and line step k of a launch
    given flag ``epoch`` publishes flag ``epoch + k`` into slot k (modulo
    ``slots``).  The dense forward and backward passes reuse a ring of
    :data:`EXCHANGE_LINES` slots; the step maps (the cached forward pass, the
    backward pass on banded+tail pivots and the fused sweeps) take one slot
    per line step at r = 1, 2, so that no slot is written twice in a launch
    and the words of every earlier step stay readable
    (``csrc/thomas_flow.cuh``, ``run_flow``); at r = 4, 8, 16 the backward pass
    on banded+tail pivots and the fused sweeps take the ring too (the wide
    step's every step waits on the one before).  The buffer is zeroed when it
    is made and only these kernels write it; the counter only grows, so no
    word left from an earlier launch carries a flag that a later one waits
    for, and no launch needs a memset.  A buffer too small for a launch is
    replaced by a larger zeroed one, and the counter starts again at 1; so
    it does when it would pass :data:`FLAG_LIMIT`, after zeroing the buffer
    once.

    The wide step (r = 4, 8, 16; ``csrc/thomas_flow.cuh``) hands its rows over
    as plain f32 rows in a second buffer (:meth:`wide_rows`), behind flag
    words in the words above, two a tile (its rows, and with two CTAs a tile
    the partial sums one hands the other) 32 bytes apart, (slots, B, 2, ld /
    8, 4) words: no more than :meth:`values`, so the words buffer never grows
    for them, and the rows buffer holds only rows, so no stale row is ever
    read as a flag.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.words: torch.Tensor | None = None     # int32, two per word
        self.rows: torch.Tensor | None = None      # float32, the wide step's rows
        self.next = 1

    @staticmethod
    def values(batch: int, r: int, ld: int, slots: int = EXCHANGE_LINES) -> int:
        """Words of a launch: ``slots`` slots of (B, ld, 2r, halves) words."""
        return slots * batch * ld * LINE_HALVES * 2 * r

    def take(self, batch: int, r: int, ld: int, lines: int, slots: int = EXCHANGE_LINES):
        """The buffer for a launch of ``lines`` line steps on ``slots`` slots
        and its first flag."""
        need = 2 * self.values(batch, r, ld, slots)
        if self.words is None or self.words.numel() < need:
            self.words = torch.zeros(need, dtype=torch.int32, device=self.device)
            self.next = 1
            self.rows = None
        if self.next + lines > FLAG_LIMIT:
            self.words.zero_()
            self.next = 1
            self.rows = None
        epoch = self.next
        self.next += lines
        return self.words, epoch

    @staticmethod
    def row_values(batch: int, r: int, ld: int, slots: int = EXCHANGE_LINES) -> int:
        """Floats of a wide launch's rows: ``slots`` slots of
        :data:`WIDE_SLOT_BYTES` x r x ld bytes a batch row."""
        return slots * batch * WIDE_SLOT_BYTES * r * ld // 4

    def wide_rows(self, batch: int, r: int, ld: int, slots: int = EXCHANGE_LINES):
        """The rows buffer of a wide launch (r = 4, 8, 16), zero when made (a
        build that hands the rows over as flagged words needs that) and made
        anew whenever the flags start again at 1; a null pointer's tensor
        (None) at r <= 2."""
        if r <= 2:
            return None
        need = self.row_values(batch, r, ld, slots)
        if self.rows is None or self.rows.numel() < need:
            self.rows = torch.zeros(need, dtype=torch.float32, device=self.device)
        return self.rows


# one exchange per (device, stream), for the life of the process: every
# launch on a stream must draw its flags from one counter over one buffer
_EXCHANGES: dict = {}


def exchange_for(t: torch.Tensor) -> Exchange:
    """The exchange of ``t``'s device and current stream (launches on one
    stream run in order, so they can share one buffer and one counter)."""
    key = (t.device, torch.cuda.current_stream(t.device).cuda_stream)
    if key not in _EXCHANGES:
        _EXCHANGES[key] = Exchange(t.device)
    return _EXCHANGES[key]


def reset_exchange(stream: torch.cuda.Stream) -> None:
    """Forget the exchange of ``stream``: its next launch takes a new zeroed
    buffer and hands out flags from 1 again.  A CUDA graph captured on
    ``stream`` right after this makes that buffer inside the capture, so each
    replay zeroes it before the flags it captured are handed out again and no
    word left by an earlier replay carries a flag that a launch waits for."""
    _EXCHANGES.pop((torch.device(stream.device), stream.cuda_stream), None)


_INVALID_VALUE = 1     # cudaErrorInvalidValue


def _raise_on(err: int, what: str, fac):
    if err == _INVALID_VALUE:
        raise ValueError(
            f"{what} refused its arguments: most likely the line length "
            f"n={fac.n} is too long for one block's shared memory (see the "
            "module note; longer lines are queued in ROADMAP.md, Queue 2)"
        )
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tests; yardstick on the card)
# ---------------------------------------------------------------------------


def _band_apply_rows(band: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Tridiagonal complex band times multi-RHS carry: band (B, 2, 3, ld),
    t (B, 2r, ld) stacked [re rows; im rows] -> (B, 2r, ld)."""
    r = t.shape[1] // 2
    tr, ti = t[:, :r], t[:, r:]
    taps = (
        (F.pad(tr[..., :-1], (1, 0)), F.pad(ti[..., :-1], (1, 0))),
        (tr, ti),
        (F.pad(tr[..., 1:], (0, 1)), F.pad(ti[..., 1:], (0, 1))),
    )
    accr = torch.zeros_like(tr)
    acci = torch.zeros_like(ti)
    for d, (sr, si) in enumerate(taps):
        br, bi = band[:, 0, d, None], band[:, 1, d, None]
        accr = accr + br * sr - bi * si
        acci = acci + br * si + bi * sr
    return torch.cat([accr, acci], dim=1)


def _pivot_dot_rows(y: torch.Tensor, cre: torch.Tensor, cim: torch.Tensor):
    """[Yr; Yi] @ Cinv^T for (B, 2r, ld) rows and tile-major (B, ld/8, ld, 8)
    bf16 planes, through dense f32 copies of the planes."""
    z1 = torch.matmul(y, dense_planes(cre).float())
    z2 = torch.matmul(y, dense_planes(cim).float())
    r = y.shape[1] // 2
    return torch.cat([z1[:, :r] - z2[:, r:], z1[:, r:] + z2[:, :r]], dim=1)


def _pivot_dot_rows_int8(y: torch.Tensor, qre: torch.Tensor, qim: torch.Tensor,
                         scale: torch.Tensor):
    """[Yr; Yi] @ Cinv^T for (B, 2r, ld) rows and tile-major int8 planes with
    their scales (B, ld/8, nb, 2, 8), in the order of the JAX package's
    ``_scaled_dots``: one f32 product per 128-row input block, scaled by its
    (block, output lane) scales, accumulated block after block."""
    sc = dense_scales(scale)                                    # (B, 2, nb, ld)
    nb = sc.shape[-2]
    dre, dim_ = dense_planes(qre), dense_planes(qim)            # (B, ld, ld) int8
    z1 = torch.zeros_like(y)
    z2 = torch.zeros_like(y)
    for b in range(nb):
        rows = slice(b * INT8_BLOCK, (b + 1) * INT8_BLOCK)
        yb = y[..., rows]
        z1 = z1 + torch.matmul(yb, dre[:, rows].float()) * sc[:, None, 0, b]
        z2 = z2 + torch.matmul(yb, dim_[:, rows].float()) * sc[:, None, 1, b]
    r = y.shape[1] // 2
    return torch.cat([z1[:, :r] - z2[:, r:], z1[:, r:] + z2[:, :r]], dim=1)


def forward_substitution_plain(fac: ThomasFactorization, s_idx: torch.Tensor,
                               b4: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Plain version of :func:`forward_substitution`: a Python loop over the
    lines with ``torch.matmul``."""
    s = s_idx.long()
    y4 = torch.zeros_like(b4)
    t = torch.zeros_like(b4[:, 0])
    for j in range(start, fac.m):
        y = b4[:, j] - _band_apply_rows(fac.lband[s, j], t)
        y4[:, j] = y
        t = line_pivot_plain(fac, s, j, y)
    return y4


def _head_dot_rows(y: torch.Tensor, hre: torch.Tensor, him: torch.Tensor, half: int):
    """[Yr; Yi] @ (banded Cinv^T) for (B, 2r, ld) rows and head windows
    (B, ld/8, wt, 8): the 8 lanes of tile t from input rows 8 t - half ..
    8 t + 7 + half, through f32 copies of the windows."""
    B, r2, ld = y.shape
    wt = hre.shape[-2]
    win = F.pad(y, (half, half)).unfold(-1, wt, LEAD_MULTIPLE)     # (B, 2r, tiles, wt)
    z1 = torch.einsum("bqtv,btvl->bqtl", win, hre.float()).reshape(B, r2, ld)
    z2 = torch.einsum("bqtv,btvl->bqtl", win, him.float()).reshape(B, r2, ld)
    r = r2 // 2
    return torch.cat([z1[:, :r] - z2[:, r:], z1[:, r:] + z2[:, :r]], dim=1)


def line_pivot_plain(fac, s: torch.Tensor, j: int, y: torch.Tensor) -> torch.Tensor:
    """``t = C_j^{-1} y`` for (B, 2r, ld) rows of slabs ``s`` (one per batch
    row), in either layout: a dense plane (bf16, or int8 with its scales), or
    for the hybrid layout the head window (``j < tail_start``) or the tail
    plane."""
    if isinstance(fac, ThomasFactorization):
        if fac.scale is not None:
            return _pivot_dot_rows_int8(y, fac.cinv_t_re[s, j], fac.cinv_t_im[s, j],
                                        fac.scale[s, j])
        return _pivot_dot_rows(y, fac.cinv_t_re[s, j], fac.cinv_t_im[s, j])
    if j < fac.tail_start:
        return _head_dot_rows(y, fac.head_re[s, j], fac.head_im[s, j], fac.half)
    k = j - fac.tail_start
    return _pivot_dot_rows(y, fac.tail_re[s, k], fac.tail_im[s, k])


def forward_substitution_cached_plain(fac, s_idx: torch.Tensor, b4: torch.Tensor,
                                      t_init: torch.Tensor, start: int = 0, out=None):
    """Plain version of :func:`forward_substitution_cached`, on either
    layout."""
    s = s_idx.long()
    y4, t4 = out if out is not None else (torch.zeros_like(b4), torch.zeros_like(b4))
    t = t_init.clone()
    t[..., fac.n:] = 0          # padding lanes of the carry count as zero
    for j in range(start, fac.m):
        y = b4[:, j] - _band_apply_rows(fac.lband[s, j], t)
        t = line_pivot_plain(fac, s, j, y)
        y4[:, j] = y
        t4[:, j] = t
    return y4, t4


def backward_substitution_plain(fac, s_idx: torch.Tensor, y4: torch.Tensor,
                                tail: int = 0) -> torch.Tensor:
    """Plain version of :func:`backward_substitution`, on either layout."""
    s = s_idx.long()
    m = fac.m
    m_eff = m if tail <= 0 or tail >= m else tail
    off = m - m_eff
    x4 = torch.empty_like(y4[:, off:])
    x = torch.zeros_like(y4[:, 0])
    for j in range(m - 1, off - 1, -1):
        w = y4[:, j] - _band_apply_rows(fac.uband[s, j], x)
        x = line_pivot_plain(fac, s, j, w)
        x4[:, j - off] = x
    return x4


# the plain versions of the hybrid kernels (rows 6 and 7 of PERF.md) are the
# same line loops: line_pivot_plain picks the layout's pivot per line; the
# names say which kernel a caller holds them against
forward_substitution_ht_plain = forward_substitution_cached_plain
backward_substitution_ht_plain = backward_substitution_plain


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def forward_substitution(fac: ThomasFactorization, s_idx: torch.Tensor,
                         b4: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Batched forward substitution ``y_j = b_j - L_j t_{j-1}``,
    ``t_j = C_j^{-1} y_j`` over lines ``start..m-1`` (zero carry at
    ``start``).  ``b4`` is (B, m, 2r, ld) f32 and batch row i uses slab
    ``s_idx[i]``.  Returns the full (B, m, 2r, ld) y stack, zero on lines
    ``< start``.  Dense layout only (the hybrid one has the cached pass), bf16
    or int8.  On the card a batch that one launch does not take runs in
    launches of :func:`line_width` columns (:func:`in_rhs_groups`)."""
    if not isinstance(fac, ThomasFactorization):
        raise ValueError("forward_substitution takes dense planes; the banded+tail "
                         "layout runs forward_substitution_cached")
    B, r = _check_rows(fac, s_idx, b4)
    if not 0 <= start < fac.m:
        raise ValueError(f"start={start} outside [0, {fac.m})")
    if not b4.is_cuda:
        return forward_substitution_plain(fac, s_idx, b4, start)
    width = line_width(fac, r)
    if width != r:
        return in_rhs_groups(lambda b: forward_substitution(fac, s_idx, b, start), r, (b4,),
                             width=width)
    fn = cuda_build.load("thomas_fwd")
    y4 = torch.empty_like(b4)
    if start:
        y4[:, :start] = 0
    ex = exchange_for(b4)
    xchg, epoch = ex.take(B, r, fac.ld, fac.m - start)
    err = fn(
        b4.data_ptr(), fac.lband.data_ptr(), fac.cinv_t_re.data_ptr(),
        fac.cinv_t_im.data_ptr(), _scale_ptr(fac), s_idx.data_ptr(), y4.data_ptr(),
        xchg.data_ptr(), _ptr(ex.wide_rows(B, r, fac.ld)), B, fac.m, fac.n, fac.ld, r, start,
        epoch,
        torch.cuda.current_stream(b4.device).cuda_stream,
    )
    _raise_on(err, "thomas_forward", fac)
    _count_launch(forward_substitution, fac)
    return y4


def _ptr(t: torch.Tensor | None) -> int:
    """A tensor's pointer, or 0 (null) for None."""
    return 0 if t is None else t.data_ptr()


def _scale_ptr(fac) -> int:
    """The int8 scales' pointer, or 0 (null) for bf16 planes."""
    return 0 if fac.scale is None else fac.scale.data_ptr()


def _pivot_args(fac) -> tuple:
    """The launchers' pivot operands of either layout: (head re, head im,
    planes re, planes im, int8 scales) pointers, then tail_start and half; the
    dense layout is tail_start = 0 with no head, the hybrid one has no
    scales."""
    if isinstance(fac, BandedTailFactorization):
        return (fac.head_re.data_ptr(), fac.head_im.data_ptr(), fac.tail_re.data_ptr(),
                fac.tail_im.data_ptr(), 0), (fac.tail_start, fac.half)
    return (0, 0, fac.cinv_t_re.data_ptr(), fac.cinv_t_im.data_ptr(), _scale_ptr(fac)), (0, 0)


def _count_launch(fn, fac):
    """One more launch of ``fn``'s kernel, under the pivot layout it ran on
    (:func:`layout`)."""
    fn.launches[layout(fac)] += 1


def layout(fac) -> str:
    """The key of a factorization's launches: "bf16" or "int8" for dense
    planes, "ht" for the banded+tail layout."""
    return "ht" if isinstance(fac, BandedTailFactorization) else fac.storage


def _cached_operands(fac, s_idx, b4, t_init, start, out):
    """Checks the operands of a cached forward pass and fills in the missing
    ones; returns (B, r, t_init, out)."""
    B, r = _check_rows(fac, s_idx, b4)
    if not 0 <= start < fac.m:
        raise ValueError(f"start={start} outside [0, {fac.m})")
    if t_init is None:
        t_init = b4.new_zeros((B, 2 * r, fac.ld))
    if out is None:
        out = (torch.empty_like(b4), torch.empty_like(b4))
        if start:
            for stack in out:
                stack[:, :start] = 0
    for name, t, shape in (("t_init", t_init, (B, 2 * r, fac.ld)),
                           ("out[0]", out[0], b4.shape), ("out[1]", out[1], b4.shape)):
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
                or t.device != b4.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape "
                             f"{tuple(shape)} on {b4.device}")
    return B, r, t_init, out


def forward_substitution_cached(fac, s_idx: torch.Tensor, b4: torch.Tensor,
                                t_init: torch.Tensor | None = None, start: int = 0,
                                out=None):
    """Batched forward substitution over lines ``start..m-1`` that starts from
    the carry ``t_init`` (B, 2r, ld) = ``t_{start-1}`` (zero when ``None``) and
    keeps both stacks: returns ``(y4, t4)``, each (B, m, 2r, ld), with
    ``t_j = C_j^{-1} y_j``.

    Either layout: on the hybrid one (the JAX package's ``_fwd_ht``) lines
    ``< tail_start`` apply their banded head windows, the rest their dense
    tail planes, and the carry crosses from one to the other as it is.

    Lines ``< start``: the kernel neither reads nor writes them.  With
    ``out=(y4, t4)`` (contiguous float32 tensors of ``b4``'s shape) lines
    ``>= start`` are written IN PLACE into those and lines ``< start`` keep
    what the caller put there (a resumed pass hands in a copy of the cached y
    stack); without ``out`` both stacks are new and zero on lines ``< start``.
    On the card a batch that one launch does not take runs in launches of
    :func:`line_width` columns, each on copies of its rows of ``out`` that
    are written back."""
    B, r, t_init, out = _cached_operands(fac, s_idx, b4, t_init, start, out)
    if not b4.is_cuda:
        return forward_substitution_cached_plain(fac, s_idx, b4, t_init, start, out)
    width = line_width(fac, r)
    if width != r:
        return in_rhs_groups(
            lambda b, t, out: forward_substitution_cached(fac, s_idx, b, t, start, out),
            r, (b4, t_init), out, width=width)
    fn = cuda_build.load("thomas_fwd_cached")
    pivots, layout = _pivot_args(fac)
    lines = fac.m - start                   # one exchange slot per line
    ex = exchange_for(b4)
    xchg, epoch = ex.take(B, r, fac.ld, lines, slots=lines)
    err = fn(
        b4.data_ptr(), fac.lband.data_ptr(), *pivots, s_idx.data_ptr(), t_init.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), B, fac.m, fac.n, fac.ld, r, start, *layout,
        xchg.data_ptr(), _ptr(ex.wide_rows(B, r, fac.ld, slots=lines)), epoch,
        torch.cuda.current_stream(b4.device).cuda_stream,
    )
    _raise_on(err, "thomas_forward_cached", fac)
    _count_launch(forward_substitution_cached, fac)
    return out


def backward_slots(fac, m_eff: int, r: int = 1) -> int:
    """Exchange slots of a backward pass over ``m_eff`` lines at ``r``
    right-hand sides: on dense planes (``flow_kernel``) and at r = 4, 8, 16 (the
    wide step, whose every step waits on the one before) the ring of
    :data:`EXCHANGE_LINES`; on the banded+tail layout at r = 1, 2 (a step map
    through ``run_flow``) one slot per line step."""
    if isinstance(fac, BandedTailFactorization) and r <= 2:
        return m_eff
    return EXCHANGE_LINES


def backward_substitution(fac, s_idx: torch.Tensor, y4: torch.Tensor,
                          tail: int = 0) -> torch.Tensor:
    """Batched backward substitution ``x_j = C_j^{-1}(y_j - U_j x_{j+1})``
    bottom-up over the FULL (B, m, 2r, ld) y stack; ``0 < tail < m``
    materializes only the last ``tail`` lines.  Returns (B, m_eff, 2r, ld).
    Either layout (the hybrid one is the JAX package's ``_bwd_ht``).  On the
    card a batch that one launch does not take runs in launches of
    :func:`line_width` columns."""
    B, r = _check_rows(fac, s_idx, y4)
    if not y4.is_cuda:
        return backward_substitution_plain(fac, s_idx, y4, tail)
    width = line_width(fac, r)
    if width != r:
        return in_rhs_groups(lambda y: backward_substitution(fac, s_idx, y, tail), r, (y4,),
                             width=width)
    fn = cuda_build.load("thomas_bwd")
    m = fac.m
    m_eff = m if tail <= 0 or tail >= m else tail
    x4 = torch.empty((B, m_eff, 2 * r, fac.ld), dtype=torch.float32, device=y4.device)
    pivots, layout = _pivot_args(fac)
    ex = exchange_for(y4)
    slots = backward_slots(fac, m_eff, r)
    xchg, epoch = ex.take(B, r, fac.ld, m_eff, slots=slots)
    err = fn(
        y4.data_ptr(), fac.uband.data_ptr(), *pivots, s_idx.data_ptr(), x4.data_ptr(),
        B, m, fac.n, fac.ld, r, m_eff, *layout, xchg.data_ptr(),
        _ptr(ex.wide_rows(B, r, fac.ld, slots=slots)), epoch,
        torch.cuda.current_stream(y4.device).cuda_stream,
    )
    _raise_on(err, "thomas_backward", fac)
    _count_launch(backward_substitution, fac)
    return x4


# launch counts: one per launch of the wrapper's kernel, by pivot layout
for _fn in (forward_substitution, forward_substitution_cached, backward_substitution):
    _fn.launches = dict.fromkeys(("bf16", "int8", "ht"), 0)


def _to_rows_b(fac: ThomasFactorization, b: torch.Tensor) -> torch.Tensor:
    """Complex (S, m, n[, r]) rhs -> (S, m, 2r, ld) f32 stacked rows."""
    S, m, n = b.shape[0], fac.m, fac.n
    bg = b.reshape(S, m, n, -1)
    rows = torch.cat([bg.real, bg.imag], dim=-1).float()
    rows = rows.permute(0, 1, 3, 2)                        # (S, m, 2r, n)
    return F.pad(rows, (0, fac.ld - n)).contiguous()


def _from_rows_b(rows: torch.Tensor, n: int, dtype: torch.dtype, m: int,
                 offset: int = 0) -> torch.Tensor:
    """(S, m_eff, 2r, ld) f32 rows -> complex (S, m, n, r), zero outside the
    computed window ``[offset, offset + m_eff)`` along lines."""
    r = rows.shape[2] // 2
    x = torch.complex(rows[:, :, :r, :n], rows[:, :, r:, :n]).to(dtype)
    x = x.permute(0, 1, 3, 2)                              # (S, m_eff, n, r)
    if x.shape[1] == m:
        return x
    out = torch.zeros((x.shape[0], m, n, r), dtype=dtype, device=rows.device)
    out[:, offset : offset + x.shape[1]] = x
    return out


def solve_all(fac, s_idx, b: torch.Tensor, start: int = 0, tail: int = 0) -> torch.Tensor:
    """Solve every slab's system at once: ``b`` is (S, m, n) or (S, m, n, r)
    complex with slab ``s_idx[i]``'s factors applied to batch row i.  ``start``
    asserts the rhs is zero on lines < start (exact head-start); ``tail``
    truncates the backward pass (zeros above the last ``tail`` lines).
    Either layout: the hybrid one runs the hybrid pair (the JAX package's
    ``_ht_solve_all``).
    """
    s = torch.as_tensor(s_idx, dtype=torch.int32, device=b.device).reshape(-1)
    m = fac.m
    if start >= m or start < 0:
        start = 0
    off = 0 if (tail <= 0 or tail >= m) else m - tail
    rows = _to_rows_b(fac, b)
    if isinstance(fac, BandedTailFactorization):     # the hybrid pass keeps its t stack
        y4, _ = forward_substitution_cached(fac, s, rows, start=start)
    else:
        y4 = forward_substitution(fac, s, rows, start=start)
    x4 = backward_substitution(fac, s, y4, tail=tail)
    return _from_rows_b(x4, fac.n, b.dtype, m, off).reshape(b.shape)


# ---------------------------------------------------------------------------
# One-slab solves (the local solves of the multi-slab sweeps)
#
# ``b`` is (m, n) for one right-hand side or (m, n, r) for r of them, and
# ``s_idx`` picks the slab: a Python int (no copy to the card) or an integer
# tensor with one element.  As in the JAX package a 2-D ``b`` goes through the
# single-RHS kernels (``_fwd``/``_bwd`` there; here the cached forward kernel
# and the backward kernel at one batch row, r = 1), and (m, n, r) through the
# multi-RHS kernels.  On the hybrid layout every case runs the hybrid pair
# (``_ht_solve_all``, ``_ht_solve_cached``, ``_ht_solve_resume`` there).
# ---------------------------------------------------------------------------


def _one_slab(fac, s_idx) -> torch.Tensor:
    if isinstance(s_idx, int):
        return fac.slab_ids[s_idx : s_idx + 1]
    return torch.as_tensor(s_idx, dtype=torch.int32, device=fac.lband.device).reshape(1)


def _rows_of(fac, b: torch.Tensor) -> torch.Tensor:
    """One slab's (m, n) or (m, n, r) complex rhs -> (1, m, 2r, ld) rows."""
    return _to_rows_b(fac, b[None] if b.ndim == 3 else b.reshape(1, fac.m, fac.n))


def _backward_to_grid(fac, s, y4, b, tail: int = 0) -> torch.Tensor:
    """Backward pass over the (1, m, 2r, ld) y stack, back to ``b``'s shape
    and dtype (zeros above the last ``tail`` lines)."""
    x4 = backward_substitution(fac, s, y4, tail=tail)
    off = 0 if (tail <= 0 or tail >= fac.m) else fac.m - tail
    return _from_rows_b(x4, fac.n, b.dtype, fac.m, off)[0].reshape(b.shape)


def solve_support(fac, s_idx, b: torch.Tensor, start: int = 0, tail: int = 0) -> torch.Tensor:
    """``S x = b`` for slab ``s_idx`` with ``b`` zero on lines ``< start``
    (``direct.block_thomas_solve_support``): the forward pass begins at
    ``start`` with a zero carry, which is exact.  ``0 < tail < m``
    materializes x only on the last ``tail`` lines (zeros above)."""
    s = _one_slab(fac, s_idx)
    if not 0 <= start < fac.m:
        start = 0
    if b.ndim == 3:
        return solve_all(fac, s, b[None], start=start, tail=tail)[0]
    y4, _ = forward_substitution_cached(fac, s, _rows_of(fac, b), start=start)
    return _backward_to_grid(fac, s, y4, b, tail)


def solve(fac, s_idx, b: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """``S x = b`` for slab ``s_idx``; semantics of
    ``direct.block_thomas_solve(_tail)``."""
    return solve_support(fac, s_idx, b, 0, tail)


def solve_cached(fac, s_idx, b: torch.Tensor, tail: int = 0):
    """Tail solve plus the forward pass's caches
    (``direct.block_thomas_solve_cached``): returns ``(x, y_cache, t_cache)``
    with the caches (m, 2r, ld) float32 rows, for :func:`solve_resume`.
    Multi-RHS streams each pivot plane once for all r columns."""
    s = _one_slab(fac, s_idx)
    y4, t4 = forward_substitution_cached(fac, s, _rows_of(fac, b))
    return _backward_to_grid(fac, s, y4, b, tail), y4[0], t4[0]


def solve_resume(fac, s_idx, b: torch.Tensor, y_cached: torch.Tensor,
                 t_cached: torch.Tensor, resume: int) -> torch.Tensor:
    """Solve where ``b`` differs from the cached solve's rhs only on the last
    ``resume`` lines (``direct.block_thomas_solve_resume``): the forward pass
    restarts at line ``m - resume`` from the carry ``t_cached[m - resume - 1]``
    and the backward pass is a full one.  The caches are those of
    :func:`solve_cached` for the same number of right-hand sides and are left
    as they were.  ``resume <= 0`` or ``>= m`` is a full solve."""
    m = fac.m
    if resume <= 0 or resume >= m:
        return solve(fac, s_idx, b)
    s = _one_slab(fac, s_idx)
    j0 = m - resume
    # lines < j0 of the y stack are the cached ones; those of the t stack are
    # read by nothing
    out = (y_cached[None].clone(), torch.empty_like(t_cached[None]))
    y4, _ = forward_substitution_cached(
        fac, s, _rows_of(fac, b), t_init=t_cached[None, j0 - 1], start=j0, out=out)
    return _backward_to_grid(fac, s, y4, b)
