"""Plane-pivot substitution for the 3D block-Thomas solves: CUDA kernels +
plain twins.

Counterpart of the JAX package's ``sparse/pallas_plane.py``.  A 3D stencil
matrix is block tridiagonal over its z-planes; its factorization
(``sparse/direct.py:factor_stencil_3d``) keeps one dense (mn x mn) pivot
inverse per plane and the 9-tap in-plane couplings between planes.  The
substitution passes stream those planes, and three TPU kernels are rewritten
by hand for Hopper in CUDA C++:

* ``csrc/plane_fwd.cu``: one whole forward pass over a slab's planes
  (``_fwd_slab_kernel``), with ``start``, an initial carry and the t stack;
* ``csrc/plane_bwd.cu``: one whole backward pass (``_bwd_slab_kernel``),
  with ``tail``;

  both on the flag-handoff plane step: one CTA an SM, whose t tiles and y
  lanes travel as flagged words of the stream's exchange buffer
  (:func:`take_words`, the buffer and launch counter of
  :func:`~.thomas_kernels.exchange_for`);
* ``csrc/plane_apply.cu``: one plane apply ``[Yr; Yi] @ P[k]``
  (``_plane_kernel``), the per-plane branch of the scans for stacks too wide
  for the fused passes.

The shared body and the design note are in ``csrc/plane_pass.cuh``.  Each
kernel has two storage modes, as the TPU kernels have:

* **bf16**: the pivot inverses of all planes of all slabs form one flat
  stack, TRANSPOSED, in bf16 real and imaginary planes, padded to
  ``ld = round_up(mn, 8)`` (not the TPU's 128 lanes) and tile-major,
  ``p_re[s, t, i_in, l] = Re Cinv_s^T[i_in, 8 t + l]``;
* **int8**: the same layout in int8 with ``ld = round_up(mn, 128)``, and one
  f32 scale per (128-row input block, output lane), tile-major too,
  ``scale[s, t, b, part, l]`` (part 0: real, 1: imaginary); an entry counts
  as ``q * scale[.., i_in // 128, ..]``.  The quantization is the JAX
  package's (``direct._quantize_t_int8``).

Right-hand sides ride as f32 rows stacked ``[re_0..re_{r-1};
im_0..im_{r-1}]``; the in-plane coupling stencils as packed flat weight rows
(``_pack_sten_rows``) that are zero wherever a tap leaves the plane.

Each wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version only for a tensor that lies on the CPU.  On the card a
launch takes r = 1, 2, 4 or 8 right-hand sides, each pivot plane read once for
all of them (r = 4 and 8 multiply on tensor cores: ``csrc/plane_pass.cuh``,
note 4); the wrappers pad other r up to 8 with zero columns and run more, or
more than a fused pass takes on the stack (:func:`fused_width`), as groups,
one launch each (``thomas_kernels.in_rhs_groups``).  Each wrapper counts its
launches by plane storage (``.launches["bf16"]``, ``.launches["int8"]``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build
from fast_solver_lippmann_schwinger_tpu_torch.sparse.thomas_kernels import (
    LEAD_MULTIPLE,
    SMEM_PER_BLOCK,
    Exchange,
    _round_up,
    dense_planes,
    exchange_for,
    in_rhs_groups,
    launch_width,
    tile_planes,
)

MAX_RHS = 8                  # right-hand sides per launch (csrc: kMaxRhs)
TAPS = 9
INT8_BLOCK = 128             # input rows per int8 scale (csrc: kScaleBlock)
# the widths the fused passes take, by the shared memory budget of a block of
# the grid-barrier step they ran before (csrc: pass_smem_bytes): the ring of
# 4 chunks x 2 planes x 4096 B (with 4 x 2 x 8 f32 scales per int8 chunk),
# the staged y_p (2r x ld floats) and the reduction; an H100 grants a block
# at most 232,448 bytes.  The flag-handoff step keeps these widths: at each
# its ring, sized per launch, still takes at least 4 chunks
_RING_BYTES = {"bf16": 4 * 2 * 4096, "int8": 4 * (2 * 4096 + 4 * 2 * 8 * 4)}
# the widest plane of a wide launch (r = 4, 8), by storage and launch width.
# The wide step takes more (csrc: max_tiles, wide_ring: at most 4 tiles a
# CTA at r = 8 and 8 at r = 4 over an H100's 132 CTAs, ld <= 4224 and 8448);
# the widths stay fixed so that the CPU and the card take the same branch
_WIDE_WIDEST = {"bf16": {4: 6352, 8: 3104}, "int8": {4: 6272, 8: 3072}}

# slots of each kind of word in a fused pass's exchange buffer (y lanes and
# t tiles; csrc: kWordSlots): a fast CTA writes plane s + 1's words while a
# slow one still reads plane s's
WORD_SLOTS = 2
WORD_KINDS = 2

_P, _I, _U = cuda_build.PTR, cuda_build.INT, cuda_build.UINT
cuda_build.register("plane_fwd", "plane_forward", [_P] * 8 + [_I] * 7 + [_P, _U, _P])
cuda_build.register("plane_bwd", "plane_backward", [_P] * 7 + [_I] * 7 + [_P, _U, _P])
cuda_build.register("plane_apply", "plane_apply", [_P] * 5 + [_I] * 4 + [_P])


# version of the PlaneStack layout below; checkpoints of slab plane stacks
# are keyed on it, so a change of layout must bump it
LAYOUT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class PlaneStack:
    """Flat (slab * plane) stack of transposed plane-pivot inverses.

    Counterpart of the JAX package's ``PallasPlaneStack``: ``p_*[f]`` holds
    ``Cinv[f // l1][f % l1]`` transposed, tile-major (see
    :func:`~.thomas_kernels.tile_planes`), in bf16 (``scale`` is ``None``)
    or in int8 with its scales; padding is zero (scale 1).
    """

    p_re: torch.Tensor    # (SL, ld/8, ld, 8) bfloat16 or int8
    p_im: torch.Tensor
    mn: int               # true plane size
    l1: int               # planes per slab
    scale: torch.Tensor | None = None    # int8: (SL, ld/8, ld/128, 2, 8) float32

    @property
    def ld(self) -> int:
        return self.p_re.shape[2]

    @property
    def n_planes(self) -> int:
        return self.p_re.shape[0]

    @property
    def storage(self) -> str:
        return "bf16" if self.scale is None else "int8"

    @property
    def nbytes(self) -> int:
        """Device bytes of the planes and scales."""
        return sum(t.numel() * t.element_size()
                   for t in (self.p_re, self.p_im, self.scale) if t is not None)


@dataclasses.dataclass(frozen=True)
class PlaneSlabView:
    """One slab's factorization view: the shared plane stack, this slab's
    inter-plane couplings and its first plane in the stack.  Drop-in for the
    ``direct.py`` 3D scans (which read ``lsten``/``usten`` and call
    ``_pivot_apply_3d`` per plane).

    ``lrows``/``urows`` are the couplings packed as the fused kernels read
    them (:func:`_pack_sten_rows`), once, at construction.  ``fused=False``
    sends the scans through the per-plane branch (one ``plane_apply`` per
    plane) whatever the stack's width.
    """

    stack: PlaneStack
    lsten: torch.Tensor           # (l1, m, n, 3, 3) couplings to plane p-1
    usten: torch.Tensor           # (l1, m, n, 3, 3) couplings to plane p+1
    base: int = 0                 # slab * l1
    fused: bool = True
    lrows: torch.Tensor | None = None    # (l1, 2, 9, ld) float32
    urows: torch.Tensor | None = None

    def __post_init__(self):
        if self.lrows is None:
            object.__setattr__(self, "lrows", _pack_sten_rows(self.lsten, self.stack.ld))
        if self.urows is None:
            object.__setattr__(self, "urows", _pack_sten_rows(self.usten, self.stack.ld))


def stack_ld(mn: int, storage: str) -> int:
    """Padded plane width of a stack: a multiple of 8 lanes (bf16) or of the
    128-row scale blocks (int8)."""
    return _round_up(mn, INT8_BLOCK if storage == "int8" else LEAD_MULTIPLE)


def empty_plane_stack(n_planes: int, mn: int, l1: int, storage: str, device) -> PlaneStack:
    """An uninitialised stack of ``n_planes`` planes, filled by
    :func:`pack_planes`."""
    if storage not in ("bf16", "int8"):
        raise ValueError(f"unknown plane storage {storage!r}")
    ld = stack_ld(mn, storage)
    dtype = torch.bfloat16 if storage == "bf16" else torch.int8
    shape = (n_planes, ld // LEAD_MULTIPLE, ld, LEAD_MULTIPLE)
    scale = None
    if storage == "int8":
        scale = torch.empty((n_planes, ld // LEAD_MULTIPLE, ld // INT8_BLOCK, 2, LEAD_MULTIPLE),
                            dtype=torch.float32, device=device)
    return PlaneStack(p_re=torch.empty(shape, dtype=dtype, device=device),
                      p_im=torch.empty(shape, dtype=dtype, device=device),
                      mn=mn, l1=l1, scale=scale)


def _tile_scales(s: torch.Tensor, ld: int) -> torch.Tensor:
    """(nb, mn) scales of one plane part -> (ld/8, nb, 8), padding 1."""
    s = F.pad(s, (0, ld - s.shape[-1]), value=1.0)
    return s.reshape(s.shape[0], ld // LEAD_MULTIPLE, LEAD_MULTIPLE).transpose(0, 1)


def pack_planes(stack: PlaneStack, first: int, fac) -> None:
    """Write the planes of ONE unbatched 3D factorization (full, bf16 or int8
    storage; full and bf16 into a bf16 stack, int8 into an int8 stack) into
    ``stack`` from flat plane ``first`` on, in place, one plane at a time,
    which bounds the temporaries to one dense plane.

    Full pivots are rounded complex -> f32 -> bf16, as the JAX package
    rounds them, so the planes are bit-equal to its stack away from the
    padding.  int8 planes arrive already transposed with their input axis
    padded to a multiple of 128 (``direct._quantize_t_int8``)."""
    mn, ld = stack.mn, stack.ld
    int8 = hasattr(fac, "q_re")
    if int8 != (stack.storage == "int8"):
        raise ValueError(f"a {'int8' if int8 else 'bf16/full'} factorization cannot be packed "
                         f"into a {stack.storage} stack")
    dense = torch.zeros((ld, ld), dtype=stack.p_re.dtype, device=stack.p_re.device)
    for k in range(_pivots(fac)[0].shape[0]):
        if int8:
            parts = (fac.q_re[k], fac.q_im[k])
            if tuple(parts[0].shape) != (ld, mn):
                raise ValueError(f"int8 planes {tuple(parts[0].shape)} must be ({ld}, {mn})")
            stack.scale[first + k, :, :, 0] = _tile_scales(fac.s_re[k], ld)
            stack.scale[first + k, :, :, 1] = _tile_scales(fac.s_im[k], ld)
        elif hasattr(fac, "cinv_re"):
            parts = (fac.cinv_re[k].T, fac.cinv_im[k].T)
        else:
            parts = (fac.cinv[k].real.float().T, fac.cinv[k].imag.float().T)
        for dst, part in zip((stack.p_re, stack.p_im), parts):
            dense[: part.shape[0], :mn] = part.to(dense.dtype)
            dst[first + k] = tile_planes(dense)


def build_plane_stack(fac, batched: bool = True) -> PlaneStack:
    """Convert a 3D plane factorization (full, bf16 or int8 storage, with a
    leading slab axis when ``batched``) to the kernels' stack layout: full
    and bf16 pivots to a bf16 stack, int8 pivots to an int8 stack.  Planes are
    packed one at a time (:func:`pack_planes`), so the stack is never held
    twice."""
    pivots = _pivots(fac)
    storage = "int8" if hasattr(fac, "q_re") else "bf16"
    first = pivots[0] if batched else pivots[0][None]
    S, l1, mn = first.shape[0], first.shape[1], first.shape[-1]
    stack = empty_plane_stack(S * l1, mn, l1, storage, first.device)
    for s in range(S):
        slab = fac if not batched else dataclasses.replace(
            fac, **{name: getattr(fac, name)[s] for name in _pivot_fields(fac)})
        pack_planes(stack, s * l1, slab)
    return stack


def _pivot_fields(fac) -> tuple:
    """Names of a 3D factorization's pivot fields, by storage."""
    if hasattr(fac, "q_re"):
        return ("q_re", "q_im", "s_re", "s_im")
    return ("cinv_re", "cinv_im") if hasattr(fac, "cinv_re") else ("cinv",)


def _pivots(fac) -> tuple:
    return tuple(getattr(fac, name) for name in _pivot_fields(fac))


def _slab_slice(fac, s: int):
    """Slab ``s`` of a batched factorization (every field sliced)."""
    return type(fac)(**{f.name: getattr(fac, f.name)[s] for f in dataclasses.fields(fac)})


def plane_view(fac) -> PlaneSlabView:
    """The view of one unbatched 3D factorization (full, bf16 or int8 pivots)
    with its pivots packed as a plane stack."""
    return PlaneSlabView(stack=build_plane_stack(fac, batched=False),
                         lsten=fac.lsten, usten=fac.usten)


def _pack_sten_rows(sten: torch.Tensor, ld: int) -> torch.Tensor:
    """(P, a, b, 3, 3) complex in-plane coupling stencils -> (P, 2, 9, ld)
    f32 flat weight rows, zeroed where tap targets fall outside the plane."""
    P, a, b = sten.shape[0], sten.shape[1], sten.shape[2]
    w = sten.permute(0, 3, 4, 1, 2)                  # (P, 3, 3, a, b)
    jj = np.arange(a)[:, None]
    ii = np.arange(b)[None, :]
    masks = np.zeros((3, 3, a, b), bool)
    for dj in range(3):
        for di in range(3):
            tj, ti = jj + dj - 1, ii + di - 1
            masks[dj, di] = (tj >= 0) & (tj < a) & (ti >= 0) & (ti < b)
    w = torch.where(torch.as_tensor(masks, device=sten.device)[None], w, 0)
    w = w.reshape(P, TAPS, a * b)
    w = torch.stack([w.real.float(), w.imag.float()], dim=1)   # (P, 2, 9, mn)
    return F.pad(w, (0, ld - a * b)).contiguous()


def _rows_of(bg: torch.Tensor, ld: int) -> torch.Tensor:
    """(P, mn[, r]) complex -> (P, 2r, ld) f32 stacked [re rows; im rows]."""
    P, mn = bg.shape[0], bg.shape[1]
    b2 = bg.reshape(P, mn, -1)
    rows = torch.cat([b2.real, b2.imag], dim=-1).float().transpose(1, 2)   # (P, 2r, mn)
    return F.pad(rows, (0, ld - mn)).contiguous()


def _unrows(rows: torch.Tensor, mn: int, dtype, shape) -> torch.Tensor:
    r = rows.shape[1] // 2
    x = torch.complex(rows[:, :r, :mn], rows[:, r:, :mn]).to(dtype)
    return x.transpose(1, 2).reshape(shape)


def fused_fits(stack: PlaneStack, r: int) -> bool:
    """Whether one fused pass takes ``r <= MAX_RHS`` right-hand sides on this
    stack (at the launch width of r): at widths 1 and 2 the staged y_p with
    the pivot-column ring (and its int8 scales) fits one block's shared
    memory on an H100, at widths 4 and 8 the plane is no wider than
    ``_WIDE_WIDEST`` (bf16: ld <= 24928, 12448, 6352 and 3104 at widths 1,
    2, 4 and 8; int8: 24704, 12288, 6272 and 3072)."""
    if r > MAX_RHS:
        return False
    w = launch_width(r)
    if w > 2:
        return stack.ld <= _WIDE_WIDEST[stack.storage][w]
    smem = _RING_BYTES[stack.storage] + 4 * 2 * w * stack.ld + 4 * 4 * 2 * w * LEAD_MULTIPLE
    return smem <= SMEM_PER_BLOCK


def fused_width(stack: PlaneStack, r: int) -> int:
    """Right-hand sides of one fused launch for a batch of ``r`` on this
    stack: the launch width of ``min(r, MAX_RHS)``, halved while a pass does
    not fit it; 0 where not even one fits (the scans then take the per-plane
    branch, which takes any width).  The answer depends on shapes only, so
    the CPU and the card take the same branch (``direct._fused``)."""
    width = launch_width(min(r, MAX_RHS))
    while width and not fused_fits(stack, width):
        width //= 2
    return width


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tests; yardstick on the card)
# ---------------------------------------------------------------------------


def _sten_apply_rows(w: torch.Tensor, t: torch.Tensor, n: int, mn: int):
    """9-tap in-plane stencil on stacked [re; im] rows: w (2, 9, ld) packed by
    :func:`_pack_sten_rows`, t (2r, ld); returns (accr, acci).  Lane f takes
    ``t[f + dj n + di]``, zero outside [0, mn) (where the weight is zero)."""
    r = t.shape[0] // 2
    ld = t.shape[1]
    tp = F.pad(t[:, :mn], (n + 1, ld - mn + n + 1))
    accr = torch.zeros_like(t[:r])
    acci = torch.zeros_like(t[:r])
    d = 0
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            off = n + 1 + dj * n + di
            s = tp[:, off : off + ld]
            sr, si = s[:r], s[r:]
            wr, wi = w[0, d][None, :], w[1, d][None, :]
            accr = accr + wr * sr - wi * si
            acci = acci + wr * si + wi * sr
            d += 1
    return accr, acci


def _dequant(p: torch.Tensor, scale: torch.Tensor | None, part: int) -> torch.Tensor:
    """One tile-major (ld/8, ld, 8) plane as a dense f32 (ld, ld) copy: bf16
    widened, or int8 times its (ld/8, nb, 2, 8) scales, element by element."""
    dense = dense_planes(p).float()
    if scale is None:
        return dense
    s = scale[:, :, part].transpose(0, 1).reshape(scale.shape[1], -1)     # (nb, ld)
    return dense * s.repeat_interleave(INT8_BLOCK, dim=0)


def _dot_plane(y: torch.Tensor, pre: torch.Tensor, pim: torch.Tensor,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """[Yr; Yi] @ P with complex recombination; y (2r, ld) f32, tile-major
    (ld/8, ld, 8) planes dequantized to dense f32 copies BEFORE the product
    (the Pallas kernel's order, ``pallas_plane.py:_dot_plane``)."""
    r = y.shape[0] // 2
    z1 = y @ _dequant(pre, scale, 0)
    z2 = y @ _dequant(pim, scale, 1)
    return torch.cat([z1[:r] - z2[r:], z1[r:] + z2[:r]], dim=0)


def _plane(stack: PlaneStack, idx: int):
    return (stack.p_re[idx], stack.p_im[idx],
            None if stack.scale is None else stack.scale[idx])


def plane_apply_rows_plain(stack: PlaneStack, idx: int, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`plane_apply_rows`."""
    return _dot_plane(rows, *_plane(stack, idx))


def plane_forward_plain(stack: PlaneStack, b4, w4, n: int, base: int = 0, start: int = 0,
                        t_init=None, out=None, collect_t: bool = True):
    """Plain version of :func:`plane_forward`: a Python loop over the planes
    with ``torch.matmul``."""
    if out is None:
        out = (torch.zeros_like(b4), torch.zeros_like(b4) if collect_t else None)
    y4, t4 = out
    t = t_init
    for p in range(start, b4.shape[0]):
        y = b4[p].clone()
        y[:, stack.mn:] = 0
        if t is not None:
            accr, acci = _sten_apply_rows(w4[p], t, n, stack.mn)
            y = y - torch.cat([accr, acci], dim=0)
        t = _dot_plane(y, *_plane(stack, base + p))
        y4[p] = y
        if t4 is not None:
            t4[p] = t
    return y4, t4


def plane_backward_plain(stack: PlaneStack, y4, w4, n: int, base: int = 0, start: int = 0,
                         out=None):
    """Plain version of :func:`plane_backward`."""
    x4 = out if out is not None else torch.zeros_like(y4)
    x = None
    for p in range(y4.shape[0] - 1, start - 1, -1):
        w = y4[p].clone()
        w[:, stack.mn:] = 0
        if x is not None:
            accr, acci = _sten_apply_rows(w4[p], x, n, stack.mn)
            w = w - torch.cat([accr, acci], dim=0)
        x = _dot_plane(w, *_plane(stack, base + p))
        x4[p] = x
    return x4


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_f32(name: str, t: torch.Tensor, shape, device):
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 tensor of shape "
                         f"{tuple(shape)} on {device}")


def _check_stack(stack: PlaneStack, device, planes: range):
    dtype = torch.bfloat16 if stack.scale is None else torch.int8
    for t in (stack.p_re, stack.p_im):
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"{stack.storage} pivot planes must be contiguous {dtype} "
                             f"tensors on {device}")
    if stack.ld % (LEAD_MULTIPLE if stack.scale is None else INT8_BLOCK):
        raise ValueError(f"{stack.storage} planes of width {stack.ld} are not padded to "
                         f"a multiple of the {stack.storage} tile")
    if stack.scale is not None:
        shape = (stack.n_planes, stack.ld // LEAD_MULTIPLE, stack.ld // INT8_BLOCK, 2,
                 LEAD_MULTIPLE)
        _check_f32("int8 scales", stack.scale, shape, device)
    if planes and (planes.start < 0 or planes[-1] >= stack.n_planes):
        raise ValueError(f"pivot planes {planes} outside the stack of {stack.n_planes}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _count(fn, stack: PlaneStack):
    fn.launches["bf16" if stack.scale is None else "int8"] += 1


def _check_rhs(rows: torch.Tensor, stack: PlaneStack) -> int:
    if rows.ndim < 2 or rows.shape[-1] != stack.ld or rows.shape[-2] % 2 or rows.shape[-2] < 2:
        raise ValueError(f"rows {tuple(rows.shape)} must be (..., 2r, {stack.ld})")
    return rows.shape[-2] // 2


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def take_words(ex: Exchange, ld: int, r: int, planes: int):
    """The exchange buffer of one fused pass over ``planes`` plane steps of
    width ``ld`` and its first flag.  The pass reads and writes
    :data:`WORD_SLOTS` slots each of y words and t words, one word (value,
    flag) per lane and row, (ld, 2r) each; plane step s publishes
    flag ``epoch + s``, so every launch takes ``planes`` fresh flags from
    the counter that the stream's line kernels draw from too."""
    return ex.take(1, r, ld, planes, slots=WORD_KINDS * WORD_SLOTS)


def plane_apply_rows(stack: PlaneStack, idx: int, rows: torch.Tensor) -> torch.Tensor:
    """``[Yr; Yi] @ P[idx]`` with complex recombination: rows (2r, ld) f32 ->
    (2r, ld) f32.  ``idx`` is the flat plane index in the stack."""
    r = _check_rhs(rows, stack)
    _check_f32("rows", rows, (2 * r, stack.ld), rows.device)
    _check_stack(stack, rows.device, range(idx, idx + 1))
    if not rows.is_cuda:
        return plane_apply_rows_plain(stack, idx, rows)
    width = launch_width(min(r, MAX_RHS))
    if width != r:
        return in_rhs_groups(lambda y: plane_apply_rows(stack, idx, y), r, (rows,), width=width)
    out = torch.empty_like(rows)
    err = cuda_build.load("plane_apply")(
        rows.data_ptr(), stack.p_re.data_ptr(), stack.p_im.data_ptr(), _ptr(stack.scale),
        out.data_ptr(), stack.mn, stack.ld, r, idx,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _raise_on(err, "plane_apply")
    _count(plane_apply_rows, stack)
    return out


def plane_forward(stack: PlaneStack, b4: torch.Tensor, w4: torch.Tensor, n: int,
                  base: int = 0, start: int = 0, t_init: torch.Tensor | None = None,
                  out=None, collect_t: bool = True):
    """Forward substitution over planes ``start..l-1`` of one slab in ONE
    launch: ``y_p = b_p - S_p(t_{p-1})``, ``t_p = y_p . P[base + p]``, from
    the carry ``t_init`` (2r, ld) = ``t_{start-1}`` (zero when ``None``).

    ``b4`` (l, 2r, ld) f32 rows, ``w4`` (l, 2, 9, ld) packed couplings to the
    plane before, ``n`` the plane's fast axis.  Returns ``(y4, t4)``, each
    (l, 2r, ld); ``t4`` is ``None`` unless ``collect_t``.  Planes
    ``< start``: the kernel neither reads nor writes them; with ``out=(y4, t4)`` (``t4`` a stack or
    ``None``, which decides ``collect_t``) planes ``>= start`` are written IN
    PLACE and the others keep what the caller put there, without ``out`` the
    stacks are new and zero there.  Padding lanes of ``t_init`` count as
    zero."""
    r = _check_rhs(b4, stack)
    l = b4.shape[0]
    dev = b4.device
    _check_f32("b4", b4, (l, 2 * r, stack.ld), dev)
    _check_f32("w4", w4, (l, 2, TAPS, stack.ld), dev)
    _check_stack(stack, dev, range(base + start, base + l))
    if not 0 <= start < l:
        raise ValueError(f"start={start} outside [0, {l})")
    if t_init is not None:
        _check_f32("t_init", t_init, (2 * r, stack.ld), dev)
    if out is None:
        out = (torch.empty_like(b4), torch.empty_like(b4) if collect_t else None)
        if start:
            for s in out:
                if s is not None:
                    s[:start] = 0
    y4, t4 = out
    _check_f32("out[0]", y4, b4.shape, dev)
    if t4 is not None:
        _check_f32("out[1]", t4, b4.shape, dev)
    if not b4.is_cuda:
        return plane_forward_plain(stack, b4, w4, n, base, start, t_init, out)
    width = fused_width(stack, r) or 1
    if width != r:
        return in_rhs_groups(
            lambda b, t, out: plane_forward(stack, b, w4, n, base, start, t, out),
            r, (b4, t_init), out, width=width)
    xchg, epoch = take_words(exchange_for(b4), stack.ld, r, l - start)
    err = cuda_build.load("plane_fwd")(
        b4.data_ptr(), w4.data_ptr(), stack.p_re.data_ptr(), stack.p_im.data_ptr(),
        _ptr(stack.scale), _ptr(t_init), y4.data_ptr(), _ptr(t4),
        l, stack.mn, n, stack.ld, r, base, start, xchg.data_ptr(), epoch,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "plane_forward")
    _count(plane_forward, stack)
    return out


def plane_backward(stack: PlaneStack, y4: torch.Tensor, w4: torch.Tensor, n: int,
                   base: int = 0, start: int = 0, out=None) -> torch.Tensor:
    """Backward substitution over planes ``l-1`` down to ``start`` of one slab
    in ONE launch: ``x_p = (y_p - S'_p(x_{p+1})) . P[base + p]``, ``x_l = 0``.

    ``w4`` holds the packed couplings to the plane after.  Returns the x
    stack (l, 2r, ld): ``out`` written in place on planes ``>= start`` when
    given, else a new stack that is zero on planes ``< start``."""
    r = _check_rhs(y4, stack)
    l = y4.shape[0]
    dev = y4.device
    _check_f32("y4", y4, (l, 2 * r, stack.ld), dev)
    _check_f32("w4", w4, (l, 2, TAPS, stack.ld), dev)
    _check_stack(stack, dev, range(base + start, base + l))
    if not 0 <= start < l:
        raise ValueError(f"start={start} outside [0, {l})")
    if out is None:
        out = torch.empty_like(y4)
        if start:
            out[:start] = 0
    _check_f32("out", out, y4.shape, dev)
    if not y4.is_cuda:
        return plane_backward_plain(stack, y4, w4, n, base, start, out)
    width = fused_width(stack, r) or 1
    if width != r:
        return in_rhs_groups(lambda y, out: plane_backward(stack, y, w4, n, base, start, out),
                             r, (y4,), out, width=width)
    xchg, epoch = take_words(exchange_for(y4), stack.ld, r, l - start)
    # wide launches hand each plane's rows y_p - S'_p(x_{p+1}) over in a
    # two-plane scratch (csrc/plane_pass.cuh, note 4)
    scratch = y4.new_empty((2, 2 * r, stack.ld)) if r > 2 else None
    err = cuda_build.load("plane_bwd")(
        y4.data_ptr(), w4.data_ptr(), stack.p_re.data_ptr(), stack.p_im.data_ptr(),
        _ptr(stack.scale), out.data_ptr(), _ptr(scratch), l, stack.mn, n, stack.ld, r, base,
        start, xchg.data_ptr(), epoch, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "plane_backward")
    _count(plane_backward, stack)
    return out


# launch counts: one per wrapper call that launched its kernel, by plane storage
for _fn in (plane_apply_rows, plane_forward, plane_backward):
    _fn.launches = dict.fromkeys(("bf16", "int8"), 0)


# ---------------------------------------------------------------------------
# The scans' entry points (``direct.py`` dispatches here for a view)
# ---------------------------------------------------------------------------


def plane_apply(view, k: int, y: torch.Tensor) -> torch.Tensor:
    """``C_k^{-1} y`` through the stack; ``view`` is a :class:`PlaneSlabView`
    (or a bare stack with base 0), ``k`` the plane index within the slab,
    ``y`` (mn[, r]) complex."""
    stack, base = (view.stack, view.base) if hasattr(view, "stack") else (view, 0)
    mn = stack.mn
    y2 = y.reshape(mn, -1)
    r = y2.shape[1]
    rows = _rows_of(y2[None], stack.ld)[0]
    z = plane_apply_rows(stack, base + k, rows)
    out = torch.complex(z[:r, :mn].T, z[r:, :mn].T).to(y.dtype)
    return out.reshape(y.shape)


def fwd_scan_fused(view: PlaneSlabView, bg: torch.Tensor, start: int = 0, t_start=None,
                   collect_t: bool = False):
    """Fused forward substitution over planes ``start..l-1`` of one slab:
    drop-in for ``direct._fwd_scan_3d`` on a :class:`PlaneSlabView`; returns
    ``(y stack, t stack or None)`` over those planes, in plane order."""
    stack = view.stack
    l = view.lsten.shape[0]
    mn, ld = stack.mn, stack.ld
    dtype = view.lsten.dtype
    rows = _rows_of(bg, ld)
    t0 = None if t_start is None else _rows_of(t_start[None], ld)[0]
    y4, t4 = plane_forward(stack, rows, view.lrows, view.lsten.shape[2], view.base, start, t0,
                           collect_t=collect_t)
    shape = (l - start,) + tuple(bg.shape[1:])
    y = _unrows(y4[start:], mn, dtype, shape)
    return y, (_unrows(t4[start:], mn, dtype, shape) if collect_t else None)


def bwd_scan_fused(view: PlaneSlabView, y: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """Fused backward substitution: drop-in for ``direct._bwd_scan_3d`` on a
    :class:`PlaneSlabView`; ``0 < tail < l`` computes only the last planes
    (zeros elsewhere, exact: the recursion starts at the true last plane)."""
    stack = view.stack
    l = view.usten.shape[0]
    start = 0 if tail <= 0 or tail >= l else l - tail
    x4 = plane_backward(stack, _rows_of(y, stack.ld), view.urows, view.usten.shape[2],
                        view.base, start)
    return _unrows(x4, stack.mn, view.usten.dtype, tuple(y.shape))
