"""Carry the JAX package's objects across to the port.

Every function takes the JAX object's fields AS NUMPY ARRAYS (the caller
does the ``np.asarray``; this module imports nothing of JAX) and returns the
port's counterpart on ``device``: the CUDA card by default (an error when
there is none), the CPU only for ``device="cpu"``.  With these the parity
tests feed the same symbol, stencils, pivots and slab system to both packages.

bfloat16 planes arrive as their raw bit patterns in a ``numpy.uint16`` array
(``np.asarray(x).view(np.uint16)`` on the JAX side): numpy has no native
bfloat16, and a float32 detour would hide whether the planes are bit-equal.
int8 planes and their float32 scales arrive as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.config import (
    real_dtype_of,
    resolve_device,
    to_tensor,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized import (
    PolarizedTracesPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized3d import (
    PolarizedTracesPreconditioner3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import SlabSystem
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain3d import SlabSystem3D
from fast_solver_lippmann_schwinger_tpu_torch.ddm.sweeps import DoubleSweepPreconditioner
from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
    LippmannSchwinger2D,
    LippmannSchwinger3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.models.bump2d import Bump2DProblem
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner,
    SparsifyingPreconditioner3D,
    SparsifyingPreconditionerT,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    BlockTridiagFactorization,
    BlockTridiagFactorizationBanded,
    BlockTridiagFactorizationBandedLR,
    BlockTridiagFactorizationBandedTail,
    BlockTridiagFactorizationBF16,
    BlockTridiagFactorization3D,
    BlockTridiagFactorization3DBF16,
    BlockTridiagFactorization3DInt8,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import (
    INT8_BLOCK,
    PlaneSlabView,
    PlaneStack,
    stack_ld,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import (
    StencilMatrix2D,
    StencilMatrix3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.thomas_kernels import (
    LEAD_MULTIPLE,
    BandedTailFactorization,
    ThomasFactorization,
    _round_up,
    n_scale_blocks,
    tile_planes,
    tile_scales,
)


def _complex_dtype(arr: np.ndarray) -> torch.dtype:
    return torch.complex128 if np.asarray(arr).dtype == np.complex128 else torch.complex64


def lippmann_schwinger_2d(symbol, nu, omega, n, m, quad_rule,
                          device=None) -> LippmannSchwinger2D:
    """``LippmannSchwinger2D`` from the JAX operator's fields."""
    device = resolve_device(device)
    dtype = _complex_dtype(symbol)
    return LippmannSchwinger2D(
        symbol=to_tensor(symbol, dtype, device),
        nu=to_tensor(nu, real_dtype_of(dtype), device),
        omega=float(omega), n=int(n), m=int(m), quad_rule=str(quad_rule),
    )


def stencil_matrix_2d(values, device=None) -> StencilMatrix2D:
    """``StencilMatrix2D`` from a (m, n, 3, 3) complex ``values`` array."""
    device = resolve_device(device)
    return StencilMatrix2D(values=to_tensor(values, _complex_dtype(values), device))


def block_tridiag_factorization(cinv, lband, uband,
                                device=None) -> BlockTridiagFactorization:
    """Dense factorization from ``(cinv, lband, uband)``; leading slab axes
    are kept as they are."""
    device = resolve_device(device)
    dtype = _complex_dtype(lband)
    return BlockTridiagFactorization(
        cinv=to_tensor(cinv, dtype, device),
        lband=to_tensor(lband, dtype, device),
        uband=to_tensor(uband, dtype, device),
    )


def block_tridiag_factorization_bf16(cinv_re, cinv_im, lband, uband,
                                     device=None) -> BlockTridiagFactorizationBF16:
    """bf16-plane factorization (``pivot_dtype="bf16"``) from the JAX one's
    fields: ``cinv_re``/``cinv_im`` as uint16 bit patterns, the bands
    complex; leading slab axes are kept as they are."""
    device = resolve_device(device)
    dtype = _complex_dtype(lband)
    return BlockTridiagFactorizationBF16(
        cinv_re=_bf16(cinv_re).to(device), cinv_im=_bf16(cinv_im).to(device),
        lband=to_tensor(lband, dtype, device), uband=to_tensor(uband, dtype, device),
    )


def block_tridiag_factorization_banded(band_re, band_im, lband, uband,
                                       device=None) -> BlockTridiagFactorizationBanded:
    """Band-compressed factorization (``pivot_dtype="banded"``) from the JAX
    one's fields: the (..., m, n, w) band planes as uint16 bit patterns, the
    bands complex; leading slab axes are kept as they are."""
    device = resolve_device(device)
    dtype = _complex_dtype(lband)
    return BlockTridiagFactorizationBanded(
        band_re=_bf16(band_re).to(device), band_im=_bf16(band_im).to(device),
        lband=to_tensor(lband, dtype, device), uband=to_tensor(uband, dtype, device),
    )


def block_tridiag_factorization_banded_lr(band_re, band_im, u_re, u_im, v_re, v_im, lband,
                                          uband, device=None) -> BlockTridiagFactorizationBandedLR:
    """Band + low-rank factorization (``pivot_dtype="banded_lr"``) from the
    JAX one's fields, every bf16 plane as uint16 bit patterns."""
    device = resolve_device(device)
    dtype = _complex_dtype(lband)
    planes = dict(band_re=band_re, band_im=band_im, u_re=u_re, u_im=u_im, v_re=v_re, v_im=v_im)
    return BlockTridiagFactorizationBandedLR(
        **{name: _bf16(bits).to(device) for name, bits in planes.items()},
        lband=to_tensor(lband, dtype, device), uband=to_tensor(uband, dtype, device),
    )


def block_tridiag_factorization_banded_tail(band_re, band_im, tail_re, tail_im, lband, uband,
                                            tail_start, device=None
                                            ) -> BlockTridiagFactorizationBandedTail:
    """Tail-dense hybrid factorization (``pivot_dtype="banded_tail"``) from
    the JAX one's fields, every bf16 plane as uint16 bit patterns."""
    device = resolve_device(device)
    dtype = _complex_dtype(lband)
    return BlockTridiagFactorizationBandedTail(
        band_re=_bf16(band_re).to(device), band_im=_bf16(band_im).to(device),
        tail_re=_bf16(tail_re).to(device), tail_im=_bf16(tail_im).to(device),
        lband=to_tensor(lband, dtype, device), uband=to_tensor(uband, dtype, device),
        tail_start=int(tail_start),
    )


def factorization_2d(fields: dict, device=None):
    """A 2D factorization in any plain pivot storage from a dict of the JAX
    one's fields, told apart by their names: ``tail_re`` (banded_tail),
    ``u_re`` (banded_lr), ``band_re`` (banded), ``cinv_re`` (bf16), else
    dense (``cinv``)."""
    make = (block_tridiag_factorization_banded_tail if "tail_re" in fields
            else block_tridiag_factorization_banded_lr if "u_re" in fields
            else block_tridiag_factorization_banded if "band_re" in fields
            else block_tridiag_factorization_bf16 if "cinv_re" in fields
            else block_tridiag_factorization)
    return make(**fields, device=device)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bit patterns -> a bfloat16 tensor of the same values."""
    bits = np.asarray(bits)
    if bits.dtype != np.uint16:
        raise TypeError(f"bf16 planes must arrive as uint16 bit patterns, got {bits.dtype}")
    return torch.from_numpy(np.array(bits, copy=True).view(np.int16)).view(torch.bfloat16)


def _bf16_planes(bits: np.ndarray, n: int, ld: int, device) -> torch.Tensor:
    """(..., np, np) uint16 bf16 bit patterns -> tile-major bfloat16 planes
    (..., ld/8, ld, 8), re-padded from the TPU's 128-lane padding to the
    port's."""
    bits = np.asarray(bits)
    if np.any(bits[..., n:, :]) or np.any(bits[..., :, n:]):
        raise ValueError("padding entries of the pivot planes must be zero")
    t = _bf16(bits[..., :n, :n])
    return tile_planes(F.pad(t, (0, ld - n, 0, ld - n))).to(device)


def _int8_line_planes(q, scale, part: int, n: int, ld: int):
    """(S, m, np, np) int8 planes ``[i_in, o_out]`` and their (S, m, 2, nb,
    np) scales -> the port's tile-major int8 planes (S, m, ld/8, ld, 8) and
    the part's scales (S, m, nb, ld), cropped from the 128-lane padding."""
    q = np.asarray(q)
    if q.dtype != np.int8:
        raise TypeError(f"int8 planes arrive as int8 arrays, got {q.dtype}")
    if np.any(q[..., n:, :]) or np.any(q[..., :, n:]):
        raise ValueError("padding entries of the pivot planes must be zero")
    sc = np.asarray(scale, np.float32)[:, :, part, :, :ld]
    if sc.shape[-2] != n_scale_blocks(ld):
        raise ValueError(f"int8 scales {np.shape(scale)} do not fit n = {n}")
    planes = tile_planes(torch.from_numpy(np.ascontiguousarray(q[..., :ld, :ld])))
    return planes, torch.from_numpy(np.ascontiguousarray(sc))


def thomas_factorization(cinv_t_re, cinv_t_im, lband, uband, scale, n,
                         device=None) -> ThomasFactorization:
    """The kernel layout from a ``PallasFactorization``'s fields, bf16 or
    int8.

    bf16: ``cinv_t_re``/``cinv_t_im`` are uint16 bit patterns of the
    (S, m, np, np) planes with ``np = round_up(n, 128)``, and ``scale`` the
    all-ones (nb = 1) scales of bf16 storage.  int8: the planes are int8
    arrays and ``scale`` the (S, m, 2, nb, np) float32 scales.  Bands are
    (S, m, 2, 3, np) float32.  The planes (and scales) come out in the port's
    own tile-major layout at ``ld = round_up(n, 8)``, cropped from the
    128-lane padding.
    """
    device = resolve_device(device)
    n = int(n)
    ld = _round_up(n, LEAD_MULTIPLE)

    def band(b):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(b, np.float32)[..., :n]))
        return F.pad(t, (0, ld - n)).contiguous().to(device)

    if np.asarray(cinv_t_re).dtype == np.int8:
        (pre, sre), (pim, sim) = (_int8_line_planes(q, scale, k, n, ld)
                                  for k, q in enumerate((cinv_t_re, cinv_t_im)))
        return ThomasFactorization(
            cinv_t_re=pre.to(device), cinv_t_im=pim.to(device),
            lband=band(lband), uband=band(uband), n=n,
            scale=tile_scales(sre, sim).to(device),
        )
    scale = np.asarray(scale)
    if scale.shape[-2] != 1 or not np.all(scale == 1.0):
        raise ValueError("bf16 planes carry all-ones scales")
    return ThomasFactorization(
        cinv_t_re=_bf16_planes(cinv_t_re, n, ld, device),
        cinv_t_im=_bf16_planes(cinv_t_im, n, ld, device),
        lband=band(lband), uband=band(uband), n=n,
    )


def banded_tail_factorization(head_re, head_im, tail_re, tail_im, lband, uband, n,
                              tail_start, halo, width, device=None) -> BandedTailFactorization:
    """The hybrid kernel layout from a ``PallasFactorizationBandedTail``'s
    fields.

    ``head_re``/``head_im`` are uint16 bit patterns of the JAX package's
    (S, tail_start, nb, 128 + 2 halo, 128) bf16 blocks: block p, window row w
    holds input row ``128 p - halo + w`` for output lane ``128 p + o``.  They
    are re-windowed into the port's tiles, ``[s, j, t, v, l]`` = input row
    ``8 t - half + v``, output lane ``8 t + l``, bit for bit; every entry the
    port's windows hold lies inside a JAX block.  ``tail_re``/``tail_im`` are
    (S, m - tail_start, np, np) dense planes as for
    :func:`thomas_factorization`; bands (S, m, 2, 3, np) float32.
    """
    device = resolve_device(device)
    n, halo, width = int(n), int(halo), int(width)
    half = width // 2
    ld = _round_up(n, LEAD_MULTIPLE)
    head_re, head_im = np.asarray(head_re), np.asarray(head_im)
    if int(tail_start) != head_re.shape[1] or half > halo:
        raise ValueError("head blocks do not match tail_start, halo and width")
    t = np.arange(ld // LEAD_MULTIPLE)[:, None, None]
    v = np.arange(LEAD_MULTIPLE + 2 * half)[None, :, None]
    lane = np.arange(LEAD_MULTIPLE)[None, None, :]
    out = LEAD_MULTIPLE * t + lane                       # output lane
    p, o = out // 128, out % 128
    w = (LEAD_MULTIPLE * t - half + v) - 128 * p + halo  # JAX window row
    w, p, o = np.broadcast_arrays(w, p, o)

    def window(bits):
        return _bf16(np.ascontiguousarray(bits[:, :, p, w, o])).to(device)

    def band(b):
        b = torch.from_numpy(np.ascontiguousarray(np.asarray(b, np.float32)[..., :n]))
        return F.pad(b, (0, ld - n)).contiguous().to(device)

    return BandedTailFactorization(
        head_re=window(head_re), head_im=window(head_im),
        tail_re=_bf16_planes(tail_re, n, ld, device), tail_im=_bf16_planes(tail_im, n, ld, device),
        lband=band(lband), uband=band(uband), n=n, half=half,
    )


def slab_system(fields: dict, fac: BlockTridiagFactorization | None = None,
                pfac: ThomasFactorization | BandedTailFactorization | None = None,
                device=None) -> SlabSystem:
    """``SlabSystem`` from a dict of the JAX slab system's fields as numpy
    arrays / Python scalars.

    ``fac`` and ``pfac`` are either converted separately and passed in, or
    ride in the dict: ``fields["fac"]`` a dict of the fields of any plain
    pivot storage (:func:`factorization_2d`), and ``fields["pfac"]`` ``None``
    or a dict of those of :func:`thomas_factorization` (bf16 or int8) or, for
    the banded+tail layout (a dict with ``head_re``), of
    :func:`banded_tail_factorization`.
    """
    device = resolve_device(device)
    if fac is None:
        fac = factorization_2d(fields["fac"], device=device)
        p = fields.get("pfac")
        if p is not None:
            make = banded_tail_factorization if "head_re" in p else thomas_factorization
            pfac = make(**p, device=device)
    dtype = _complex_dtype(fields["h_stencils"])
    out = {}
    for f in dataclasses.fields(SlabSystem):
        if f.name in ("fac", "pfac"):
            continue
        v = fields[f.name]
        if f.name in ("n", "m", "n_subs", "m1_max", "trace_tail", "trace_head"):
            out[f.name] = int(v)
        elif f.name in ("has_top", "has_bot", "src_valid"):
            out[f.name] = torch.tensor(np.asarray(v, bool), device=device)
        elif f.name in ("h_stencils", "cpl_01", "cpl_10", "cpl_n_np", "cpl_np_n"):
            out[f.name] = to_tensor(v, dtype, device)
        else:
            out[f.name] = torch.tensor(np.asarray(v, np.int64), device=device)
    return SlabSystem(fac=fac, pfac=pfac, **out)


def double_sweep_preconditioner(slabs: dict, slabs_t: dict, msp_values, a_s_values,
                                device=None) -> DoubleSweepPreconditioner:
    """``DoubleSweepPreconditioner`` from the JAX one's parts: the two slab
    systems as dicts for :func:`slab_system` (with their ``fac`` and ``pfac``
    entries, either kernel layout) and the (m, n, 3, 3) stencil fields of
    ``msp`` and ``a_s``."""
    device = resolve_device(device)
    return DoubleSweepPreconditioner(
        slabs=slab_system(slabs, device=device),
        slabs_t=slab_system(slabs_t, device=device),
        msp=stencil_matrix_2d(msp_values, device=device),
        a_s=stencil_matrix_2d(a_s_values, device=device),
    )


def polarized_traces_preconditioner(slabs: dict, a_s_values, n_it, inner_tol, inner_maxiter,
                                    precond_type, device=None) -> PolarizedTracesPreconditioner:
    """``PolarizedTracesPreconditioner`` from the JAX one's parts: its slab
    system as a dict for :func:`slab_system` (with its ``fac`` and ``pfac``
    entries, either kernel layout), the (m, n, 3, 3) stencil field of
    ``a_s`` and its four scalar settings."""
    device = resolve_device(device)
    return PolarizedTracesPreconditioner(
        slabs=slab_system(slabs, device=device),
        a_s=stencil_matrix_2d(a_s_values, device=device),
        n_it=int(n_it), inner_tol=float(inner_tol), inner_maxiter=int(inner_maxiter),
        precond_type=str(precond_type),
    )


def sparsifying_preconditioner(factorization: dict, a_s_values,
                               device=None) -> SparsifyingPreconditioner:
    """The 2D ``SparsifyingPreconditioner`` from the JAX one's parts: its
    dense factorization's fields as a dict for
    :func:`block_tridiag_factorization` and the (m, n, 3, 3) field of
    ``a_s``."""
    device = resolve_device(device)
    return SparsifyingPreconditioner(
        factorization=block_tridiag_factorization(**factorization, device=device),
        a_s=stencil_matrix_2d(a_s_values, device=device),
    )


def sparsifying_preconditioner_t(factorization: dict, a_s_t_values,
                                 device=None) -> SparsifyingPreconditionerT:
    """``SparsifyingPreconditionerT`` from the JAX one's parts: the dense
    factorization of ``Msp^T`` as a dict and the (m, n, 3, 3) field of
    ``a_s_t`` (the matrix transpose of ``a_s``)."""
    device = resolve_device(device)
    return SparsifyingPreconditionerT(
        factorization=block_tridiag_factorization(**factorization, device=device),
        a_s_t=stencil_matrix_2d(a_s_t_values, device=device),
    )


def bump2d_problem(op: dict, factorization: dict | None, a_s_values, rhs, u_inc, h, k,
                   device=None) -> Bump2DProblem:
    """``Bump2DProblem`` from the JAX one's parts: the operator's fields as a
    dict for :func:`lippmann_schwinger_2d`, the preconditioner's parts as for
    :func:`sparsifying_preconditioner` (``factorization=None``: no
    preconditioner), the rhs and incident field, and the grid step and
    wavenumber."""
    device = resolve_device(device)
    op = lippmann_schwinger_2d(**op, device=device)
    precond = (None if factorization is None
               else sparsifying_preconditioner(factorization, a_s_values, device=device))
    dtype = op.symbol.dtype
    return Bump2DProblem(grid=Grid2D(a=1.0, h=float(h)), k=float(k), op=op, precond=precond,
                         rhs=to_tensor(rhs, dtype, device), u_inc=to_tensor(u_inc, dtype, device))


# -----------------------------------------------------------------------------
# 3D
# -----------------------------------------------------------------------------


def lippmann_schwinger_3d(symbol, nu, omega, n, m, l, quad_rule,
                          device=None) -> LippmannSchwinger3D:
    """``LippmannSchwinger3D`` from the JAX operator's fields."""
    device = resolve_device(device)
    dtype = _complex_dtype(symbol)
    return LippmannSchwinger3D(
        symbol=to_tensor(symbol, dtype, device),
        nu=to_tensor(nu, real_dtype_of(dtype), device),
        omega=float(omega), n=int(n), m=int(m), l=int(l), quad_rule=str(quad_rule),
    )


def stencil_matrix_3d(values, device=None) -> StencilMatrix3D:
    """``StencilMatrix3D`` from a (l, m, n, 3, 3, 3) complex ``values`` array."""
    device = resolve_device(device)
    return StencilMatrix3D(values=to_tensor(values, _complex_dtype(values), device))


def factorization_3d(lsten, usten, cinv=None, cinv_re=None, cinv_im=None, q_re=None,
                     q_im=None, s_re=None, s_im=None, device=None):
    """A 3D plane factorization from the JAX one's fields: full pivots
    (``cinv`` complex), bf16 pivots (``cinv_re``/``cinv_im`` as uint16 bit
    patterns) or int8 pivots (``q_re``/``q_im`` int8, ``s_re``/``s_im`` f32
    scales, in the JAX package's transposed layout).  Leading slab axes are
    kept as they are."""
    device = resolve_device(device)
    dtype = _complex_dtype(lsten)
    lsten, usten = to_tensor(lsten, dtype, device), to_tensor(usten, dtype, device)
    if cinv is not None:
        return BlockTridiagFactorization3D(cinv=to_tensor(cinv, dtype, device),
                                           lsten=lsten, usten=usten)
    if q_re is not None:
        def raw(a, want):
            a = np.asarray(a)
            if a.dtype != want:
                raise TypeError(f"int8 pivots arrive as {want} arrays, got {a.dtype}")
            return torch.from_numpy(np.array(a, copy=True)).to(device)

        return BlockTridiagFactorization3DInt8(
            q_re=raw(q_re, np.int8), q_im=raw(q_im, np.int8),
            s_re=raw(s_re, np.float32), s_im=raw(s_im, np.float32), lsten=lsten, usten=usten)
    return BlockTridiagFactorization3DBF16(cinv_re=_bf16(cinv_re).to(device),
                                           cinv_im=_bf16(cinv_im).to(device),
                                           lsten=lsten, usten=usten)


def _int8_stack(p_re, p_im, scale, mn, l1, device) -> PlaneStack:
    """int8 planes (SL, np, np) ``[i_in, o_out]`` with (SL, 2, nb, np) scales
    -> the port's tile-major layout at ld = np = round_up(mn, 128); the JAX
    package's zero scales of padding lanes become ones."""
    q_re, q_im, scale = np.asarray(p_re), np.asarray(p_im), np.asarray(scale, np.float32)
    ld = stack_ld(mn, "int8")
    if q_re.shape[-1] != ld or q_re.shape[-2] != ld or scale.shape[-2] != ld // INT8_BLOCK:
        raise ValueError(f"int8 planes {q_re.shape} and scales {scale.shape} do not fit "
                         f"mn = {mn}")
    if np.any(q_re[..., mn:, :]) or np.any(q_re[..., :, mn:]) or np.any(q_im[..., mn:, :]) \
            or np.any(q_im[..., :, mn:]):
        raise ValueError("padding entries of the pivot planes must be zero")
    sc = np.ones(scale.shape, np.float32)
    sc[..., :mn] = scale[..., :mn]
    sc = sc.reshape(scale.shape[:3] + (ld // LEAD_MULTIPLE, LEAD_MULTIPLE))
    return PlaneStack(
        p_re=tile_planes(torch.from_numpy(np.array(q_re, copy=True))).to(device),
        p_im=tile_planes(torch.from_numpy(np.array(q_im, copy=True))).to(device),
        scale=torch.from_numpy(np.ascontiguousarray(sc.transpose(0, 3, 2, 1, 4))).to(device),
        mn=mn, l1=int(l1))


def plane_stack(p_re, p_im, scale, mn, l1, device=None) -> PlaneStack:
    """The kernels' plane stack from a ``PallasPlaneStack``'s fields: bf16
    planes as uint16 bit patterns of (SL, np, np) with the all-ones scales of
    bf16 storage (128-lane padding, cropped here; the planes come out padded
    to round_up(mn, 8) and tile-major), or int8 planes with their
    (SL, 2, nb, np) scales (kept at np = round_up(mn, 128), tile-major)."""
    device = resolve_device(device)
    mn = int(mn)
    if np.asarray(p_re).dtype == np.int8:
        return _int8_stack(p_re, p_im, scale, mn, l1, device)
    scale = np.asarray(scale)
    if scale.shape[-2] != 1 or not np.all(scale == 1.0):
        raise ValueError("bf16 planes carry all-ones scales")
    ld = stack_ld(mn, "bf16")
    return PlaneStack(p_re=_bf16_planes(p_re, mn, ld, device),
                      p_im=_bf16_planes(p_im, mn, ld, device), mn=mn, l1=int(l1))


def plane_slab_view(stack: dict, lsten, usten, base=0, device=None) -> PlaneSlabView:
    """``PlaneSlabView`` from a JAX view's fields: ``stack`` a dict of the
    arguments of :func:`plane_stack`."""
    device = resolve_device(device)
    dtype = _complex_dtype(lsten)
    return PlaneSlabView(stack=plane_stack(**stack, device=device),
                         lsten=to_tensor(lsten, dtype, device),
                         usten=to_tensor(usten, dtype, device), base=int(base))


def sparsifying_preconditioner_3d(factorization: dict, a_s_values,
                                  device=None) -> SparsifyingPreconditioner3D:
    """``SparsifyingPreconditioner3D`` from the JAX one's parts: the
    factorization's fields as a dict (a plane view's, with ``stack``, for
    :func:`plane_slab_view`; a dense or bf16 one's for
    :func:`factorization_3d`) and the (l, m, n, 3, 3, 3) field of ``a_s``."""
    device = resolve_device(device)
    fac = (plane_slab_view(**factorization, device=device) if "stack" in factorization
           else factorization_3d(**factorization, device=device))
    return SparsifyingPreconditioner3D(factorization=fac,
                                       a_s=stencil_matrix_3d(a_s_values, device=device))


def slab_system_3d(fields: dict, device=None) -> SlabSystem3D:
    """``SlabSystem3D`` from a dict of the JAX slab system's fields as numpy
    arrays / Python scalars: ``fields["fac"]`` a dict of the arguments of
    :func:`factorization_3d` (batched, with the leading slab axis; for a
    system with a plane stack the empty ``cinv`` placeholder), and
    ``fields["pfac"]`` ``None`` or a dict of those of :func:`plane_stack`."""
    device = resolve_device(device)
    fac = factorization_3d(**fields["fac"], device=device)
    pfac = None if fields.get("pfac") is None else plane_stack(**fields["pfac"], device=device)
    dtype = _complex_dtype(fields["cpl_01"])
    out = {}
    for f in dataclasses.fields(SlabSystem3D):
        if f.name in ("fac", "pfac"):
            continue
        v = fields[f.name]
        if f.name in ("n", "m", "l", "n_subs", "l1_max", "trace_tail", "trace_head"):
            out[f.name] = int(v)
        elif f.name == "pivot_layout":
            out[f.name] = str(v)
        elif f.name in ("has_top", "has_bot", "src_valid"):
            out[f.name] = torch.tensor(np.asarray(v, bool), device=device)
        elif f.name.startswith("cpl_"):
            out[f.name] = to_tensor(v, dtype, device)
        else:
            out[f.name] = torch.tensor(np.asarray(v, np.int64), device=device)
    return SlabSystem3D(fac=fac, pfac=pfac, **out)


def polarized_traces_preconditioner_3d(slabs: dict, a_s_values, n_it, inner_tol, inner_maxiter,
                                       device=None) -> PolarizedTracesPreconditioner3D:
    """``PolarizedTracesPreconditioner3D`` from the JAX one's parts: its slab
    system as a dict for :func:`slab_system_3d` (with its ``fac`` and
    ``pfac`` entries), the (l, m, n, 3, 3, 3) stencil field of ``a_s`` and
    its three scalar settings."""
    device = resolve_device(device)
    return PolarizedTracesPreconditioner3D(
        slabs=slab_system_3d(slabs, device=device),
        a_s=stencil_matrix_3d(a_s_values, device=device),
        n_it=int(n_it), inner_tol=float(inner_tol), inner_maxiter=int(inner_maxiter),
    )
