"""Slab subdomains for the method of polarized traces.

TPU-native re-design of the reference's ``Subdomain`` struct
(``src/subdomains.jl:2-107``): the domain is cut into y-slabs, each extended
by ``npml`` absorbing layers where the medium is tapered by a cubic-spline
cutoff and given a quadratic complex shift
(``src/subdomains.jl:46-68``).  The local matrix is the sparsified global
operator restricted to the slab with its first/last two lines replaced by the
global boundary (annihilator) rows (``src/subdomains.jl:76-86``).

Instead of per-slab Julia objects + PARDISO handles, all slabs live in one
batched, end-padded ``SlabSystem``: stencil fields
``(n_subs, m1_max, n, 3, 3)``, batched block-Thomas factorizations, and
per-slab trace/interface index vectors.  All slabs are factored together,
one batched inversion per line (the reference loops + factorizes
sequentially, ``tests/plasma_example.jl:123-128``).  Counterpart of the JAX
package's ``ddm/subdomain.py``; the host numpy part carries over whole.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device, to_tensor
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    BlockTridiagFactorization,
    BlockTridiagFactorizationBanded,
    BlockTridiagFactorizationBandedLR,
    BlockTridiagFactorizationBandedTail,
    BlockTridiagFactorizationBF16,
    compress_factorization,
    compress_factorization_banded,
    compress_factorization_banded_lr,
    compress_factorization_banded_tail,
    default_band_width,
    factor_stencil_values,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix2D
from fast_solver_lippmann_schwinger_tpu_torch.utils import checkpoint


def subdomain_limits(m: int, n_subs: int):
    """Interior line range of each slab (0-based, inclusive).

    Mirrors ``SubDomLimits = round(floor(linspace(1, m+1, nSubs+1)))``
    (``tests/plasma_example.jl:95-99``).
    """
    lim = np.floor(np.linspace(1, m + 1, n_subs + 1)).astype(np.int64)
    ind1 = lim[:-1] - 1
    indn = lim[1:] - 2
    return ind1, indn


def _spline_cutoff(t: np.ndarray) -> np.ndarray:
    """C^1 cubic cutoff: 1 for t<0, 2t^3-3t^2+1 on [0,1), 0 beyond
    (``src/subdomains.jl:46``)."""
    t = np.clip(t, -1.0, 2.0)   # the cubic only matters on [0, 1); clipping
    inside = (t >= 0) & (t < 1)  # avoids overflow when knots coincide (inf/1e-300)
    return np.where(t < 0, 1.0, np.where(inside, 2 * t ** 3 - 3 * t ** 2 + 1, 0.0))


def _filter_profile(a1, b1, b2, a2, y):
    """Rise from 0 at a1 to 1 at b1, plateau, fall to 0 at a2
    (``src/subdomains.jl:47``)."""
    eps = 1e-300
    rise = _spline_cutoff((b1 - y) / max(abs(b1 - a1), eps))
    fall = _spline_cutoff((y - b2) / max(abs(a2 - b2), eps))
    out = np.where(y < b1, rise, np.where(y < b2, 1.0, fall))
    return np.where(y >= a1, out, 0.0)


def _shift_profile(a1, a2, y):
    """Quadratic ramp outside [a1, a2] (``src/subdomains.jl:52``)."""
    return np.where(y <= a1, (y - a1) ** 2, 0.0) + np.where(
        y >= a2, (y - a2) ** 2, 0.0
    )


def absorbing_nu(nu_slab: np.ndarray, y1: np.ndarray, h: float, k: float,
                 ndelta: int, is_bottom: bool, is_top: bool,
                 shift_factor: float = 2.0) -> np.ndarray:
    """Cutoff + complex-shifted medium ``nu1`` on the extended slab.

    ``nu1 = filter(y) * (nu - shift * i * filtershift(y))`` with the
    boundary-dependent knot choices of ``src/subdomains.jl:59-68``.
    """
    m1 = len(y1)
    if is_bottom:
        a1, b1 = y1[0] - h, y1[0]
        s1 = y1[0] - h
    else:
        a1, b1 = y1[2], y1[ndelta - 3]
        s1 = y1[ndelta - 3]
    if is_top:
        b2, a2 = y1[m1 - 1], y1[m1 - 1] + h
        s2 = y1[m1 - 1] + h
    else:
        b2, a2 = y1[m1 - ndelta + 1], y1[m1 - 3]
        s2 = y1[m1 - ndelta + 1]
    filt = _filter_profile(a1, b1, b2, a2, y1)
    shift = _shift_profile(s1, s2, y1)
    return filt[:, None] * (nu_slab - (shift_factor * k) * 1j * shift[:, None])


class SlabTraceLines(NamedTuple):
    """Host copies of a slab system's per-slab trace lines and flags, as
    tuples of Python ints and bools indexed by slab."""

    l0: tuple
    l1: tuple
    ln: tuple
    lnp: tuple
    has_top: tuple
    has_bot: tuple


@dataclasses.dataclass(frozen=True)
class SlabSystem:
    """All slabs of one sweep direction, batched and end-padded."""

    h_stencils: torch.Tensor        # (S, m1_max, n, 3, 3) local matrices
    # batched: cinv (S, m1_max, n, n), ...; or bf16 planes (pivot_dtype="bf16"),
    # or the banded storages ("banded", "banded_lr", "banded_tail")
    fac: (BlockTridiagFactorization | BlockTridiagFactorizationBF16
          | BlockTridiagFactorizationBanded | BlockTridiagFactorizationBandedLR
          | BlockTridiagFactorizationBandedTail)
    # trace-line indices (0-based local lines); 0 where absent (see has_*)
    l0: torch.Tensor                # (S,)
    l1: torch.Tensor
    ln: torch.Tensor
    lnp: torch.Tensor
    has_top: torch.Tensor           # (S,) bool: slab has an upper neighbor -1
    has_bot: torch.Tensor           # (S,) bool: slab has a lower neighbor +1
    # source partitioning: for each (slab, local line) the global line it
    # owns as interior, or an arbitrary clipped index where invalid
    src_line: torch.Tensor          # (S, m1_max) int64
    src_valid: torch.Tensor         # (S, m1_max) bool
    # reconstruction gather: owner slab and local line per global line
    owner: torch.Tensor             # (m,) int64
    owner_line: torch.Tensor        # (m,) int64
    n: int
    m: int
    n_subs: int
    m1_max: int
    # coupling bands extracted at trace lines (S, n, 3)
    cpl_01: torch.Tensor            # H[ind_0, ind_1]
    cpl_10: torch.Tensor            # H[ind_1, ind_0]
    cpl_n_np: torch.Tensor          # H[ind_n, ind_np]
    cpl_np_n: torch.Tensor          # H[ind_np, ind_n]
    # backward-pass lines needed to reach the deepest bottom trace (0 = full
    # backward pass): down sweeps only consume bottom traces
    trace_tail: int = 0
    # first line carrying a top trace (0 = no head skip): trace-driven local
    # solves have zero rhs above it, so forward substitution can start there
    # with a zero carry
    trace_head: int = 0
    # optional kernel layout of ``fac`` (sparse/thomas_kernels.py): dense bf16
    # or int8 planes, or the banded+tail hybrid; when present the sweeps run
    # the substitution kernels (and, on the hybrid layout, the fused sweep
    # kernels)
    pfac: thomas_kernels.ThomasFactorization | thomas_kernels.BandedTailFactorization | None = None

    @functools.cached_property
    def host(self) -> SlabTraceLines:
        """The trace lines and flags on the host, read back once.  The sweeps
        walk the slabs in a Python loop; indexing or branching on the device
        tensors there would stall the stream once per slab and trace."""
        return SlabTraceLines(*(
            tuple(getattr(self, name).tolist()) for name in SlabTraceLines._fields
        ))

    @functools.cached_property
    def sweep_tables(self) -> SweepTables:
        """The trace metadata and coupling rows of the fused sweep kernels
        (``sparse/sweep_kernels.py``), built once, on the pivots' device."""
        return build_sweep_tables(self)


META_ROWS = ("l0", "l1", "ln", "lnp", "has_top", "has_bot")


@dataclasses.dataclass(frozen=True)
class SweepTables:
    """What the fused sweep kernels read besides the rows and the pivots."""

    meta: torch.Tensor      # (6, S) int32: l0, l1, ln, lnp, has_top, has_bot
    c01: torch.Tensor       # (S, 2, 3, ld) f32 coupling rows: down injections
    c10: torch.Tensor
    cnpn: torch.Tensor      #   up injections
    cnnp: torch.Tensor


def _pack_cpl_rows(cpl: torch.Tensor, ld: int) -> torch.Tensor:
    """(S, n, 3) complex coupling bands -> (S, 2, 3, ld) f32 rows."""
    return thomas_kernels._band_pack(cpl[:, None], ld)[:, 0].contiguous()


def build_sweep_tables(slabs: SlabSystem) -> SweepTables:
    """The (6, S) trace metadata (0 where a trace line is absent: the flag is
    the predicate) and the packed coupling rows.  The kernels hand the traces
    from slab to slab, so each slab with an upper neighbour must be the lower
    neighbour of the one above, as ``build_slab_system`` makes them."""
    hs = slabs.host
    S = slabs.n_subs
    if list(hs.has_top) != [s > 0 for s in range(S)] or \
            list(hs.has_bot) != [s < S - 1 for s in range(S)]:
        raise ValueError("the fused sweep needs slabs chained top to bottom "
                         f"(has_top={hs.has_top}, has_bot={hs.has_bot})")
    ld = slabs.pfac.ld
    meta = torch.tensor([[int(v) for v in getattr(hs, name)] for name in META_ROWS],
                        dtype=torch.int32, device=slabs.pfac.lband.device)
    return SweepTables(meta=meta, c01=_pack_cpl_rows(slabs.cpl_01, ld),
                       c10=_pack_cpl_rows(slabs.cpl_10, ld),
                       cnpn=_pack_cpl_rows(slabs.cpl_np_n, ld),
                       cnnp=_pack_cpl_rows(slabs.cpl_n_np, ld))


def attach_pallas(slabs: SlabSystem, storage: str = "bf16",
                  keep_dense: bool = True) -> SlabSystem:
    """Return a copy of ``slabs`` with the kernel solve layout attached
    (sweeps then dispatch to ``sparse/thomas_kernels.py``), packed from
    ``slabs.fac`` (full or bf16 pivots) in ``storage`` "bf16" or "int8".
    Keeps the name of its JAX counterpart, as the pivot mode ``"pallas"``
    does.

    ``keep_dense=False`` stores ONLY the padded/transposed planes: ``fac``
    keeps the bands (cheap) with an empty placeholder pivot stack, so shape
    metadata and consumers of the bands still work.  This is what
    ``pivot_dtype="pallas"`` and ``"pallas_int8"`` mean.
    """
    if hasattr(slabs.fac, "cinv") and slabs.fac.cinv.shape[-1] == 0:
        # the JAX package would re-pack the empty placeholder pivots here
        raise ValueError("attach_pallas packs the slab system's own pivots, and these "
                         "are only a placeholder beside a kernel layout")
    pfac = thomas_kernels.build_thomas_factorization(slabs.fac, storage=storage)
    fac = slabs.fac if keep_dense else _bands_only(slabs.fac)
    return dataclasses.replace(slabs, fac=fac, pfac=pfac)


def _bands_only(fac: BlockTridiagFactorization) -> BlockTridiagFactorization:
    """``fac`` with an empty placeholder pivot stack: the bands (cheap) stay
    for shape metadata and consumers of the bands."""
    return BlockTridiagFactorization(
        cinv=fac.lband.new_zeros(tuple(fac.lband.shape[:2]) + (0, 0)),
        lband=fac.lband, uband=fac.uband,
    )


def attach_banded_tail(slabs: SlabSystem, pivot_band: int | None = None) -> SlabSystem:
    """Return a copy of ``slabs`` whose pivots are ONLY the banded+tail hybrid
    layout of the kernels (``pivot_dtype="pallas_banded_tail"``): band width
    ``pivot_band`` (``None``: the w(n) rule, ``direct.default_band_width``)
    on the head lines, dense bf16 planes on the last :func:`tail_lines`
    lines; ``fac`` keeps the bands only.  The
    sweeps then run the fused sweep kernels (``gs_sweep``) and the hybrid
    substitution kernels (every other solve)."""
    pfac = thomas_kernels.build_banded_tail_factorization(
        slabs.fac, width=pivot_band, tail_lines=tail_lines(slabs))
    return dataclasses.replace(slabs, fac=_bands_only(slabs.fac), pfac=pfac)


# pivot modes of build_slab_system: the JAX package's, every one
PIVOT_MODES = ("full", "bf16", "banded", "banded_tail", "banded_lr", "pallas", "pallas_int8",
               "pallas_banded_tail")
# what each pivot mode keeps: the class of ``fac`` and that of the kernel
# layout ``pfac`` with its storage (None: no kernel layout); a checkpoint
# that holds anything else is recomputed
_MODE_LAYOUT = {
    "full": (BlockTridiagFactorization, None, None),
    "bf16": (BlockTridiagFactorizationBF16, None, None),
    "banded": (BlockTridiagFactorizationBanded, None, None),
    "banded_tail": (BlockTridiagFactorizationBandedTail, None, None),
    "banded_lr": (BlockTridiagFactorizationBandedLR, None, None),
    "pallas": (BlockTridiagFactorization, thomas_kernels.ThomasFactorization, "bf16"),
    "pallas_int8": (BlockTridiagFactorization, thomas_kernels.ThomasFactorization, "int8"),
    "pallas_banded_tail": (BlockTridiagFactorization, thomas_kernels.BandedTailFactorization,
                           "bf16"),
}
# rank of the low-rank term of "banded_lr" when pivot_rank is None
DEFAULT_PIVOT_RANK = 24


def tail_lines(slabs: SlabSystem) -> int:
    """Lines that keep dense pivot planes in the tail-dense layouts
    (``"banded_tail"``, ``"pallas_banded_tail"``): the deepest bottom-trace
    line and below, whose pivot inverses are effectively dense interface
    Green's functions, with a margin of four, at least 8."""
    return min(slabs.m1_max, max(slabs.trace_tail + 4, 8))


def pack_pivots(slabs: SlabSystem, pivot_dtype: str, pivot_band: int | None = None,
                pivot_rank: int | None = None) -> SlabSystem:
    """The slab system of ``pivot_dtype`` from one with full pivots: as it
    is (``"full"``), bf16 planes for the plain solves (``"bf16"``), the
    central ``pivot_band`` diagonals of each pivot inverse (``"banded"``),
    those plus a rank-``pivot_rank`` term (``"banded_lr"``, rank 24 when
    ``None``), the band with dense bf16 planes on the last
    :func:`tail_lines` lines (``"banded_tail"``), only the bf16 or int8
    planes of the substitution kernels (``"pallas"``, ``"pallas_int8"``), or
    only the kernels' banded+tail layout (``"pallas_banded_tail"``).  A band
    width of ``None`` is the w(n) rule, ``direct.default_band_width``."""
    if pivot_dtype not in PIVOT_MODES:
        raise ValueError(f"unknown pivot_dtype {pivot_dtype!r}; one of {PIVOT_MODES}")
    if pivot_dtype == "full":
        return slabs
    if pivot_dtype in ("pallas", "pallas_int8"):
        storage = "int8" if pivot_dtype == "pallas_int8" else "bf16"
        return attach_pallas(slabs, storage=storage, keep_dense=False)
    if pivot_dtype == "pallas_banded_tail":
        return attach_banded_tail(slabs, pivot_band)
    width = pivot_band if pivot_band is not None else default_band_width(slabs.n)
    if pivot_dtype == "bf16":
        fac = compress_factorization(slabs.fac)
    elif pivot_dtype == "banded":
        fac = compress_factorization_banded(slabs.fac, width)
    elif pivot_dtype == "banded_tail":
        fac = compress_factorization_banded_tail(slabs.fac, width, tail_lines(slabs))
    else:
        rank = DEFAULT_PIVOT_RANK if pivot_rank is None else pivot_rank
        fac = compress_factorization_banded_lr(slabs.fac, width, rank)
    return dataclasses.replace(slabs, fac=fac)


def build_slab_system(
    a_st: StencilMatrix2D,
    ag_st: StencilMatrix2D,
    nu: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    h: float,
    k: float,
    n_subs: int,
    npml: int = 10,
    shift_factor: float = 2.0,
    a_host: np.ndarray | None = None,
    ag_host: np.ndarray | None = None,
    pivot_dtype: str = "full",
    pivot_band: int | None = None,
    pivot_rank: int | None = None,
    cache_dir: str | None = None,
    device=None,
    timings: dict | None = None,
) -> SlabSystem:
    """Construct and factor all slabs of one sweep direction.

    ``a_st``/``ag_st`` are the global annihilator fields (their boundary-class
    rows supply the slab's artificial-boundary rows exactly as the
    ``Msp[1:2n,1:2n]`` overwrite at ``src/subdomains.jl:79-86``), ``nu`` is
    the (m, n) medium.  ``pivot_dtype`` is one of :data:`PIVOT_MODES`, see
    :func:`pack_pivots`: ``"full"`` (dense pivots in the working dtype),
    ``"bf16"`` (bf16 planes, plain solves), ``"banded"``, ``"banded_tail"``
    and ``"banded_lr"`` (band width ``pivot_band``, rank ``pivot_rank``;
    plain solves), ``"pallas"`` / ``"pallas_int8"`` (only the transposed
    bf16 / int8 planes of the substitution kernels are kept) or
    ``"pallas_banded_tail"`` (only the banded+tail hybrid layout of the
    kernels; see :func:`attach_banded_tail`).  The slabs live on the
    stencils' device unless ``device`` says otherwise.

    ``cache_dir`` checkpoints the factorization in its final pivot mode
    (``slabfac_<key>.pt``, ``utils/checkpoint.py``), never the dense pivots
    it is packed from, keyed as in the JAX package (a digest of the local
    stencils, their shape, ``pivot_dtype``, ``pivot_band``, ``pivot_rank``
    and the dtype) and on the version of the kernels' pivot layouts.  A
    checkpoint is written from whatever device the slabs were built on.

    ``timings``, when given, receives the wall seconds of ``factorization``
    (the local stencils and their dense factorization), ``packing`` (into
    ``pivot_dtype``) and, with a ``cache_dir``, ``checkpoint`` (the load, or
    the miss and the save), synchronised on the device.
    """
    if pivot_dtype not in PIVOT_MODES:
        raise ValueError(f"unknown pivot_dtype {pivot_dtype!r}; one of {PIVOT_MODES}")
    if npml < 5:
        # absorbing_nu indexes y1[ndelta - 3] / y1[m1 - ndelta + 1]; below 5
        # the cutoff knots mis-order and the spline clamp silently produces a
        # useless (blowing-up) absorbing profile
        raise ValueError(f"npml must be >= 5 for ordered cutoff knots, got {npml}")
    t_start = time.perf_counter()
    m, n = a_st.m, a_st.n
    dtype = a_st.values.dtype
    device = a_st.values.device if device is None else resolve_device(device)
    nu = np.asarray(nu).reshape(m, n)
    y = np.asarray(y)
    if a_host is not None and ag_host is not None:
        a_vals, ag_vals = np.asarray(a_host), np.asarray(ag_host)
    else:
        a_vals = a_st.values.detach().cpu().numpy()
        ag_vals = ag_st.values.detach().cpu().numpy()

    ind1, indn = subdomain_limits(m, n_subs)
    jstart = np.maximum(ind1 - npml, 0)
    jend = np.minimum(indn + npml, m - 1)
    m1 = jend - jstart + 1
    m1_max = int(m1.max())

    S = n_subs
    h_sten = np.zeros((S, m1_max, n, 3, 3), dtype=np.complex128)
    l0 = np.full(S, -1, np.int32)
    l1 = np.full(S, -1, np.int32)
    ln = np.full(S, -1, np.int32)
    lnp = np.full(S, -1, np.int32)
    src_line = np.zeros((S, m1_max), np.int32)
    src_valid = np.zeros((S, m1_max), bool)
    owner = np.zeros(m, np.int32)
    owner_line = np.zeros(m, np.int32)

    for s in range(S):
        js, je = int(jstart[s]), int(jend[s])
        msl = int(m1[s])
        y1 = y[js : je + 1]
        is_bottom = ind1[s] == 0
        is_top = indn[s] == m - 1

        # slab stencil classes: line 0 -> global-bottom (y-LO) classes,
        # line msl-1 -> y-HI classes, interior lines -> MID classes.  Slicing
        # the global fields achieves exactly that because the global fields
        # are class-constant away from the two boundary lines.
        a_slab = np.empty((msl, n, 3, 3), np.complex128)
        ag_slab = np.empty((msl, n, 3, 3), np.complex128)
        mid = (m - 1) // 2  # any global-interior line
        a_slab[:] = a_vals[mid][None]
        ag_slab[:] = ag_vals[mid][None]
        a_slab[0] = a_vals[0]
        ag_slab[0] = ag_vals[0]
        a_slab[msl - 1] = a_vals[m - 1]
        ag_slab[msl - 1] = ag_vals[m - 1]

        # medium fields: nu1 (cutoff + shift) everywhere; boundary-condition
        # rows read the global-domain-edge medium instead
        # (the Msp row overwrite, src/subdomains.jl:79-86)
        nu_loc = absorbing_nu(
            nu[js : je + 1], y1, h, k, npml, is_bottom, is_top, shift_factor
        )
        nu_bc = nu_loc.copy()
        if not is_bottom:
            nu_bc[0] = nu[0]
            nu_bc[1] = nu[1]
        if not is_top:
            nu_bc[msl - 2] = nu[m - 2]
            nu_bc[msl - 1] = nu[m - 1]

        bc_rows = np.zeros(msl, bool)
        if not is_bottom:
            bc_rows[[0, 1]] = True
        if not is_top:
            bc_rows[[msl - 2, msl - 1]] = True

        def col_field(nu_field):
            nup = np.pad(nu_field, ((1, 1), (1, 1)))
            cols = np.empty((msl, n, 3, 3), np.complex128)
            for dj in range(3):
                for di in range(3):
                    cols[:, :, dj, di] = nup[dj : dj + msl, di : di + n]
            return cols

        cols_loc = col_field(nu_loc)
        cols_bc = col_field(nu_bc)
        cols = np.where(bc_rows[:, None, None, None], cols_bc, cols_loc)
        h_slab = a_slab + (k ** 2) * ag_slab * cols

        h_sten[s, :msl] = h_slab
        # identity padding lines
        h_sten[s, msl:, :, 1, 1] = 1.0

        if not is_bottom:
            l0[s] = npml - 1
            l1[s] = npml
        if not is_top:
            ln[s] = msl - npml - 1
            lnp[s] = msl - npml

        int_lo = int(ind1[s] - js)
        int_hi = int(indn[s] - js)
        for ell in range(int_lo, int_hi + 1):
            src_line[s, ell] = js + ell
            src_valid[s, ell] = True
            owner[js + ell] = s
            owner_line[js + ell] = ell

    # coupling bands at the trace lines (rows l0 coupling to line l0+1 is the
    # dj=+1 band, etc.); zero where the trace is absent
    def band_at(lines, dj):
        out = np.zeros((S, n, 3), np.complex128)
        for s in range(S):
            if lines[s] >= 0:
                out[s] = h_sten[s, lines[s], :, dj, :]
        return out

    cpl_01 = band_at(l0, 2)
    cpl_10 = band_at(l1, 0)
    cpl_n_np = band_at(ln, 2)
    cpl_np_n = band_at(lnp, 0)

    # deepest bottom-trace line over slabs that have one (pre-clamp values)
    valid_ln = ln[ln >= 0]
    trace_tail = int(m1_max - valid_ln.min()) + 1 if valid_ln.size else 0
    valid_l0 = l0[l0 >= 0]
    trace_head = int(valid_l0.min()) if valid_l0.size else 0

    h_dev = to_tensor(h_sten, dtype, device)

    def index(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    slabs = SlabSystem(
        h_stencils=h_dev,
        fac=None,                   # factored, or loaded, below
        l0=index(np.maximum(l0, 0)),
        l1=index(np.maximum(l1, 0)),
        ln=index(np.maximum(ln, 0)),
        lnp=index(np.maximum(lnp, 0)),
        has_top=torch.as_tensor(l0 >= 0, device=device),
        has_bot=torch.as_tensor(ln >= 0, device=device),
        src_line=index(src_line),
        src_valid=torch.as_tensor(src_valid, device=device),
        owner=index(owner),
        owner_line=index(owner_line),
        n=n,
        m=m,
        n_subs=S,
        m1_max=m1_max,
        cpl_01=to_tensor(cpl_01, dtype, device),
        cpl_10=to_tensor(cpl_10, dtype, device),
        cpl_n_np=to_tensor(cpl_n_np, dtype, device),
        cpl_np_n=to_tensor(cpl_np_n, dtype, device),
        trace_tail=trace_tail,
        trace_head=trace_head,
    )
    seconds = {"factorization": 0.0, "packing": 0.0}

    def lap(part, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[part] = seconds.get(part, 0.0) + time.perf_counter() - t0

    lap("factorization", t_start)
    path = None
    if cache_dir is not None:
        t0 = time.perf_counter()
        path = checkpoint.path_for(
            cache_dir, "slabfac", h_digest=checkpoint.digest(h_sten), shape=list(h_sten.shape),
            pivot_dtype=pivot_dtype, pivot_band=pivot_band, pivot_rank=pivot_rank,
            dtype=str(dtype), layout=thomas_kernels.LAYOUT_VERSION,
        )
        loaded = checkpoint.load(path, device, check=lambda facs: _fits(
            facs, pivot_dtype, (S, m1_max, n, 3), dtype))
        lap("checkpoint", t0)
        if loaded is not None:
            slabs = dataclasses.replace(slabs, fac=loaded[0], pfac=loaded[1])
    if slabs.fac is None:
        t0 = time.perf_counter()
        slabs = dataclasses.replace(slabs, fac=factor_stencil_values(h_dev))
        lap("factorization", t0)
        t0 = time.perf_counter()
        slabs = pack_pivots(slabs, pivot_dtype, pivot_band, pivot_rank)
        lap("packing", t0)
        if path is not None:
            t0 = time.perf_counter()
            checkpoint.save(path, (slabs.fac, slabs.pfac))
            lap("checkpoint", t0)
    if timings is not None:
        timings.update(seconds)
    return slabs


def _fits(facs, pivot_dtype: str, band_shape: tuple, dtype: torch.dtype) -> bool:
    """Whether a loaded ``(fac, pfac)`` is what ``pivot_dtype`` keeps for
    slab stencils whose bands are ``band_shape`` (S, m1_max, n, 3) in
    ``dtype``."""
    fac, pfac = facs
    fac_kind, pfac_kind, storage = _MODE_LAYOUT[pivot_dtype]
    if type(fac) is not fac_kind or tuple(fac.lband.shape) != band_shape \
            or fac.lband.dtype != dtype:
        return False
    if pfac_kind is None:
        return pfac is None
    S, m1, n, _ = band_shape
    return (type(pfac) is pfac_kind and pfac.storage == storage and pfac.n == n
            and tuple(pfac.lband.shape[:2]) == (S, m1))


def partition_source(slabs: SlabSystem, b: torch.Tensor) -> torch.Tensor:
    """Scatter a global (m*n,) source into per-slab interior lines
    (``sourcePartition``, ``src/subdomains.jl:291-306``).

    ``b`` may carry trailing RHS columns: (m*n, r) -> (S, m1_max, n, r)."""
    bg = b.reshape((slabs.m, slabs.n) + tuple(b.shape[1:]))
    gathered = bg[slabs.src_line]                  # (S, m1_max, n) + extra
    mask = slabs.src_valid.reshape(
        tuple(slabs.src_valid.shape) + (1,) * (gathered.ndim - 2)
    )
    return torch.where(mask, gathered, torch.zeros_like(gathered))


def gather_interior(slabs: SlabSystem, fields: torch.Tensor) -> torch.Tensor:
    """Collect per-slab (S, m1_max, n[, r]) fields back to a flat global
    (m*n[, r]) vector."""
    out = fields[slabs.owner, slabs.owner_line]    # (m, n) + extra
    return out.reshape((slabs.m * slabs.n,) + tuple(fields.shape[3:]))
