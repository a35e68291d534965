"""3D slab subdomains and the Gauss-Seidel sweeping preconditioner.

Counterpart of the JAX package's ``ddm/subdomain3d.py``.  The reference ships
no 3D domain decomposition; the JAX package extends the 2D construction
(``src/subdomains.jl:2-107``) by one dimension:

* the domain is cut into z-slabs, each extended by ``npml`` absorbing planes
  where the medium is tapered by the same cubic-spline cutoff and quadratic
  complex shift as in 2D (``src/subdomains.jl:46-68``);
* the local matrix is the sparsified global operator restricted to the slab,
  with its first/last two PLANES replaced by the global boundary
  (annihilator) rows;
* interface traces are (m, n) planes, inter-plane couplings 9-point in-plane
  stencils;
* the local solves are plane block-Thomas factorizations
  (``sparse/direct.py:factor_stencil_3d``), over z-planes (``"z"`` layout,
  (mn)^2 pivots, with the tail/resume shortcuts of the 2D sweeps) or over
  y-planes (``"y"`` layout, (l1 n)^2 pivots: l1/m of the memory, the layout
  of the 96^3 solve).

The sweep recursion is that of the 2D ``precondGSOptimized``
(``src/preconditioner.jl:557-630``) with lines replaced by planes: two Python
loops over the slabs, as the port's 2D ``ddm/sweeps.py``, indexing and
branching on host copies of the trace planes (``SlabSystem3D.host``), so a
sweep reads nothing back from the device.  Slabs are factored one at a time;
with a ``_pallas`` pivot mode each slab's planes are packed into the shared
plane stack of ``sparse/plane_kernels.py`` before the next slab is factored,
and every local solve runs the fused plane kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time

import numpy as np
import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import to_tensor
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import (
    SlabTraceLines,
    _filter_profile,
    _shift_profile,
    subdomain_limits,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    BlockTridiagFactorization3D,
    _plane_stencil_matvec,
    block_thomas_solve_3d,
    block_thomas_solve_cached_3d,
    block_thomas_solve_resume_3d,
    block_thomas_solve_support_3d,
    factor_stencil_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix3D
from fast_solver_lippmann_schwinger_tpu_torch.utils import checkpoint

# pivot modes of build_slab_system_3d without the "_pallas" suffix: layout and
# storage of the plane pivots
_PIVOT_MODES = {
    "full": ("z", "full"), "bf16": ("z", "bf16"), "int8": ("z", "int8"),
    "yblock": ("y", "full"), "yblock_bf16": ("y", "bf16"), "yblock_int8": ("y", "int8"),
}


def absorbing_nu_3d(nu_slab: np.ndarray, z1: np.ndarray, h: float, k: float,
                    ndelta: int, is_bottom: bool, is_top: bool,
                    shift_factor: float = 2.0) -> np.ndarray:
    """Cutoff + complex-shifted medium on the extended z-slab: the 1D profiles
    along z are exactly the 2D ones (``src/subdomains.jl:46-68``), broadcast
    over the (m, n) plane."""
    l1 = len(z1)
    if is_bottom:
        a1, b1 = z1[0] - h, z1[0]
        s1 = z1[0] - h
    else:
        a1, b1 = z1[2], z1[ndelta - 3]
        s1 = z1[ndelta - 3]
    if is_top:
        b2, a2 = z1[l1 - 1], z1[l1 - 1] + h
        s2 = z1[l1 - 1] + h
    else:
        b2, a2 = z1[l1 - ndelta + 1], z1[l1 - 3]
        s2 = z1[l1 - ndelta + 1]
    filt = _filter_profile(a1, b1, b2, a2, z1)
    shift = _shift_profile(s1, s2, z1)
    return filt[:, None, None] * (nu_slab - (shift_factor * k) * 1j * shift[:, None, None])


@dataclasses.dataclass(frozen=True)
class SlabSystem3D:
    """All z-slabs, batched and end-padded (3D counterpart of ``SlabSystem``)."""

    # batched factorization with a leading slab axis; with a plane stack
    # (``pfac``) only its couplings: ``cinv`` is an empty (S, l1, 0, 0)
    # placeholder, as in the JAX package
    fac: object
    # trace-plane indices (0-based local planes); 0 where absent (see has_*)
    l0: torch.Tensor               # (S,)
    l1: torch.Tensor
    ln: torch.Tensor
    lnp: torch.Tensor
    has_top: torch.Tensor          # (S,) bool: slab has an upper neighbour -1
    has_bot: torch.Tensor          # (S,) bool: slab has a lower neighbour +1
    src_plane: torch.Tensor        # (S, l1_max) int64 global plane owned
    src_valid: torch.Tensor        # (S, l1_max) bool
    owner: torch.Tensor            # (l,) int64
    owner_plane: torch.Tensor      # (l,) int64
    # coupling stencils at the trace planes (S, m, n, 3, 3)
    cpl_01: torch.Tensor           # H[ind_0, ind_1]
    cpl_10: torch.Tensor           # H[ind_1, ind_0]
    cpl_n_np: torch.Tensor         # H[ind_n, ind_np]
    cpl_np_n: torch.Tensor         # H[ind_np, ind_n]
    n: int
    m: int
    l: int
    n_subs: int
    l1_max: int
    # backward-pass planes reaching the deepest bottom trace (0 = full)
    trace_tail: int = 0
    # pivot block axis: "z" (z-planes, (mn)^2 pivots, tail/resume shortcuts)
    # or "y" (y-planes, (l1 n)^2 pivots)
    pivot_layout: str = "z"
    # first plane carrying a top trace (0 = no head skip)
    trace_head: int = 0
    # optional plane stack of all slabs' pivots (sparse/plane_kernels.py):
    # the local solves then run the plane kernels
    pfac: plane_kernels.PlaneStack | None = None

    @functools.cached_property
    def host(self) -> SlabTraceLines:
        """The trace planes and flags on the host, read back once: the sweeps
        index and branch on them in Python loops."""
        return SlabTraceLines(*(
            tuple(getattr(self, name).tolist()) for name in SlabTraceLines._fields
        ))

    @functools.cached_property
    def slab_facs(self) -> tuple:
        """Each slab's factorization for the local solves, built once: a
        plane view into the shared stack (its couplings packed as weight rows
        once), or a slice of the batched factorization."""
        if self.pfac is not None:
            return tuple(
                plane_kernels.PlaneSlabView(stack=self.pfac, lsten=self.fac.lsten[i],
                                            usten=self.fac.usten[i], base=i * self.pfac.l1)
                for i in range(self.n_subs))
        return tuple(plane_kernels._slab_slice(self.fac, i) for i in range(self.n_subs))


def _split_pivot_dtype(pivot_dtype: str):
    """``pivot_dtype`` -> (layout, storage, use_pallas), as the JAX package
    reads it; a plane stack stores compressed pivots (full -> bf16)."""
    use_pallas = pivot_dtype.endswith("_pallas")
    base = pivot_dtype[: -len("_pallas")] if use_pallas else pivot_dtype
    if base not in _PIVOT_MODES:
        raise ValueError(f"unknown pivot_dtype {pivot_dtype!r}")
    layout, storage = _PIVOT_MODES[base]
    if use_pallas and storage == "full":
        storage = "bf16"
    return layout, storage, use_pallas


def _slab_stencil(s, a_vals, ag_vals, nu, z, h, k, npml, shift_factor, ind1, indn, kstart,
                  kend, l1_max):
    """Slab ``s``'s local stencil field (l1_max, m, n, 3, 3, 3) complex128 on
    the host, identity planes below its end (``ddm/subdomain3d.py:191-247``
    of the JAX package)."""
    l, m, n = nu.shape
    ks, ke = int(kstart[s]), int(kend[s])
    lsl = ke - ks + 1
    z1 = z[ks : ke + 1]
    is_bottom = ind1[s] == 0
    is_top = indn[s] == l - 1

    # plane 0 -> global z-LO classes, plane lsl-1 -> z-HI classes, interior
    # planes -> z-MID classes (the global fields are class-constant in z away
    # from the two boundary planes)
    mid = (l - 1) // 2
    a_slab = np.empty((lsl, m, n, 3, 3, 3), np.complex128)
    ag_slab = np.empty_like(a_slab)
    a_slab[:] = a_vals[mid][None]
    ag_slab[:] = ag_vals[mid][None]
    a_slab[0] = a_vals[0]
    ag_slab[0] = ag_vals[0]
    a_slab[lsl - 1] = a_vals[l - 1]
    ag_slab[lsl - 1] = ag_vals[l - 1]

    nu_loc = absorbing_nu_3d(nu[ks : ke + 1], z1, h, k, npml, is_bottom, is_top, shift_factor)
    nu_bc = nu_loc.copy()
    if not is_bottom:
        nu_bc[0] = nu[0]
        nu_bc[1] = nu[1]
    if not is_top:
        nu_bc[lsl - 2] = nu[l - 2]
        nu_bc[lsl - 1] = nu[l - 1]
    bc_rows = np.zeros(lsl, bool)
    if not is_bottom:
        bc_rows[[0, 1]] = True
    if not is_top:
        bc_rows[[lsl - 2, lsl - 1]] = True

    def col_field(nu_field):
        nup = np.pad(nu_field, ((1, 1), (1, 1), (1, 1)))
        cols = np.empty((lsl, m, n, 3, 3, 3), np.complex128)
        for dk in range(3):
            for dj in range(3):
                for di in range(3):
                    cols[:, :, :, dk, dj, di] = nup[dk : dk + lsl, dj : dj + m, di : di + n]
        return cols

    cols = np.where(bc_rows[:, None, None, None, None, None], col_field(nu_bc),
                    col_field(nu_loc))
    h_s = np.zeros((l1_max, m, n, 3, 3, 3), np.complex128)
    h_s[:lsl] = a_slab + (k ** 2) * ag_slab * cols
    h_s[lsl:, :, :, 1, 1, 1] = 1.0          # identity padding planes
    return h_s


def build_slab_system_3d(
    a_st: StencilMatrix3D,
    ag_st: StencilMatrix3D,
    nu: np.ndarray,
    z: np.ndarray,
    h: float,
    k: float,
    n_subs: int,
    npml: int = 5,
    shift_factor: float = 2.0,
    a_host: np.ndarray | None = None,
    ag_host: np.ndarray | None = None,
    pivot_dtype: str = "full",
    pivot_band: int | None = None,
    cache_dir: str | None = None,
    fac_provider=None,
    timings: dict | None = None,
) -> SlabSystem3D:
    """Construct and factor all z-slabs (3D counterpart of
    ``build_slab_system``), on the device of ``a_st``.

    ``pivot_dtype`` in {``"full"``, ``"bf16"``, ``"int8"``, ``"yblock"``,
    ``"yblock_bf16"``, ``"yblock_int8"``} selects the plane-pivot storage
    and block axis (``sparse/direct.py``): the ``yblock`` layouts factor each
    slab over y-planes, (l1 n)^2 pivot blocks instead of (mn)^2, exact solves
    at l1/m of the memory.  A ``_pallas`` suffix stores the same pivots
    (full ones as bf16) in the plane kernels' stack
    (``sparse/plane_kernels.py``), and the local solves run the fused plane
    kernels.  Slabs are factored one at a time and, with a stack, packed into
    it before the next one is factored, so the stack is never held twice.

    ``a_host``/``ag_host``, when both are given, are host copies of the
    stencil values (l, m, n, 3, 3, 3) and are read instead of copying
    ``a_st``/``ag_st`` back from the device.  ``pivot_band`` is passed to
    ``factor_stencil_3d``, which accepts and ignores it, as the JAX package
    does.

    ``cache_dir`` checkpoints the factorization and the plane stack in the
    final storage (``slabfac3d_<key>.pt``, ``utils/checkpoint.py``), keyed as
    in the JAX package (a digest of the local stencils, their shape,
    ``pivot_dtype``, ``pivot_band``, the dtype) and on the version of the
    plane kernels' stack layout.

    ``timings``, when given, receives the wall seconds of the parts:
    ``slab_fields`` (host stencil fields), ``factorization`` and ``packing``
    and, with a ``cache_dir``, ``checkpoint`` (the load, or the miss and the
    save), synchronised on the device.

    ``fac_provider(h_sten, dtype, factor_one)``, when given, supplies the
    ``(fac, pfac)`` pair after a checkpoint miss, in place of the
    in-process factorization: ``h_sten`` is the host (S, l1_max, m, n, 3, 3,
    3) complex128 stack of slab stencil fields, ``dtype`` the working dtype
    and ``factor_one(v)`` factors one slab's field ``v`` (a tensor of that
    shape, on any device) in this pivot mode's layout and storage.  A
    provider can factor slab by slab where the whole stack would not fit at
    once (the capacity path of ``benchmarks/capacity3d.py``); what it
    returns is not checkpointed, as in the JAX package.
    """
    if npml < 5:
        # see build_slab_system: the cutoff knots need >= 5 absorbing planes
        raise ValueError(f"npml must be >= 5 for ordered cutoff knots, got {npml}")
    layout, storage, use_pallas = _split_pivot_dtype(pivot_dtype)
    l, m, n = a_st.l, a_st.m, a_st.n
    dtype = a_st.values.dtype
    device = a_st.values.device
    nu = np.asarray(nu).reshape(l, m, n)
    z = np.asarray(z)
    if a_host is not None and ag_host is not None:
        a_vals, ag_vals = np.asarray(a_host), np.asarray(ag_host)
    else:
        a_vals, ag_vals = a_st.values.cpu().numpy(), ag_st.values.cpu().numpy()
    seconds = {"slab_fields": 0.0, "factorization": 0.0, "packing": 0.0}

    def lap(part, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[part] = seconds.get(part, 0.0) + time.perf_counter() - t0

    ind1, indn = subdomain_limits(l, n_subs)
    kstart = np.maximum(ind1 - npml, 0)
    kend = np.minimum(indn + npml, l - 1)
    l1 = kend - kstart + 1
    l1_max = int(l1.max())
    S = n_subs

    pl0 = np.full(S, -1, np.int64)
    pl1 = np.full(S, -1, np.int64)
    pln = np.full(S, -1, np.int64)
    plnp = np.full(S, -1, np.int64)
    src_plane = np.zeros((S, l1_max), np.int64)
    src_valid = np.zeros((S, l1_max), bool)
    owner = np.zeros(l, np.int64)
    owner_plane = np.zeros(l, np.int64)
    cpl = {name: np.zeros((S, m, n, 3, 3), np.complex128)
           for name in ("cpl_01", "cpl_10", "cpl_n_np", "cpl_np_n")}

    h_slabs = []
    for s in range(S):
        t0 = time.perf_counter()
        h_s = _slab_stencil(s, a_vals, ag_vals, nu, z, h, k, npml, shift_factor, ind1, indn,
                            kstart, kend, l1_max)
        h_slabs.append(h_s)
        lsl = int(l1[s])
        if ind1[s] != 0:
            pl0[s], pl1[s] = npml - 1, npml
            cpl["cpl_01"][s] = h_s[pl0[s], :, :, 2]
            cpl["cpl_10"][s] = h_s[pl1[s], :, :, 0]
        if indn[s] != l - 1:
            pln[s], plnp[s] = lsl - npml - 1, lsl - npml
            cpl["cpl_n_np"][s] = h_s[pln[s], :, :, 2]
            cpl["cpl_np_n"][s] = h_s[plnp[s], :, :, 0]
        int_lo, int_hi = int(ind1[s] - kstart[s]), int(indn[s] - kstart[s])
        for ell in range(int_lo, int_hi + 1):
            src_plane[s, ell] = kstart[s] + ell
            src_valid[s, ell] = True
            owner[kstart[s] + ell] = s
            owner_plane[kstart[s] + ell] = ell
        lap("slab_fields", t0)

    fac = stack = path = None
    if cache_dir is not None:
        t0 = time.perf_counter()
        digest = hashlib.sha256()
        for h_s in h_slabs:         # the bytes of the (S, l1_max, ...) stack
            digest.update(h_s.tobytes())
        path = checkpoint.path_for(
            cache_dir, "slabfac3d", h_digest=digest.hexdigest(), shape=[S, *h_slabs[0].shape],
            pivot_dtype=pivot_dtype, pivot_band=pivot_band, dtype=str(dtype),
            layout=plane_kernels.LAYOUT_VERSION,
        )
        loaded = checkpoint.load(path, device, check=lambda facs: _fits(
            facs, layout, storage, use_pallas, S, (l1_max, m, n), dtype))
        if loaded is not None:
            fac, stack = loaded
            h_slabs.clear()
        lap("checkpoint", t0)

    def factor_one(v: torch.Tensor):
        """One slab's (l1_max, m, n, 3, 3, 3) stencil field -> its
        factorization in this mode's layout and storage."""
        if layout == "y":
            # block over y: grid axes (l, m, n) -> (m, l, n) and the stencil
            # offset axes to match; the factorization is axis-agnostic
            v = v.permute(1, 0, 2, 4, 3, 5).contiguous()
        return factor_stencil_3d(StencilMatrix3D(values=v), pivot_dtype=storage,
                                 pivot_band=pivot_band)

    if fac is None and fac_provider is not None:
        t0 = time.perf_counter()
        h_sten = np.stack(h_slabs)
        h_slabs.clear()
        fac, stack = fac_provider(h_sten, dtype, factor_one)
        del h_sten
        lap("factorization", t0)

    batched = None
    for s, h_s in enumerate(h_slabs):
        t0 = time.perf_counter()
        v = to_tensor(h_s, dtype, device)
        h_slabs[s] = None
        lap("slab_fields", t0)

        t0 = time.perf_counter()
        fac_s = factor_one(v)
        del v
        lap("factorization", t0)

        t0 = time.perf_counter()
        if use_pallas:
            if stack is None:
                planes = fac_s.lsten.shape[0]
                mn = fac_s.lsten.shape[1] * fac_s.lsten.shape[2]
                stack = plane_kernels.empty_plane_stack(S * planes, mn, planes, storage, device)
                batched = {name: getattr(fac_s, name).new_empty((S,) + tuple(getattr(fac_s, name).shape))
                           for name in ("lsten", "usten")}
            plane_kernels.pack_planes(stack, s * stack.l1, fac_s)
        elif batched is None:
            batched = {f.name: getattr(fac_s, f.name).new_empty(
                (S,) + tuple(getattr(fac_s, f.name).shape)) for f in dataclasses.fields(fac_s)}
        for name, t in batched.items():
            t[s] = getattr(fac_s, name)
        kind = type(fac_s)
        del fac_s
        lap("packing", t0)

    if batched is not None and use_pallas:
        lsten = batched["lsten"]
        fac = BlockTridiagFactorization3D(
            cinv=lsten.new_zeros(tuple(lsten.shape[:2]) + (0, 0)), **batched)
    elif batched is not None:
        fac = kind(**batched)
    if path is not None and batched is not None:
        t0 = time.perf_counter()
        checkpoint.save(path, (fac, stack))
        lap("checkpoint", t0)
    if timings is not None:
        timings.update(seconds)

    def index(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return SlabSystem3D(
        fac=fac,
        l0=index(np.maximum(pl0, 0)),
        l1=index(np.maximum(pl1, 0)),
        ln=index(np.maximum(pln, 0)),
        lnp=index(np.maximum(plnp, 0)),
        has_top=torch.as_tensor(pl0 >= 0, device=device),
        has_bot=torch.as_tensor(pln >= 0, device=device),
        src_plane=index(src_plane),
        src_valid=torch.as_tensor(src_valid, device=device),
        owner=index(owner),
        owner_plane=index(owner_plane),
        **{name: to_tensor(c, dtype, device) for name, c in cpl.items()},
        n=n, m=m, l=l, n_subs=S, l1_max=l1_max,
        trace_tail=int(l1_max - pln[pln >= 0].min()) + 1 if (pln >= 0).any() else 0,
        pivot_layout=layout,
        trace_head=int(pl0[pl0 >= 0].min()) if (pl0 >= 0).any() else 0,
        pfac=stack,
    )


def _fits(facs, layout: str, storage: str, use_pallas: bool, S: int, zmn: tuple,
          dtype: torch.dtype) -> bool:
    """Whether a loaded ``(fac, stack)`` holds ``S`` slabs of (l1_max, m, n)
    planes ``zmn`` in ``layout`` and ``storage``, with a plane stack exactly
    when ``use_pallas``."""
    fac, stack = facs
    l1, m, n = zmn
    planes = (l1, m, n) if layout == "z" else (m, l1, n)
    if tuple(fac.lsten.shape) != (S, *planes, 3, 3) or fac.lsten.dtype != dtype:
        return False
    if not use_pallas:
        pivots = {"full": "cinv", "bf16": "cinv_re", "int8": "q_re"}[storage]
        return stack is None and hasattr(fac, pivots)
    return (isinstance(stack, plane_kernels.PlaneStack) and stack.storage == storage
            and stack.n_planes == S * planes[0] and stack.mn == planes[1] * planes[2])


def slab_solve_3d(slabs: SlabSystem3D, fac_slice, rhs: torch.Tensor, start: int = 0,
                  tail: int = 0) -> torch.Tensor:
    """One slab's local solve for rhs (l1_max, mn[, r]), dispatching on the
    pivot block axis.  The y layout transposes rhs to y-major, solves the
    y-blocked factorization and transposes back (``start``/``tail`` are z-axis
    shortcuts and do not apply there)."""
    if slabs.pivot_layout == "y":
        l1, m, n = slabs.l1_max, slabs.m, slabs.n
        extra = tuple(rhs.shape[2:])
        r = rhs.reshape((l1, m, n) + extra).movedim(1, 0).reshape((m, l1 * n) + extra)
        u = block_thomas_solve_3d(fac_slice, r)
        u = u.reshape((m, l1, n) + extra).movedim(0, 1)
        return u.reshape((l1, m * n) + extra)
    if start or tail:
        return block_thomas_solve_support_3d(fac_slice, rhs, start=start, tail=tail)
    return block_thomas_solve_3d(fac_slice, rhs)


def partition_source_3d(slabs: SlabSystem3D, b: torch.Tensor) -> torch.Tensor:
    """Scatter a global (l*m*n[, r]) source into per-slab interior planes
    (S, l1_max, mn[, r]); trailing RHS columns ride along."""
    bg = b.reshape((slabs.l, slabs.m * slabs.n) + tuple(b.shape[1:]))
    gathered = bg[slabs.src_plane]                 # (S, l1_max, mn) + extra
    mask = slabs.src_valid.reshape(tuple(slabs.src_valid.shape) + (1,) * (gathered.ndim - 2))
    return torch.where(mask, gathered, torch.zeros_like(gathered))


def gather_interior_3d(slabs: SlabSystem3D, fields: torch.Tensor) -> torch.Tensor:
    """Collect per-slab (S, l1_max, mn[, r]) fields back to a flat global
    (l*m*n[, r]) vector."""
    out = fields[slabs.owner, slabs.owner_plane]   # (l, mn) + extra
    return out.reshape((slabs.l * slabs.m * slabs.n,) + tuple(fields.shape[3:]))


def _cpl_apply(sten: torch.Tensor, plane: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Apply an (m, n, 3, 3) inter-plane coupling stencil to a flat (mn[, r])
    plane; trailing RHS columns ride along."""
    extra = tuple(plane.shape[1:])
    return _plane_stencil_matvec(sten, plane.reshape((m, n) + extra)).reshape((m * n,) + extra)


def gs_sweep_3d(slabs: SlabSystem3D, b: torch.Tensor) -> torch.Tensor:
    """One optimized Gauss-Seidel down/up sweep over the z-slabs:
    ``u ~ Msp^{-1} b`` (the plane-trace form of ``precondGSOptimized``,
    ``src/preconditioner.jl:557-630``).

    DOWN: local solves in slab order, slab s receiving equivalent sources
    built from slab s-1's outgoing traces at its top trace planes. UP: the
    slabs in reverse, with the sources of slab s+1's traces at the bottom
    trace planes, keeping the volume solution and correcting the reflected
    trace ``u_1 <- u[l1] - u_np``.  In the z layout the down solves keep the
    forward pass's stacks and truncate the backward pass to ``trace_tail``
    planes, and the up solves resume from the stacks there
    (``block_thomas_solve_cached_3d``/``_resume_3d``); the y layout has no
    such shortcut and runs plain local solves (the JAX package's
    ``_gs_sweep_3d_plain``).

    ``b`` may carry trailing RHS columns (l*m*n, r): the plane solves then
    stream each pivot plane once for all r columns.
    """
    rhs = partition_source_3d(slabs, b)       # (S, l1_max, mn[, r]); updated in place
    S = slabs.n_subs
    if S == 1:
        # no interfaces: the sweep is the exact Msp solve
        u = slab_solve_3d(slabs, slabs.slab_facs[0], rhs[0])[None]
        return gather_interior_3d(slabs, u)
    cached = slabs.pivot_layout == "z"
    tail = slabs.trace_tail
    hs = slabs.host
    m, n = slabs.m, slabs.n

    caches, u_np_down = [], []
    u_n = u_np = None
    for s in range(S):
        if hs.has_top[s]:
            rhs[s, hs.l0[s]] += _cpl_apply(slabs.cpl_01[s], u_np, m, n)
            rhs[s, hs.l1[s]] -= _cpl_apply(slabs.cpl_10[s], u_n, m, n)
        if cached:
            v, y_c, t_c = block_thomas_solve_cached_3d(slabs.slab_facs[s], rhs[s], tail)
            caches.append((y_c, t_c))
        else:
            v = slab_solve_3d(slabs, slabs.slab_facs[s], rhs[s])
        if hs.has_bot[s]:
            u_n, u_np = v[hs.ln[s]], v[hs.lnp[s]]
        u_np_down.append(u_np)

    u = torch.empty_like(rhs)
    u_0 = u_1 = None
    for s in reversed(range(S)):
        if hs.has_bot[s]:
            rhs[s, hs.lnp[s]] += _cpl_apply(slabs.cpl_np_n[s], u_0, m, n)
            rhs[s, hs.ln[s]] -= _cpl_apply(slabs.cpl_n_np[s], u_1, m, n)
        if cached:
            u[s] = block_thomas_solve_resume_3d(slabs.slab_facs[s], rhs[s], *caches[s], tail)
        else:
            u[s] = slab_solve_3d(slabs, slabs.slab_facs[s], rhs[s])
        if hs.has_top[s]:
            u_0 = u[s, hs.l0[s]]
            u_1 = u[s, hs.l1[s]] - u_np_down[s - 1]     # reflection correction
    return gather_interior_3d(slabs, u)


@dataclasses.dataclass(frozen=True)
class GSPreconditioner3D:
    """Single-direction z-sweep preconditioner for the sparsified 3D system."""

    slabs: SlabSystem3D

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return gs_sweep_3d(self.slabs, b)

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, l*m*n) joint batch apply (``gmres_batched`` convention)."""
        return self.apply(b_batch.T).T

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply(b)


@dataclasses.dataclass(frozen=True)
class SingleSweepPreconditioner3D:
    """``b -> gs_sweep_3d(As b)``: the z-sweep applied to the full 3D
    Lippmann-Schwinger system (3D counterpart of the 2D
    ``SingleSweepPreconditioner``)."""

    slabs: SlabSystem3D
    a_s: StencilMatrix3D

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return gs_sweep_3d(self.slabs, self.a_s.matvec(b))

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, l*m*n) joint batch apply: the sweep's plane solves stream each
        pivot plane once for the whole multi-source batch."""
        return self.apply(b_batch.T).T

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply(b)
