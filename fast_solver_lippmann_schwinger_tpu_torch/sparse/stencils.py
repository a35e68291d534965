"""Sparsifying annihilator stencils (Ying 2014) for the LS preconditioner.

For each boundary class (interior / edges / corners in 2D: 9 classes) the
reference samples rows of the dense quadrature matrix ``G`` on a local
stencil, takes the last left singular vector of the far-field block as the
annihilating row ``a`` (so that ``a G ~ 0`` away from the stencil), and
assembles sparse ``A`` and ``A G``
(``entriesSparseA``/``entriesSparseG``/``buildSparseA(G)``,
``src/SparsifyingMatrix2D.jl`` whole file).

Classes are enumerated generically as products of per-axis categories
(lo/mid/hi), each class's stencil row is computed once on the host from
analytic Duan-Rokhlin Green's rows (float64 numpy/SciPy), and the result is
scattered into a dense stencil field (``StencilMatrix2D``) by per-class
masks: no COO/CSC assembly.  The other sampler, unit impulses through the
fast operator with the Gram matrices on the device
(``build_annihilator_classes_conv``), serves the 3D path (27 classes) and the
``conv_op=`` branch in 2D.

The annihilator row's overall phase/scale is arbitrary (an SVD gauge); it is
consistent between ``A`` and ``A G`` rows, which is all the preconditioner
``Msp^{-1} (A b)`` depends on.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device, to_tensor
from fast_solver_lippmann_schwinger_tpu_torch.ops import greens
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import (
    StencilMatrix2D,
    StencilMatrix3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.utils import checkpoint

# per-axis categories: (name, allowed offsets, representative index fn,
# node indicator fn)
_LO, _MID, _HI = 0, 1, 2


def _axis_offsets(cat: int):
    return {(_LO): (0, 1), (_MID): (-1, 0, 1), (_HI): (-1, 0)}[cat]


def _axis_rep(cat: int, size: int) -> int:
    return {(_LO): 0, (_MID): (size - 1) // 2, (_HI): size - 1}[cat]


def _axis_mask(cat: int, size: int) -> np.ndarray:
    idx = np.arange(size)
    if cat == _LO:
        return idx == 0
    if cat == _HI:
        return idx == size - 1
    return (idx > 0) & (idx < size - 1)


def _class_defs(shape):
    """Enumerate boundary classes: per-class category tuple, stencil
    offsets, and flat grid indices of the representative stencil."""
    shape = tuple(shape)
    ndim = len(shape)
    strides = np.array(
        [int(np.prod(shape[d + 1 :])) for d in range(ndim)], dtype=np.int64
    )
    class_defs = []
    for cats in itertools.product((_LO, _MID, _HI), repeat=ndim):
        offsets = list(
            itertools.product(*[_axis_offsets(c) for c in cats])
        )  # ordered tuples, slowest axis first
        rep = np.array([_axis_rep(c, s) for c, s in zip(cats, shape)], dtype=np.int64)
        flat = np.array(
            [int(np.dot(rep + np.array(off), strides)) for off in offsets],
            dtype=np.int64,
        )
        class_defs.append((cats, offsets, flat))
    return class_defs


def _uniq_indices(class_defs):
    # ONE sampler call for every class: deduplicated union of all stencil
    # indices (classes share most of their stencil nodes).
    all_flat = np.concatenate([flat for _, _, flat in class_defs])
    return np.unique(all_flat, return_inverse=True)


def build_annihilator_classes(
    sampler: Callable[[np.ndarray], np.ndarray],
    shape: Sequence[int],
):
    """Compute per-class annihilator rows and local Green's blocks from a
    host sampler (analytic Duan-Rokhlin rows).

    ``sampler(flat_indices) -> (len(indices), N)`` returns rows of the dense
    quadrature matrix G.  ``shape`` is the grid shape, slowest axis first
    (e.g. ``(m, n)`` in 2D).

    Returns a list of dicts with keys ``cats``, ``offsets`` (tuples, per grid
    axis, slowest first), ``a_row`` (s,), ``ag_row`` (s,).
    """
    shape = tuple(shape)
    N = int(np.prod(shape))
    class_defs = _class_defs(shape)
    uniq, inverse = _uniq_indices(class_defs)
    g_uniq = np.asarray(sampler(uniq))  # (len(uniq), N) complex

    classes = []
    pos = 0
    for cats, offsets, flat in class_defs:
        s = len(flat)
        g_rows = g_uniq[inverse[pos : pos + s]]
        pos += s
        far = np.ones(N, dtype=bool)
        far[flat] = False
        w = g_rows[:, far]
        # last left singular vector = best annihilator of the far field
        u, _, _ = np.linalg.svd(w, full_matrices=False)
        a_row = np.conj(u[:, -1])
        ag_row = a_row @ g_rows[:, flat]
        classes.append(
            dict(cats=cats, offsets=offsets, a_row=a_row, ag_row=ag_row)
        )
    return classes


def _annihilator_from_gram(c_far: np.ndarray, g_near: np.ndarray):
    """(a_row, ag_row) from the far-field Gram matrix and the near block.

    The smallest-eigenvalue eigenvector of ``C = W W^H`` equals the last left
    singular vector of ``W`` (up to phase: a gauge the preconditioner is
    invariant to, see the module docstring).  Host ``eigh`` in complex128."""
    c = np.asarray(c_far, dtype=np.complex128)
    c = 0.5 * (c + np.conj(c.T))          # exact Hermitian for eigh
    _, vecs = np.linalg.eigh(c)
    a_row = np.conj(vecs[:, 0])
    ag_row = a_row @ np.asarray(g_near, dtype=np.complex128)
    return a_row, ag_row


def _class_grams_device(rows, row_idx, col_idx, col_valid):
    """Per class, the s_max x s_max far-field Gram ``C = G G^H - G_near
    G_near^H`` and the near block ``G_near``, on the rows' device.

    ``rows`` (U, N) never leaves the device: only the small Gram and near
    blocks do.  The products run in the rows' own precision: the subtraction
    is a cancellation, which is why the JAX package asks for
    ``Precision.HIGHEST`` here and why the port leaves float32 matmuls in
    full float32 (``torch.backends.cuda.matmul.allow_tf32`` False,
    ``torch.get_float32_matmul_precision() == "highest"``, the defaults)."""
    ncls, s_max = row_idx.shape
    c_far = torch.empty((ncls, s_max, s_max), dtype=rows.dtype, device=rows.device)
    g_near = torch.empty_like(c_far)
    for c in range(ncls):
        g = rows[row_idx[c]]                     # (s_max, N)
        near = g[:, col_idx[c]]                  # (s_max, s_max)
        # padded column slots repeat column 0: mask them so the near-field
        # subtraction counts each true stencil column exactly once
        near_m = torch.where(col_valid[c][None, :], near, torch.zeros_like(near))
        c_far[c] = g @ g.conj().T - near_m @ near_m.conj().T
        g_near[c] = near
    return c_far, g_near


def build_annihilator_classes_conv(conv_op, shape: Sequence[int]):
    """Annihilator construction through a fast operator
    (``entriesSparseAConv``/``entriesSparseA3D`` semantics,
    ``src/SparsifyingMatrix2D.jl:104-201``,
    ``src/SparsifyingMatrix3D.jl:1136-1408``): Green's rows are sampled by
    unit impulses on the operator's device (``sample_g_columns``), each
    class's far-field Gram accumulates there, and only the small Gram and
    near blocks (27 x 27 x 27 at most) cross to the host for a complex128
    ``eigh``."""
    from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import sample_g_columns

    shape = tuple(shape)
    class_defs = _class_defs(shape)
    uniq, inverse = _uniq_indices(class_defs)
    rows = sample_g_columns(conv_op, uniq)          # (U, N) on the device

    s_max = max(len(flat) for _, _, flat in class_defs)
    ncls = len(class_defs)
    row_idx = np.zeros((ncls, s_max), dtype=np.int64)
    col_idx = np.zeros((ncls, s_max), dtype=np.int64)
    col_valid = np.zeros((ncls, s_max), dtype=bool)
    pos = 0
    for c, (_, _, flat) in enumerate(class_defs):
        s = len(flat)
        row_idx[c, :s] = inverse[pos : pos + s]
        col_idx[c, :s] = flat
        col_valid[c, :s] = True
        pos += s
    # padding rows repeat entry 0; they only touch Gram/near entries at
    # indices >= s, which the per-class [:s, :s] slice below never reads
    dev = rows.device
    c_far, g_near = _class_grams_device(
        rows, torch.as_tensor(row_idx, device=dev), torch.as_tensor(col_idx, device=dev),
        torch.as_tensor(col_valid, device=dev),
    )
    del rows
    c_far_h = c_far.cpu().numpy()
    g_near_h = g_near.cpu().numpy()

    classes = []
    for c, (cats, offsets, flat) in enumerate(class_defs):
        s = len(flat)
        a_row, ag_row = _annihilator_from_gram(c_far_h[c, :s, :s], g_near_h[c, :s, :s])
        classes.append(dict(cats=cats, offsets=offsets, a_row=a_row, ag_row=ag_row))
    return classes


def _assemble_fields(classes, shape, stencil_extent=3):
    """Scatter per-class rows into dense stencil fields (numpy, setup time)."""
    ndim = len(shape)
    a_field = np.zeros(tuple(shape) + (stencil_extent,) * ndim, dtype=np.complex128)
    ag_field = np.zeros_like(a_field)
    for cls in classes:
        mask = np.ones(shape, dtype=bool)
        for d, cat in enumerate(cls["cats"]):
            shp = [1] * ndim
            shp[d] = shape[d]
            mask = mask & _axis_mask(cat, shape[d]).reshape(shp)
        a_st = np.zeros((stencil_extent,) * ndim, dtype=np.complex128)
        ag_st = np.zeros_like(a_st)
        for off, av, agv in zip(cls["offsets"], cls["a_row"], cls["ag_row"]):
            pos = tuple(o + 1 for o in off)
            a_st[pos] = av
            ag_st[pos] = agv
        sel = (...,) + (None,) * ndim
        a_field = np.where(mask[sel], a_st, a_field)
        ag_field = np.where(mask[sel], ag_st, ag_field)
    return a_field, ag_field


# -----------------------------------------------------------------------------
# 2D stencil fields
# -----------------------------------------------------------------------------

def _cached_fields(compute, cache_dir, field_shape: tuple, /, **key_fields):
    """The host stencil fields ``(A, AG)`` from ``compute()`` or from their
    checkpoint in ``cache_dir`` (``stencils_<key>.pt``, keyed on the sampling
    configuration, as in the JAX package); a checkpoint must hold two
    complex128 fields of ``field_shape``."""
    if cache_dir is None:
        return compute()

    def fits(out):
        return len(out) == 2 and all(f.shape == field_shape and f.dtype == np.complex128
                                     for f in out)

    return checkpoint.cached(checkpoint.path_for(cache_dir, "stencils", **key_fields),
                             lambda: tuple(compute()), fits)


def _sampler_2d_trapezoidal(k, X, Y, d0, h):
    return lambda idx: greens.sample_g_rows_2d(k, X.ravel(), Y.ravel(), idx, d0, h)


def build_sparse_a_ag_2d(
    k: float,
    x: np.ndarray,
    y: np.ndarray,
    h: float,
    d0: complex | None = None,
    conv_op=None,
    dtype: torch.dtype = torch.complex64,
    cache_dir: str | None = None,
    return_host: bool = False,
    device=None,
):
    """Build the annihilator ``A`` and product ``A G`` as stencil fields.

    With ``conv_op=None`` uses direct Duan-Rokhlin Hankel sampling on the
    host (``entriesSparseA``/``entriesSparseG`` semantics,
    ``src/SparsifyingMatrix2D.jl:5-102,205-275``); otherwise samples G by
    unit impulses through the given fast operator (``entriesSparseAConv``,
    ``:104-201,278-348``; :func:`build_annihilator_classes_conv`).

    With ``return_host=True`` also returns the host numpy fields
    ``(A, AG, a_np, ag_np)``, used by the DDM layer to avoid a device
    round-trip when building slab systems.  ``cache_dir`` checkpoints the
    host fields (``utils/checkpoint.py``), so a repeat setup skips the
    sampling.

    Returns (A, AG) as ``StencilMatrix2D`` on ``device``.
    """
    device = resolve_device(device)
    n, m = len(x), len(y)
    if conv_op is None and d0 is None:
        d0 = greens.duan_rokhlin_d0(k * h)

    def fields():
        if conv_op is not None:
            classes = build_annihilator_classes_conv(conv_op, (m, n))
        else:
            X, Y = np.meshgrid(np.asarray(x), np.asarray(y), indexing="xy")
            sampler = _sampler_2d_trapezoidal(k, X, Y, d0, h)
            classes = build_annihilator_classes(sampler, (m, n))
        return _assemble_fields(classes, (m, n))

    a_field, ag_field = _cached_fields(
        fields, cache_dir, (m, n, 3, 3), kind="a_ag_2d", k=k, h=h, n=n, m=m,
        sampling=(f"conv_{conv_op.quad_rule}_{tuple(conv_op.symbol.shape)}"
                  if conv_op is not None else "d0"),
        d0=str(d0),
    )
    out = (
        StencilMatrix2D(values=to_tensor(a_field, dtype, device)),
        StencilMatrix2D(values=to_tensor(ag_field, dtype, device)),
    )
    return out + (a_field, ag_field) if return_host else out


def build_sparse_a_2d(k, x, y, h, d0=None, conv_op=None, dtype: torch.dtype = torch.complex64,
                      device=None) -> StencilMatrix2D:
    """``A`` only (reference ``buildSparseA``,
    ``src/SparsifyingMatrix2D.jl:806-884``)."""
    return build_sparse_a_ag_2d(k, x, y, h, d0=d0, conv_op=conv_op, dtype=dtype,
                                device=device)[0]


def build_msp_2d(a: StencilMatrix2D, ag: StencilMatrix2D, nu, k: float):
    """``Msp = A + k^2 (A G) diag(nu)`` (``examples/example.jl:67``)."""
    nu_arr = to_tensor(np.asarray(nu), a.values.dtype, a.values.device)
    return a + (k ** 2) * ag.scale_columns(nu_arr)


# -----------------------------------------------------------------------------
# 3D stencil fields
# -----------------------------------------------------------------------------

def build_sparse_a_ag_3d(
    k: float,
    conv_op,
    dtype: torch.dtype = torch.complex64,
    cache_dir: str | None = None,
    device=None,
):
    """3D annihilator fields via impulse sampling through the 3D fast
    operator (reference ``entriesSparseA3D``/``buildSparseA3DConv``/
    ``buildSparseAG3DConv``, ``src/SparsifyingMatrix3D.jl:963-1659``).

    ``cache_dir`` checkpoints the host fields, so a repeat setup skips the
    impulse sampling.  Returns (A, AG) as ``StencilMatrix3D`` on ``device``
    (the operator's device when ``None``)."""
    device = conv_op.symbol.device if device is None else resolve_device(device)
    shape = (conv_op.l, conv_op.m, conv_op.n)
    a_field, ag_field = _cached_fields(
        lambda: _assemble_fields(build_annihilator_classes_conv(conv_op, shape), shape),
        cache_dir, shape + (3, 3, 3), kind="a_ag_3d", k=k, shape=shape,
        sampling=f"conv_{conv_op.quad_rule}_{tuple(conv_op.symbol.shape)}",
    )
    return (
        StencilMatrix3D(values=to_tensor(a_field, dtype, device)),
        StencilMatrix3D(values=to_tensor(ag_field, dtype, device)),
    )


def build_msp_3d(a: StencilMatrix3D, ag: StencilMatrix3D, nu, k: float):
    """``Msp = A + k^2 (A G) diag(nu)`` in 3D."""
    nu_arr = to_tensor(np.asarray(nu), a.values.dtype, a.values.device)
    return a + (k ** 2) * ag.scale_columns(nu_arr)
