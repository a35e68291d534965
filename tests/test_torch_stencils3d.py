"""The port's 3D stencil fields, the device-Gram annihilator construction
(3D, and the 2D ``conv_op=`` branch) and ``Msp`` against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.ops import fastconv as jfastconv
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix3D as JStencilMatrix3D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D, Grid3D
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.ops import fastconv
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils
from torch_threads import few_threads  # noqa: F401

L, M, N = 4, 5, 6
H = 1.0 / 10.0


def _rand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def pair():
    v = _rand(np.random.default_rng(0), (L, M, N, 3, 3, 3))
    return JStencilMatrix3D(values=jnp.asarray(v)), convert.stencil_matrix_3d(v, device="cpu")


@pytest.mark.parametrize("shape", [(L * M * N,), (L, M, N), (L * M * N, 3), (L, M, N, 2)])
def test_matvec_matches(pair, shape):
    """Single and multi-RHS: the same 27 multiply-adds in the same order."""
    js, ts = pair
    u = _rand(np.random.default_rng(1), shape)
    want = np.asarray(js.matvec(jnp.asarray(u)))
    got = ts.matvec(torch.as_tensor(u)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_algebra_and_dense_match(pair):
    js, ts = pair
    d = np.random.default_rng(3).standard_normal((L, M, N))
    for got, want in [
        (ts.scale_columns(torch.as_tensor(d)), js.scale_columns(jnp.asarray(d))),
        (ts.matrix_transpose(), js.matrix_transpose()),
        (ts + ts * 2.5, js + js * 2.5),
        ((0.5 + 1j) * ts, (0.5 + 1j) * js),
    ]:
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values), rtol=1e-14)
    dense = ts.to_dense()
    np.testing.assert_array_equal(dense, js.to_dense())
    np.testing.assert_array_equal(ts.matrix_transpose().to_dense(), dense.T)
    u = _rand(np.random.default_rng(2), (L * M * N,))
    np.testing.assert_allclose(ts.matvec(torch.as_tensor(u)).numpy(), dense @ u, rtol=1e-12)


def test_class_defs_match_in_3d():
    defs, jdefs = stencils._class_defs((4, 5, 6)), jstencils._class_defs((4, 5, 6))
    assert len(defs) == len(jdefs) == 27
    for (c, o, f), (jc, jo, jf) in zip(defs, jdefs):
        assert c == jc and o == jo
        np.testing.assert_array_equal(f, jf)


@pytest.fixture(scope="module")
def fields():
    grid = Grid3D(a=1.0, h=H)
    k = 1.0 / H
    X, Y, Z = grid.mesh()
    nu = media.gaussian_bump_3d(X, Y, Z)
    jop = jfastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, H, k, nu,
                                              dtype=jnp.complex128, prefer_pow2=False)
    top = fastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, H, k, nu,
                                             dtype=torch.complex128, prefer_pow2=False,
                                             device="cpu")
    ja = jstencils.build_sparse_a_ag_3d(k, jop, dtype=jnp.complex128)
    ta = stencils.build_sparse_a_ag_3d(k, top, dtype=torch.complex128)
    return grid, k, nu, jop, top, ja, ta


def _row_phases(t_a, j_a):
    """Per grid node, the unit phase that maps the port's annihilator row
    onto the JAX package's.  Each row is an ``eigh`` eigenvector, fixed only
    up to a phase; the phase is shared by a node's ``A`` and ``A G`` rows,
    and the preconditioner ``Msp^{-1} A`` does not depend on it."""
    axes = tuple(range(t_a.ndim // 2, t_a.ndim))
    dots = np.sum(np.conj(t_a) * j_a, axis=axes)
    np.testing.assert_allclose(np.abs(dots), 1.0, rtol=1e-8)   # unit rows, parallel
    return (dots / np.abs(dots))[(...,) + (None,) * len(axes)]


def test_gram_pass_matches(fields):
    """The device Gram pass on the same rows, index tables and mask:
    complex128 products, agreement to rounding."""
    _, _, _, jop, top, _, _ = fields
    defs = stencils._class_defs((10, 10, 10))
    uniq, inverse = stencils._uniq_indices(defs)
    rows = fastconv.sample_g_columns(top, uniq)
    ncls, s_max = len(defs), max(len(f) for _, _, f in defs)
    row_idx = np.zeros((ncls, s_max), np.int64)
    col_idx = np.zeros((ncls, s_max), np.int64)
    valid = np.zeros((ncls, s_max), bool)
    pos = 0
    for c, (_, _, flat) in enumerate(defs):
        s = len(flat)
        row_idx[c, :s], col_idx[c, :s], valid[c, :s] = inverse[pos : pos + s], flat, True
        pos += s
    got = stencils._class_grams_device(rows, torch.as_tensor(row_idx),
                                       torch.as_tensor(col_idx), torch.as_tensor(valid))
    want = jstencils._class_grams_jit(jnp.asarray(rows.numpy()), jnp.asarray(row_idx),
                                      jnp.asarray(col_idx), jnp.asarray(valid))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())


def test_annihilator_fields_match(fields):
    """``A`` and ``A G`` agree once each node's row phase is normalised."""
    _, _, _, _, _, ja, ta = fields
    j_a, j_ag = np.asarray(ja[0].values), np.asarray(ja[1].values)
    t_a, t_ag = ta[0].values.numpy(), ta[1].values.numpy()
    ph = _row_phases(t_a, j_a)
    for t, j in ((t_a, j_a), (t_ag, j_ag)):
        np.testing.assert_allclose(ph * t, j, rtol=0, atol=1e-8 * np.abs(j).max())


def test_ag_consistency_oracle(fields):
    """``A G`` rows on the stencil pattern equal ``A`` times the dense G
    sampled by impulses (``tests/test_3d.py:70-82``)."""
    grid, _, _, _, top, _, ta = fields
    G = fastconv.sample_g_columns(top, np.arange(grid.size)).numpy()
    AG_true = ta[0].to_dense() @ G
    AG_sp = ta[1].to_dense()
    pattern = np.abs(AG_sp) > 0
    np.testing.assert_allclose(AG_sp[pattern], AG_true[pattern], rtol=1e-7, atol=1e-11)


def test_msp_matches(fields):
    _, k, nu, _, _, ja, ta = fields
    want = np.asarray(jstencils.build_msp_3d(ja[0], ja[1], nu, k).values)
    got = stencils.build_msp_3d(ta[0], ta[1], nu, k).values.numpy()
    ph = _row_phases(ta[0].values.numpy(), np.asarray(ja[0].values))
    np.testing.assert_allclose(ph * got, want, rtol=0, atol=1e-8 * np.abs(want).max())
    # on carried-over fields there is no gauge: rounding only
    tmsp = stencils.build_msp_3d(convert.stencil_matrix_3d(np.asarray(ja[0].values), device="cpu"),
                                 convert.stencil_matrix_3d(np.asarray(ja[1].values), device="cpu"),
                                 nu, k)
    np.testing.assert_allclose(tmsp.values.numpy(), want, rtol=1e-13, atol=1e-13)


def test_conv_op_branch_in_2d():
    """``build_sparse_a_ag_2d(conv_op=...)`` samples G through the 2D fast
    operator, as the JAX package's branch does."""
    from fast_solver_lippmann_schwinger_tpu.ops.fastconv import build_fast_convolution_2d
    from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
        build_fast_convolution_2d as tbuild,
    )

    grid = Grid2D(a=1.0, h=1.0 / 12.0)
    k = 12.0
    X, Y = grid.mesh()
    nu = media.plasma_2d(X, Y)
    jop = build_fast_convolution_2d(grid.x, grid.y, grid.h, k, nu, quad_rule="greengard_vico",
                                    dtype=jnp.complex128, prefer_pow2=False)
    top = tbuild(grid.x, grid.y, grid.h, k, nu, quad_rule="greengard_vico",
                 dtype=torch.complex128, device="cpu")
    ja = jstencils.build_sparse_a_ag_2d(k, grid.x, grid.y, grid.h, conv_op=jop,
                                        dtype=jnp.complex128)
    ta = stencils.build_sparse_a_ag_2d(k, grid.x, grid.y, grid.h, conv_op=top,
                                       dtype=torch.complex128, device="cpu")
    ph = _row_phases(ta[0].values.numpy(), np.asarray(ja[0].values))
    for t, j in zip(ta, ja):
        j = np.asarray(j.values)
        np.testing.assert_allclose(ph * t.values.numpy(), j, rtol=0, atol=1e-8 * np.abs(j).max())


def test_to_coo_matches_the_jax_triplets(fields):
    """``StencilMatrix3D.to_coo`` against the JAX package's on the h = 1/10
    annihilator (the port's field, so that the annihilator's phase plays no
    part, in both packages' matrices): the same indices, values within 1e-12
    in complex128, and scipy's COO matrix of the triplets times a random
    vector is the matvec."""
    import scipy.sparse as sp

    ta = fields[-1][0]
    v = ta.values.numpy()
    rows, cols, vals = ta.to_coo()
    jrows, jcols, jvals = JStencilMatrix3D(values=jnp.asarray(v)).to_coo()
    for got, want in ((rows, jrows), (cols, jcols)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert isinstance(vals, np.ndarray) and vals.dtype == np.complex128
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=0, atol=1e-12)
    size = v.shape[0] * v.shape[1] * v.shape[2]
    u = _rand(np.random.default_rng(5), (size,))
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(size, size))
    np.testing.assert_allclose(coo @ u, ta.matvec(torch.as_tensor(u)).numpy(), rtol=1e-12,
                               atol=1e-12 * np.abs(v).max())


def test_unported_options_raise_3d(fields, tmp_path):
    """``cache_dir``, once unported, checkpoints the 3D fields: a first build
    writes what the uncached one computes, a second loads it bit-identically."""
    _, k, _, _, top, _, ta = fields
    for _ in range(2):
        got = stencils.build_sparse_a_ag_3d(k, top, dtype=torch.complex128,
                                            cache_dir=str(tmp_path))
        for a, b in zip(got, ta):
            assert torch.equal(a.values, b.values)
    assert len(list(tmp_path.iterdir())) == 1
