"""The port's stencil fields and annihilator construction against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix2D as JStencilMatrix2D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix2D
from torch_threads import few_threads  # noqa: F401

M, N = 7, 9


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((M, N, 3, 3)) + 1j * rng.standard_normal((M, N, 3, 3))
    return JStencilMatrix2D(values=jnp.asarray(v)), convert.stencil_matrix_2d(v, device="cpu")


def _rand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("shape", [(M * N,), (M, N), (M * N, 3), (M, N, 2)])
def test_matvec_matches(pair, shape):
    """Single and multi-RHS: the same 9 multiply-adds in the same order."""
    js, ts = pair
    u = _rand(np.random.default_rng(1), shape)
    want = np.asarray(js.matvec(jnp.asarray(u)))
    got = ts.matvec(torch.as_tensor(u)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_matvec_matches_dense(pair):
    _, ts = pair
    u = _rand(np.random.default_rng(2), (M * N,))
    np.testing.assert_allclose(
        ts.matvec(torch.as_tensor(u)).numpy(), ts.to_dense() @ u, rtol=1e-12, atol=1e-12
    )
    assert ts.shape == (M * N, M * N)


def test_algebra_matches(pair):
    js, ts = pair
    d = np.random.default_rng(3).standard_normal((M, N))
    for got, want in [
        (ts.scale_columns(torch.as_tensor(d)), js.scale_columns(jnp.asarray(d))),
        (ts.transpose(), js.transpose()),
        (ts + ts * 2.5, js + js * 2.5),
        ((0.5 + 1j) * ts, (0.5 + 1j) * js),
    ]:
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values), rtol=1e-14)
    np.testing.assert_array_equal(ts.to_dense(), js.to_dense())


def test_class_defs_match():
    defs, jdefs = stencils._class_defs((5, 6)), jstencils._class_defs((5, 6))
    assert len(defs) == len(jdefs) == 9
    for (c, o, f), (jc, jo, jf) in zip(defs, jdefs):
        assert c == jc and o == jo
        np.testing.assert_array_equal(f, jf)
    u, inv = stencils._uniq_indices(defs)
    ju, jinv = jstencils._uniq_indices(jdefs)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(inv, jinv)


@pytest.fixture(scope="module")
def fields():
    grid = Grid2D(a=1.0, h=1.0 / 20.0)
    k = 1.0 / grid.h
    ja = jstencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, grid.h, dtype=jnp.complex128, return_host=True
    )
    ta = stencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, grid.h, dtype=torch.complex128, return_host=True, device="cpu"
    )
    return grid, k, ja, ta


def _row_phases(t_a, j_a):
    """Per grid node, the unit phase that maps the port's annihilator row
    onto the JAX package's.  Each row is a singular vector, fixed only up to
    a phase (the SVD gauge); LAPACK picks it from the last bits of its
    input, and the two packages' Hankel samplers differ there.  The gauge is
    shared by a node's ``A`` and ``A G`` rows, and the preconditioner
    ``Msp^{-1} A`` does not depend on it."""
    dots = np.einsum("jiab,jiab->ji", np.conj(t_a), j_a)
    np.testing.assert_allclose(np.abs(dots), 1.0, rtol=1e-9)   # unit rows, parallel
    return (dots / np.abs(dots))[:, :, None, None]


def test_annihilator_fields_match(fields):
    """``A`` and ``A G`` agree to 1e-9 once each node's row phase is
    normalised (see :func:`_row_phases`)."""
    _, _, ja, ta = fields
    ph = _row_phases(ta[2], ja[2])
    for t_st, j_st, t_np, j_np in zip(ta[:2], ja[:2], ta[2:], ja[2:]):
        scale = np.abs(j_np).max()
        np.testing.assert_allclose(ph * t_np, j_np, rtol=0, atol=1e-9 * scale)
        np.testing.assert_allclose(ph * t_st.values.numpy(), np.asarray(j_st.values),
                                   rtol=0, atol=1e-9 * scale)


def test_msp_matches(fields):
    grid, k, ja, ta = fields
    X, Y = grid.mesh()
    nu = media.plasma_2d(X, Y)
    jmsp = jstencils.build_msp_2d(ja[0], ja[1], nu, k)
    tmsp = stencils.build_msp_2d(ta[0], ta[1], nu, k)
    want = np.asarray(jmsp.values)
    got = _row_phases(ta[2], ja[2]) * tmsp.values.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_msp_matches_on_carried_over_fields(fields):
    """Same ``A``/``A G`` on both sides (carried over): no gauge involved."""
    grid, k, ja, _ = fields
    X, Y = grid.mesh()
    nu = media.plasma_2d(X, Y)
    jmsp = jstencils.build_msp_2d(ja[0], ja[1], nu, k)
    tmsp = stencils.build_msp_2d(
        convert.stencil_matrix_2d(ja[2], device="cpu"),
        convert.stencil_matrix_2d(ja[3], device="cpu"), nu, k
    )
    np.testing.assert_allclose(tmsp.values.numpy(), np.asarray(jmsp.values), rtol=1e-13, atol=1e-13)


@pytest.fixture(scope="module")
def annihilator_h40():
    """The port's complex128 annihilator field at h = 1/40, as numpy values."""
    grid = Grid2D(a=1.0, h=1.0 / 40.0)
    a = stencils.build_sparse_a_2d(1.0 / grid.h, grid.x, grid.y, grid.h,
                                   dtype=torch.complex128, device="cpu")
    return a.values.numpy()


def test_to_coo_matches_the_jax_triplets(annihilator_h40):
    """``StencilMatrix2D.to_coo`` against the JAX package's on the h = 1/40
    annihilator, both matrices built from the same values (so the
    annihilator's phase plays no part): the same indices, values within
    1e-12 in complex128, and scipy's COO matrix of the triplets times a
    random vector is the matvec."""
    import scipy.sparse as sp

    v = annihilator_h40
    ts = StencilMatrix2D(values=torch.as_tensor(v))
    rows, cols, vals = ts.to_coo()
    jrows, jcols, jvals = JStencilMatrix2D(values=jnp.asarray(v)).to_coo()
    for got, want in ((rows, jrows), (cols, jcols)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert isinstance(vals, np.ndarray) and vals.dtype == np.complex128
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=0, atol=1e-12)
    size = v.shape[0] * v.shape[1]
    assert len(rows) == 9 * size - 6 * (v.shape[0] + v.shape[1]) + 4   # taps inside the grid
    u = _rand(np.random.default_rng(4), (size,))
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(size, size))
    np.testing.assert_allclose(coo @ u, ts.matvec(torch.as_tensor(u)).numpy(), rtol=1e-12,
                               atol=1e-12 * np.abs(v).max())


def test_unported_options_raise(tmp_path):
    """``conv_op=`` sampling is ported (``tests/test_torch_stencils3d.py``);
    ``cache_dir``, once unported, checkpoints the host fields: a second build
    loads them bit-identically, host arrays and device fields alike."""
    grid = Grid2D(a=1.0, h=0.1)
    first, second = (stencils.build_sparse_a_ag_2d(10.0, grid.x, grid.y, 0.1, return_host=True,
                                                   cache_dir=str(tmp_path), device="cpu")
                     for _ in range(2))
    assert len(list(tmp_path.iterdir())) == 1
    for a, b in zip(first[:2], second[:2]):
        assert torch.equal(a.values, b.values)
    for a, b in zip(first[2:], second[2:]):
        np.testing.assert_array_equal(a, b)
