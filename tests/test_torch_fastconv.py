"""The port's Green's symbols and fast operator against the JAX package."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D as JGrid2D
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.ops import fastconv as jfastconv
from fast_solver_lippmann_schwinger_tpu.ops import greens as jgreens
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.ops import fastconv, greens
from torch_threads import few_threads  # noqa: F401

H = 1.0 / 40.0


def test_grid_and_medium_match():
    g, jg = Grid2D(a=1.0, h=H), JGrid2D(a=1.0, h=H)
    assert g.shape == jg.shape == (41, 41)
    np.testing.assert_array_equal(g.x, jg.x)
    X, Y = g.mesh()
    np.testing.assert_array_equal(media.plasma_2d(X, Y), jmedia.plasma_2d(X, Y))


@pytest.mark.parametrize("minimum", [1, 81, 1601, 2047])
@pytest.mark.parametrize("pow2", [False, True])
def test_good_fft_size_matches(minimum, pow2):
    assert greens.good_fft_size(minimum, prefer_pow2=pow2) == jgreens.good_fft_size(
        minimum, prefer_pow2=pow2
    )


def test_good_fft_size_default_is_5_smooth():
    # explicit default, no backend sniff: 1601 -> 1620 = 2^2 3^4 5
    assert greens.good_fft_size(1601) == 1620


@pytest.mark.parametrize("fn_name", ["gv_symbol_2d", "gv_compact_kernel_2d"])
def test_gv_symbols_match(fn_name):
    """Host float64 numpy/SciPy on both sides: equal to 1e-12."""
    n = m = 41
    kw = dict(prefer_pow2=False) if fn_name == "gv_compact_kernel_2d" else {}
    sym, ne, me = getattr(greens, fn_name)(n, m, H, 1.0 / H, **kw)
    jsym, jne, jme = getattr(jgreens, fn_name)(n, m, H, 1.0 / H, **kw)
    assert (ne, me) == (jne, jme)
    np.testing.assert_allclose(sym, jsym, rtol=1e-12, atol=1e-12 * np.abs(jsym).max())


def test_duan_rokhlin_and_rows_match():
    assert greens.duan_rokhlin_d0(1.0) == jgreens.duan_rokhlin_d0(1.0)
    g = Grid2D(a=1.0, h=1.0 / 10.0)
    X, Y = g.mesh()
    idx = np.array([0, 5, 60, 120])
    d0 = greens.duan_rokhlin_d0(1.0)
    rows = greens.sample_g_rows_2d(10.0, X.ravel(), Y.ravel(), idx, d0, g.h)
    jrows = jgreens.sample_g_rows_2d(10.0, X.ravel(), Y.ravel(), idx, d0, g.h)
    # the JAX package may sample through its C++ library, whose Hankel
    # evaluation differs from SciPy's in the last digits: 1e-10 of the max
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=1e-10 * np.abs(jrows).max())


@pytest.fixture(scope="module")
def operators():
    grid = Grid2D(a=1.0, h=H)
    k = 1.0 / H
    jop = jfastconv.build_fast_convolution_2d(
        grid.x, grid.y, H, k, jmedia.plasma_2d, quad_rule="greengard_vico",
        dtype=jnp.complex128, prefer_pow2=False,
    )
    op = fastconv.build_fast_convolution_2d(
        grid.x, grid.y, H, k, media.plasma_2d, quad_rule="greengard_vico",
        dtype=torch.complex128, prefer_pow2=False, device="cpu",
    )
    return grid, jop, op


def test_operator_fields_match(operators):
    _, jop, op = operators
    assert op.symbol.shape == jop.symbol.shape and op.shape == jop.shape
    np.testing.assert_allclose(op.symbol.numpy(), np.asarray(jop.symbol), rtol=1e-12,
                               atol=1e-12 * float(jnp.abs(jop.symbol).max()))
    np.testing.assert_array_equal(op.nu.numpy(), np.asarray(jop.nu))


@pytest.mark.parametrize("method", ["convolve", "apply"])
@pytest.mark.parametrize("gridded", [False, True])
def test_operator_matches(operators, method, gridded):
    """Same symbol, FFTs by pocketfft on both sides: rtol 1e-10."""
    grid, jop, op = operators
    rng = np.random.default_rng(1)
    u = rng.standard_normal(grid.size) + 1j * rng.standard_normal(grid.size)
    if gridded:
        u = u.reshape(grid.shape)
    want = np.asarray(getattr(jop, method)(jnp.asarray(u)))
    got = getattr(op, method)(torch.as_tensor(u)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_operator_batch_axis(operators):
    """An (R, N) batch goes through one set of batched FFTs and equals the
    row-by-row apply."""
    grid, _, op = operators
    rng = np.random.default_rng(2)
    U = torch.as_tensor(rng.standard_normal((3, grid.size)) + 1j * rng.standard_normal((3, grid.size)))
    got = op.apply(U)
    want = torch.stack([op.apply(U[i]) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_converted_operator_matches(operators):
    grid, jop, _ = operators
    op = convert.lippmann_schwinger_2d(
        np.asarray(jop.symbol), np.asarray(jop.nu), jop.omega, jop.n, jop.m, jop.quad_rule,
        device="cpu",
    )
    rng = np.random.default_rng(3)
    u = rng.standard_normal(grid.size) + 1j * rng.standard_normal(grid.size)
    np.testing.assert_allclose(
        op.apply(torch.as_tensor(u)).numpy(), np.asarray(jop.apply(jnp.asarray(u))),
        rtol=1e-10, atol=1e-10,
    )


def test_unported_branches_raise(tmp_path):
    """``cache_dir`` (checkpointing, slice 9), once unported, checkpoints the
    symbol: a second build loads it bit-identically, and the Greengard-Vico
    rule keys apart from the trapezoidal default (both branches are ported:
    ``test_trapezoidal_operator_matches``)."""
    grid = Grid2D(a=1.0, h=0.1)

    def build(**kw):
        return fastconv.build_fast_convolution_2d(
            grid.x, grid.y, 0.1, 10.0, media.plasma_2d, cache_dir=str(tmp_path),
            device="cpu", **kw
        )

    op1, op2 = build(), build()
    assert op1.quad_rule == "trapezoidal" and len(os.listdir(tmp_path)) == 1
    assert torch.equal(op1.symbol, op2.symbol)
    gv = build(quad_rule="greengard_vico")
    assert len(os.listdir(tmp_path)) == 2 and gv.quad_rule == "greengard_vico"


@pytest.mark.parametrize("n,m", [(41, 41), (21, 33)])
def test_trapezoidal_kernel_matches(n, m):
    """Host float64 on both sides at equal extended sizes; the Hankel tables
    may come from the JAX package's C++ sampler, whose last digits differ
    from SciPy's: 1e-10 of the max."""
    h = 1.0 / (n - 1)
    ne, me = greens.good_fft_size(2 * n - 1), greens.good_fft_size(2 * m - 1)
    sym, tne, tme = greens.trapezoidal_kernel_2d(n, m, h, 1.0 / h, ne=ne, me=me)
    jsym, jne, jme = jgreens.trapezoidal_kernel_2d(n, m, h, 1.0 / h, ne=ne, me=me)
    assert (tne, tme) == (jne, jme) == (ne, me)
    np.testing.assert_allclose(sym, jsym, rtol=0, atol=1e-10 * np.abs(jsym).max())
    with pytest.raises(ValueError, match="circulant"):
        greens.trapezoidal_kernel_2d(n, m, h, 1.0 / h, ne=2 * n - 2)


@pytest.mark.parametrize("pad_to_friendly", [True, False])
def test_trapezoidal_operator_matches(pad_to_friendly):
    """The trapezoidal operator in complex128 against the JAX package's on
    the same grid and medium, with the size class pinned on both sides: the
    same extended grid, and ``apply`` within 1e-10."""
    grid = Grid2D(a=1.0, h=H)
    k = 1.0 / H
    kw = dict(quad_rule="trapezoidal", pad_to_friendly=pad_to_friendly, prefer_pow2=False)
    jop = jfastconv.build_fast_convolution_2d(grid.x, grid.y, H, k, jmedia.plasma_2d,
                                              dtype=jnp.complex128, **kw)
    op = fastconv.build_fast_convolution_2d(grid.x, grid.y, H, k, media.plasma_2d,
                                            dtype=torch.complex128, device="cpu", **kw)
    assert op.symbol.shape == jop.symbol.shape and op.quad_rule == jop.quad_rule
    if not pad_to_friendly:
        assert op.symbol.shape == (2 * grid.m - 1, 2 * grid.n - 1)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(grid.size) + 1j * rng.standard_normal(grid.size)
    want = np.asarray(jop.apply(jnp.asarray(u)))
    got = op.apply(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_default_quadrature_is_trapezoidal():
    """Leaving ``quad_rule`` out gives the JAX package's default operator, the
    Duan-Rokhlin trapezoidal rule."""
    import inspect

    ours = inspect.signature(fastconv.build_fast_convolution_2d).parameters["quad_rule"]
    theirs = inspect.signature(jfastconv.build_fast_convolution_2d).parameters["quad_rule"]
    assert ours.default == theirs.default == "trapezoidal"
    grid = Grid2D(a=1.0, h=0.1)
    op = fastconv.build_fast_convolution_2d(grid.x, grid.y, 0.1, 10.0, media.plasma_2d,
                                            dtype=torch.complex128, device="cpu")
    trap = fastconv.build_fast_convolution_2d(grid.x, grid.y, 0.1, 10.0, media.plasma_2d,
                                              quad_rule="trapezoidal", dtype=torch.complex128,
                                              device="cpu")
    assert op.quad_rule == "trapezoidal"
    assert torch.equal(op.symbol, trap.symbol)
