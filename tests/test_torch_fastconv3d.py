"""The port's 3D grid, medium, Greengard-Vico symbol, fast operator and
impulse sampler against the JAX package (complex128, 10^3 grid)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.core.grids import Grid3D as JGrid3D
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.ops import fastconv as jfastconv
from fast_solver_lippmann_schwinger_tpu.ops import greens as jgreens
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid3D
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.ops import fastconv, greens
from torch_threads import few_threads  # noqa: F401

H = 1.0 / 10.0


def _rand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_grid_and_medium_match():
    g, jg = Grid3D(a=1.0, h=H), JGrid3D(a=1.0, h=H)
    assert g.n == jg.n == 10 and g.shape == jg.shape and g.size == 1000
    np.testing.assert_array_equal(g.x, jg.x)
    for a, b in zip(g.mesh(), jg.mesh()):
        np.testing.assert_array_equal(a, b)
    X, Y, Z = g.mesh()
    np.testing.assert_array_equal(media.gaussian_bump_3d(X, Y, Z),
                                  jmedia.gaussian_bump_3d(X, Y, Z))
    assert Grid3D(a=1.0, h=1 / 48).n == 48


@pytest.mark.parametrize("prefer_pow2", [False, True])
def test_compact_symbol_matches(prefer_pow2):
    """Host float64 numpy on both sides: the same numbers."""
    got = greens.gv_compact_kernel_3d(10, 9, 8, H, 10.0, prefer_pow2=prefer_pow2)
    want = jgreens.gv_compact_kernel_3d(10, 9, 8, H, 10.0, prefer_pow2=prefer_pow2)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])
    full = greens.gv_symbol_3d(6, 6, 6, H, 10.0)
    np.testing.assert_array_equal(full[0], jgreens.gv_symbol_3d(6, 6, 6, H, 10.0)[0])


@pytest.fixture(scope="module")
def ops():
    grid = Grid3D(a=1.0, h=H)
    k = 1.0 / H
    X, Y, Z = grid.mesh()
    nu = media.gaussian_bump_3d(X, Y, Z)
    jop = jfastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, H, k, nu,
                                              dtype=jnp.complex128, prefer_pow2=False)
    top = fastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, H, k, nu,
                                             dtype=torch.complex128, prefer_pow2=False,
                                             device="cpu")
    return jop, top


def test_operator_fields_match(ops):
    jop, top = ops
    assert top.symbol.shape == jop.symbol.shape == (20, 20, 20)
    np.testing.assert_allclose(top.symbol.numpy(), np.asarray(jop.symbol), rtol=1e-15)
    np.testing.assert_array_equal(top.nu.numpy(), np.asarray(jop.nu))
    assert (top.omega, top.shape, top.quad_rule) == (jop.omega, jop.shape, jop.quad_rule)


@pytest.mark.parametrize("shape", [(1000,), (10, 10, 10)])
def test_convolve_and_apply_match(ops, shape):
    """The same FFT stages in complex128: agreement to rounding."""
    jop, top = ops
    u = _rand(np.random.default_rng(1), shape)
    for name in ("convolve", "apply"):
        want = np.asarray(getattr(jop, name)(jnp.asarray(u)))
        got = getattr(top, name)(torch.as_tensor(u)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_batched_apply_is_per_field(ops):
    """A leading batch axis rides through every FFT stage."""
    jop, top = ops
    u = _rand(np.random.default_rng(2), (3, 1000))
    got = top.apply(torch.as_tensor(u)).numpy()
    for r in range(3):
        want = np.asarray(jop.apply(jnp.asarray(u[r])))
        np.testing.assert_allclose(got[r], want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_converted_operator_is_the_same(ops):
    jop, top = ops
    c = convert.lippmann_schwinger_3d(np.asarray(jop.symbol), np.asarray(jop.nu), jop.omega,
                                      jop.n, jop.m, jop.l, jop.quad_rule, device="cpu")
    u = torch.as_tensor(_rand(np.random.default_rng(3), (1000,)))
    torch.testing.assert_close(c.apply(u), top.apply(u), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [64, 7])
def test_sample_g_columns_matches(ops, chunk):
    """Impulse rows, in one chunk and in chunks with a ragged last one."""
    jop, top = ops
    idx = np.random.default_rng(4).choice(1000, 30, replace=False)
    want = np.asarray(jfastconv.sample_g_columns(jop, idx))
    got = fastconv.sample_g_columns(top, idx, chunk=chunk).numpy()
    assert got.shape == (30, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    # G is symmetric: row j of the sample is column j of G
    np.testing.assert_allclose(got[:, idx], got[:, idx].T, rtol=0, atol=1e-12 * np.abs(got).max())


def test_unported_options_raise(tmp_path):
    """``cache_dir``, once unported, checkpoints the 3D symbol (a second build
    loads it bit-identically); the trapezoidal rule still raises in 3D."""
    grid = Grid3D(a=1.0, h=H)
    op1, op2 = (fastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, H, 10.0,
                                                   lambda x, y, z: x, cache_dir=str(tmp_path),
                                                   device="cpu") for _ in range(2))
    assert len(os.listdir(tmp_path)) == 1 and torch.equal(op1.symbol, op2.symbol)
    with pytest.raises(NotImplementedError):
        fastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, H, 10.0, lambda x, y, z: x,
                                           quad_rule="trapezoidal", device="cpu")
