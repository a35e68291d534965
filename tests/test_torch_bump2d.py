"""The 2D sparsifying bump slice (``examples/example.jl``) against the JAX
package: the media, the dense quadrature oracle, the native Hankel sampler,
and ``bump2d.build_problem``/``solve`` at h = 1/40 in complex128, where both
packages compute the same operator, stencils and dense LAPACK factorization
and agree to rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.models import bump2d as jbump2d
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.native import sampler as jsampler
from fast_solver_lippmann_schwinger_tpu.ops import greens as jgreens
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.models import bump2d, media
from fast_solver_lippmann_schwinger_tpu_torch.native import sampler
from fast_solver_lippmann_schwinger_tpu_torch.ops import greens
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner,
)
from torch_threads import few_threads  # noqa: F401


def test_media_match():
    grid = Grid2D(a=1.0, h=1.0 / 40.0)
    X, Y = grid.mesh()
    np.testing.assert_array_equal(media.gaussian_bump_2d(X, Y), jmedia.gaussian_bump_2d(X, Y))
    np.testing.assert_array_equal(media.gaussian_bump_2d(X, Y, 0.5, 20.0, 0.3),
                                  jmedia.gaussian_bump_2d(X, Y, 0.5, 20.0, 0.3))
    np.testing.assert_array_equal(media.plasma_2d_transposed(X, Y),
                                  jmedia.plasma_2d_transposed(X, Y))
    np.testing.assert_array_equal(media.plasma_2d_transposed(X, Y), media.plasma_2d(Y, X))


def test_dense_conv_matrix_matches():
    grid = Grid2D(a=1.0, h=1.0 / 16.0)
    k = 16.0
    X, Y = grid.mesh()
    d0 = greens.duan_rokhlin_d0(k * grid.h)
    got = greens.dense_conv_matrix_2d(k, X.ravel(), Y.ravel(), d0, grid.h)
    want = jgreens.dense_conv_matrix_2d(k, X.ravel(), Y.ravel(), d0, grid.h)
    assert got.shape == (grid.size, grid.size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    np.testing.assert_allclose(got, got.T, rtol=0, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("k,h", [(800.0, 1.0 / 800.0), (200.0, 0.005), (40.0, 1.0 / 40.0)])
def test_native_hankel_sampler(k, h):
    """The OpenMP sampler against its SciPy (AMOS) plain version and against
    the JAX package's sampler, to 1e-11 (relative to each entry, with a
    floor of 1e-11 of the table's max-norm), over the distances of the
    solver's tables (k r from 1 to about 1.1e3)."""
    rng = np.random.default_rng(0)
    r = rng.uniform(h, 1.4, (20, 1000))
    got = sampler.hankel_kernel_table(k, r, h)
    assert got.shape == r.shape and got.dtype == np.complex128
    for want in (sampler.hankel_kernel_table_plain(k, r, h), jsampler.hankel_kernel_table(k, r, h)):
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11 * np.abs(want).max())


def test_native_helmholtz3d_sampler():
    rng = np.random.default_rng(1)
    r = rng.uniform(1.0 / 48.0, 1.8, 20000)
    got = sampler.helmholtz3d_kernel_table(48.0, r, 1.0 / 48.0)
    for want in (sampler.helmholtz3d_kernel_table_plain(48.0, r, 1.0 / 48.0),
                 jsampler.helmholtz3d_kernel_table(48.0, r, 1.0 / 48.0)):
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_sampler_builds_into_build_and_raises_on_failure(tmp_path, monkeypatch):
    """The library lies under the git-ignored ``build/`` at the repository
    root, named after the hash of its source; a source that does not compile
    raises with the compiler's message (no SciPy fallback)."""
    path = sampler.library_path()
    assert path.parent.name == "build" and (path.parents[1] / "fast_solver_lippmann_schwinger_tpu_torch").is_dir()
    sampler.load_library()
    assert path.exists()
    broken = tmp_path / "hankel_sampler.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(sampler, "SOURCE", broken)
    monkeypatch.setattr(sampler, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        sampler.build_library()
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# the slice whole, h = 1/40 (k = 40, 41 x 41), complex128
# ---------------------------------------------------------------------------

HIST = dict(rtol=1e-8, floor=1e-13)


@pytest.fixture(scope="module")
def problems():
    jp = jbump2d.build_problem(h=1.0 / 40.0, dtype=jnp.complex128)
    tp = bump2d.build_problem(h=1.0 / 40.0, dtype=torch.complex128, device="cpu")
    return jp, tp


def test_problem_matches(problems):
    jp, tp = problems
    assert tp.grid.shape == jp.grid.shape == (41, 41) and tp.k == jp.k == 40.0
    assert tp.op.quad_rule == jp.op.quad_rule == "greengard_vico"
    for got, want in ((tp.rhs, jp.rhs), (tp.u_inc, jp.u_inc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
    want = np.asarray(jp.precond.factorization.cinv)
    np.testing.assert_allclose(tp.precond.factorization.cinv.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    assert set(tp.setup_seconds) == {"symbol", "stencils", "msp", "factorization"}


def _check(info, x, jinfo, jx):
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and bool(info.converged) and bool(jinfo.converged)
    want = np.asarray(jinfo.residuals)
    assert info.residuals.shape == want.shape
    np.testing.assert_allclose(info.residuals.numpy()[: n_it + 1], want[: n_it + 1],
                               rtol=HIST["rtol"], atol=HIST["floor"] * want[0])
    want = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-8 * np.abs(want).max())
    return n_it


def test_preconditioned_solve_matches(problems):
    """The JAX package pins 4 iterations here (``tests/test_end_to_end_2d.py``)."""
    jp, tp = problems
    jx, jinfo = jbump2d.solve(jp, rtol=1e-8)
    x, info = bump2d.solve(tp, rtol=1e-8)
    assert _check(info, x, jinfo, jx) == 4
    assert float(info.true_residual) < 1e-6


def test_unpreconditioned_solve_matches(problems):
    jp, tp = problems
    jx, jinfo = jbump2d.solve(jp, rtol=1e-8, preconditioned=False, maxiter=400)
    x, info = bump2d.solve(tp, rtol=1e-8, preconditioned=False, maxiter=400)
    n_it = _check(info, x, jinfo, jx)
    xp, info_p = bump2d.solve(tp, rtol=1e-8)
    assert n_it > int(info_p.n_iterations)
    assert float(torch.linalg.vector_norm(x - xp) / torch.linalg.vector_norm(xp)) < 1e-5


def test_preconditioner_carried_and_apply_batch(problems):
    """The JAX preconditioner carried across applies as the port's own, and
    ``apply_batch`` on three columns equals three single applies."""
    jp, tp = problems
    jpc = jp.precond
    carried = convert.sparsifying_preconditioner(
        dict(cinv=np.asarray(jpc.factorization.cinv), lband=np.asarray(jpc.factorization.lband),
             uband=np.asarray(jpc.factorization.uband)),
        np.asarray(jpc.a_s.values), device="cpu")
    assert isinstance(carried, SparsifyingPreconditioner)
    rng = np.random.default_rng(4)
    B = rng.standard_normal((3, tp.grid.size)) + 1j * rng.standard_normal((3, tp.grid.size))
    want = np.asarray(jpc.apply(jnp.asarray(B[0])))
    for pc in (tp.precond, carried):
        np.testing.assert_allclose(pc(torch.as_tensor(B[0])).numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())
    batch = tp.precond.apply_batch(torch.as_tensor(B))
    assert tuple(batch.shape) == B.shape
    for i in range(3):
        single = tp.precond.apply(torch.as_tensor(B[i]))
        np.testing.assert_allclose(batch[i].numpy(), single.numpy(), rtol=0,
                                   atol=1e-12 * float(single.abs().max()))


def test_problem_carried_across(problems):
    """``convert.bump2d_problem`` rebuilds the JAX problem in the port: its
    solve takes the JAX iterations."""
    jp, tp = problems
    carried = convert.bump2d_problem(
        dict(symbol=np.asarray(jp.op.symbol), nu=np.asarray(jp.op.nu), omega=jp.op.omega,
             n=jp.op.n, m=jp.op.m, quad_rule=jp.op.quad_rule),
        dict(cinv=np.asarray(jp.precond.factorization.cinv),
             lband=np.asarray(jp.precond.factorization.lband),
             uband=np.asarray(jp.precond.factorization.uband)),
        np.asarray(jp.precond.a_s.values), np.asarray(jp.rhs), np.asarray(jp.u_inc),
        h=jp.grid.h, k=jp.k, device="cpu")
    x, info = bump2d.solve(carried, rtol=1e-8)
    xo, info_o = bump2d.solve(tp, rtol=1e-8)
    assert int(info.n_iterations) == int(info_o.n_iterations) == 4
    np.testing.assert_allclose(x.numpy(), xo.numpy(), rtol=0, atol=1e-9 * float(xo.abs().max()))


def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here; the rule is tested where it does not")
    with pytest.raises(RuntimeError, match="CUDA"):
        bump2d.build_problem(h=1.0 / 8.0)
