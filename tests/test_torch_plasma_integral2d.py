"""The polarized-traces slice as a whole against the JAX package: each
package builds ``plasma_integral2d.build_problem`` on its own (trapezoidal
quadrature, the default) at h = 1/40 with 4 slabs, npml = 6, nIt = 2, in
complex128 with dense pivots, and solves.  Both sides compute the same
operator and their own annihilator stencils and LAPACK factorizations, so
they agree to rounding: the tolerances of the multi-slab slice in
``tests/test_torch_plasma2d.py``.  One JAX solve is compiled here (about
half a minute); the port's two-direction solve is held against the port's
own single solves, and its first direction against the JAX solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.models import plasma_integral2d as jpi
from fast_solver_lippmann_schwinger_tpu_torch import resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized import (
    PolarizedTracesPreconditioner,
    pallas_only,
)
from fast_solver_lippmann_schwinger_tpu_torch.models import plasma_integral2d as pi
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from torch_threads import few_threads  # noqa: F401

KW = dict(h=1.0 / 40.0, n_subdomains=4, npml=6, n_it=2)
SOLVE = dict(rtol=1e-6, restart=20, maxiter=12)
DIRS = ((1.0, 0.0), (0.0, 1.0))
TOL = dict(hist=1e-8, floor=1e-12, sol=1e-8)


@pytest.fixture(scope="module")
def problems():
    jp = jpi.build_problem(dtype=jnp.complex128, **KW)
    tp = pi.build_problem(dtype=torch.complex128, device="cpu", **KW)
    jx, jinfo = jpi.solve(jp, DIRS[0], **SOLVE)
    return jp, tp, np.asarray(jx), jinfo


@pytest.fixture(scope="module")
def single_solves(problems):
    tp = problems[1]
    return [pi.solve(tp, d, **SOLVE) for d in DIRS]


def test_problem_setup_matches(problems):
    jp, tp, _, _ = problems
    assert tp.grid.shape == jp.grid.shape == (41, 41) and tp.k == jp.k
    assert tp.op.quad_rule == jp.op.quad_rule == "trapezoidal"
    assert tuple(tp.op.symbol.shape) == jp.op.symbol.shape
    pc, jpc = tp.precond, jp.precond
    assert isinstance(pc, PolarizedTracesPreconditioner)
    assert (pc.n_it, pc.inner_tol, pc.inner_maxiter, pc.precond_type) == (
        jpc.n_it, jpc.inner_tol, jpc.inner_maxiter, jpc.precond_type)
    for name in ("n_subs", "m1_max", "trace_head", "trace_tail"):
        assert getattr(pc.slabs, name) == getattr(jpc.slabs, name), name
    assert pc.slabs.pfac is None
    assert set(tp.setup_seconds) == {"symbol", "stencils", "slab_system"}


def test_solve_matches(problems, single_solves):
    """Equal iteration counts, the residual history and the solution to
    rounding, and a small true residual."""
    _, _, jx, jinfo = problems
    tx, info = single_solves[0]
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and n_it > 0
    assert bool(info.converged) and bool(jinfo.converged)
    want = np.asarray(jinfo.residuals)
    got = info.residuals.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[: n_it + 1], want[: n_it + 1], rtol=TOL["hist"],
                               atol=TOL["floor"] * want[0])
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=TOL["sol"] * np.abs(jx).max())
    assert float(info.true_residual) < 1e-4


def test_solve_batched_matches_single_solves(problems, single_solves):
    """The joint two-direction solve (``apply_batch``: one inner
    ``gmres_batched`` on the trace system) takes the iterations of the
    single solves and finds their solutions; its first direction takes the
    JAX solve's iterations."""
    _, tp, _, jinfo = problems
    X, info = pi.solve_batched(tp, DIRS, **SOLVE)
    assert tuple(X.shape) == (2, tp.grid.size)
    assert bool(info.converged.all())
    assert int(info.n_iterations[0]) == int(jinfo.n_iterations)
    for i, (x, single) in enumerate(single_solves):
        assert int(info.n_iterations[i]) == int(single.n_iterations)
        np.testing.assert_allclose(info.residuals[i].numpy(), single.residuals.numpy(),
                                   rtol=TOL["hist"], atol=TOL["floor"] * float(single.residuals[0]))
        np.testing.assert_allclose(X[i].numpy(), x.numpy(), rtol=0,
                                   atol=TOL["sol"] * float(x.abs().max()))
    assert float(info.true_residual.max()) < 1e-4


def _check_against_full(problems, tp, extra_iterations=None):
    """A solve on plain banded pivots: converged to the JAX package's
    full-pivot solution, within ``extra_iterations`` of its count where
    given."""
    _, _, jx, jinfo = problems
    assert not pallas_only(tp.precond.slabs) and tp.precond.slabs.pfac is None
    tx, info = pi.solve(tp, DIRS[0], **SOLVE)
    assert bool(info.converged)
    if extra_iterations is not None:
        assert int(info.n_iterations) <= int(jinfo.n_iterations) + extra_iterations
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    assert float(info.true_residual) < 1e-4


def test_device_rule_and_unported_modes(problems):
    """No ``device`` means the card (an error without one).  The
    ``"banded"`` pivots, once a mode the port did not have, build and solve;
    an unknown mode raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pi.build_problem(**KW)
    assert resolve_device("cpu") == torch.device("cpu")
    tp = pi.build_problem(dtype=torch.complex128, pivot_dtype="banded", pivot_band=21,
                          device="cpu", **KW)
    assert isinstance(tp.precond.slabs.fac, direct.BlockTridiagFactorizationBanded)
    # the band drops the interface lines' dense Green's functions: 10
    # iterations against the full pivots' 5 here, so no count is held
    _check_against_full(problems, tp)
    with pytest.raises(ValueError, match="unknown pivot_dtype"):
        pi.build_problem(pivot_dtype="banded_nonsense", device="cpu", **KW)


def test_banded_tail_pivots(problems):
    """The local solves on the tail-dense hybrid (``slabs.fac.slab(s)``, the
    dense bf16 tail lines after the band): within two iterations of the full
    pivots, the margin ``tests/test_banded_pivots.py`` pins for this mode."""
    tp = pi.build_problem(dtype=torch.complex128, pivot_dtype="banded_tail", pivot_band=21,
                          device="cpu", **KW)
    assert isinstance(tp.precond.slabs.fac, direct.BlockTridiagFactorizationBandedTail)
    _check_against_full(problems, tp, 2)
