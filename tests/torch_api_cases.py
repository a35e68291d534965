"""Shared pieces of the port's API tests (``tests/test_torch_api*.py``): the
cases, one ``ProblemConfig`` of the same fields for each package, the JAX
solve of each case computed once per test module, and the comparison.

Each package builds everything itself.  With dense complex128 pivots the two
agree to LAPACK and FFT rounding: equal iteration counts, residual histories
and solutions within 1e-8.  On bf16 planes each package rounds its own
complex128 factorization, and a few plane entries flip between the two: equal
counts, histories within 1e-3 of their entries, solutions within 1e-4 (the
tolerances of ``tests/test_torch_plasma2d.py`` for the same planes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu import api as japi
from fast_solver_lippmann_schwinger_tpu import config as jconfig
from fast_solver_lippmann_schwinger_tpu_torch import api
from fast_solver_lippmann_schwinger_tpu_torch.config import (
    DDMConfig,
    ProblemConfig,
    SolverConfig,
)

# 2D at h = 1/40 with 2 slabs; 3D at h = 1/10 with 2 slabs; complex128
BASE = dict(dim=2, medium="plasma", h=1.0 / 40.0)
DDM = dict(n_subdomains=2, npml=6)
SOLVER = dict(rtol=1e-8, maxiter=200)
BASE_3D = dict(dim=3, medium="gaussian_bump", h=1.0 / 10.0)
DDM_3D = dict(n_subdomains=2, npml=5)
CASES = {
    "sparsifying": dict(precond="sparsifying"),
    "sparsifying_trapezoidal": dict(precond="sparsifying", quad_rule="trapezoidal"),
    "gs": dict(precond="gs"),
    "gs_inner": dict(precond="gs_inner"),
    "double_sweep": dict(precond="double_sweep"),
    "double_sweep_inner": dict(precond="double_sweep_inner"),
    "polarized_traces": dict(precond="polarized_traces"),
    "none": dict(precond="none"),
    "double_sweep_pallas": dict(precond="double_sweep", pivot_dtype="pallas"),
    "3d_sparsifying": dict(BASE_3D, precond="sparsifying"),
    "3d_gs": dict(BASE_3D, precond="gs"),
    "3d_polarized_traces": dict(BASE_3D, precond="polarized_traces"),
}
DENSE = dict(hist=1e-8, sol=1e-8)
BF16_PLANES = dict(hist=1e-3, sol=1e-4)


def configs(case, **extra):
    """The same fields as a port and a JAX ``ProblemConfig``."""
    fields = {**BASE, **CASES.get(case, {}), **extra}
    ddm = DDM_3D if fields["dim"] == 3 else DDM
    ours = ProblemConfig(**fields, solver=SolverConfig(**SOLVER, dtype=torch.complex128),
                         ddm=DDMConfig(**ddm))
    theirs = jconfig.ProblemConfig(**fields, solver=jconfig.SolverConfig(**SOLVER,
                                                                         dtype=jnp.complex128),
                                   ddm=jconfig.DDMConfig(**ddm))
    return ours, theirs


@pytest.fixture(scope="module")
def jax_solves():
    """Each case's JAX solve, computed once for the module."""
    cache = {}

    def solve(case):
        if case not in cache:
            _, cfg = configs(case)
            u, info = japi.solve_problem(japi.build_problem(cfg))
            cache[case] = (np.asarray(u), np.asarray(info.residuals),
                           int(info.n_iterations), bool(info.converged))
        return cache[case]

    return solve


def check_against_jax(case, jax_result):
    """The port's solve of ``case`` against the JAX result; returns the
    port's problem, solution and record."""
    tol = BF16_PLANES if case.endswith("pallas") else DENSE
    cfg, _ = configs(case)
    problem = api.build_problem(cfg, device="cpu")
    u, info = api.solve_problem(problem)
    want_u, want_res, n_it, converged = jax_result
    assert int(info.n_iterations) == n_it and bool(info.converged) == converged and converged
    res = info.residuals.numpy()
    np.testing.assert_allclose(res[: n_it + 1], want_res[: n_it + 1], rtol=tol["hist"], atol=0)
    assert tuple(u.shape) == want_u.shape and u.dtype == torch.complex128
    np.testing.assert_allclose(u.numpy(), want_u, rtol=0, atol=tol["sol"] * np.abs(want_u).max())
    return problem, u, info
