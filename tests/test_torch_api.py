"""The port's config-driven API (``api.py``) against the JAX package's on the
same ``ProblemConfig`` fields, on the CPU in complex128 at h = 1/40 with 2
slabs: the sparsifying preconditioner on both quadratures, the single and the
double sweep, no preconditioner, and the double sweep on ``"pallas"`` pivots
(the port's plain versions against the JAX package's interpret-mode kernels);
then the joint solve against single ones, the incident field, and the
refusals.  The inner-GMRES composites and the polarized traces are in
``tests/test_torch_api_inner.py``, the 3D families in
``tests/test_torch_api3d.py``; the cases and tolerances in
``tests/torch_api_cases.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu import api as japi
from fast_solver_lippmann_schwinger_tpu_torch import api
from fast_solver_lippmann_schwinger_tpu_torch.config import ProblemConfig, default_complex_dtype
from torch_api_cases import check_against_jax, configs, jax_solves  # noqa: F401
from torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize("case", ["sparsifying", "sparsifying_trapezoidal", "gs",
                                  "double_sweep", "none", "double_sweep_pallas"])
def test_api_matches_the_jax_package(jax_solves, case):
    problem, _, info = check_against_jax(case, jax_solves(case))
    assert float(info.true_residual) < 1e-6
    if case == "double_sweep_pallas":
        assert problem.precond.slabs.pfac is not None and problem.precond.slabs_t.pfac is not None


@pytest.mark.parametrize("case", ["double_sweep", "gs_inner", "polarized_traces"])
def test_solve_problem_batched_matches_single(case):
    """The joint solve of two directions (``apply_batch`` for the sweeps and
    the polarized traces; column by column for ``InnerGMRESPreconditioner``,
    which has none) against a single solve of each direction."""
    cfg, _ = configs(case)
    problem = api.build_problem(cfg, device="cpu")
    dirs = [(1.0, 0.0), (0.0, 1.0)]
    assert hasattr(problem.precond, "apply_batch") == (case != "gs_inner")
    ub, infob = api.solve_problem_batched(problem, dirs)
    assert tuple(ub.shape) == (2, problem.grid.size)
    for i, d in enumerate(dirs):
        single = dataclasses.replace(problem, config=dataclasses.replace(
            problem.config, incident_direction=d))
        u, info = api.solve_problem(single)
        assert int(infob.n_iterations[i]) == int(info.n_iterations)
        np.testing.assert_allclose(ub[i].numpy(), u.numpy(), rtol=0,
                                   atol=1e-8 * float(u.abs().max()))


def test_incident_field_is_the_jax_packages():
    """The plane wave is formed on the host in float64, then cast, as the JAX
    package forms it; 2D and 3D (a 2-component direction padded)."""
    for case, kw in (("none", dict(incident_direction=(0.6, 0.8))),
                     ("3d", dict(dim=3, medium="gaussian_bump", h=0.1))):
        cfg, jcfg = configs(case, precond="none", **kw)
        ours = api.incident_field(api.build_problem(cfg, device="cpu"))
        theirs = np.asarray(japi.incident_field(japi.build_problem(jcfg)))
        np.testing.assert_array_equal(ours.numpy(), theirs)


def test_bad_precond_raises():
    with pytest.raises(ValueError, match="unknown precond"):
        api.build_problem(ProblemConfig(h=0.1, precond="typo"), device="cpu")
    with pytest.raises(ValueError, match="3D supports"):
        api.build_problem(ProblemConfig(dim=3, h=0.1, precond="double_sweep"), device="cpu")
    with pytest.raises(ValueError, match="dim must be 2 or 3"):
        api.build_problem(ProblemConfig(dim=4), device="cpu")


def test_build_problem_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here; the rule is tested where it does not")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build_problem(ProblemConfig(h=0.1))


def test_default_complex_dtype_follows_the_default_float():
    """complex128 where PyTorch's default float is float64 (the JAX
    package's x64 mode), complex64 otherwise."""
    saved = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        assert default_complex_dtype() == torch.complex128
        torch.set_default_dtype(torch.float32)
        assert default_complex_dtype() == torch.complex64
    finally:
        torch.set_default_dtype(saved)
