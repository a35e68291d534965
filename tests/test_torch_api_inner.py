"""The port's config-driven API against the JAX package's on the same
``ProblemConfig`` fields, on the CPU in complex128 at h = 1/40 with 2 slabs:
the inner-GMRES composites (``gs_inner``, ``double_sweep_inner``) and the
polarized traces, whose JAX solves compile the longest (a file of their own,
so no test file of the API takes much over a minute).  The cases and
tolerances are in ``tests/torch_api_cases.py``."""

import pytest

from torch_api_cases import check_against_jax, jax_solves  # noqa: F401
from torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize("case", ["gs_inner", "double_sweep_inner", "polarized_traces"])
def test_api_matches_the_jax_package(jax_solves, case):
    _, _, info = check_against_jax(case, jax_solves(case))
    # an inner-GMRES composite changes with its input, so the preconditioned
    # residual at 1e-8 bounds the true one only loosely there (1.6e-5)
    assert float(info.true_residual) < 1e-4
