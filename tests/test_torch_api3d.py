"""The port's config-driven API against the JAX package's on the same 3D
``ProblemConfig`` fields, on the CPU in complex128 at h = 1/10 with 2 slabs
and npml = 5: the sparsifying preconditioner, the z-slab sweep and the 3D
polarized traces on dense pivots, and a ``"pallas"`` pivot mode, which the
3D slab systems read as ``"full"`` as the JAX package does.  The cases and
tolerances are in ``tests/torch_api_cases.py``."""

import pytest

from fast_solver_lippmann_schwinger_tpu_torch import api
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain3d import SlabSystem3D
from torch_api_cases import check_against_jax, configs, jax_solves  # noqa: F401
from torch_threads import few_threads  # noqa: F401


@pytest.mark.parametrize("case", ["3d_sparsifying", "3d_gs", "3d_polarized_traces"])
def test_api_matches_the_jax_package(jax_solves, case):
    problem, _, info = check_against_jax(case, jax_solves(case))
    assert float(info.true_residual) < 1e-6
    if case != "3d_sparsifying":
        assert isinstance(problem.precond.slabs, SlabSystem3D)


def test_2d_kernel_pivot_mode_reads_as_full():
    """A ``"pallas*"`` mode in 3D means dense pivots (``api.py`` of the JAX
    package, ``:112-114``); ``"bf16_pallas"`` keeps a bf16 plane stack."""
    for mode, stack in (("pallas", None), ("bf16_pallas", "bf16")):
        cfg, _ = configs("3d_gs", pivot_dtype=mode)
        slabs = api.build_problem(cfg, device="cpu").precond.slabs
        assert (slabs.pfac.storage if slabs.pfac is not None else None) == stack
        if stack is None:
            assert slabs.fac.cinv.shape[-1] == slabs.m * slabs.n
