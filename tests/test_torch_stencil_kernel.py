"""The stencil matvec of the port (``ops/stencil_kernels.py``, the
counterpart of the JAX package's ``ops/pallas_stencil.py``) and the slice
that runs it, ``plasma2d.build_problem(use_pallas=True)``, against the JAX
package, whose Pallas kernel runs in interpret mode (the oracle of
``tests/test_pallas_stencil.py``).

On the CPU ``stencil_matvec_2d`` takes its plain version; the CUDA kernel is
held against that on the card (``chip_smoke.py``,
``tests/test_torch_cuda_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D as JGrid2D
from fast_solver_lippmann_schwinger_tpu.models import plasma2d as jplasma2d
from fast_solver_lippmann_schwinger_tpu.ops.pallas_stencil import (
    stencil_matvec_2d as jstencil_matvec_2d,
)
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.ops import stencil_kernels as sk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencil_matrix
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix2D
from torch_threads import few_threads  # noqa: F401


@pytest.fixture(scope="module", params=[40, 30], ids=["h40", "h30"])
def field(request):
    """The A stencil field of the JAX package at h = 1/40 (41 rows) and
    h = 1/30 (31 rows, uneven blocks of the TPU kernel), and a random u."""
    grid = JGrid2D(a=1.0, h=1.0 / request.param)
    k = 1.0 / grid.h
    a_st, _ = jstencils.build_sparse_a_ag_2d(k, grid.x, grid.y, grid.h, dtype=jnp.complex128)
    rng = np.random.default_rng(request.param)
    u = rng.standard_normal(grid.size) + 1j * rng.standard_normal(grid.size)
    return np.array(a_st.values), u


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_plain_version_matches_interpret_kernel(field, dtype):
    """Same float32 arithmetic and the same tap order on both sides; a
    complex128 field gives complex64 accuracy in both packages, pinned by
    its distance from the exact complex128 matvec."""
    values, u = (a.astype(dtype) for a in field)
    want = np.asarray(jstencil_matvec_2d(jnp.asarray(values), jnp.asarray(u), block_rows=8,
                                         interpret=True))
    got = sk.stencil_matvec_2d(torch.as_tensor(values), torch.as_tensor(u))
    assert got.dtype == torch.as_tensor(values).dtype and tuple(got.shape) == u.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    exact = StencilMatrix2D(values=torch.as_tensor(values)).matvec(torch.as_tensor(u)).numpy()
    err = np.abs(got.numpy() - exact).max() / np.abs(exact).max()
    assert err < 1e-5
    if dtype is np.complex128:
        assert err > 1e-10          # float32 arithmetic, not complex128's


def test_use_pallas_dispatch(field, monkeypatch):
    """Single-RHS input, flat or gridded, goes to the kernel's module; multi-RHS
    input keeps the 9 shifted multiply-adds; every derived matrix drops the
    flag, as the JAX package's does."""
    values, u = field
    plain = StencilMatrix2D(values=torch.as_tensor(values))
    flagged = dataclasses.replace(plain, use_pallas=True)
    m, n = plain.m, plain.n
    u_t = torch.as_tensor(u)
    want = sk.stencil_matvec_2d_plain(plain.values, u_t)
    assert torch.equal(flagged.matvec(u_t), want)
    assert torch.equal(flagged.matvec(u_t.reshape(m, n)), want.reshape(m, n))
    calls = []
    monkeypatch.setattr(stencil_matrix, "stencil_matvec_2d",
                        lambda *args: calls.append(args) or sk.stencil_matvec_2d(*args))
    flagged.matvec(u_t)
    u2 = torch.stack([u_t, 2 * u_t], dim=-1)
    assert torch.equal(flagged.matvec(u2), plain.matvec(u2))       # multi-RHS: 9 taps
    assert torch.equal(flagged.matvec(u2.reshape(m, n, 2)), plain.matvec(u2.reshape(m, n, 2)))
    assert len(calls) == 1
    for derived in (flagged.transpose(), flagged.scale_columns(torch.ones(m * n)),
                    flagged + flagged, 2.0 * flagged):
        assert derived.use_pallas is False


def test_wrapper_validates(field):
    values, u = field
    v = torch.as_tensor(values)
    with pytest.raises(ValueError, match="complex"):
        sk.stencil_matvec_2d(v.real, torch.as_tensor(u))
    with pytest.raises(ValueError, match="nodes"):
        sk.stencil_matvec_2d(v, torch.as_tensor(u[:-1]))
    before = sk.stencil_matvec_2d.launches
    sk.stencil_matvec_2d(v, torch.as_tensor(u))
    assert sk.stencil_matvec_2d.launches == before       # the CPU launches nothing


# ---------------------------------------------------------------------------
# The slice: build_problem(use_pallas=True), h = 1/40, 3 slabs, double sweep
# ---------------------------------------------------------------------------

KW = dict(h=1.0 / 40.0, n_subdomains=3, npml=5, use_pallas=True)
SOLVE = dict(rtol=1e-5, restart=20, maxiter=20)


@pytest.fixture(scope="module")
def slice_problems():
    """Both packages' ``build_problem(use_pallas=True)`` with the JAX defaults
    (full pivots, bf16 kernel planes attached), complex64, and the port's
    problem again with the JAX preconditioner's stencil fields and slab
    systems carried over."""
    from test_torch_int8_thomas import slab_fields

    jp = jplasma2d.build_problem(dtype=jnp.complex64, **KW)
    tp = plasma2d.build_problem(dtype=torch.complex64, device="cpu", **KW)
    jpc = jp.precond
    carried = convert.double_sweep_preconditioner(
        slab_fields(jpc.slabs), slab_fields(jpc.slabs_t), np.asarray(jpc.msp.values),
        np.asarray(jpc.a_s.values), device="cpu")
    carried = dataclasses.replace(carried, a_s=dataclasses.replace(carried.a_s, use_pallas=True))
    return jp, {"own": tp, "carried": dataclasses.replace(tp, precond=carried)}


def test_slice_setup(slice_problems):
    """As the JAX package: full pivots with bf16 planes beside them in both
    directions, the flag on ``a_s`` only."""
    jp, problems = slice_problems
    pc = problems["own"].precond
    assert pc.a_s.use_pallas and jp.precond.a_s.use_pallas
    assert not pc.msp.use_pallas and not jp.precond.msp.use_pallas
    for slabs in (pc.slabs, pc.slabs_t):
        assert slabs.pfac.storage == "bf16" and slabs.fac.cinv.shape[-1] == slabs.n


def test_slice_matches_jax(slice_problems):
    """``solve`` on both sides: the same iteration count, the residual history
    within 1e-5 above the float32 floor (1e-6 of the first residual), the
    solution within 1e-4; with the port's own factors and with the JAX ones."""
    jp, problems = slice_problems
    jx, jinfo = jplasma2d.solve(jp, (1.0, 0.0), **SOLVE)
    n_it = int(jinfo.n_iterations)
    assert bool(jinfo.converged) and n_it > 0
    for name, tp in problems.items():
        tx, info = plasma2d.solve(tp, (1.0, 0.0), **SOLVE)
        assert int(info.n_iterations) == n_it and bool(info.converged), name
        want = np.asarray(jinfo.residuals)[: n_it + 1]
        np.testing.assert_allclose(np.asarray(info.residuals)[: n_it + 1], want,
                                   rtol=1e-5, atol=1e-6 * want[0], err_msg=name)
        want = np.asarray(jx)
        np.testing.assert_allclose(tx.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        assert float(info.true_residual) < 1e-4


@pytest.mark.parametrize("kw", [dict(pivot_dtype="pallas"), dict(pivot_dtype="pallas_int8"),
                                dict(pivot_dtype="pallas_banded_tail"),
                                dict(pivot_dtype="full", pivot_dtype_t="pallas")])
def test_use_pallas_with_a_kernel_pivot_mode_raises(kw):
    """Those modes keep only placeholder pivots beside their kernel layout,
    which the JAX package would re-pack into empty bf16 planes."""
    with pytest.raises(ValueError, match="placeholder"):
        plasma2d.build_problem(device="cpu", **{**KW, **kw})
