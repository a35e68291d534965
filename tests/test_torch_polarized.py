"""The port's polarized-traces integral system (``ddm/polarized.py``) against
the JAX package, on the setup of ``tests/test_polarized.py`` at h = 1/40:
4 slabs, npml = 6.  The JAX slab system is carried across (``convert.py``),
so both packages hold the same annihilator phases and pivots.

Tolerances: ``full``, dense complex128 pivots, 1e-10 of the max-norm.
``pallas``, the same bf16 planes in complex64 (the JAX side runs its Pallas
kernels in interpret mode, the port its plain versions): 1e-5 of the
max-norm, float32 carries against float32 carries in another summation
order.  The port's own int8 and banded+tail layouts against its bf16 planes:
5e-2, the int8 quantization and the head band's truncation at n = 41
(measured 1.2e-2 to 2.6e-2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D as JGrid2D
from fast_solver_lippmann_schwinger_tpu.ddm import polarized as jpol
from fast_solver_lippmann_schwinger_tpu.ddm import subdomain as jsub
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.ddm import polarized, subdomain
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils, thomas_kernels
from test_torch_multislab_sweeps import slab_fields
from torch_threads import few_threads  # noqa: F401

H, N_SUBS, NPML = 1.0 / 40.0, 4, 6
MODES = {"full": (jnp.complex128, np.complex128), "pallas": (jnp.complex64, np.complex64)}


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@functools.lru_cache(maxsize=None)
def _systems(mode):
    """(JAX slab system, its stencil ``A``, the port's carried over)."""
    grid = JGrid2D(a=1.0, h=H)
    k = 1.0 / H
    X, Y = grid.mesh()
    nu = jmedia.plasma_2d(X, Y)
    a, ag, a_np, ag_np = jstencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, H, dtype=MODES[mode][0], return_host=True)
    js = jsub.build_slab_system(a, ag, nu, grid.x, grid.y, H, k, N_SUBS, npml=NPML,
                                a_host=a_np, ag_host=ag_np, pivot_dtype=mode)
    return js, a, convert.slab_system(slab_fields(js), device="cpu")


def _trace(mode, seed, factor, r=None):
    rng = np.random.default_rng(seed)
    shape = (factor * (N_SUBS - 1) * 41,) + (() if r is None else (r,))
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(MODES[mode][1])


def _both(mode, fn, arg, *extra):
    js, _, ts = _systems(mode)
    got = getattr(polarized, fn)(ts, torch.as_tensor(arg), *extra)
    want = getattr(jpol, fn)(js, jnp.asarray(arg), *extra)
    return got.numpy(), np.asarray(want)


def test_carried_system_is_kernel_only_for_pallas():
    assert not polarized.pallas_only(_systems("full")[2])
    ts = _systems("pallas")[2]
    assert polarized.pallas_only(ts) and isinstance(ts.pfac, thomas_kernels.ThomasFactorization)
    assert (ts.m1_max, ts.trace_head, ts.trace_tail) == (22, 5, 14)


def test_devectorize_interface_roundtrip():
    """``_devectorize`` as the JAX package's, and ``_interface_vector`` of its
    lower traces gives the vector back."""
    js, _, ts = _systems("full")
    u = _trace("full", 2, 2, r=3)
    got = polarized._devectorize(ts, torch.as_tensor(u))
    want = jpol._devectorize(js, jnp.asarray(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(polarized._interface_vector(ts, got[2], got[1]).numpy(), u)


@pytest.mark.parametrize("fn,factor,r", [
    ("apply_mm", 4, None), ("apply_u_coupling", 2, None), ("apply_l_coupling", 2, None),
    ("apply_dinv_down", 2, None), ("apply_dinv_up", 2, None), ("permute_to_pairs", 4, None),
    ("apply_mm", 4, 3), ("apply_dinv_down", 2, 3), ("apply_dinv_up", 2, 3),
])
def test_trace_operators_match(fn, factor, r):
    """The MM apply, the couplings and the D-inverse recursions against the
    JAX package on the same traces; on the paths of ``apply_batch`` also
    with a trailing batch of three directions riding along."""
    got, want = _both("full", fn, _trace("full", 11, factor, r))
    assert got.shape == want.shape
    assert _relerr(got, want) < 1e-10


def test_mm_quadrants_match_optimized():
    """The composite 2-RHS ``apply_mm`` equals the four-quadrant plain
    assembly (reference ``applyMM`` against ``applyMMOptUmf``)."""
    ts = _systems("full")[2]
    u = torch.as_tensor(_trace("full", 11, 4))
    assert _relerr(polarized.apply_mm_plain(ts, u), polarized.apply_mm(ts, u)) < 1e-10


@pytest.mark.parametrize("direction", ["down", "up"])
def test_d_inverts_dinv(direction):
    ts = _systems("full")[2]
    u = torch.as_tensor(_trace("full", 0 if direction == "down" else 1, 2))
    dinv = getattr(polarized, f"apply_dinv_{direction}")
    d = getattr(polarized, f"apply_d_{direction}")
    assert _relerr(d(ts, dinv(ts, u)), u) < 1e-10


@pytest.mark.parametrize("fn", ["precond_gauss_seidel", "precond_jacobi"])
def test_inner_preconditioners_match(fn):
    got, want = _both("full", fn, _trace("full", 3, 4), 2)
    assert _relerr(got, want) < 1e-10


@pytest.mark.parametrize("method", ["apply", "apply_batch"])
def test_preconditioner_matches(method):
    """``PolarizedTracesPreconditioner`` built by ``convert`` from the JAX
    one's fields: the whole apply, inner GMRES included, and the joint apply
    of two directions."""
    js, a, _ = _systems("full")
    jpc = jpol.PolarizedTracesPreconditioner(slabs=js, a_s=a, n_it=2, inner_tol=1e-2)
    tpc = convert.polarized_traces_preconditioner(
        slab_fields(js), np.asarray(a.values), jpc.n_it, jpc.inner_tol, jpc.inner_maxiter,
        jpc.precond_type, device="cpu")
    rng = np.random.default_rng(5)
    shape = (41 * 41,) if method == "apply" else (2, 41 * 41)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    want = np.asarray(jax.jit(lambda pc, v: getattr(pc, method)(v))(jpc, jnp.asarray(b)))
    got = getattr(tpc, method)(torch.as_tensor(b)).numpy()
    assert got.shape == want.shape
    assert _relerr(got, want) < 1e-10
    if method == "apply":
        np.testing.assert_array_equal(tpc(torch.as_tensor(b)).numpy(), got)


@pytest.mark.parametrize("fn,factor", [("apply_mm", 4), ("apply_dinv_down", 2),
                                       ("apply_dinv_up", 2)])
def test_kernel_layout_matches_interpret_mode(fn, factor):
    """bf16 planes on both sides: the port's plain versions of the line
    kernels (``solve_all``, and ``solve_support`` with its head start and
    tail) against the JAX Pallas kernels in interpret mode."""
    got, want = _both("pallas", fn, _trace("pallas", 7, factor))
    assert _relerr(got, want) < 1e-5


@functools.lru_cache(maxsize=None)
def _own_system(mode):
    grid = Grid2D(a=1.0, h=H)
    k = 1.0 / H
    X, Y = grid.mesh()
    a, ag, a_np, ag_np = stencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, H, dtype=torch.complex64, return_host=True, device="cpu")
    return subdomain.build_slab_system(a, ag, media.plasma_2d(X, Y), grid.x, grid.y, H, k,
                                       N_SUBS, npml=NPML, a_host=a_np, ag_host=ag_np,
                                       pivot_dtype=mode, device="cpu")


@pytest.mark.parametrize("mode", ["pallas_int8", "pallas_banded_tail"])
def test_other_kernel_layouts_match_bf16_planes(mode):
    """The port's own int8 and banded+tail systems through the same entry
    points: the MM apply, both recursions and the reconstruction (which
    reads the banded head lines) within the layouts' quantization of the
    bf16 planes' results."""
    ts, ref = _own_system(mode), _own_system("pallas")
    assert polarized.pallas_only(ts) and polarized.pallas_only(ref)
    rng = np.random.default_rng(9)
    u = torch.as_tensor(_trace("pallas", 8, 4))
    half = u.shape[0] // 2
    for fn, arg in (("apply_mm", u), ("apply_dinv_down", u[:half]), ("apply_dinv_up", u[:half])):
        assert _relerr(getattr(polarized, fn)(ts, arg), getattr(polarized, fn)(ref, arg)) < 5e-2, fn
    b = torch.as_tensor((rng.standard_normal(41 * 41) + 1j * rng.standard_normal(41 * 41))
                        .astype(np.complex64))
    traces = polarized._devectorize(ref, u[:half])
    assert _relerr(polarized.reconstruction(ts, b, *traces),
                   polarized.reconstruction(ref, b, *traces)) < 5e-2
