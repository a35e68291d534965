"""The port's 3D polarized traces (``ddm/polarized3d.py``) against the JAX
package, on the setup of ``tests/test_polarized3d.py`` (NN = 17, K = 8, three
slabs, npml = 5), and the slice whole through ``models/bump3d.py``.

Each JAX slab system is carried across with ``convert.slab_system_3d``, so
both packages hold the same annihilator phases and pivots.  Every JAX output
is computed once (jitted) and kept for the module: its trace operators run at
r = 2, and a call without a trailing axis is held against the first column,
the JAX package's answer for that column alone (its columns are independent
solves).

Tolerances: dense complex128 pivots (z-planes and y-planes), 1e-10 of the
max-norm.  The y-planes' D-inverse recursion against the z-planes': 1e-8, as
in ``tests/test_polarized3d.py``.  ``bf16_pallas``, the same bf16 planes (the
JAX side runs its Pallas kernels in interpret mode, the port the plain
versions of its plane kernels): 1e-4 of the max-norm, float32 carries in
another summation order.  The whole preconditioner apply: 1e-8, the inner
GMRES at its 1e-2 tolerance amplifying rounding differences.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.ddm import polarized3d as jpol
from fast_solver_lippmann_schwinger_tpu.ddm import subdomain3d as jsd
from fast_solver_lippmann_schwinger_tpu.models import bump3d as jbump3d
from fast_solver_lippmann_schwinger_tpu.models import media
from fast_solver_lippmann_schwinger_tpu.ops.fastconv import build_fast_convolution_3d
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ddm import polarized3d
from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import PlaneSlabView
from test_torch_subdomain3d import _fields
from torch_threads import few_threads  # noqa: F401

NN, K, S, NPML = 17, 8.0, 3, 5
MN = NN * NN
# name -> (factor of the trace vector's length, as in the JAX tests)
FNS = {"block_apply": 2, "apply_mm": 4, "apply_u_coupling": 2, "apply_l_coupling": 2,
       "apply_dinv_down": 2, "apply_dinv_up": 2, "permute_to_pairs": 4,
       "precond_gauss_seidel": 4}
TOL = {"full": 1e-10, "yblock": 1e-10, "bf16_pallas": 1e-4}


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _call(pkg, fn, slabs, g):
    """``fn`` of package module ``pkg`` on the trace vector ``g``: the block
    apply on its devectorized traces (the four outputs stacked), the inner
    Gauss-Seidel at n_it = 2."""
    if fn == "block_apply":
        out = pkg.block_apply(slabs, *pkg._devectorize(slabs, g))
        return (torch if pkg is polarized3d else jnp).stack(out)
    if fn == "precond_gauss_seidel":
        return pkg.precond_gauss_seidel(slabs, g, 2)
    return getattr(pkg, fn)(slabs, g)


def _trace(fn, seed=11, r=2):
    rng = np.random.default_rng(seed)
    shape = (FNS[fn] * (S - 1) * MN, r)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def setup():
    """The JAX operator and stencils (complex128), the JAX slab systems by
    pivot mode, the port's carried across, and a cache of JAX outputs."""
    h = 1.0 / (NN - 1)
    x = np.linspace(0.0, 1.0, NN)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    nu = media.gaussian_bump_3d(X, Y, Z)
    op = build_fast_convolution_3d(x, x, x, h, K, nu, dtype=jnp.complex128)
    a, ag = jstencils.build_sparse_a_ag_3d(K, op, dtype=jnp.complex128)

    @functools.lru_cache(maxsize=None)
    def systems(mode):
        js = jsd.build_slab_system_3d(a, ag, nu, x, h, K, n_subs=S, npml=NPML, pivot_dtype=mode)
        return js, convert.slab_system_3d(_fields(js), device="cpu")

    @functools.lru_cache(maxsize=None)
    def jax_out(mode, fn, r):
        g = jnp.asarray(_trace(fn, r=r))
        return np.asarray(jax.jit(functools.partial(_call, jpol, fn))(systems(mode)[0], g))

    return dict(a=a, systems=systems, jax_out=jax_out)


def test_carried_systems(setup):
    """The carried systems keep the JAX trace planes and shortcuts; a plane
    stack makes every slab's factorization a plane view."""
    for mode, layout in (("full", "z"), ("yblock", "y"), ("bf16_pallas", "z")):
        js, ts = setup["systems"](mode)
        assert ts.pivot_layout == layout
        assert (ts.l1_max, ts.trace_head, ts.trace_tail) == (js.l1_max, js.trace_head,
                                                             js.trace_tail)
        assert ts.host.l0 == tuple(np.asarray(js.l0).tolist())
        views = [isinstance(f, PlaneSlabView) for f in ts.slab_facs]
        assert views == [mode == "bf16_pallas"] * S
    assert (ts.l1_max, ts.trace_head, ts.trace_tail) == (16, 4, 13)


@pytest.mark.parametrize("r", [None, 2])
@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("mode", ["full", "yblock"])
def test_trace_operators_match(setup, mode, fn, r):
    """The block apply, the MM apply, the couplings, the D-inverse recursions,
    the pair permutation and the inner Gauss-Seidel on dense pivots, without
    a trailing axis and with two directions riding along."""
    ts = setup["systems"](mode)[1]
    g = _trace(fn)
    want = setup["jax_out"](mode, fn, 2)
    if r is None:
        g, want = g[:, 0], want[..., 0]
    got = _call(polarized3d, fn, ts, torch.as_tensor(g)).numpy()
    assert got.shape == want.shape
    assert _relerr(got, want) < TOL[mode]


def test_yblock_dinv_down_matches_z_layout(setup):
    """The y-plane recursion (no head start, no tail) against the z-plane
    one, as ``tests/test_polarized3d.py`` holds the JAX package's."""
    g = torch.as_tensor(_trace("apply_dinv_down", seed=1, r=1)[:, 0])
    ref = polarized3d.apply_dinv_down(setup["systems"]("full")[1], g)
    got = polarized3d.apply_dinv_down(setup["systems"]("yblock")[1], g)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("fn", ["block_apply", "precond_gauss_seidel"])
def test_plane_stack_matches_interpret_mode(setup, fn):
    """bf16 planes on both sides: the port's plain plane kernels through
    every slab's plane view (the full pass at r = 2, the head start and tail
    of the recursions) against the JAX Pallas kernels in interpret mode."""
    ts = setup["systems"]("bf16_pallas")[1]
    g = _trace(fn)
    want = setup["jax_out"]("bf16_pallas", fn, 2)
    got = _call(polarized3d, fn, ts, torch.as_tensor(g)).numpy()
    assert _relerr(got, want) < TOL["bf16_pallas"]


def test_apply_batch_matches_rows(setup):
    """The joint apply of two directions (R x 2 columns through the MM apply,
    one ``gmres_batched``) is the apply of each row."""
    ts = setup["systems"]("full")[1]
    pc = polarized3d.PolarizedTracesPreconditioner3D(
        slabs=ts, a_s=convert.stencil_matrix_3d(np.asarray(setup["a"].values), device="cpu"))
    rng = np.random.default_rng(11)
    b = torch.as_tensor(rng.standard_normal((2, NN ** 3)) + 1j * rng.standard_normal((2, NN ** 3)))
    got = pc.apply_batch(b)
    for r in range(2):
        assert _relerr(got[r], pc.apply(b[r])) < 1e-10


@pytest.fixture(scope="module")
def bump():
    """The slice at h = 1/10 with two slabs in complex128 (three or more
    would put slab 1's first interior plane below npml at this size), each
    package building its own problem."""
    kw = dict(h=1 / 10, precond="polarized_traces", n_subdomains=2, npml=5)
    return (jbump3d.build_problem(dtype=jnp.complex128, **kw),
            bump3d.build_problem(dtype=torch.complex128, device="cpu", **kw))


def test_preconditioner_apply_matches(bump):
    """``PolarizedTracesPreconditioner3D`` built by ``convert`` from the JAX
    problem's: the whole apply, inner GMRES included."""
    jpc = bump[0].precond
    tpc = convert.polarized_traces_preconditioner_3d(
        _fields(jpc.slabs), np.asarray(jpc.a_s.values), jpc.n_it, jpc.inner_tol,
        jpc.inner_maxiter, device="cpu")
    rng = np.random.default_rng(5)
    b = rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
    want = np.asarray(jax.jit(lambda pc, v: pc.apply(v))(jpc, jnp.asarray(b)))
    got = tpc(torch.as_tensor(b)).numpy()
    assert got.shape == want.shape
    assert _relerr(got, want) < 1e-8


def test_bump3d_polarized_solve_matches(bump):
    """The slice whole: the same iteration count and residual history as the
    JAX package (the annihilators' phases scale the rows of the slab
    matrices and of A alike), histories to 1e-6 above a floor of 1e-12 of
    the first residual."""
    jp, tp = bump
    assert isinstance(tp.precond, polarized3d.PolarizedTracesPreconditioner3D)
    assert set(tp.setup_seconds) == {"symbol", "stencils", "slabs", "slab_fields",
                                     "factorization", "packing"}
    jx, jinfo = jbump3d.solve(jp, rtol=1e-8)
    tx, info = bump3d.solve(tp, rtol=1e-8)
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and 0 < n_it <= 10
    assert bool(info.converged) and bool(jinfo.converged)
    want = np.asarray(jinfo.residuals)[: n_it + 1]
    np.testing.assert_allclose(info.residuals.numpy()[: n_it + 1], want, rtol=1e-6,
                               atol=1e-12 * want[0])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-7 * np.abs(np.asarray(jx)).max())
    assert float(info.true_residual) < 1e-6
