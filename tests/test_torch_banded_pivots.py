"""The plain banded pivot storages of the port (``pivot_dtype`` ``"banded"``,
``"banded_tail"``, ``"banded_lr"``) against the JAX package's.

(a) the three compressions of one complex128 factorization carried across:
    band and tail planes bit-equal; the low-rank factors, which the QR fixes
    only up to a phase per column, through their product ``U V^H``;
(b) each pivot apply on lines of the head and of the tail, to 1e-6 of the
    max-norm (the same bf16 entries in f32 arithmetic; only the summation
    order of the band differs);
(c) the one-slab solves on the hybrid layout with head starts and tails on
    both sides of its segment boundary, and the cached/resumed pair, to 1e-6;
    the resumed solve equals the port's own full solve;
(d) ``plasma2d`` at h = 1/40 with 3 slabs and the single sweep in complex128,
    each package building its own problem in each mode: the same iteration
    count, the residual history and the solution.

``plasma_integral2d`` on these pivots is in ``test_torch_plasma_integral2d.py``
(a JAX polarized-traces solve on banded pivots takes minutes to compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D as JGrid2D
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.models import plasma2d as jplasma2d
from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain
from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from torch_threads import few_threads  # noqa: F401

WIDTH, TAIL, RANK = 9, 8, 8
TOL = 1e-6


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


def _tbits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def fac_fields(jf) -> dict:
    """A JAX factorization of any plain storage as the dict
    ``convert.factorization_2d`` takes: bf16 planes as bit patterns."""
    out = {}
    for name in jf.__dataclass_fields__:
        v = getattr(jf, name)
        out[name] = (_bits(v) if getattr(v, "dtype", None) == jnp.bfloat16
                     else v if isinstance(v, int) else np.asarray(v))
    return out


@pytest.fixture(scope="module")
def factors():
    """One complex128 factorization of the bump's Msp at h = 1/30 (31 lines
    of 31), compressed by each package in each storage."""
    grid = JGrid2D(a=1.0, h=1.0 / 30.0)
    k = 1.0 / grid.h
    X, Y = grid.mesh()
    a, ag = jstencils.build_sparse_a_ag_2d(k, grid.x, grid.y, grid.h, dtype=jnp.complex128)
    jfac = jdirect.factor_stencil_2d(jstencils.build_msp_2d(a, ag, jmedia.gaussian_bump_2d(X, Y), k))
    tfac = convert.block_tridiag_factorization(np.asarray(jfac.cinv), np.asarray(jfac.lband),
                                               np.asarray(jfac.uband), device="cpu")
    pairs = {
        "banded": (jdirect.compress_factorization_banded(jfac, WIDTH),
                   direct.compress_factorization_banded(tfac, WIDTH)),
        "banded_tail": (jdirect.compress_factorization_banded_tail(jfac, WIDTH, TAIL),
                        direct.compress_factorization_banded_tail(tfac, WIDTH, TAIL)),
        "banded_lr": (jdirect.compress_factorization_banded_lr(jfac, WIDTH, RANK),
                      direct.compress_factorization_banded_lr(tfac, WIDTH, RANK)),
    }
    return grid.shape, pairs


MODES = ("banded", "banded_tail", "banded_lr")


@pytest.mark.parametrize("mode", MODES)
def test_compressed_planes_bit_equal(factors, mode):
    """Band planes (and the tail's dense planes) bit-equal: the band is a
    gather of the same complex128 entries, rounded to bf16 the same way on
    both sides (through f32 in the port; directly in the JAX package, which
    lands on the same bits for these entries)."""
    _, pairs = factors
    jf, tf = pairs[mode]
    names = ["band_re", "band_im"] + (["tail_re", "tail_im"] if mode == "banded_tail" else [])
    for name in names:
        assert getattr(tf, name).dtype == torch.bfloat16
        np.testing.assert_array_equal(_tbits(getattr(tf, name)), _bits(getattr(jf, name)),
                                      err_msg=name)
    if mode == "banded_tail":
        assert tf.tail_start == jf.tail_start == factors[0][0] - TAIL
    for name in ("lband", "uband"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)))
    # the JAX factorization carried across: the port's class, the JAX bits
    carried = convert.factorization_2d(fac_fields(jf), device="cpu")
    assert type(carried) is type(tf)
    for name, want in fac_fields(jf).items():
        got = getattr(carried, name)
        if isinstance(want, int):
            assert got == want, name
        else:
            got = _tbits(got) if got.dtype == torch.bfloat16 else got.numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_lowrank_product_matches(factors):
    """``U V^H`` of the stored bf16 factors against the JAX package's.  Both
    QRs run LAPACK's Householder convention, so the columns even share their
    phase; the probe is computed in float32 on both sides (cos and sin of two
    libraries), and a handful of entries of U and V round to the
    neighbouring bf16 value: one ulp (2^-8 relative) of an entry moves the
    product by at most that much of its size, so the product is held to
    1e-4 of its max-norm, and the planes to one ulp."""
    _, pairs = factors
    jf, tf = pairs["banded_lr"]

    def product(u_re, u_im, v_re, v_im):
        u, v = u_re + 1j * u_im, v_re + 1j * v_im
        return np.einsum("mir,mjr->mij", u, v.conj())

    def f64(x):
        return np.asarray(jnp.asarray(x, jnp.float64))

    want = product(*(f64(getattr(jf, n)) for n in ("u_re", "u_im", "v_re", "v_im")))
    got = product(*(getattr(tf, n).double().numpy() for n in ("u_re", "u_im", "v_re", "v_im")))
    assert tuple(tf.u_re.shape) == tuple(jf.u_re.shape) == (31, 31, RANK)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    for name in ("u_re", "u_im", "v_re", "v_im"):
        ulps = np.abs(_tbits(getattr(tf, name)).astype(np.int32)
                      - _bits(getattr(jf, name)).astype(np.int32))
        assert ulps.max() <= 1 and (ulps > 0).mean() < 1e-3, name


def _jax_line(jf, j):
    """The JAX package's line ``j`` of a factorization, in the storage its
    ``_pivot_apply`` takes (the hybrid through its two segment views)."""
    if hasattr(jf, "tail_start"):
        head, tail = jdirect._hybrid_views(jf)
        ts = jf.tail_start
        view, jj = (head, j) if j < ts else (tail, j - ts)
        return jax.tree_util.tree_map(lambda a: a[jj], view)
    return jax.tree_util.tree_map(lambda a: a[j], jf)


def _near(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("r", [None, 2])
def test_pivot_apply_matches(factors, mode, r):
    (m, n), pairs = factors
    jf, tf = pairs[mode]
    rng = np.random.default_rng(1)
    shape = (n,) if r is None else (n, r)
    for j in (0, 11, m - TAIL - 1, m - TAIL, m - 1):
        y = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        _near(direct._pivot_apply(tf, j, torch.as_tensor(y)),
              jdirect._pivot_apply(_jax_line(jf, j), jnp.asarray(y)))


@pytest.fixture(scope="module")
def hybrid(factors):
    (m, n), pairs = factors
    jf, tf = pairs["banded_tail"]
    tf = convert.factorization_2d(fac_fields(jf), device="cpu")     # carried across
    rng = np.random.default_rng(2)
    b = rng.standard_normal((m, n, 2)) + 1j * rng.standard_normal((m, n, 2))
    return m, jf, tf, b


@pytest.mark.parametrize("start,tail", [(0, 0), (5, 12), (25, 4)])
def test_hybrid_support_solves(hybrid, start, tail):
    """The full solve, a head start before the segment boundary (line 23)
    with a tail across it, and a head start past it with a tail inside the
    dense segment."""
    m, jf, tf, b = hybrid
    b = b.copy()
    b[:start] = 0
    _near(direct.block_thomas_solve_support(tf, torch.as_tensor(b), start=start, tail=tail),
          jdirect.block_thomas_solve_support(jf, jnp.asarray(b), start=start, tail=tail))


@pytest.mark.parametrize("tail,resume", [(12, 11)])
def test_hybrid_cached_and_resumed(hybrid, tail, resume):
    """The cached solve and its stacks, and a solve resumed from them whose
    rhs differs on lines inside the resumed range; the resumed solve equals
    the port's own full solve (the JAX package's fast-path claim)."""
    m, jf, tf, b = hybrid
    x, y, t = direct.block_thomas_solve_cached(tf, torch.as_tensor(b), tail=tail)
    jx, jy, jt = jdirect.block_thomas_solve_cached(jf, jnp.asarray(b), tail=tail)
    for got, want in ((x, jx), (y, jy), (t, jt)):
        _near(got, want)
    b2 = b.copy()
    b2[m - 3] += 1.0 + 0.5j
    got = direct.block_thomas_solve_resume(tf, torch.as_tensor(b2), y, t, resume)
    _near(got, jdirect.block_thomas_solve_resume(jf, jnp.asarray(b2), jy, jt, resume))
    np.testing.assert_allclose(got.numpy(), direct.block_thomas_solve(tf, torch.as_tensor(b2)).numpy(),
                               rtol=0, atol=1e-12 * float(got.abs().max()))


# ---------------------------------------------------------------------------
# (d)-(e) the slices whole, h = 1/40
# ---------------------------------------------------------------------------

KW = dict(h=1.0 / 40.0, n_subdomains=3, npml=6, double_sweep=False, pivot_band=13)
SOLVE = dict(rtol=1e-8, restart=20, maxiter=40)
# The pivot applies of these modes run in float32 on bf16 entries in both
# packages, which sum the band (and the rank term) in different orders: each
# apply differs by about 1e-7 of its size, and the complex128 residual
# histories by up to 2e-5 (measured here, banded_lr); they are held to 1e-4.
HIST = dict(rtol=1e-4, floor=1e-12)


def _check_solve(info, x, jinfo, jx, sol=1e-5):
    n_it = int(jinfo.n_iterations)
    assert bool(jinfo.converged) and n_it > 0
    assert int(info.n_iterations) == n_it and bool(info.converged)
    want = np.asarray(jinfo.residuals)[: n_it + 1]
    np.testing.assert_allclose(info.residuals.numpy()[: n_it + 1], want,
                               rtol=HIST["rtol"], atol=HIST["floor"] * want[0])
    want = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=sol * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_plasma2d_solve_matches(mode):
    """Each package builds its own problem (its own LAPACK factorization,
    bf16 planes that agree bit for bit away from rounding ties) and solves
    in complex128 at rtol 1e-8."""
    rank = dict(pivot_rank=RANK) if mode == "banded_lr" else {}
    jp = jplasma2d.build_problem(dtype=jnp.complex128, pivot_dtype=mode, **KW, **rank)
    tp = plasma2d.build_problem(dtype=torch.complex128, pivot_dtype=mode, device="cpu",
                                **KW, **rank)
    kind = {"banded": direct.BlockTridiagFactorizationBanded,
            "banded_tail": direct.BlockTridiagFactorizationBandedTail,
            "banded_lr": direct.BlockTridiagFactorizationBandedLR}[mode]
    assert isinstance(tp.precond.slabs.fac, kind) and tp.precond.slabs.pfac is None
    if mode == "banded_tail":
        assert tp.precond.slabs.fac.tail_start == jp.precond.slabs.fac.tail_start
        assert tp.precond.slabs.m1_max - tp.precond.slabs.fac.tail_start == \
            subdomain.tail_lines(tp.precond.slabs)
    jx, jinfo = jplasma2d.solve(jp, (1.0, 0.0), **SOLVE)
    tx, info = plasma2d.solve(tp, (1.0, 0.0), **SOLVE)
    _check_solve(info, tx, jinfo, jx)
    assert float(info.true_residual) < 1e-6
