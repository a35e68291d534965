"""The banded+tail pivot layout of the port (``pivot_dtype="pallas_banded_tail"``)
against the JAX package's, whose Pallas kernels run in interpret mode.

(a) the port's hybrid layout, built from the JAX factorization, is bit-equal
    to the JAX layout carried over by ``convert.banded_tail_factorization``;
(b) the plain versions of the hybrid substitution kernels through every
    one-slab entry point, against ``pallas_thomas`` on the same layout (the
    shapes of ``tests/test_pallas_thomas.py``'s ``setup_ht``);
(c) the plain fused sweep against ``gs_sweep_fused`` on the 3-slab system of
    ``test_gs_sweep_pallas_banded_tail_dispatch``, and against the port's
    per-slab sweep on the same layout;
(d) the slice whole at h = 1/40, port against JAX, with the port's own
    preconditioner and with the JAX one carried over, and the joint solve of
    eight directions at once.

On the card a launch takes r = 1, 2, 4 or 8 right-hand sides on this layout
too; here the wrappers take their plain versions, held at r = 8 (and 4 in the
fused sweep) against the JAX kernels, which take any r.

Same bf16 entries and f32 arithmetic on both sides, so only the summation
order differs: 1e-5 of the max-norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D as JGrid2D
from fast_solver_lippmann_schwinger_tpu.ddm import subdomain as jsub
from fast_solver_lippmann_schwinger_tpu.ddm import sweeps as jsweeps
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.models import plasma2d as jplasma2d
from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
from fast_solver_lippmann_schwinger_tpu.sparse import pallas_thomas as jpt
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix2D as JStencilMatrix2D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain, sweeps
from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from fast_solver_lippmann_schwinger_tpu_torch.sparse import sweep_kernels as sk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

M, N = 12, 40          # the shapes of test_pallas_thomas.py
WIDTH, TAIL = 15, 4
TOL = 1e-5


def _bits(x):
    return np.asarray(x).view(np.uint16)


def ht_fields(p) -> dict:
    """A JAX ``PallasFactorizationBandedTail`` as the arguments of
    ``convert.banded_tail_factorization``."""
    return dict(head_re=_bits(p.head_re), head_im=_bits(p.head_im), tail_re=_bits(p.tail_re),
                tail_im=_bits(p.tail_im), lband=np.asarray(p.lband), uband=np.asarray(p.uband),
                n=p.n, tail_start=p.tail_start, halo=p.halo, width=p.width)


def _near(got, want, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def factors():
    """The factorizations of ``setup_ht`` (complex64) on both sides: the JAX
    one and the port's carried over from it."""
    rng = np.random.default_rng(3)
    vals = (rng.standard_normal((2, M, N, 3, 3))
            + 1j * rng.standard_normal((2, M, N, 3, 3))).astype(np.complex64)
    vals[:, :, :, 1, 1] += 12.0
    jf = jax.vmap(lambda v: jdirect.factor_stencil_2d(JStencilMatrix2D(values=v)))(
        jnp.asarray(vals))
    tf = convert.block_tridiag_factorization(np.asarray(jf.cinv), np.asarray(jf.lband),
                                             np.asarray(jf.uband), device="cpu")
    return jf, tf


@pytest.fixture(scope="module")
def banded(factors):
    jf, _ = factors
    jp = jpt.build_pallas_banded_tail(jf, width=WIDTH, tail_lines=TAIL)
    return jp, convert.banded_tail_factorization(**ht_fields(jp), device="cpu")


@pytest.mark.parametrize("width", [WIDTH, 2 * N - 1, None])
def test_layout_is_bit_equal(factors, width):
    """The port's windows and tail planes, built from the same factorization,
    are the JAX package's carried over, bit for bit; ``width=None`` is the
    w(n) rule of both packages."""
    jf, tf = factors
    jp = jpt.build_pallas_banded_tail(jf, width=width, tail_lines=TAIL)
    carried = convert.banded_tail_factorization(**ht_fields(jp), device="cpu")
    built = tk.build_banded_tail_factorization(tf, width=width, tail_lines=TAIL)
    assert built.width == carried.width == jp.width
    assert direct.default_band_width(N) == jdirect.default_band_width(N)
    half = jp.width // 2
    assert built.tail_start == carried.tail_start == jp.tail_start == M - TAIL
    assert tuple(built.head_re.shape) == (2, M - TAIL, 5, 8 + 2 * half, 8)
    assert tuple(built.tail_re.shape) == (2, TAIL, 5, 40, 8)
    for name in ("head_re", "head_im", "tail_re", "tail_im"):
        a, b = getattr(built, name), getattr(carried, name)
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name
    assert torch.equal(built.lband, carried.lband) and torch.equal(built.uband, carried.uband)
    # a window holds Cinv^T[8 t - half + v, 8 t + l] where |in - out| <= half
    ct = tf.cinv[:, : M - TAIL].transpose(-1, -2).real.float().to(torch.bfloat16).float()
    t, v, l = 2, half + 3, 5
    assert float(built.head_re[1, 0, t, v, l].float()) == float(ct[1, 0, 8 * t + 3, 8 * t + l])


@pytest.mark.parametrize("r", [None, 2, 8])
@pytest.mark.parametrize("tail", [0, 3])
def test_solve(banded, r, tail):
    jp, tp = banded
    rng = np.random.default_rng(tail)
    shape = (M, N) if r is None else (M, N, r)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want = jpt.solve(jp, 1, jnp.asarray(b), tail=tail, interpret=True)
    _near(tk.solve(tp, 1, torch.as_tensor(b), tail=tail), want)


def test_solve_all_with_slab_permutation(banded):
    """The slab of each batch row through the index (permuted), start and
    tail; three right-hand sides (the card takes them as one launch of
    four)."""
    jp, tp = banded
    rng = np.random.default_rng(7)
    bb = (rng.standard_normal((2, M, N, 3)) + 1j * rng.standard_normal((2, M, N, 3))).astype(
        np.complex64)
    _near(tk.solve_all(tp, [0, 1], torch.as_tensor(bb)),
          jpt.solve_all(jp, jnp.arange(2), jnp.asarray(bb), interpret=True))
    perm = [1, 0]
    b1 = bb[perm, ..., 0].copy()
    b1[:, :3] = 0
    _near(tk.solve_all(tp, perm, torch.as_tensor(b1), start=3, tail=5),
          jpt.solve_all(jp, jnp.asarray(perm), jnp.asarray(b1), start=3, tail=5, interpret=True))


@pytest.mark.parametrize("r", [None, 2, 8])
def test_solve_cached_and_resume(banded, r):
    """The cached solve and its caches, then the resumed solve from them; the
    caches are left as they were."""
    jp, tp = banded
    rng = np.random.default_rng(11)
    shape = (M, N) if r is None else (M, N, r)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    jx, jy, jt = jpt.solve_cached(jp, 0, jnp.asarray(b), tail=3, interpret=True)
    x, y, t = tk.solve_cached(tp, 0, torch.as_tensor(b), tail=3)
    _near(x, jx, "x")
    _near(y[..., :N], np.asarray(jy)[..., :N], "y cache")
    _near(t[..., :N], np.asarray(jt)[..., :N], "t cache")
    b2 = b.copy()
    b2[M - 3:] += (1.0 + 0.5j)
    y0, t0 = y.clone(), t.clone()
    want = jpt.solve_resume(jp, 0, jnp.asarray(b2), jy, jt, 4, interpret=True)
    got = tk.solve_resume(tp, 0, torch.as_tensor(b2), y, t, 4)
    _near(got, want, "resumed")
    assert torch.equal(y, y0) and torch.equal(t, t0)


def test_solve_support(banded):
    jp, tp = banded
    rng = np.random.default_rng(13)
    b = (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))).astype(np.complex64)
    b[:5] = 0
    want = jpt.solve_support(jp, 0, jnp.asarray(b), start=5, tail=4, interpret=True)
    _near(tk.solve_support(tp, 0, torch.as_tensor(b), start=5, tail=4), want)


def _launch_counts():
    fwd, bwd = tk.forward_substitution_cached, tk.backward_substitution
    return dict(fwd.launches), dict(bwd.launches)


def test_passes_count_no_launch_on_the_cpu(banded):
    """On the hybrid layout the pass wrappers take their plain versions on
    the CPU and count a launch only where they launch; the carry-free
    forward pass takes dense planes only."""
    _, tp = banded
    s_idx = torch.zeros(1, dtype=torch.int32)
    rows = torch.zeros((1, M, 2, tp.ld))
    before = _launch_counts()
    y4, _ = tk.forward_substitution_cached(tp, s_idx, rows)
    tk.backward_substitution(tp, s_idx, y4)
    assert _launch_counts() == before
    with pytest.raises(ValueError, match="start"):
        tk.forward_substitution_cached(tp, s_idx, rows, start=M)
    with pytest.raises(ValueError, match="dense planes"):     # no carry-free hybrid pass
        tk.forward_substitution(tp, s_idx, rows)
    with pytest.raises(ValueError):
        tk.backward_substitution(tp, s_idx, rows[..., :-8].contiguous())


# ---------------------------------------------------------------------------
# (c) the fused sweep on the system of test_gs_sweep_pallas_banded_tail_dispatch
# ---------------------------------------------------------------------------

H = 1.0 / 40.0


def slab_fields(js) -> dict:
    """A JAX slab system on the banded+tail layout as the dict
    ``convert.slab_system`` takes."""
    names = [f.name for f in dataclasses.fields(subdomain.SlabSystem)
             if f.name not in ("fac", "pfac")]
    d = {name: np.asarray(getattr(js, name)) for name in names}
    d["fac"] = dict(cinv=np.asarray(js.fac.cinv), lband=np.asarray(js.fac.lband),
                    uband=np.asarray(js.fac.uband))
    d["pfac"] = ht_fields(js.pfac)
    return d


@pytest.fixture(scope="module")
def sweep_system():
    grid = JGrid2D(a=1.0, h=H)
    k = 1.0 / H
    X, Y = grid.mesh()
    nu = jmedia.gaussian_bump_2d(X, Y)
    a_st, ag_st, a_np, ag_np = jstencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, H, dtype=jnp.complex64, return_host=True)
    js = jsub.build_slab_system(a_st, ag_st, nu, grid.x, grid.y, H, k, 3, npml=5,
                                a_host=a_np, ag_host=ag_np,
                                pivot_dtype="pallas_banded_tail", pivot_band=21)
    return js, convert.slab_system(slab_fields(js), device="cpu")


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_fused_sweep_matches_jax(sweep_system, r):
    js, ts = sweep_system
    assert isinstance(ts.pfac, tk.BandedTailFactorization) and ts.pfac.width == 21
    assert 0 < ts.trace_tail < ts.m1_max
    rng = np.random.default_rng(5 + r)
    shape = (ts.m * ts.n,) if r == 1 else (ts.m * ts.n, r)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want = jsweeps.gs_sweep(js, jnp.asarray(b))
    before = (sk.sweep_down.launches, sk.sweep_up.launches)
    got = sweeps.gs_sweep(ts, torch.as_tensor(b))
    assert (sk.sweep_down.launches, sk.sweep_up.launches) == before    # plain on the CPU
    _near(got, want)
    # the per-slab route on the same layout: the same sweep
    _near(sweeps._gs_sweep_per_slab(ts, torch.as_tensor(b)), want, "per slab")


def test_fused_sweep_parts(sweep_system):
    """The two wrappers separately: the down sweep's caches feed the up
    sweep, and the last slab has no bottom trace."""
    _, ts = sweep_system
    tables = ts.sweep_tables
    assert tables.meta.dtype == torch.int32 and tuple(tables.meta.shape) == (6, ts.n_subs)
    assert tables.meta[4].tolist() == [0, 1, 1] and tables.meta[5].tolist() == [1, 1, 0]
    rng = np.random.default_rng(9)
    b = torch.as_tensor((rng.standard_normal(ts.m * ts.n)
                         + 1j * rng.standard_normal(ts.m * ts.n)).astype(np.complex64))
    b4 = tk._to_rows_b(ts.pfac, subdomain.partition_source(ts, b))
    tt = ts.trace_tail
    y4, t4, unp = sk.sweep_down(ts.pfac, tables.meta, b4, tables.c01, tables.c10, tt)
    assert not unp[-1].any() and unp[0].any()
    u4 = sk.sweep_up(ts.pfac, tables.meta, b4, tables.cnpn, tables.cnnp, y4, t4, unp, tt)
    assert torch.equal(u4, sk.sweep_fused_plain(ts.pfac, tables.meta, b4, tables, tt))
    with pytest.raises(ValueError, match="trace_tail"):
        sk.sweep_down(ts.pfac, tables.meta, b4, tables.c01, tables.c10, ts.m1_max)
    with pytest.raises(ValueError, match="coupling"):
        sk.sweep_down(ts.pfac, tables.meta, b4, tables.c01[:, :, :2].contiguous(),
                      tables.c10, tt)


# ---------------------------------------------------------------------------
# (d) the slice whole
# ---------------------------------------------------------------------------

PROBLEM = dict(h=H, n_subdomains=3, double_sweep=True,
               pivot_dtype="pallas_banded_tail", pivot_band=21)
SOLVE = dict(rtol=1e-5, restart=20, maxiter=12)


@pytest.fixture(scope="module")
def slice_problems():
    """``build_problem`` on both sides, complex64, and the port's problem
    again with the JAX preconditioner carried over (its slab systems, hence
    the same bf16 entries)."""
    jp = jplasma2d.build_problem(dtype=jnp.complex64, **PROBLEM)
    tp = plasma2d.build_problem(dtype=torch.complex64, device="cpu", **PROBLEM)
    jpc = jp.precond
    carried = convert.double_sweep_preconditioner(
        slab_fields(jpc.slabs), slab_fields(jpc.slabs_t), np.asarray(jpc.msp.values),
        np.asarray(jpc.a_s.values), device="cpu")
    return jp, {"own": tp, "carried": dataclasses.replace(tp, precond=carried)}


@pytest.mark.parametrize("precond", ["own", "carried"])
def test_slice_matches_jax(slice_problems, precond):
    """``solve`` on both sides: the same iteration count, the residual history
    within 1e-5 above the float32 floor (1e-7 of the first residual: below it
    a residual norm is rounding noise), the solution within 1e-4.  ``own``:
    each package factors its own stencils; ``carried``: the JAX slab systems.
    The solves stop at rtol 1e-5: at 1e-6 the last iteration would fall to
    the float32 floor of an apply (ROADMAP.md, Queue 3)."""
    jp, problems = slice_problems
    tp = problems[precond]
    for slabs, jslabs in ((tp.precond.slabs, jp.precond.slabs),
                          (tp.precond.slabs_t, jp.precond.slabs_t)):
        assert isinstance(slabs.pfac, tk.BandedTailFactorization)
        assert slabs.pfac.width == jslabs.pfac.width == 21
        assert slabs.pfac.tail_start == jslabs.pfac.tail_start
        assert tuple(slabs.fac.cinv.shape[2:]) == (0, 0)
    jx, jinfo = jplasma2d.solve(jp, (1.0, 0.0), **SOLVE)
    tx, info = plasma2d.solve(tp, (1.0, 0.0), **SOLVE)
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it > 0
    assert bool(info.converged) and bool(jinfo.converged)
    want = np.asarray(jinfo.residuals)[: n_it + 1]
    np.testing.assert_allclose(np.asarray(info.residuals)[: n_it + 1], want,
                               rtol=1e-5, atol=1e-7 * want[0])
    want = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert float(info.true_residual) < 1e-4


R = 8
# eight plane-wave directions at angles 2 pi k / 8 (chip_smoke.WIDE_DIRECTIONS)
WIDE_DIRECTIONS = tuple((float(np.cos(2 * np.pi * k / R)), float(np.sin(2 * np.pi * k / R)))
                        for k in range(R))


def test_eight_directions_joint_solve_matches_jax(slice_problems):
    """``solve_batched`` of eight directions at once on the banded+tail
    layout (the port's problem with the JAX preconditioner carried over, so
    both solve with the same bf16 entries; the fused sweep at r = 8, one
    launch a direction on the card), against the JAX ``solve_batched``,
    whose fused sweep runs in interpret mode: the same iteration count for
    every direction, the residual histories within 1e-5 above the float32
    floor, the solutions within 1e-4.  The joint solve stops at rtol 1e-4:
    at 1e-5 the last residual of some directions is 2e-6 of the first,
    within a factor two of the float32 floor of an apply, where the two
    packages' summation orders alone move it by 1.7e-7 of the first."""
    jp, problems = slice_problems
    tp = problems["carried"]
    solve = dict(SOLVE, rtol=1e-4)
    jX, jinfo = jplasma2d.solve_batched(jp, WIDE_DIRECTIONS, **solve)
    tX, info = plasma2d.solve_batched(tp, WIDE_DIRECTIONS, **solve)
    counts = np.asarray(jinfo.n_iterations)
    np.testing.assert_array_equal(info.n_iterations.numpy(), counts)
    assert counts.shape == (R,) and counts.min() > 0
    assert bool(info.converged.all()) and bool(np.asarray(jinfo.converged).all())
    for i in range(R):
        want = np.asarray(jinfo.residuals[i])[: counts[i] + 1]
        np.testing.assert_allclose(info.residuals[i].numpy()[: counts[i] + 1], want,
                                   rtol=1e-5, atol=1e-7 * want[0])
    want = np.asarray(jX)
    assert tuple(tX.shape) == want.shape == (R, tp.grid.size)
    np.testing.assert_allclose(tX.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert float(info.true_residual.max()) < 1e-3
