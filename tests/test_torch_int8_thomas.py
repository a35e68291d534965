"""The int8 storage of the line substitution (``pivot_dtype="pallas_int8"``)
and the XLA-side ``"bf16"`` pivots of the port, against the JAX package,
whose Pallas kernels run in interpret mode.

(a) the port's int8 packing of the same dense pivots is bit-equal to
    ``build_pallas_factorization(storage="int8")``, entries and scales, away
    from its 128-lane padding (and to ``convert.thomas_factorization``);
(b) the plain int8 passes through ``solve_all``, ``solve_cached`` and
    ``solve_resume`` at r = 1, 2 and 3 against the interpret-mode kernels on
    carried-over int8 factors, to f32 summation order (rel 1e-5), at a line
    of one scale block (n = 41) and of a partial second one (n = 150);
(c) the ``"pallas_int8"``, mixed (y bf16, x int8) and ``"bf16"`` slab
    systems at h = 1/40 with 3 slabs: ``gs_sweep`` on the carried-over JAX
    slab systems, and the ``plasma2d`` solve whole, with each package's own
    factors and with the JAX preconditioner carried over.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.ddm import sweeps as jsweeps
from fast_solver_lippmann_schwinger_tpu.models import plasma2d as jplasma2d
from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
from fast_solver_lippmann_schwinger_tpu.sparse import pallas_thomas as jpt
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix2D as JStencilMatrix2D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain, sweeps
from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

TOL = 1e-5      # of the max-norm: the same int8 entries and f32 arithmetic


def _bits(x):
    return np.asarray(x).view(np.uint16)


def pfac_fields(p) -> dict:
    """A JAX ``PallasFactorization`` (bf16 or int8) as the arguments of
    ``convert.thomas_factorization``."""
    planes = (np.asarray(p.cinv_t_re), np.asarray(p.cinv_t_im))
    if planes[0].dtype != np.int8:
        planes = tuple(_bits(a) for a in planes)
    return dict(cinv_t_re=planes[0], cinv_t_im=planes[1], lband=np.asarray(p.lband),
                uband=np.asarray(p.uband), scale=np.asarray(p.scale), n=p.n)


def slab_fields(js) -> dict:
    """A JAX slab system as the dict ``convert.slab_system`` takes."""
    names = [f.name for f in dataclasses.fields(subdomain.SlabSystem)
             if f.name not in ("fac", "pfac")]
    d = {name: np.asarray(getattr(js, name)) for name in names}
    if hasattr(js.fac, "cinv_re"):
        d["fac"] = dict(cinv_re=_bits(js.fac.cinv_re), cinv_im=_bits(js.fac.cinv_im),
                        lband=np.asarray(js.fac.lband), uband=np.asarray(js.fac.uband))
    else:
        d["fac"] = dict(cinv=np.asarray(js.fac.cinv), lband=np.asarray(js.fac.lband),
                        uband=np.asarray(js.fac.uband))
    d["pfac"] = None if js.pfac is None else pfac_fields(js.pfac)
    return d


def _near(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# (a), (b): random factors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(3, 24, 41), (2, 6, 150)], ids=["n41", "n150"])
def factors(request):
    """Random well-conditioned stencils factored by the JAX package (complex64),
    its int8 layout, and the port's: packed by the port from the same dense
    pivots, and carried over."""
    S, M, N = request.param
    rng = np.random.default_rng(N)
    v = (rng.standard_normal((S, M, N, 3, 3))
         + 1j * rng.standard_normal((S, M, N, 3, 3))).astype(np.complex64)
    v[..., 1, 1] += 8.0
    jf = jax.vmap(lambda w: jdirect.factor_stencil_2d(JStencilMatrix2D(values=w)))(
        jnp.asarray(v))
    jpf = jpt.build_pallas_factorization(jf, storage="int8")
    dense = convert.block_tridiag_factorization(np.asarray(jf.cinv), np.asarray(jf.lband),
                                                np.asarray(jf.uband), device="cpu")
    built = tk.build_thomas_factorization(dense, storage="int8")
    carried = convert.thomas_factorization(**pfac_fields(jpf), device="cpu")
    return (S, M, N), jpf, built, carried, dense


def test_int8_packing_is_bit_equal(factors):
    """Entries and scales of the port's packing equal the JAX package's, and
    the carried-over layout equals the port's own, bit for bit."""
    (S, M, N), jpf, built, carried, dense = factors
    ld = tk._round_up(N, 8)
    nb = tk.n_scale_blocks(ld)
    assert built.storage == carried.storage == "int8" and built.ld == ld
    assert built.scale.shape == (S, M, ld // 8, nb, 2, 8)
    for name in ("cinv_t_re", "cinv_t_im", "scale", "lband", "uband"):
        assert torch.equal(getattr(built, name), getattr(carried, name)), name
    jsc = np.asarray(jpf.scale)                              # (S, M, 2, nb, np)
    assert jsc.shape[3] == nb
    np.testing.assert_array_equal(tk.dense_scales(built.scale).numpy(), jsc[..., :ld])
    for k, name in enumerate(("cinv_t_re", "cinv_t_im")):
        plane = tk.dense_planes(getattr(built, name))
        assert plane.dtype == torch.int8 and plane.shape == (S, M, ld, ld)
        np.testing.assert_array_equal(plane[:, :, :N, :N].numpy(),
                                      np.asarray(getattr(jpf, name))[:, :, :N, :N])
        assert not plane[:, :, N:].any() and not plane[:, :, :, N:].any()
        # padding lanes carry scale 1, as the JAX package's zero columns do
        assert bool((tk.dense_scales(built.scale)[:, :, k, :, N:] == 1).all())
    unbatched = tk.build_thomas_factorization(direct.BlockTridiagFactorization(
        dense.cinv[0], dense.lband[0], dense.uband[0]), batched=False, storage="int8")
    assert torch.equal(unbatched.scale[0], built.scale[0])


def test_packing_from_bf16_pivots(factors):
    """The kernel layouts packed from the XLA-side bf16 pivots
    (``compress_factorization``, what ``use_pallas=True`` attaches to
    ``pivot_dtype="bf16"``): bf16 planes equal those packed from the full
    pivots, and int8 planes equal the JAX package's packing of its own bf16
    pivots, bit for bit."""
    (S, M, N), _, _, _, dense = factors
    jf = jdirect.BlockTridiagFactorization(
        cinv=jnp.asarray(dense.cinv.numpy()), lband=jnp.asarray(dense.lband.numpy()),
        uband=jnp.asarray(dense.uband.numpy()))
    jpf = jpt.build_pallas_factorization(jdirect.compress_factorization(jf), storage="int8")
    bf16 = direct.compress_factorization(dense)
    assert bf16.cinv_re.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.cinv_re.view(torch.int16).numpy().view(np.uint16),
                                  _bits(jdirect.compress_factorization(jf).cinv_re))
    from_bf16 = tk.build_thomas_factorization(bf16)
    from_full = tk.build_thomas_factorization(dense)
    assert torch.equal(from_bf16.cinv_t_re.view(torch.int16), from_full.cinv_t_re.view(torch.int16))
    assert torch.equal(from_bf16.cinv_t_im.view(torch.int16), from_full.cinv_t_im.view(torch.int16))
    q = tk.build_thomas_factorization(bf16, storage="int8")
    carried = convert.thomas_factorization(**pfac_fields(jpf), device="cpu")
    for name in ("cinv_t_re", "cinv_t_im", "scale"):
        assert torch.equal(getattr(q, name), getattr(carried, name)), name


def _rhs(rng, shape, start=0):
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    b[:, :start] = 0
    return b


@pytest.mark.parametrize("r,start,tail", [(None, 0, 0), (1, 3, 5), (2, 3, 0), (3, 0, 5)])
def test_solve_all_matches_interpret_kernels(factors, r, start, tail):
    """The int8 forward and backward passes (``_fwd_b``/``_bwd_b``), batch
    rows picking slabs out of order."""
    (S, M, N), jpf, _, pf, _ = factors
    rng = np.random.default_rng(10 * start + (r or 0))
    shape = (2, M, N) if r is None else (2, M, N, r)
    b = _rhs(rng, shape, start)
    s_idx = [S - 1, 0]
    want = jpt.solve_all(jpf, jnp.asarray(s_idx), jnp.asarray(b), start=start, tail=tail,
                         interpret=True)
    before = dict(tk.forward_substitution.launches)
    got = tk.solve_all(pf, s_idx, torch.as_tensor(b), start=start, tail=tail)
    # the CPU runs the plain versions: no launch is counted
    assert tk.forward_substitution.launches == before
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    _near(got, want)


@pytest.mark.parametrize("r", [None, 3])
def test_cached_and_resumed_solves_match(factors, r):
    """``solve_cached`` (``_fwd``/``_fwd_bt`` with the t stack, truncated
    backward pass) and ``solve_resume`` (the forward pass resumed from the
    cached carry, full backward pass) on one slab, caches included."""
    (S, M, N), jpf, _, pf, _ = factors
    rng = np.random.default_rng(7 + (r or 0))
    shape = (M, N) if r is None else (M, N, r)
    b = _rhs(rng, shape)
    tail = 6
    b_up = b.copy()
    b_up[M - tail:] += _rhs(rng, (tail,) + shape[1:])
    s = S - 1
    jx, jy, jt = jpt.solve_cached(jpf, s, jnp.asarray(b), tail=tail, interpret=True)
    x, y_c, t_c = tk.solve_cached(pf, s, torch.as_tensor(b), tail)
    _near(x, jx)
    # caches: (M, 2r, ld) rows here, (M, 2, np) / (M, 2r, np) there
    jy, jt = np.asarray(jy), np.asarray(jt)
    _near(y_c[..., :N], jy.reshape(M, -1, jy.shape[-1])[..., :N])
    _near(t_c[..., :N], jt.reshape(M, -1, jt.shape[-1])[..., :N])
    want = jpt.solve_resume(jpf, s, jnp.asarray(b_up), jnp.asarray(jy), jnp.asarray(jt),
                            tail, interpret=True)
    got = tk.solve_resume(pf, s, torch.as_tensor(b_up), y_c, t_c, tail)
    _near(got, want)
    _near(got, tk.solve(pf, s, torch.as_tensor(b_up)).numpy(), 1e-6)


def test_int8_close_to_dense_solve(factors):
    """int8 pivots with per-block scales keep the solve within a few per cent
    of the full-precision ``block_thomas_solve`` on these systems."""
    (S, M, N), _, built, _, dense = factors
    rng = np.random.default_rng(1)
    b = torch.as_tensor(_rhs(rng, (S, M, N, 2)))
    got = tk.solve_all(built, list(range(S)), b)
    for s in range(S):
        want = direct.block_thomas_solve(dense.slab(s), b[s])
        assert float((got[s] - want).abs().max() / want.abs().max()) < 5e-2


# ---------------------------------------------------------------------------
# (c) the slab systems and the slice whole, h = 1/40, 3 slabs, double sweep
# ---------------------------------------------------------------------------

KW3 = dict(h=1.0 / 40.0, n_subdomains=3, npml=6, double_sweep=True)
MODES = {"int8": dict(pivot_dtype="pallas_int8"),
         "mixed": dict(pivot_dtype="pallas", pivot_dtype_t="pallas_int8"),
         "bf16": dict(pivot_dtype="bf16")}
# complex64 solves stop at rtol 1e-5: at 1e-6 the last iteration would fall to
# the float32 floor of an apply (ROADMAP.md, Queue 3)
SOLVE = dict(rtol=1e-5, restart=20, maxiter=20)


@pytest.fixture(scope="module", params=list(MODES))
def slice_problems(request):
    """``build_problem`` on both sides (complex64), and the port's problem
    again with the JAX preconditioner carried over (its slab systems, hence
    the same int8 or bf16 entries)."""
    mode = MODES[request.param]
    jp = jplasma2d.build_problem(dtype=jnp.complex64, **KW3, **mode)
    tp = plasma2d.build_problem(dtype=torch.complex64, device="cpu", **KW3, **mode)
    jpc = jp.precond
    carried = convert.double_sweep_preconditioner(
        slab_fields(jpc.slabs), slab_fields(jpc.slabs_t), np.asarray(jpc.msp.values),
        np.asarray(jpc.a_s.values), device="cpu")
    return request.param, jp, {"own": tp, "carried": dataclasses.replace(tp, precond=carried)}


def test_slab_system_storage(slice_problems):
    """Each direction keeps the storage its mode names, beside the bands."""
    name, jp, problems = slice_problems
    want = {"int8": ("int8", "int8"), "mixed": ("bf16", "int8"), "bf16": (None, None)}[name]
    for tp in problems.values():
        for slabs, jslabs, storage in zip((tp.precond.slabs, tp.precond.slabs_t),
                                          (jp.precond.slabs, jp.precond.slabs_t), want):
            if storage is None:
                assert slabs.pfac is None and jslabs.pfac is None
                assert slabs.fac.cinv_re.dtype == torch.bfloat16
                assert tuple(slabs.fac.cinv_re.shape) == tuple(jslabs.fac.cinv_re.shape)
            else:
                assert slabs.pfac.storage == storage
                assert tuple(slabs.fac.cinv.shape[2:]) == (0, 0)


def test_gs_sweep_matches(slice_problems):
    """``gs_sweep`` at two right-hand sides (the multi-RHS kernels) over both
    directions' carried-over slab systems against the JAX package's (its int8
    kernels in interpret mode, or its bf16 XLA solves); the single-RHS
    kernels run in the solves below."""
    _, jp, problems = slice_problems
    pc, jpc = problems["carried"].precond, jp.precond
    rng = np.random.default_rng(2)
    shape = (jpc.slabs.m * jpc.slabs.n, 2)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    for slabs, jslabs in ((pc.slabs, jpc.slabs), (pc.slabs_t, jpc.slabs_t)):
        _near(sweeps.gs_sweep(slabs, torch.as_tensor(b)), jsweeps.gs_sweep(jslabs, jnp.asarray(b)))


def test_slice_matches_jax(slice_problems):
    """``solve`` on both sides: the same iteration count, the residual history
    within 1e-5 above the float32 floor, the solution within 1e-4.  The floor:
    the last residual of these solves, about 3e-6 of the first, differs by 5 %
    between two float32 summation orders even on identical factors, so
    residuals are compared to 1e-6 of the first.  ``own``: each package
    factors its own stencils (int8 entries where two LAPACKs round
    differently may differ by one step), for the int8 storage; ``carried``:
    the JAX slab systems, for every mode."""
    name, jp, problems = slice_problems
    jx, jinfo = jplasma2d.solve(jp, (1.0, 0.0), **SOLVE)
    n_it = int(jinfo.n_iterations)
    assert bool(jinfo.converged) and n_it > 0
    for precond in ("own", "carried") if name == "int8" else ("carried",):
        tx, info = plasma2d.solve(problems[precond], (1.0, 0.0), **SOLVE)
        assert int(info.n_iterations) == n_it and bool(info.converged), precond
        want = np.asarray(jinfo.residuals)[: n_it + 1]
        np.testing.assert_allclose(np.asarray(info.residuals)[: n_it + 1], want,
                                   rtol=1e-5, atol=1e-6 * want[0], err_msg=precond)
        want = np.asarray(jx)
        np.testing.assert_allclose(tx.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=precond)
        assert float(info.true_residual) < 1e-4
