"""The 3D slices as a whole against the JAX package at h = 1/10: the bump
scattering solve with the sparsifying preconditioner (dense complex128 pivots
and bf16 plane pivots) and with the z-slab Gauss-Seidel sweep (two slabs,
npml = 5: dense complex128 pivots, int8 y-planes), and the entry point's
options."""

import dataclasses
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.models import bump3d as jbump3d
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain3d
from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d, media
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import PlaneSlabView
from torch_threads import few_threads  # noqa: F401

H = 1.0 / 10.0


@pytest.fixture(scope="module")
def full():
    """complex128, dense pivots: each package builds everything itself."""
    jp = jbump3d.build_problem(h=H, dtype=jnp.complex128)
    tp = bump3d.build_problem(h=H, dtype=torch.complex128, device="cpu")
    return jp, tp


def test_problem_setup_matches(full):
    jp, tp = full
    assert tp.grid.shape == jp.grid.shape == (10, 10, 10) and tp.k == jp.k == 10.0
    assert tp.op.symbol.shape == jp.op.symbol.shape
    np.testing.assert_allclose(tp.rhs.numpy(), np.asarray(jp.rhs), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jp.rhs)).max())
    assert set(tp.setup_seconds) == {"symbol", "stencils", "msp", "factorization", "packing"}
    assert type(tp.precond.factorization).__name__ == "BlockTridiagFactorization3D"


def test_full_solve_matches(full):
    """complex128: the same iteration count and residual history as the JAX
    package (``tests/test_3d.py:98-106``); the annihilators differ in phase
    only, to which the preconditioned operator is blind, so the histories
    agree to 1e-6 above a floor of 1e-12 of the first residual."""
    jp, tp = full
    jx, jinfo = jbump3d.solve(jp, rtol=1e-8)
    tx, info = bump3d.solve(tp, rtol=1e-8)
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and 0 < n_it <= 25
    assert bool(info.converged) and bool(jinfo.converged)
    want = np.asarray(jinfo.residuals)[: n_it + 1]
    np.testing.assert_allclose(info.residuals.numpy()[: n_it + 1], want, rtol=1e-6,
                               atol=1e-12 * want[0])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-7 * np.abs(np.asarray(jx)).max())
    assert float(info.true_residual) < 1e-6


def test_unpreconditioned_solve_matches(full):
    jp, tp = full
    _, jinfo = jbump3d.solve(jp, rtol=1e-4, maxiter=40, preconditioned=False)
    _, info = bump3d.solve(tp, rtol=1e-4, maxiter=40, preconditioned=False)
    assert int(info.n_iterations) == int(jinfo.n_iterations)


@pytest.fixture(scope="module")
def pallas():
    """complex64, bf16 plane pivots; the port's preconditioner carried across
    from the JAX package (its plane stack and annihilator field)."""
    jp = jbump3d.build_problem(h=H, dtype=jnp.complex64, pivot_dtype="bf16_pallas")
    tp = bump3d.build_problem(h=H, dtype=torch.complex64, pivot_dtype="bf16_pallas", device="cpu")
    view = jp.precond.factorization
    st = view.stack
    carried = convert.sparsifying_preconditioner_3d(
        dict(stack=dict(p_re=np.asarray(st.p_re).view(np.uint16),
                        p_im=np.asarray(st.p_im).view(np.uint16),
                        scale=np.asarray(st.scale), mn=st.mn, l1=st.l1),
             lsten=np.asarray(view.lsten), usten=np.asarray(view.usten), base=int(view.base)),
        np.asarray(jp.precond.a_s.values), device="cpu")
    return jp, tp, carried


def test_pallas_problem_uses_plane_views(pallas):
    jp, tp, carried = pallas
    for pc in (tp.precond, carried):
        assert isinstance(pc.factorization, PlaneSlabView)
        assert pc.factorization.stack.p_re.dtype == torch.bfloat16
        assert pc.factorization.stack.mn == 100 and pc.factorization.stack.ld == 104


def test_pallas_solve_matches_on_carried_preconditioner(pallas):
    """The same bf16 planes and annihilators on both sides: the same count
    at rtol 1e-5, and a solution within 1e-4 of the max-norm (f32 summation
    order, amplified by the solve's conditioning)."""
    jp, tp, carried = pallas
    jx, jinfo = jbump3d.solve(jp, rtol=1e-5)
    tx, info = bump3d.solve(dataclasses.replace(tp, precond=carried), rtol=1e-5)
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and bool(info.converged)
    want = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert float(info.true_residual) < 1e-4


def test_pallas_solve_on_own_preconditioner(pallas, full):
    """The port's own bf16 setup converges in the JAX package's count, to a
    solution within 1e-4 of the complex128 one."""
    jp, tp, _ = pallas
    _, jinfo = jbump3d.solve(jp, rtol=1e-5)
    tx, info = bump3d.solve(tp, rtol=1e-5)
    assert int(info.n_iterations) == int(jinfo.n_iterations) and bool(info.converged)
    x128, _ = bump3d.solve(full[1], rtol=1e-8)
    ref = x128.numpy()
    assert np.max(np.abs(tx.numpy() - ref)) <= 1e-4 * np.abs(ref).max()


def test_apply_batch_is_per_column(pallas):
    _, tp, _ = pallas
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 1000)).astype(np.complex64))
    got = tp.precond.apply_batch(b)
    for r in range(2):
        torch.testing.assert_close(got[r], tp.precond.apply(b[r]), rtol=0, atol=1e-5)


def test_defaults_are_the_jax_packages():
    ours = inspect.signature(bump3d.build_problem).parameters
    theirs = inspect.signature(jbump3d.build_problem).parameters
    for name in ("h", "precond", "n_subdomains", "npml", "pivot_dtype", "with_preconditioner"):
        assert ours[name].default == theirs[name].default, name
    ours = inspect.signature(bump3d.solve).parameters
    theirs = inspect.signature(jbump3d.solve).parameters
    for name in ("rtol", "restart", "maxiter", "preconditioned"):
        assert ours[name].default == theirs[name].default, name


@pytest.mark.parametrize("kw,slice_", [(dict(precond="gs", cache_dir="x"), "slice 9"),
                                       (dict(precond="polarized_traces", cache_dir="x"),
                                        "slice 9"),
                                       (dict(cache_dir="x"), "slice 9")])
def test_unported_options_raise(tmp_path, kw, slice_):
    """``cache_dir`` (ROADMAP.md, Queue 1 slice 9), once unported, now
    checkpoints: a second build from the same directory loads the stencil
    fields and, for the slab preconditioners, the slab factorization, as the
    JAX package's ``bump3d`` does, and holds bit-identical tensors."""
    kw = {**kw, "cache_dir": str(tmp_path / kw["cache_dir"])}
    p1, p2 = (bump3d.build_problem(h=H, device="cpu", **kw) for _ in range(2))
    for a, b in ((p1.a_s, p2.a_s), (p1.ag_s, p2.ag_s)):
        assert torch.equal(a.values, b.values)
    kinds = sorted(name.split("_")[0] for name in os.listdir(kw["cache_dir"]))
    if "precond" not in kw:
        assert kinds == ["stencils"], slice_
        return
    assert kinds == ["slabfac3d", "stencils"], slice_
    assert p2.setup_seconds["factorization"] == 0.0 < p2.setup_seconds["checkpoint"]
    f1, f2 = p1.precond.slabs.fac, p2.precond.slabs.fac
    for f in dataclasses.fields(f1):
        assert torch.equal(getattr(f1, f.name), getattr(f2, f.name)), f.name


def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here; the rule is tested where it does not")
    with pytest.raises(RuntimeError, match="CUDA"):
        bump3d.build_problem(h=H)
    for function, args in (("lippmann_schwinger_3d", (np.ones((2, 2, 2), np.complex64),
                                                      np.ones(8), 1.0, 2, 2, 2, "greengard_vico")),
                           ("stencil_matrix_3d", (np.ones((2, 2, 2, 3, 3, 3), np.complex64),)),
                           ("sparsifying_preconditioner_3d", ({}, None))):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(convert, function)(*args)


GS = dict(precond="gs", n_subdomains=2, npml=5)


@pytest.fixture(scope="module")
def gs_full():
    """complex128, dense z-plane pivots: each package builds everything."""
    jp = jbump3d.build_problem(h=H, dtype=jnp.complex128, pivot_dtype="full", **GS)
    tp = bump3d.build_problem(h=H, dtype=torch.complex128, pivot_dtype="full", device="cpu",
                              **GS)
    return jp, tp


def test_gs_solve_matches(gs_full):
    """The sweep slice whole in complex128: the same iteration count and
    residual history as the JAX package (the annihilators' phases scale the
    rows of the slab matrices and of A alike, so the preconditioned operator
    is the same), histories to 1e-6 above a floor of 1e-12 of the first
    residual, and the setup phases recorded."""
    jp, tp = gs_full
    assert set(tp.setup_seconds) == {"symbol", "stencils", "slabs", "slab_fields",
                                     "factorization", "packing"}
    jx, jinfo = jbump3d.solve(jp, rtol=1e-8)
    tx, info = bump3d.solve(tp, rtol=1e-8)
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and 0 < n_it <= 25
    assert bool(info.converged) and bool(jinfo.converged)
    want = np.asarray(jinfo.residuals)[: n_it + 1]
    np.testing.assert_allclose(info.residuals.numpy()[: n_it + 1], want, rtol=1e-6,
                               atol=1e-12 * want[0])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-7 * np.abs(np.asarray(jx)).max())


def test_gs_int8_counts_match():
    """complex64 on the 96^3 path's mode (int8 y-planes through the plane
    kernels), each package building its own: the same count at rtol 1e-5
    (the float32 floor of ``ROADMAP.md`` Queue 3 keeps 1e-6 out of reach)."""
    jp = jbump3d.build_problem(h=H, dtype=jnp.complex64, pivot_dtype="yblock_int8_pallas", **GS)
    tp = bump3d.build_problem(h=H, dtype=torch.complex64, pivot_dtype="yblock_int8_pallas",
                              device="cpu", **GS)
    assert tp.precond.slabs.pfac.storage == "int8"
    _, jinfo = jbump3d.solve(jp, rtol=1e-5)
    _, info = bump3d.solve(tp, rtol=1e-5)
    assert int(info.n_iterations) == int(jinfo.n_iterations)
    assert bool(info.converged) and bool(jinfo.converged)


def test_rebuild_sweep_is_a_fresh_build(gs_full):
    """A sweep rebuilt on another pivot storage from the stencils the problem
    keeps (``a_s``, ``ag_s``), as ``chip_smoke.py`` does at 96^3, is the
    sweep that ``build_problem`` builds for that storage."""
    _, tp = gs_full
    X, Y, Z = tp.grid.mesh()
    seconds = {}
    slabs = subdomain3d.build_slab_system_3d(
        tp.a_s, tp.ag_s, media.gaussian_bump_3d(X, Y, Z), tp.grid.x, tp.grid.h, tp.k,
        GS["n_subdomains"], npml=GS["npml"], pivot_dtype="yblock", timings=seconds)
    assert set(seconds) == {"slab_fields", "factorization", "packing"}
    assert slabs.pivot_layout == "y" and tp.precond.slabs.pivot_layout == "z"
    pc = subdomain3d.SingleSweepPreconditioner3D(slabs=slabs, a_s=tp.a_s)
    fresh = bump3d.build_problem(h=H, dtype=torch.complex128, pivot_dtype="yblock",
                                 device="cpu", **GS)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(1000) + 0j)
    torch.testing.assert_close(pc.apply(b), fresh.precond.apply(b), rtol=0, atol=1e-12)
