"""The port's slab systems and one-slab sweeps against the JAX package (the
multi-slab sweeps are in ``test_torch_multislab_sweeps.py``).

Both sides are fed the SAME annihilator fields (carried over from the JAX
package), so no SVD gauge enters the comparison.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.ddm import subdomain as jsub
from fast_solver_lippmann_schwinger_tpu.ddm import sweeps as jsweeps
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain, sweeps
from fast_solver_lippmann_schwinger_tpu_torch.models import media
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

H, NPML = 1.0 / 30.0, 6
HOST_FIELDS = ("l0", "l1", "ln", "lnp", "has_top", "has_bot", "src_line",
               "src_valid", "owner", "owner_line")
BAND_FIELDS = ("cpl_01", "cpl_10", "cpl_n_np", "cpl_np_n")


@pytest.fixture(scope="module")
def setup():
    grid = Grid2D(a=1.0, h=H)
    k = 1.0 / H
    X, Y = grid.mesh()
    nu = media.plasma_2d(X, Y)
    ja, jag, a_np, ag_np = jstencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, H, dtype=jnp.complex128, return_host=True
    )
    ta, tag = convert.stencil_matrix_2d(a_np, device="cpu"), convert.stencil_matrix_2d(ag_np, device="cpu")
    return grid, k, nu, (ja, jag, a_np, ag_np), (ta, tag)


def _build_both(setup, n_subs, pivot_dtype="full", cdtype=(jnp.complex128, torch.complex128)):
    grid, k, nu, (ja, jag, a_np, ag_np), (ta, tag) = setup
    if cdtype[0] == jnp.complex64:
        ja = ja.replace(values=ja.values.astype(jnp.complex64))
        jag = jag.replace(values=jag.values.astype(jnp.complex64))
        ta = dataclasses.replace(ta, values=ta.values.to(torch.complex64))
        tag = dataclasses.replace(tag, values=tag.values.to(torch.complex64))
    js = jsub.build_slab_system(ja, jag, nu, grid.x, grid.y, H, k, n_subs, npml=NPML,
                                a_host=a_np, ag_host=ag_np, pivot_dtype=pivot_dtype)
    ts = subdomain.build_slab_system(ta, tag, nu, grid.x, grid.y, H, k, n_subs, npml=NPML,
                                     a_host=a_np, ag_host=ag_np, pivot_dtype=pivot_dtype)
    return js, ts, ta


@pytest.mark.parametrize("n_subs", [1, 2])
def test_subdomain_limits_match(n_subs):
    a, b = subdomain.subdomain_limits(31, n_subs), jsub.subdomain_limits(31, n_subs)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("is_bottom,is_top", [(True, True), (True, False), (False, True), (False, False)])
def test_absorbing_nu_matches(is_bottom, is_top):
    rng = np.random.default_rng(0)
    y1 = np.linspace(-0.3, 0.3, 25)
    nu = rng.standard_normal((25, 9))
    args = (nu, y1, y1[1] - y1[0], 30.0, NPML, is_bottom, is_top)
    np.testing.assert_array_equal(subdomain.absorbing_nu(*args), jsub.absorbing_nu(*args))


@pytest.mark.parametrize("n_subs", [1, 2])
def test_slab_system_host_fields_match(setup, n_subs):
    js, ts, _ = _build_both(setup, n_subs)
    assert (ts.n, ts.m, ts.n_subs, ts.m1_max) == (js.n, js.m, js.n_subs, js.m1_max)
    assert (ts.trace_tail, ts.trace_head) == (js.trace_tail, js.trace_head)
    np.testing.assert_allclose(ts.h_stencils.numpy(), np.asarray(js.h_stencils), rtol=1e-14)
    for name in HOST_FIELDS + BAND_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)
    want = np.asarray(js.fac.cinv)
    np.testing.assert_allclose(ts.fac.cinv.numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max())
    assert ts.pfac is None


def test_npml_guard_and_unported_modes(setup, tmp_path):
    grid, k, nu, (_, _, a_np, ag_np), (ta, tag) = setup
    with pytest.raises(ValueError, match="npml"):
        subdomain.build_slab_system(ta, tag, nu, grid.x, grid.y, H, k, 1, npml=4)
    # the banded modes, once unported, build; pivot_rank belongs to banded_lr
    # and is ignored by the other modes, as in the JAX package
    for kw, kind in ((dict(pivot_dtype="banded"), direct.BlockTridiagFactorizationBanded),
                     (dict(pivot_rank=24), direct.BlockTridiagFactorization),
                     (dict(pivot_dtype="banded_lr", pivot_rank=4),
                      direct.BlockTridiagFactorizationBandedLR)):
        slabs = subdomain.build_slab_system(ta, tag, nu, grid.x, grid.y, H, k, 1, npml=NPML, **kw)
        assert isinstance(slabs.fac, kind) and slabs.pfac is None
    assert slabs.fac.u_re.shape[-1] == 4
    # cache_dir, once unported, checkpoints the factorization: a second build
    # loads it bit-identically
    facs = [subdomain.build_slab_system(ta, tag, nu, grid.x, grid.y, H, k, 1, npml=NPML,
                                        cache_dir=str(tmp_path)).fac for _ in range(2)]
    for f in dataclasses.fields(facs[0]):
        assert torch.equal(getattr(facs[0], f.name), getattr(facs[1], f.name))


@pytest.mark.parametrize("n_subs", [1, 2])
@pytest.mark.parametrize("r", [None, 2])
def test_partition_and_gather_match(setup, n_subs, r):
    js, ts, _ = _build_both(setup, n_subs)
    rng = np.random.default_rng(1)
    shape = (ts.m * ts.n,) if r is None else (ts.m * ts.n, r)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    jp = jsub.partition_source(js, jnp.asarray(b))
    tp = subdomain.partition_source(ts, torch.as_tensor(b))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(subdomain.gather_interior(ts, tp).numpy(),
                                  np.asarray(jsub.gather_interior(js, jp)))
    # interior lines partition the grid: gather undoes partition
    np.testing.assert_array_equal(subdomain.gather_interior(ts, tp).numpy(), b)


def test_carried_over_slab_system_matches_built(setup):
    js, ts, _ = _build_both(setup, 2)
    names = [f.name for f in dataclasses.fields(subdomain.SlabSystem) if f.name not in ("fac", "pfac")]
    fields = {name: np.asarray(getattr(js, name)) for name in names}
    fac = convert.block_tridiag_factorization(
        np.asarray(js.fac.cinv), np.asarray(js.fac.lband), np.asarray(js.fac.uband),
        device="cpu",
    )
    cs = convert.slab_system(fields, fac, device="cpu")
    for name in names:
        a, b = getattr(cs, name), getattr(ts, name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14, err_msg=name)
        else:
            assert a == b, name


def _sweep_case(setup, mode):
    if mode == "full":
        js, ts, ta = _build_both(setup, 1, "full")
        return js, ts, ta, np.complex128, 1e-9
    # bf16 planes from two complex64 factorizations: the planes differ where
    # a rounding flips, so agreement is at bf16 level, not f32
    js, ts, ta = _build_both(setup, 1, "pallas", (jnp.complex64, torch.complex64))
    return js, ts, ta, np.complex64, 2e-2


@pytest.mark.parametrize("mode", ["full", "pallas"])
@pytest.mark.parametrize("r", [None, 2])
def test_gs_sweep_one_slab_matches(setup, mode, r):
    js, ts, _, cdt, tol = _sweep_case(setup, mode)
    assert (ts.pfac is not None) == (mode == "pallas")
    rng = np.random.default_rng(2)
    shape = (ts.m * ts.n,) if r is None else (ts.m * ts.n, r)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(cdt)
    want = np.asarray(jsweeps.gs_sweep(js, jnp.asarray(b)))
    got = sweeps.gs_sweep(ts, torch.as_tensor(b))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(sweeps.GSPreconditioner(ts).apply(torch.as_tensor(b)).numpy(), got.numpy())


def test_gs_sweep_on_carried_over_planes_matches_interpret_kernels(setup):
    """Same bf16 planes on both sides: the one-slab sweep agrees to f32
    summation order (1e-4 of the max-norm)."""
    js, ts, _, cdt, _ = _sweep_case(setup, "pallas")
    p = js.pfac
    pf = convert.thomas_factorization(
        np.asarray(p.cinv_t_re).view(np.uint16), np.asarray(p.cinv_t_im).view(np.uint16),
        np.asarray(p.lband), np.asarray(p.uband), np.asarray(p.scale), p.n, device="cpu",
    )
    ts = dataclasses.replace(ts, pfac=pf)
    rng = np.random.default_rng(3)
    b = (rng.standard_normal(ts.m * ts.n) + 1j * rng.standard_normal(ts.m * ts.n)).astype(cdt)
    want = np.asarray(jsweeps.gs_sweep(js, jnp.asarray(b)))
    got = sweeps.gs_sweep(ts, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["full", "pallas"])
def test_single_sweep_preconditioner_matches(setup, mode):
    js, ts, ta, cdt, tol = _sweep_case(setup, mode)
    ja = setup[3][0]
    if mode == "pallas":
        ja = ja.replace(values=ja.values.astype(jnp.complex64))
    jpc = jsweeps.SingleSweepPreconditioner(slabs=js, a_s=ja)
    tpc = sweeps.SingleSweepPreconditioner(slabs=ts, a_s=ta)
    rng = np.random.default_rng(4)
    B = (rng.standard_normal((2, ts.m * ts.n)) + 1j * rng.standard_normal((2, ts.m * ts.n))).astype(cdt)
    want = np.asarray(jpc.apply(jnp.asarray(B[0])))
    got = tpc.apply(torch.as_tensor(B[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    want_b = np.asarray(jpc.apply_batch(jnp.asarray(B)))
    got_b = tpc.apply_batch(torch.as_tensor(B))
    assert tuple(got_b.shape) == (2, ts.m * ts.n)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=tol * np.abs(want_b).max())
    # the joint apply equals the row-by-row apply
    np.testing.assert_allclose(got_b[0].numpy(), got, rtol=0, atol=1e-5 * np.abs(got).max())


def test_attach_pallas_and_multi_slab_sweep_raises(setup, monkeypatch):
    """The kernel layouts a slab system takes: ``gs_sweep`` on the banded+tail
    layout takes the fused route (the sweeps themselves are held against the
    JAX package in ``test_torch_multislab_sweeps.py`` and
    ``test_torch_banded_tail.py``), and ``attach_pallas`` keeps or drops the
    dense pivots."""
    _, ts, _ = _build_both(setup, 2)
    banded = subdomain.attach_banded_tail(ts, pivot_band=9)
    assert isinstance(banded.pfac, tk.BandedTailFactorization) and banded.pfac.width == 9
    assert tuple(banded.fac.cinv.shape) == (2, ts.m1_max, 0, 0)
    assert 0 < banded.trace_tail < banded.m1_max
    calls = []
    monkeypatch.setattr(sweeps, "_gs_sweep_fused",
                        lambda slabs, b: calls.append(slabs) or b)
    b = torch.zeros(ts.m * ts.n, dtype=torch.complex128)
    assert sweeps.gs_sweep(banded, b) is b and calls == [banded]
    sweeps.gs_sweep(ts, b)          # the dense layout keeps the per-slab route
    assert calls == [banded]
    kept = subdomain.attach_pallas(ts)
    assert isinstance(kept.pfac, tk.ThomasFactorization) and kept.fac.cinv.shape[-1] == ts.n
    assert kept.pfac.n_slabs == 2 and kept.pfac.m == ts.m1_max
    dropped = subdomain.attach_pallas(ts, keep_dense=False)
    assert tuple(dropped.fac.cinv.shape) == (2, ts.m1_max, 0, 0)
    assert torch.equal(dropped.fac.lband, ts.fac.lband)
