"""The port's multi-slab sweeps and composite preconditioners against the JAX
package, on slab systems CARRIED OVER from it (``convert.py``): both sides
hold the same pivots, so the comparison sees the sweep logic and the
summation order only.

``full``: dense complex128 pivots, 1e-10 of the max-norm.  ``pallas``: the
same bf16 planes in complex64 (the JAX side runs its Pallas kernels in
interpret mode, the port its plain versions), 1e-4 of the max-norm: f32
summation order through 2 S chained local solves.
"""

import dataclasses
import functools

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
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

H, NPML = 1.0 / 40.0, 6
MODES = {
    "full": (jnp.complex128, np.complex128, 1e-10),
    "pallas": (jnp.complex64, np.complex64, 1e-4),
}


def slab_fields(js) -> dict:
    """A JAX slab system as the dict of numpy arrays ``convert.slab_system``
    takes, factorization and kernel layout included."""
    names = [f.name for f in dataclasses.fields(subdomain.SlabSystem)
             if f.name not in ("fac", "pfac")]
    d = {name: np.asarray(getattr(js, name)) for name in names}
    d["fac"] = dict(cinv=np.asarray(js.fac.cinv), lband=np.asarray(js.fac.lband),
                    uband=np.asarray(js.fac.uband))
    p = js.pfac
    d["pfac"] = None if p is None else dict(
        cinv_t_re=np.asarray(p.cinv_t_re).view(np.uint16),
        cinv_t_im=np.asarray(p.cinv_t_im).view(np.uint16),
        lband=np.asarray(p.lband), uband=np.asarray(p.uband),
        scale=np.asarray(p.scale), n=p.n,
    )
    return d


@functools.lru_cache(maxsize=None)
def _stencils(mode):
    grid = Grid2D(a=1.0, h=H)
    k = 1.0 / H
    X, Y = grid.mesh()
    nu = media.plasma_2d(X, Y)
    ja, jag, a_np, ag_np = jstencils.build_sparse_a_ag_2d(
        k, grid.x, grid.y, H, dtype=MODES[mode][0], return_host=True
    )
    return grid, k, nu, ja, jag, a_np, ag_np


@functools.lru_cache(maxsize=None)
def _slabs(mode, n_subs, transposed=False):
    """(JAX slab system, the port's carried over from it)."""
    grid, k, nu, ja, jag, a_np, ag_np = _stencils(mode)
    if transposed:
        js = jsub.build_slab_system(
            ja.transpose(), jag.transpose(), nu.T, grid.y, grid.x, H, k, n_subs, npml=NPML,
            a_host=a_np.transpose(1, 0, 3, 2), ag_host=ag_np.transpose(1, 0, 3, 2),
            pivot_dtype=mode)
    else:
        js = jsub.build_slab_system(ja, jag, nu, grid.x, grid.y, H, k, n_subs, npml=NPML,
                                    a_host=a_np, ag_host=ag_np, pivot_dtype=mode)
    return js, convert.slab_system(slab_fields(js), device="cpu")


def _vector(seed, mode, size, r):
    rng = np.random.default_rng(seed)
    shape = (size,) if r is None else (size, r)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(MODES[mode][1])


def _close(got, want, mode, tol=None):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    tol = MODES[mode][2] if tol is None else tol
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_subs", [2, 3, 4])
def test_carried_over_multi_slab_system(mode, n_subs):
    js, ts = _slabs(mode, n_subs)
    assert ts.n_subs == n_subs and (ts.pfac is not None) == (mode == "pallas")
    assert 0 < ts.trace_tail < ts.m1_max
    host = ts.host
    for name in host._fields:
        assert list(getattr(host, name)) == np.asarray(getattr(js, name)).tolist(), name
    assert host.has_top == (False,) + (True,) * (n_subs - 1)
    assert host.has_bot == (True,) * (n_subs - 1) + (False,)
    if mode == "pallas":
        assert isinstance(ts.pfac, tk.ThomasFactorization)
        assert tuple(ts.fac.cinv.shape[-2:]) == (0, 0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_subs", [2, 3, 4])
@pytest.mark.parametrize("r", [None, 2])
def test_gs_sweep_matches(mode, n_subs, r):
    js, ts = _slabs(mode, n_subs)
    b = _vector(n_subs, mode, ts.m * ts.n, r)
    tb = torch.as_tensor(b)
    want = jsweeps.gs_sweep(js, jnp.asarray(b))
    got = sweeps.gs_sweep(ts, tb)
    _close(got, want, mode)
    assert np.array_equal(tb.numpy(), b)            # the source is not touched
    assert torch.equal(sweeps.GSPreconditioner(ts).apply(tb), got)


@pytest.mark.parametrize("mode,n_subs,r", [
    ("full", 2, None), ("full", 3, None), ("full", 4, None),
    ("full", 2, 2), ("full", 3, 2), ("full", 4, 2),
    # the JAX side's interpret-mode kernels make these the slow ones
    ("pallas", 2, None), ("pallas", 3, None), ("pallas", 4, None), ("pallas", 3, 2),
])
def test_jacobi_sweep_matches(mode, n_subs, r):
    js, ts = _slabs(mode, n_subs)
    b = _vector(10 + n_subs, mode, ts.m * ts.n, r)
    want = jsweeps.jacobi_sweep(js, jnp.asarray(b))
    _close(sweeps.jacobi_sweep(ts, torch.as_tensor(b)), want, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_gs_sweep_two_columns_equal_two_sweeps(mode):
    """The joint sweep over two right-hand sides against one sweep each."""
    _, ts = _slabs(mode, 3)
    b = torch.as_tensor(_vector(5, mode, ts.m * ts.n, 2))
    joint = sweeps.gs_sweep(ts, b)
    for c in range(2):
        single = sweeps.gs_sweep(ts, b[:, c].contiguous())
        np.testing.assert_allclose(joint[:, c].numpy(), single.numpy(), rtol=0,
                                   atol=MODES[mode][2] * float(single.abs().max()))


@functools.lru_cache(maxsize=None)
def _double_sweep(mode, n_subs=3):
    grid, k, nu, ja, jag, _, _ = _stencils(mode)
    js, _ = _slabs(mode, n_subs)
    jst, _ = _slabs(mode, n_subs, True)
    jmsp = jstencils.build_msp_2d(ja, jag, nu, k)
    jpc = jsweeps.DoubleSweepPreconditioner(slabs=js, slabs_t=jst, msp=jmsp, a_s=ja)
    tpc = convert.double_sweep_preconditioner(
        slab_fields(js), slab_fields(jst), np.asarray(jmsp.values), np.asarray(ja.values),
        device="cpu")
    return jpc, tpc


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("method,r", [("apply", None), ("apply", 2), ("apply_sparsified", None)])
def test_double_sweep_preconditioner_matches(mode, method, r):
    jpc, tpc = _double_sweep(mode)
    assert isinstance(tpc, sweeps.DoubleSweepPreconditioner)
    b = _vector(20, mode, tpc.msp.m * tpc.msp.n, r)
    want = getattr(jpc, method)(jnp.asarray(b))
    _close(getattr(tpc, method)(torch.as_tensor(b)), want, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_double_sweep_apply_batch_matches(mode):
    jpc, tpc = _double_sweep(mode)
    B = _vector(21, mode, tpc.msp.m * tpc.msp.n, 2).T.copy()          # (R, N)
    want = jpc.apply_batch(jnp.asarray(B))
    got = tpc.apply_batch(torch.as_tensor(B))
    _close(got, want, mode)
    _close(tpc(torch.as_tensor(B[0])), np.asarray(want)[0], mode)


def test_transpose_flat_matches():
    jpc, tpc = _double_sweep("full")
    v = _vector(22, "full", tpc.msp.m * tpc.msp.n, 2)
    for x in (v, v[:, 0].copy()):
        np.testing.assert_array_equal(tpc._transpose_flat(torch.as_tensor(x)).numpy(),
                                      np.asarray(jpc._transpose_flat(jnp.asarray(x))))


@pytest.mark.parametrize("sweep", ["gs", "double"])
def test_inner_gmres_preconditioner_matches(sweep):
    """Same inner GMRES iterate in complex128: 1e-8 of the max-norm."""
    jpc, tpc = _double_sweep("full")
    jsw, tsw = ((jsweeps.GSPreconditioner(jpc.slabs), sweeps.GSPreconditioner(tpc.slabs))
                if sweep == "gs" else (jpc, tpc))
    jin = jsweeps.InnerGMRESPreconditioner(msp=jpc.msp, a_s=jpc.a_s, sweep=jsw, max_iter=5, tol=1e-3)
    tin = sweeps.InnerGMRESPreconditioner(msp=tpc.msp, a_s=tpc.a_s, sweep=tsw, max_iter=5, tol=1e-3)
    b = _vector(23, "full", tpc.msp.m * tpc.msp.n, None)
    want = jin.apply(jnp.asarray(b))
    _close(tin(torch.as_tensor(b)), want, "full", tol=1e-8)


def test_sweep_is_a_good_approximate_inverse():
    """``Msp gs_sweep(b) ~ b`` on the port's own slab system (built, not
    carried over): the sweep is a preconditioner for the sparsified system."""
    grid, k, nu, ja, jag, a_np, ag_np = _stencils("full")
    ta = convert.stencil_matrix_2d(a_np, device="cpu")
    tag = convert.stencil_matrix_2d(ag_np, device="cpu")
    ts = subdomain.build_slab_system(ta, tag, nu, grid.x, grid.y, H, k, 3, npml=NPML,
                                     a_host=a_np, ag_host=ag_np)
    js, _ = _slabs("full", 3)
    b = _vector(24, "full", ts.m * ts.n, None)
    want = np.asarray(jsweeps.gs_sweep(js, jnp.asarray(b)))
    got = sweeps.gs_sweep(ts, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())
