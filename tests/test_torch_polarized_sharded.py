"""The port's sharded polarized-traces preconditioners (``parallel/
polarized.py``, ``parallel/polarized3d.py``) on 2 and 4 gloo ranks against
the JAX package's single-device ``PolarizedTracesPreconditioner.apply_batch``
and ``PolarizedTracesPreconditioner3D.apply_batch``, on the setups of
``tests/test_polarized_sharded.py`` (h = 1/48, Gaussian bump, 4 slabs, npml
6) and ``tests/test_polarized3d_sharded.py`` (NN = 17, K = 8, 4 slabs, npml
5), complex128, nIt = 2, two random right-hand sides (seed 0), to the JAX
tests' 1e-10.  The 2D trace-path solve with the sharded preconditioner on 4
ranks is held to the same solve on one device, as the JAX test holds its
own (iteration counts equal, solutions to 1e-8, residual histories to
1e-6); the one-device solve here is the port's (``ddm.polarized``, held to
the JAX package in ``test_torch_polarized.py``), since compiling the JAX
package's whole trace-path solve on this CPU takes minutes.

JAX slab systems are carried across with ``convert``; one spawn per world
size; every rank must return the same bits.  JAX is imported inside the
fixtures only: the ranks import this module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu_torch.parallel import polarized as ppol
from fast_solver_lippmann_schwinger_tpu_torch.parallel import polarized3d as ppol3
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres_batched
from torch_dist import run_ranks, same_on_every_rank, slab_fields, slab_fields_3d
from torch_threads import few_threads  # noqa: F401

H2, NN, K3 = 1.0 / 48.0, 17, 8.0
SOLVE = dict(rtol=1e-8, restart=20, maxiter=30)


def rank_cases(mesh, inp):
    out = {}
    pc = ppol.make_sharded_polarized_preconditioner(inp["slabs"], inp["a_s"], mesh, n_it=2)
    out["apply2d"] = pc(inp["B2"])
    pc3 = ppol3.make_sharded_polarized_preconditioner_3d(inp["slabs3"], inp["a3"], mesh, n_it=2)
    out["apply3d"] = pc3(inp["B3"])
    if "op" in inp:
        op, u_inc = inp["op"], inp["u_inc"]
        x, info = gmres_batched(op.apply, -(op.apply(u_inc) - u_inc), preconditioner=pc, **SOLVE)
        out.update(solve_x=x, solve_iterations=info.n_iterations.tolist(),
                   solve_residuals=info.residuals)
    for name, call in inp.get("refusals", {}).items():
        try:
            call[0](call[1], inp["a_s"], mesh)
            out[f"refused_{name}"] = ""
        except ValueError as e:
            out[f"refused_{name}"] = str(e)
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D
    from fast_solver_lippmann_schwinger_tpu.ddm import subdomain as jsub
    from fast_solver_lippmann_schwinger_tpu.ddm import subdomain3d as jsd
    from fast_solver_lippmann_schwinger_tpu.ddm.polarized import PolarizedTracesPreconditioner
    from fast_solver_lippmann_schwinger_tpu.ddm.polarized3d import (
        PolarizedTracesPreconditioner3D,
    )
    from fast_solver_lippmann_schwinger_tpu.models import media
    from fast_solver_lippmann_schwinger_tpu.ops.fastconv import (
        build_fast_convolution_2d,
        build_fast_convolution_3d,
    )
    from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
    from fast_solver_lippmann_schwinger_tpu.sparse import pallas_thomas as pt
    from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
    from fast_solver_lippmann_schwinger_tpu_torch import convert
    from fast_solver_lippmann_schwinger_tpu_torch.ddm import polarized as tpolarized

    grid = Grid2D(a=1.0, h=H2)
    k = 1.0 / H2
    X, Y = grid.mesh()
    nu = media.gaussian_bump_2d(X, Y)
    a, ag = jstencils.build_sparse_a_ag_2d(k, grid.x, grid.y, H2, dtype=jnp.complex128)
    js = jsub.build_slab_system(a, ag, nu, grid.x, grid.y, H2, k, 4, npml=6)
    rng = np.random.default_rng(0)
    B2 = rng.standard_normal((2, grid.size)) + 1j * rng.standard_normal((2, grid.size))
    pc = PolarizedTracesPreconditioner(slabs=js, a_s=a, n_it=2)
    want2 = np.asarray(jax.jit(pc.apply_batch)(jnp.asarray(B2)))

    op = build_fast_convolution_2d(grid.x, grid.y, H2, k, nu, quad_rule="greengard_vico",
                                   dtype=jnp.complex128)
    dirs = np.array([(1.0, 0.0), (0.0, 1.0)])
    u_inc = np.exp(1j * k * (dirs[:, 0:1] * X.ravel()[None] + dirs[:, 1:2] * Y.ravel()[None]))

    h = 1.0 / (NN - 1)
    x = np.linspace(0.0, 1.0, NN)
    Z3, Y3, X3 = np.meshgrid(x, x, x, indexing="ij")
    nu3 = media.gaussian_bump_3d(X3, Y3, Z3)
    op3 = build_fast_convolution_3d(x, x, x, h, K3, nu3, dtype=jnp.complex128)
    a3, ag3 = jstencils.build_sparse_a_ag_3d(K3, op3, dtype=jnp.complex128)
    js3 = jsd.build_slab_system_3d(a3, ag3, nu3, x, h, K3, n_subs=4, npml=5)
    rng = np.random.default_rng(0)
    B3 = rng.standard_normal((2, NN ** 3)) + 1j * rng.standard_normal((2, NN ** 3))
    pc3 = PolarizedTracesPreconditioner3D(slabs=js3, a_s=a3, n_it=2)
    want3 = np.asarray(jax.jit(pc3.apply_batch)(jnp.asarray(B3)))

    jko = js.replace(
        pfac=pt.build_pallas_factorization(js.fac),
        fac=jdirect.BlockTridiagFactorization(
            cinv=jnp.zeros(js.fac.cinv.shape[:2] + (0, 0), js.fac.cinv.dtype),
            lband=js.fac.lband, uband=js.fac.uband))
    slabs = convert.slab_system(slab_fields(js), device="cpu")
    port = dict(
        slabs=slabs,
        a_s=convert.stencil_matrix_2d(np.asarray(a.values), device="cpu"),
        slabs3=convert.slab_system_3d(slab_fields_3d(js3), device="cpu"),
        a3=convert.stencil_matrix_3d(np.asarray(a3.values), device="cpu"),
        op=convert.lippmann_schwinger_2d(np.asarray(op.symbol), np.asarray(op.nu), op.omega,
                                         op.n, op.m, "greengard_vico", device="cpu"),
        kernel_only=convert.slab_system(slab_fields(jko), device="cpu"),
        # bottom trace lines moved onto the top ones: what slabs shorter than
        # about 2 npml make
        thin=dataclasses.replace(slabs, ln=slabs.l1.clone()),
    )
    one = tpolarized.PolarizedTracesPreconditioner(slabs=slabs, a_s=port["a_s"], n_it=2)
    tu = torch.as_tensor(u_inc)
    x_ref, info_ref = gmres_batched(port["op"].apply, -(port["op"].apply(tu) - tu),
                                    preconditioner=one.apply_batch, **SOLVE)
    return dict(B2=B2, want2=want2, B3=B3, want3=want3, u_inc=u_inc, x_ref=x_ref.numpy(),
                it_ref=info_ref.n_iterations.tolist(), res_ref=info_ref.residuals.numpy(),
                port=port)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    done = {}

    def get(D):
        if D not in done:
            p = setup["port"]
            inp = dict(slabs=p["slabs"], a_s=p["a_s"], slabs3=p["slabs3"], a3=p["a3"],
                       B2=torch.as_tensor(setup["B2"]), B3=torch.as_tensor(setup["B3"]))
            if D == 4:
                inp.update(op=p["op"], u_inc=torch.as_tensor(setup["u_inc"]))
            else:
                make = ppol.make_sharded_polarized_preconditioner
                inp["refusals"] = {"kernel_only": (make, p["kernel_only"]),
                                   "thin": (make, p["thin"])}
            done[D] = same_on_every_rank(run_ranks(
                D, __name__, "rank_cases", inp, tmp_path_factory.mktemp(f"polarized_d{D}")))
        return done[D]

    return get


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_polarized_matches_single(setup, ranks, D):
    np.testing.assert_allclose(np.asarray(ranks(D)["apply2d"]), setup["want2"], rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_polarized3d_matches_single(setup, ranks, D):
    np.testing.assert_allclose(np.asarray(ranks(D)["apply3d"]), setup["want3"], rtol=0,
                               atol=1e-10)


def test_sharded_polarized_full_solve(setup, ranks):
    """The trace-path solve on 4 ranks: the one-device solve's iteration
    counts, solutions to 1e-8, residual histories to 1e-6."""
    got = ranks(4)
    assert got["solve_iterations"] == setup["it_ref"]
    np.testing.assert_allclose(np.asarray(got["solve_x"]), setup["x_ref"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(got["solve_residuals"]), setup["res_ref"], rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("what", ["kernel_only", "thin"])
def test_sharded_polarized_refusals(ranks, what):
    """The kernel layout alone and slabs whose trace lines collide are
    refused (the JAX maker asserts both)."""
    message = ranks(2)[f"refused_{what}"]
    assert ("pivot_dtype='pallas'" if what == "kernel_only" else "degenerate") in message
