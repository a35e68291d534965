"""The composed multi-device solves of ``tests/test_composed_distributed.py``
in the port: the distributed FFT operator (``DistributedLS2D.apply_batch``)
+ the pipelined sharded double sweep + ``gmres_batched`` (h = 1/36, Gaussian
bump, 8 slabs, npml 5, three directions, rtol 1e-10, restart 8, maxiter 8),
and its 3D counterpart (``DistributedLS3D.apply_batch`` + the pipelined
z-slab sweep preconditioner, rhs_block 2; NN = 17, K = 8, 2 slabs, two
directions), complex128, on gloo ranks.  Both are held to the JAX package's
own composed solve on a CPU mesh of the same size: the same iteration
counts, residual histories to 1e-6 (rtol), solutions to 1e-9.

The slab systems and stencils are carried across from the JAX package
(``convert``); each package builds its own operator.  One spawn per world
size; every rank must return the same bits.  JAX is imported inside the
fixtures only: the ranks import this module.
"""

import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu_torch.parallel import fft as pfft
from fast_solver_lippmann_schwinger_tpu_torch.parallel import sharded, sharded3d
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres_batched
from torch_dist import run_ranks, same_on_every_rank, slab_fields, slab_fields_3d
from torch_threads import few_threads  # noqa: F401

SOLVE = dict(rtol=1e-10, restart=8, maxiter=8)
NN, K3 = 17, 8.0
# world size of each composed solve, rhs_block: the JAX test's, and the 2D
# solve also on 2 ranks in blocks of 2
CASES = {"composed2d_d4": ("2d", 4, 1), "composed2d_d2": ("2d", 2, 2),
         "composed3d_d2": ("3d", 2, 2)}


def _solve(op, pc, u_inc):
    rhs = -(op.apply_batch(u_inc) - u_inc)
    x, info = gmres_batched(op.apply_batch, rhs, preconditioner=pc, **SOLVE)
    return dict(x=x, iterations=info.n_iterations.tolist(), residuals=info.residuals)


def rank_cases(mesh, inp):
    out = {}
    for name, (dim, block) in inp["cases"].items():
        p = inp[dim]
        if dim == "2d":
            op = pfft.build_distributed_fast_convolution_2d(*p["grid"], p["k"], p["nu"], mesh,
                                                            dtype=torch.complex128)
            pc = sharded.make_sharded_double_sweep_pipelined(
                p["slabs"], p["slabs_t"], p["msp"], p["a_s"], mesh, rhs_block=block)
        else:
            x, h = p["grid"]
            op = pfft.build_distributed_fast_convolution_3d(x, x, x, h, K3, p["nu"], mesh,
                                                            dtype=torch.complex128)
            pc = sharded3d.make_sharded_sweep_preconditioner_3d_pipelined(
                p["slabs"], p["a_s"], mesh, rhs_block=block)
        for key, value in _solve(op, pc, p["u_inc"]).items():
            out[f"{name}_{key}"] = value
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D
    from fast_solver_lippmann_schwinger_tpu.ddm.subdomain import build_slab_system
    from fast_solver_lippmann_schwinger_tpu.ddm.subdomain3d import build_slab_system_3d
    from fast_solver_lippmann_schwinger_tpu.models import media
    from fast_solver_lippmann_schwinger_tpu.ops.fastconv import build_fast_convolution_3d
    from fast_solver_lippmann_schwinger_tpu.parallel import fft as jfft
    from fast_solver_lippmann_schwinger_tpu.parallel import sharded as jsharded
    from fast_solver_lippmann_schwinger_tpu.parallel import sharded3d as jsharded3d
    from fast_solver_lippmann_schwinger_tpu.solver.gmres import gmres_batched as jgmres_batched
    from fast_solver_lippmann_schwinger_tpu.sparse import stencils
    from fast_solver_lippmann_schwinger_tpu_torch import convert

    def jax_solve(op, pc, mesh, u_inc):
        def run(b):
            rhs = -(op.apply_batch(b) - b)
            x, info = jgmres_batched(op.apply_batch, rhs, preconditioner=pc, **SOLVE)
            return x, info.residuals, info.n_iterations

        with mesh:
            x, res, its = jax.jit(run)(u_inc)
        return dict(x=np.asarray(x), residuals=np.asarray(res),
                    iterations=np.asarray(its).tolist())

    # ---- 2D: tests/test_composed_distributed.py::_setup ----
    mesh = Mesh(np.array(jax.devices()[:4]), ("slab",))
    grid = Grid2D(a=1.0, h=1.0 / 36.0)
    k = 1.0 / grid.h
    X, Y = grid.mesh()
    nu = media.gaussian_bump_2d(X, Y)
    a, ag = stencils.build_sparse_a_ag_2d(k, grid.x, grid.y, grid.h, dtype=jnp.complex128)
    msp = stencils.build_msp_2d(a, ag, nu, k)
    js = build_slab_system(a, ag, nu, grid.x, grid.y, grid.h, k, 8, npml=5)
    js_t = build_slab_system(a.transpose(), ag.transpose(), nu.T, grid.y, grid.x, grid.h, k,
                             8, npml=5)
    dirs = np.array([(1.0, 0.0), (0.0, 1.0), (0.6, 0.8)])
    u_inc = np.exp(1j * k * (dirs[:, 0:1] * X.ravel()[None] + dirs[:, 1:2] * Y.ravel()[None]))
    op = jfft.build_distributed_fast_convolution_2d(grid.x, grid.y, grid.h, k, nu, mesh,
                                                    dtype=jnp.complex128)
    pc = jsharded.make_sharded_double_sweep_pipelined(
        jsharded.shard_slab_system(js, mesh), jsharded.shard_slab_system(js_t, mesh), msp, a,
        mesh)
    ref2 = jax_solve(op, pc, mesh, jnp.asarray(u_inc))
    port2 = dict(
        grid=(np.asarray(grid.x), np.asarray(grid.y), grid.h), k=k, nu=nu,
        slabs=convert.slab_system(slab_fields(js), device="cpu"),
        slabs_t=convert.slab_system(slab_fields(js_t), device="cpu"),
        msp=convert.stencil_matrix_2d(np.asarray(msp.values), device="cpu"),
        a_s=convert.stencil_matrix_2d(np.asarray(a.values), device="cpu"),
        u_inc=torch.as_tensor(u_inc))

    # ---- 3D: test_composed_3d_solve_matches_single_device ----
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("slab",))
    h = 1.0 / (NN - 1)
    x = np.linspace(0.0, 1.0, NN)
    Z, Y3, X3 = np.meshgrid(x, x, x, indexing="ij")
    nu3 = media.gaussian_bump_3d(X3, Y3, Z)
    op_ref = build_fast_convolution_3d(x, x, x, h, K3, nu3, dtype=jnp.complex128)
    a3, ag3 = stencils.build_sparse_a_ag_3d(K3, op_ref, dtype=jnp.complex128)
    js3 = build_slab_system_3d(a3, ag3, nu3, x, h, K3, n_subs=2, npml=5, pivot_dtype="full")
    dirs3 = np.array([(1.0, 0.0, 0.0), (0.0, 0.6, 0.8)])
    u_inc3 = np.exp(1j * K3 * sum(dirs3[:, i:i + 1] * ax.ravel()[None]
                                  for i, ax in enumerate((X3, Y3, Z))))
    op3 = jfft.build_distributed_fast_convolution_3d(x, x, x, h, K3, nu3, mesh2,
                                                     dtype=jnp.complex128)
    pc3 = jsharded3d.make_sharded_sweep_preconditioner_3d_pipelined(
        jsharded.shard_slab_system(js3, mesh2), a3, mesh2, rhs_block=2)
    ref3 = jax_solve(op3, pc3, mesh2, jnp.asarray(u_inc3))
    port3 = dict(grid=(x, h), nu=nu3,
                 slabs=convert.slab_system_3d(slab_fields_3d(js3), device="cpu"),
                 a_s=convert.stencil_matrix_3d(np.asarray(a3.values), device="cpu"),
                 u_inc=torch.as_tensor(u_inc3))
    return dict(refs={"2d": ref2, "3d": ref3}, port={"2d": port2, "3d": port3})


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    done = {}

    def get(D):
        if D not in done:
            cases = {n: (dim, block) for n, (dim, d, block) in CASES.items() if d == D}
            inp = dict(setup["port"], cases=cases)
            done[D] = same_on_every_rank(run_ranks(
                D, __name__, "rank_cases", inp, tmp_path_factory.mktemp(f"composed_d{D}")))
        return done[D]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_composed_solve_matches_jax(setup, ranks, case):
    dim, D, _ = CASES[case]
    got, want = ranks(D), setup["refs"][dim]
    assert got[f"{case}_iterations"] == want["iterations"]
    np.testing.assert_allclose(np.asarray(got[f"{case}_residuals"]), want["residuals"],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got[f"{case}_x"]), want["x"], rtol=0, atol=1e-9)
