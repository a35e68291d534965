"""The port's six example scripts (``fast_solver_lippmann_schwinger_tpu_torch/
examples/``) run through ``main(argv)`` on the CPU in complex128 at a small
size, their iteration counts held to the JAX package's model functions at
the same size: ``example2d`` (bump2d at h = 0.05, with and without the
preconditioner), ``example3d`` (bump3d at n = 8), ``example_plasma2d`` and
``example_plasma_integral2d`` (h = 0.05, 2 slabs, npml 5, both directions,
against the JAX joint solve's count of each),
``example_multisource2d`` (two directions in one batch; and with ``--mesh 2
--rhs-block 2`` on two gloo ranks, the pipelined sharded double sweep), and
``example_inverse2d --steps 3``, whose losses are held to the JAX script's
loop (``optax.adam`` over ``jax.value_and_grad``) to 1e-8.

JAX is imported inside the tests only: the ranks import this module.
"""

import numpy as np
import pytest

from fast_solver_lippmann_schwinger_tpu_torch.examples import (
    example2d,
    example3d,
    example_inverse2d,
    example_multisource2d,
    example_plasma2d,
    example_plasma_integral2d,
)
from torch_dist import run_ranks, same_on_every_rank
from torch_threads import few_threads  # noqa: F401

COMMON = ["--cpu", "--x64", "--save-field", ""]
H, SUBS, NPML = 0.05, 2, 5
SLABS = ["--h", str(H), "--subs", str(SUBS), "--npml", str(NPML)]
DIRECTIONS = [(1.0, 0.0), (0.0, 1.0)]
MULTISOURCE = SLABS + ["--n-dirs", "2"]


def _count(info):
    return np.asarray(info.n_iterations).tolist()


def test_example2d():
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.models import bump2d

    got = example2d.main(["--h", str(H)] + COMMON)
    problem = bump2d.build_problem(h=H, dtype=jnp.complex128)
    assert got["iterations"] == _count(bump2d.solve(problem)[1])
    assert got["iterations_unpreconditioned"] == _count(
        bump2d.solve(problem, preconditioned=False, maxiter=400)[1])


def test_example3d():
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.models import bump3d

    got = example3d.main(["--n", "8"] + COMMON)
    problem = bump3d.build_problem(h=1.0 / 8, dtype=jnp.complex128)
    assert got["iterations"] == _count(bump3d.solve(problem, rtol=1e-8, maxiter=100)[1])


@pytest.mark.parametrize("example", ["plasma2d", "plasma_integral2d"])
def test_plasma_examples(example):
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.models import plasma2d, plasma_integral2d

    if example == "plasma2d":
        got = example_plasma2d.main(SLABS + COMMON)
        problem = plasma2d.build_problem(h=H, n_subdomains=SUBS, npml=NPML,
                                         dtype=jnp.complex128)
        solve_batched = plasma2d.solve_batched
    else:
        got = example_plasma_integral2d.main(SLABS + COMMON)
        problem = plasma_integral2d.build_problem(h=H, n_subdomains=SUBS, npml=NPML,
                                                  dtype=jnp.complex128)
        solve_batched = plasma_integral2d.solve_batched
    # the JAX joint solve's count of each direction (its Arnoldi runs per
    # direction, as a single solve's does): one compile instead of two
    want = _count(solve_batched(problem, DIRECTIONS)[1])
    assert [got[d]["iterations"] for d in DIRECTIONS] == want


def rank_multisource(mesh, argv):
    return example_multisource2d.main(argv)


@pytest.fixture(scope="module")
def multisource_jax():
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.models import plasma2d

    dirs = np.stack([np.cos(2 * np.pi * np.arange(2) / 2), np.sin(2 * np.pi * np.arange(2) / 2)],
                    axis=1)
    problem = plasma2d.build_problem(h=H, n_subdomains=SUBS, npml=NPML, dtype=jnp.complex128,
                                     double_sweep=True)
    return _count(plasma2d.solve_batched(problem, incident_directions=dirs, rtol=1e-6,
                                         maxiter=60)[1])


@pytest.mark.parametrize("mesh", [0, 2])
def test_example_multisource2d(multisource_jax, tmp_path, mesh):
    """One device, and the pipelined sharded double sweep on 2 ranks (every
    rank reporting the same)."""
    if mesh == 0:
        got = example_multisource2d.main(MULTISOURCE + COMMON)
        assert got["mode"] == "one-device joint batch"
    else:
        argv = MULTISOURCE + ["--mesh", "2", "--rhs-block", "2"] + COMMON
        got = same_on_every_rank(run_ranks(2, __name__, "rank_multisource", argv, tmp_path))
        assert got["mode"] == "2-device pipelined sweep, rhs_block=2"
    assert got["iterations"] == multisource_jax


def test_example_inverse2d():
    """The first three losses of the Adam loop against the JAX script's own
    loop (its forward, loss and ``optax.adam(lr)``), in complex128."""
    import jax
    import jax.numpy as jnp
    import optax

    from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D
    from fast_solver_lippmann_schwinger_tpu.models import media
    from fast_solver_lippmann_schwinger_tpu.ops.fastconv import build_fast_convolution_2d
    from fast_solver_lippmann_schwinger_tpu.solver.adjoint import differentiable_solve

    got = example_inverse2d.main(["--steps", "3"] + COMMON)

    h, k, lr = 0.04, 10.0, 3e-2
    grid = Grid2D(a=1.0, h=h)
    X, Y = grid.mesh()
    nu_true = media.gaussian_bump_2d(X, Y)
    op = build_fast_convolution_2d(grid.x, grid.y, grid.h, k, nu_true,
                                   quad_rule="trapezoidal", dtype=jnp.complex128)
    dirs = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    phases = dirs[:, 0:1] * X.ravel()[None] + dirs[:, 1:2] * Y.ravel()[None]
    u_inc = jnp.asarray(np.exp(1j * k * phases), dtype=jnp.complex128)

    def forward(nu_arr, ui):
        op2 = op.replace(nu=nu_arr)
        rhs = -(op2.apply(ui) - ui)
        return differentiable_solve(op2, rhs, rtol=1e-8, restart=30, maxiter=120)

    data = jax.jit(jax.vmap(lambda ui: forward(op.nu, ui)))(u_inc)

    def loss(nu_arr):
        u = jax.vmap(lambda ui: forward(nu_arr, ui))(u_inc)
        return jnp.sum(jnp.abs(u - data) ** 2) / jnp.sum(jnp.abs(data) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    opt = optax.adam(lr)
    nu = jnp.zeros_like(op.nu)
    state = opt.init(nu)
    want = []
    for _ in range(3):
        val, g = value_and_grad(nu)
        updates, state = opt.update(g, state)
        nu = optax.apply_updates(nu, updates)
        want.append(float(val))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-8, atol=0)
    np.testing.assert_allclose(got["nu"].numpy(), np.asarray(nu), rtol=0, atol=1e-8)
