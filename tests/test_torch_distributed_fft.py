"""The port's distributed FFT operators (``parallel/fft.py``) on 2 and 4 gloo
ranks against the JAX package's single-device operators, on the setups of
``tests/test_distributed_fft.py`` and ``tests/test_composed_distributed.py``:
the 2D Greengard-Vico operator at h = 1/40 (against ``pad_to_friendly=False``,
the reference-exact path) and the trapezoidal one at h = 1/32, to 1e-11; the
3D operator at n = 14, k = 10, to 1e-10; ``apply_batch`` at h = 1/36 against
single applies, to 1e-11.  Same seeds as the JAX tests, complex128.  One
spawn per world size; every rank must return the same bits.  JAX is imported
inside the fixtures only: the ranks import this module.
"""

import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu_torch.parallel import fft as pfft
from torch_dist import run_ranks, same_on_every_rank
from torch_threads import few_threads  # noqa: F401

N3, K3 = 14, 10.0


def rank_cases(mesh, inp):
    out = {}
    for name, (grid, k, nu, quad, u) in inp["ops2d"].items():
        op = pfft.build_distributed_fast_convolution_2d(grid[0], grid[1], grid[2], k, nu, mesh,
                                                        quad_rule=quad, dtype=torch.complex128)
        out[name] = op.apply(u)
        if name == "batch":
            out["batch_apply_batch"] = op.apply_batch(inp["batch_b"])
            out["batch_single"] = torch.stack([op(b) for b in inp["batch_b"]])
            out["batch_convolve"] = op.convolve(u.reshape(-1))
    x, h, nu3, u3 = inp["op3d"]
    op3 = pfft.build_distributed_fast_convolution_3d(x, x, x, h, K3, nu3, mesh,
                                                     dtype=torch.complex128)
    out["op3d"] = op3.apply(u3)
    out["op3d_batch"] = op3.apply_batch(torch.stack([u3.reshape(-1), 2j * u3.reshape(-1)]))
    return out


@pytest.fixture(scope="module")
def setup():
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D
    from fast_solver_lippmann_schwinger_tpu.models import media
    from fast_solver_lippmann_schwinger_tpu.ops.fastconv import (
        build_fast_convolution_2d,
        build_fast_convolution_3d,
    )

    cases, want = {}, {}
    for name, h, quad, seed, friendly in (("gv", 1.0 / 40.0, "greengard_vico", 0, False),
                                          ("trapezoidal", 1.0 / 32.0, "trapezoidal", 1, True),
                                          ("batch", 1.0 / 36.0, "greengard_vico", 4, False)):
        grid = Grid2D(a=1.0, h=h)
        k = 1.0 / grid.h
        X, Y = grid.mesh()
        nu = media.gaussian_bump_2d(X, Y)
        op = build_fast_convolution_2d(grid.x, grid.y, grid.h, k, nu, quad_rule=quad,
                                       dtype=jnp.complex128, pad_to_friendly=friendly)
        rng = np.random.default_rng(seed)
        u = rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape)
        want[name] = np.asarray(op.apply(jnp.asarray(u).reshape(-1))).reshape(grid.shape)
        cases[name] = ((np.asarray(grid.x), np.asarray(grid.y), grid.h), k, nu, quad,
                       torch.as_tensor(u))
        if name == "batch":
            rng = np.random.default_rng(3)
            batch_b = rng.standard_normal((3, grid.size)) + 1j * rng.standard_normal((3, grid.size))
            want["batch_apply_batch"] = np.stack(
                [np.asarray(op.apply(jnp.asarray(b))) for b in batch_b])
            want["batch_convolve"] = np.asarray(op.convolve(jnp.asarray(u).reshape(-1)))

    h = 1.0 / (N3 - 1)
    x = np.linspace(0.0, 1.0, N3)

    def nu3(X, Y, Z):
        return media.gaussian_bump_3d(X, Y, Z)

    op3 = build_fast_convolution_3d(x, x, x, h, K3, nu3, dtype=jnp.complex128)
    rng = np.random.default_rng(2)
    u3 = rng.standard_normal((N3,) * 3) + 1j * rng.standard_normal((N3,) * 3)
    want["op3d"] = np.asarray(op3.apply(jnp.asarray(u3).reshape(-1))).reshape(u3.shape)
    want["op3d_batch"] = np.stack([np.asarray(op3.apply(jnp.asarray(v.reshape(-1))))
                                   for v in (u3, 2j * u3)])
    # the 3D medium on the (z, y, x) grid, as the builders evaluate it
    nu_grid = nu3(x[None, None, :], x[None, :, None], x[:, None, None])
    inputs = dict(ops2d=cases, op3d=(x, h, nu_grid, torch.as_tensor(u3)),
                  batch_b=torch.as_tensor(batch_b))
    return dict(inputs=inputs, want=want)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    done = {}

    def get(D):
        if D not in done:
            done[D] = same_on_every_rank(run_ranks(
                D, __name__, "rank_cases", setup["inputs"], tmp_path_factory.mktemp(f"fft_d{D}")))
        return done[D]

    return get


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["gv", "trapezoidal", "batch", "batch_apply_batch",
                                  "batch_convolve"])
def test_distributed_2d_matches_single_device(setup, ranks, case, D):
    np.testing.assert_allclose(np.asarray(ranks(D)[case]), setup["want"][case], rtol=1e-11,
                               atol=1e-11)


@pytest.mark.parametrize("D", [2, 4])
def test_apply_batch_matches_apply(ranks, D):
    got = ranks(D)
    np.testing.assert_allclose(np.asarray(got["batch_apply_batch"]),
                               np.asarray(got["batch_single"]), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["op3d", "op3d_batch"])
def test_distributed_3d_matches_single_device(setup, ranks, case, D):
    np.testing.assert_allclose(np.asarray(ranks(D)[case]), setup["want"][case], rtol=1e-10,
                               atol=1e-10)
