"""The port's special functions (``ops/special.py``) and quadrature toolbox
(``solver/quadratures.py``) against the JAX package's and against SciPy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import quad as sciquad
from scipy.special import hankel1, j0 as sj0, y0 as sy0

from fast_solver_lippmann_schwinger_tpu.ops import special as jspecial
from fast_solver_lippmann_schwinger_tpu.solver import quadratures as jquad
from fast_solver_lippmann_schwinger_tpu_torch.native import sampler
from fast_solver_lippmann_schwinger_tpu_torch.ops import special
from fast_solver_lippmann_schwinger_tpu_torch.solver import quadratures as quad
from torch_threads import few_threads  # noqa: F401

X = np.concatenate([np.linspace(0.05, 11.9, 3000), np.linspace(12.0, 1200.0, 3000)])


def test_j0y0_accuracy():
    """Against SciPy (AMOS) to the JAX test's tolerance, and against the JAX
    package's identical series/asymptotic pair to rounding."""
    j, y = special.j0y0(torch.as_tensor(X))
    assert j.dtype == torch.float64
    np.testing.assert_allclose(j.numpy(), sj0(X), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(y.numpy(), sy0(X), rtol=1e-9, atol=1e-11)
    jj, jy = jspecial.j0y0(jnp.asarray(X))
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-13, atol=1e-15)


def test_hankel1_0():
    h = special.hankel1_0(torch.as_tensor(X))
    assert h.dtype == torch.complex128
    np.testing.assert_allclose(h.numpy(), hankel1(0, X), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(h.numpy(), np.asarray(jspecial.hankel1_0(jnp.asarray(X))),
                               rtol=1e-13, atol=1e-15)


def test_greens_kernel_matches_native_sampler():
    """The JAX test's case: the tensor kernel against the native sampler's
    table, and against the JAX package's device kernel."""
    rng = np.random.default_rng(0)
    r = rng.uniform(1.0 / 800.0, 1.4, 20000)
    k, h = 800.0, 1.0 / 800.0
    dev = special.greens_kernel_2d(k, torch.as_tensor(r), h).numpy()
    np.testing.assert_allclose(dev, sampler.hankel_kernel_table(k, r, h), rtol=1e-8, atol=1e-16)
    np.testing.assert_allclose(dev, np.asarray(jspecial.greens_kernel_2d(k, jnp.asarray(r), h)),
                               rtol=1e-13, atol=1e-20)


def test_helmholtz_gaussian_solution():
    r = np.linspace(0.05, 2.0, 200)
    got = special.helmholtz_gaussian_solution(r, 0.1, 12.0)
    np.testing.assert_array_equal(got, jspecial.helmholtz_gaussian_solution(r, 0.1, 12.0))
    # far from the source (r >> sigma) the erf tends to -1 and the field to
    # -exp(-sigma^2 k^2 / 2) exp(i k r) / (4 pi r)
    r_far, sigma, k = np.array([2.0, 3.5]), 0.05, 12.0
    point = -np.exp(-(sigma * k) ** 2 / 2) * np.exp(1j * k * r_far) / (4 * np.pi * r_far)
    np.testing.assert_allclose(special.helmholtz_gaussian_solution(r_far, sigma, k), point,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# quadratures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 8, 24])
def test_gauss_legendre(n):
    x, w = quad.gauss_legendre(n)
    lx, lw = np.polynomial.legendre.leggauss(n)
    np.testing.assert_allclose(x, lx, rtol=0, atol=1e-14)
    np.testing.assert_allclose(w, lw, rtol=1e-13, atol=1e-15)
    jx, jw = jquad.gauss_legendre(n, 0.0, 2.0)
    x2, w2 = quad.gauss_legendre(n, 0.0, 2.0)
    np.testing.assert_array_equal(x2, jx)
    np.testing.assert_array_equal(w2, jw)


def test_legendre_tables_match():
    x = np.linspace(-0.95, 0.95, 13)
    np.testing.assert_array_equal(quad.eval_legendre(9, x), jquad.eval_legendre(9, x))
    np.testing.assert_allclose(quad.eval_legendre(9, x).T,
                               [np.polynomial.legendre.Legendre.basis(j)(x) for j in range(9)],
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_array_equal(quad.legendre_q(6, 2.0), jquad.legendre_q(6, 2.0))
    np.testing.assert_allclose(quad.legendre_q(3, 2.0)[:2], [0.5 * np.log(3.0), np.log(3.0) - 1.0])
    np.testing.assert_array_equal(quad.r_j(6, 1.7), jquad.r_j(6, 1.7))
    np.testing.assert_array_equal(quad.eval_phi(5, 0.3, x, hyper=True),
                                  jquad.eval_phi(5, 0.3, x, hyper=True))


@pytest.mark.parametrize("name,kernel", [
    ("modified_weights_log", lambda t, y: 0.5 * np.log((y - t) ** 2)),
    ("modified_weights_pv", lambda t, y: 1.0 / (y - t)),
    ("modified_weights_hyper", None),
])
def test_modified_weights(name, kernel):
    """Each weight family equals the JAX package's; the log and PV weights
    integrate a smooth function against their kernel (checked by adaptive
    quadrature off the interval, as the JAX package's tests do; they check
    no hypersingular integral)."""
    y = 1.5
    x, w = quad.gauss_legendre(24)
    wmod = getattr(quad, name)(w, x, y)
    np.testing.assert_array_equal(wmod, getattr(jquad, name)(w, x, y))
    if kernel is not None:
        exact, _ = sciquad(lambda t: np.exp(t) * kernel(t, y), -1, 1)
        np.testing.assert_allclose(np.sum(wmod * np.exp(x)), exact, rtol=1e-8)


def test_compute_weights_and_moments():
    y, m = 1.3, 12
    x, w = quad.gauss_legendre(m)
    wmod = quad.compute_weights(m, x, w, y)
    np.testing.assert_allclose(wmod, jquad.compute_weights(m, x, w, y), rtol=1e-12, atol=1e-14)
    for kern in (lambda t: 1.0 + 0 * t, lambda t: np.log(np.abs(y - t)), lambda t: 1.0 / (y - t)):
        exact, _ = sciquad(lambda t: np.exp(t) * kern(t), -1, 1)
        np.testing.assert_allclose(np.sum(wmod * np.exp(x) * kern(x)), exact, rtol=1e-6)
    np.testing.assert_array_equal(quad.eval_generalized_moments(m, y, x, w),
                                  jquad.eval_generalized_moments(m, y, x, w))


def test_legendre_interp_matrix():
    x, w = quad.gauss_legendre(16)
    s = np.linspace(-0.9, 0.9, 11)
    mat = quad.legendre_interp_matrix(s, x, w)
    np.testing.assert_array_equal(mat, jquad.legendre_interp_matrix(s, x, w))
    f = lambda t: np.sin(3 * t) + t ** 2  # noqa: E731
    np.testing.assert_allclose(mat @ f(x), f(s), atol=1e-9)
