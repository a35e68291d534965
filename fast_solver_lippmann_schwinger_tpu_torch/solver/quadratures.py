"""Singular-quadrature toolbox (Gauss-Legendre + Kolm-Rokhlin weights).

Counterpart of the reference's ``src/quadratures.jl`` (dormant there: not on
the main solve path, but part of the capability surface): Gauss-Legendre
nodes/weights by Newton iteration on Legendre polynomials, modified weights
for integrating smooth functions against log / principal-value /
hypersingular kernels (P. Kolm & V. Rokhlin, "Numerical quadratures for
singular and hypersingular integrals", eqs. 71-73), and spectral Legendre
interpolation.  The reference's GSL dependency (``sf_legendre_Ql``,
``quadratures.jl:106``) is replaced by a plain three-term recurrence for the
Legendre function of the second kind.

Everything is setup-time host math (numpy float64).  The port's own copy of
the JAX package's ``solver/quadratures.py`` (which imports no JAX either).
"""

from __future__ import annotations

import numpy as np


def eval_legendre(m: int, x: np.ndarray) -> np.ndarray:
    """Vandermonde-style table ``P[i, j] = P_j(x_i)`` for j < m
    (reference ``evalLegendrePol``, ``quadratures.jl:44-56``)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((x.shape[0], m))
    out[:, 0] = 1.0
    if m > 1:
        out[:, 1] = x
    for j in range(1, m - 1):
        out[:, j + 1] = ((2 * j + 1) * x * out[:, j] - j * out[:, j - 1]) / (j + 1)
    return out


def gauss_legendre(n: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Legendre nodes and weights on [a, b] by Newton iteration
    (reference ``gaussLegendreQuad``, ``quadratures.jl:3-42``)."""
    i = np.arange(n)
    # Chebyshev-like initial guess
    y = np.cos((2 * i + 1) * np.pi / (2 * n))
    for _ in range(100):
        p = eval_legendre(n + 1, y)
        # derivative of P_n via the standard identity
        dp = n * (p[:, n - 1] - y * p[:, n]) / (1 - y ** 2)
        dy = p[:, n] / dp
        y = y - dy
        if np.max(np.abs(dy)) < 1e-15:
            break
    p = eval_legendre(n + 1, y)
    dp = n * (p[:, n - 1] - y * p[:, n]) / (1 - y ** 2)
    w = 2.0 / ((1 - y ** 2) * dp ** 2)
    x = 0.5 * (a * (1 - y) + b * (1 + y))
    return x[::-1].copy(), (0.5 * (b - a) * w)[::-1].copy()


def legendre_q(m: int, y: float) -> np.ndarray:
    """Legendre functions of the second kind ``Q_j(y)`` for j < m, |y| > 1.

    Three-term recurrence replacing GSL's ``sf_legendre_Ql``.
    """
    assert abs(y) > 1.0, "Q_j recurrence valid off the cut [-1, 1]"
    q = np.empty(m)
    q[0] = 0.5 * np.log((y + 1.0) / (y - 1.0))
    if m > 1:
        q[1] = y * q[0] - 1.0
    for j in range(1, m - 1):
        q[j + 1] = ((2 * j + 1) * y * q[j] - j * q[j - 1]) / (j + 1)
    return q


def r_j(m: int, y: float) -> np.ndarray:
    """``R_j(y) = Q_j(y) + (1/4) log((y-1)^2)`` (reference ``R_j``,
    ``quadratures.jl:183-186``) — finite continuation used by the log-kernel
    weights."""
    return legendre_q(m, y) + 0.25 * np.log((y - 1.0) ** 2)


def modified_weights_pv(w: np.ndarray, x: np.ndarray, y: float) -> np.ndarray:
    """Weights for ``pv ∫ f(x)/(y-x) dx`` (Kolm-Rokhlin eq. 71; reference
    ``modifiedGLWeights1``)."""
    n = len(x)
    p = eval_legendre(n, x)
    q = legendre_q(n, y)
    j = 2 * np.arange(n) + 1
    return w * (p @ (q * j))


def modified_weights_log(w: np.ndarray, x: np.ndarray, y: float) -> np.ndarray:
    """Weights for ``∫ f(x) (1/2) log((y-x)^2) dx`` (eq. 72; reference
    ``modifiedGLWeights2``)."""
    n = len(x)
    p = eval_legendre(n, x)
    r = r_j(n + 1, y)
    corr = (p[:, 0] - p[:, 1]) * r[0]
    for j in range(1, n - 1):
        corr = corr + (p[:, j - 1] - p[:, j + 1]) * r[j]
    corr = corr + p[:, n - 2] * r[n - 1] + p[:, n - 1] * r[n]
    return w * corr


def modified_weights_hyper(w: np.ndarray, x: np.ndarray, y: float) -> np.ndarray:
    """Weights for ``fp ∫ f(x)/(y-x)^2 dx`` (eq. 73; reference
    ``modifiedGLWeights3``)."""
    n = len(x)
    p = eval_legendre(n, x)
    signs = (-1.0) ** np.arange(n)
    q = 1.0 / (y - 1.0) - signs / (y + 1.0)
    j = (2 * np.arange(n) + 1) / 2.0
    return w * (p @ (q * j))


def eval_phi(m: int, y: float, x: np.ndarray, weak: bool = True,
             singular: bool = True, hyper: bool = False) -> np.ndarray:
    """Stacked basis table for generalized Gaussian quadratures (reference
    ``evalPhi``, ``quadratures.jl:66-87``): Legendre polynomials, optionally
    times ``log|y-x|`` (weak), ``1/(y-x)`` (singular) and ``1/(y-x)^2``
    (hyper); rows are basis functions, columns quadrature points.
    Singular evaluations (y hitting a node) are zeroed like the reference.
    """
    x = np.asarray(x, dtype=np.float64)
    p = eval_legendre(m, x).T               # (m, N)
    ymx = y - x[None, :]
    blocks = [p]
    with np.errstate(divide="ignore", invalid="ignore"):
        if weak:
            blocks.append(p * np.log(np.abs(ymx)))
        if singular:
            blocks.append(p / ymx)
        if hyper:
            blocks.append(p / ymx ** 2)
    phi = np.vstack(blocks)
    phi[~np.isfinite(phi)] = 0.0
    return phi


def compute_weights(m: int, x: np.ndarray, w: np.ndarray, y: float) -> np.ndarray:
    """Generalized quadrature weights integrating polynomials, log-singular
    and PV-singular families simultaneously, via least squares against the
    exact (modified-weight) moments — semantics of ``computeweights``
    (``quadratures.jl:135-145``).

    The target moments are the exact integrals of each stacked family:
    ``int P_j = P @ w``, ``int P_j log|y-x| = P @ w_log``,
    ``int P_j/(y-x) = P @ w_pv`` (the modified weights applied to the PLAIN
    polynomial values — the singular factor lives in the weights).  The
    reference instead multiplies the singular-block values by the modified
    weights, double-counting the kernel (and swaps eq. 71/72 between the
    blocks) — an apparent bug on a dormant path, corrected here.
    """
    phi = eval_phi(m, y, x)
    p = phi[:m]
    w_log = modified_weights_log(w, x, y)
    w_pv = modified_weights_pv(w, x, y)
    moments = np.concatenate([p @ w, p @ w_log, p @ w_pv])
    return np.linalg.lstsq(phi, moments, rcond=None)[0]


def eval_generalized_moments(m: int, y: float, x: np.ndarray,
                             w: np.ndarray) -> np.ndarray:
    """Moments of the stacked singular basis under the PLAIN Gauss-Legendre
    rule (reference ``evalGeneralizedMoments``, ``quadratures.jl:190-195``) —
    the unmodified counterpart of :func:`compute_weights`' target vector."""
    return eval_phi(m, y, x) @ np.asarray(w, dtype=np.float64)


def legendre_interp_matrix(s: np.ndarray, x: np.ndarray, w: np.ndarray):
    """Interpolation matrix from Gauss-Legendre nodes x to targets s
    (reference ``legendreInterpMatrix``, ``quadratures.jl:146-152``)."""
    n = len(x)
    px = eval_legendre(n, x)
    ps = eval_legendre(n, np.asarray(s))
    scale = (2 * np.arange(n) + 1) / 2.0
    return ps @ np.diag(scale) @ px.T @ np.diag(w)
