"""Special functions on tensors: J0, Y0, H0^(1), and the analytic
Gaussian-source Helmholtz solution.

Counterpart of the JAX package's ``ops/special.py``.  The solver's hot path
never needs Bessel functions on the device (kernel tables are setup-time
artifacts, built by the native sampler), but the capability is part of the
surface the reference gets from SpecialFunctions.jl/AMOS (``hankelh1`` at
``src/FastConvolution.jl:354,398``): evaluated here, on whatever device the
float64 input lies on, a kernel table can be rebuilt without the host.  The
same two-branch scheme as ``native/hankel_sampler.cpp``: Maclaurin series
below x = 12, Hankel's asymptotic expansion beyond, accurate to about 1e-11
relative.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EULER_GAMMA = 0.57721566490153286060651209
_TWO_OVER_PI = 0.63661977236758134307553505

_N_SERIES = 40
_N_ASYM = 17


def _j0y0_series(x: torch.Tensor):
    q = 0.25 * x * x
    term = torch.ones_like(x)
    j0 = torch.ones_like(x)
    ysum = torch.zeros_like(x)
    h = 0.0
    for kk in range(1, _N_SERIES + 1):
        term = term * (-q) / (kk * kk)
        j0 = j0 + term
        h += 1.0 / kk
        ysum = ysum - term * h
    y0 = _TWO_OVER_PI * ((torch.log(0.5 * x) + _EULER_GAMMA) * j0 + ysum)
    return j0, y0


def _j0y0_asymptotic(x: torch.Tensor):
    z = 1.0 / (8.0 * x)
    tm = torch.ones_like(x)
    p = torch.zeros_like(x)
    q = torch.zeros_like(x)
    for m in range(_N_ASYM):
        if m > 0:
            odd = 2.0 * m - 1.0
            tm = tm * (odd * odd / m) * z
        mm = m % 4
        if mm == 0:
            p = p + tm
        elif mm == 1:
            q = q - tm
        elif mm == 2:
            p = p - tm
        else:
            q = q + tm
    chi = x - 0.25 * math.pi
    amp = torch.sqrt(_TWO_OVER_PI / x)
    c, s = torch.cos(chi), torch.sin(chi)
    return amp * (p * c - q * s), amp * (p * s + q * c)


def j0y0(x: torch.Tensor):
    """(J0(x), Y0(x)) elementwise for x > 0 (a float64 tensor)."""
    small = x < 12.0
    js, ys = _j0y0_series(torch.where(small, x, torch.ones_like(x)))   # finite series
    ja, ya = _j0y0_asymptotic(torch.where(small, torch.full_like(x, 20.0), x))
    return torch.where(small, js, ja), torch.where(small, ys, ya)


def hankel1_0(x: torch.Tensor) -> torch.Tensor:
    """H0^(1)(x) = J0(x) + i Y0(x) for x > 0."""
    j0, y0 = j0y0(x)
    return torch.complex(j0, y0)


def greens_kernel_2d(k: float, r: torch.Tensor, h: float) -> torch.Tensor:
    """(i/4) h^2 H0^(1)(k r): the 2D quadrature kernel."""
    scale = 0.25 * h * h
    j0, y0 = j0y0(k * r)
    return torch.complex(-scale * y0, scale * j0)


def helmholtz_gaussian_solution(r, sigma: float, k: float):
    """Outgoing free-space Helmholtz field of a unit-mass 3D Gaussian source.

    Closed form for ``(Delta + k^2) u = -g_sigma`` scaled so ``g`` has unit
    integral; the reference ships this oracle as ``solRefHelmholtz``
    (``src/Functions.jl:32-36``).  Host numpy, as in the JAX package (the
    complex erf comes from SciPy).
    """
    from scipy.special import erf

    r = np.asarray(r)
    return (np.exp(-(sigma ** 2) * k ** 2 / 2) / (4 * np.pi * r)) * (
        np.real(
            np.exp(-1j * k * r)
            * erf((2 * sigma ** 2 * 1j * k - 2 * r) / (2 * np.sqrt(2 * sigma ** 2)))
        )
        - 1j * np.sin(k * r)
    )
