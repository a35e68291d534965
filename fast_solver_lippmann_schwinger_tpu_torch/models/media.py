"""Scattering media (perturbations ``nu`` of the squared slowness).

These are the "model families" of the reference's example scripts, as pure functions of
coordinates (numpy, float64 — they are setup-time quantities):

* ``gaussian_bump_2d``      — ``examples/example.jl:48``
* ``plasma_2d``             — tokamak-shaped plasma profile,
                              ``tests/plasma_example.jl:53-68``
* ``plasma_2d_transposed``  — the same profile on swapped axes,
                              ``tests/plasma_example.jl:70``
* ``gaussian_bump_3d``      — truncated Gaussian bump, ``examples/example3D.jl``
"""

from __future__ import annotations

import numpy as np


def gaussian_bump_2d(x, y, amplitude: float = 0.3, width: float = 40.0,
                     cutoff: float = 0.48):
    """Smooth compactly-supported Gaussian bump (``examples/example.jl:48``)."""
    return (
        amplitude
        * np.exp(-width * (x ** 2 + y ** 2))
        * (np.abs(x) < cutoff)
        * (np.abs(y) < cutoff)
    )


def _plasma_phi(x, y, c: float = 0.4987):
    return 1.0 - (x - 0.05 * (1.0 - x ** 2)) ** 2 - c * ((1.0 + 0.3 * x) ** 2) * y ** 2


def _plasma_gaussians(x, y):
    amps = np.array([0.45, 0.196, 0.51, 0.195, 0.63])
    xi = np.array([0.4, 0.54, -0.14, -0.5, 0.18])
    yi = np.array([0.0, -0.28, 0.70, -0.01, 0.8])
    out = np.zeros(np.broadcast(x, y).shape)
    for a, cx, cy in zip(amps, xi, yi):
        out = out + a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / 0.01)
    return out


def plasma_2d(x, y):
    """Five-Gaussian plasma profile inside a tokamak-shaped region.

    Matches ``nu(x,y) = -nu2(3x, 3y)`` of ``tests/plasma_example.jl:53-68``
    (including the sign convention noted there).
    """
    xs, ys = 3.0 * x, 3.0 * y
    phi = _plasma_phi(xs, ys)
    inner = -1.5 * (phi - 0.05) - _plasma_gaussians(xs, ys) * np.cos(0.9 * ys)
    return -np.where(phi > 0.05, inner, 0.0)


def plasma_2d_transposed(x, y):
    """``nuT(x,y) = nu(y,x)`` (``tests/plasma_example.jl:70``)."""
    return plasma_2d(y, x)


def gaussian_bump_3d(x, y, z, amplitude: float = 0.3, width: float = 40.0,
                     cutoff: float = 0.48):
    """Gaussian bump cut off near the box faces (``examples/example3D.jl``)."""
    return (
        amplitude
        * np.exp(-width * (x ** 2 + y ** 2 + z ** 2))
        * (np.abs(x) < cutoff)
        * (np.abs(y) < cutoff)
        * (np.abs(z) < cutoff)
    )
