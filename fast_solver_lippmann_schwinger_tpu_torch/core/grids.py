"""Uniform grids for the Lippmann-Schwinger solver.

Layout convention (differs from the reference's Julia column-major flattening
only in notation, not in the flattened order): 2D fields are stored as
row-major arrays of shape ``(m, n)`` where axis 0 is y (the slab/sweep axis)
and axis 1 is x.  Flattening a ``(m, n)`` row-major array gives exactly the
reference's x-fastest vector order (Julia ``reshape(1:n*m, n, m)``,
``src/SparsifyingMatrix2D.jl:356``): ``flat[j*n + i] = field[j, i]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Uniform tensor grid on ``[-a/2, a/2]^2`` with spacing ``h``.

    Mirrors the example scripts' setup ``x = collect(-a/2:h:a/2)``
    (``examples/example.jl:34-40``).  ``n`` points per axis, odd for the
    trapezoidal kernel table (``src/FastConvolution.jl:431``).
    """

    a: float
    h: float

    @property
    def x(self) -> np.ndarray:
        return np.arange(
            -self.a / 2, self.a / 2 + self.h / 2, self.h, dtype=np.float64
        )

    @property
    def y(self) -> np.ndarray:
        return self.x

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def m(self) -> int:
        return self.n

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def size(self) -> int:
        return self.m * self.n

    def mesh(self):
        """(X, Y) each of shape (m, n): X varies along axis 1, Y along axis 0."""
        X, Y = np.meshgrid(self.x, self.y, indexing="xy")
        return X, Y


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Uniform grid on ``[-a/2, a/2)^3`` (half-open like
    ``examples/example3D.jl:27-29``: ``collect(-a/2:h:a/2-h)``), so n = 48
    at h = 1/48."""

    a: float
    h: float

    @property
    def x(self) -> np.ndarray:
        return np.arange(
            -self.a / 2, self.a / 2 - self.h / 2, self.h, dtype=np.float64
        )

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def shape(self):
        return (self.n, self.n, self.n)

    @property
    def size(self) -> int:
        return self.n ** 3

    def mesh(self):
        """(X, Y, Z) each (l, m, n): X fastest (axis 2), Z slowest (axis 0)."""
        Z, Y, X = np.meshgrid(self.x, self.x, self.x, indexing="ij")
        return X, Y, Z
