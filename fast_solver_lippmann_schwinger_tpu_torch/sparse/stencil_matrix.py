"""Dense stencil-field representation of the sparsified operators.

The reference assembles its sparsifying matrices ``A`` and ``A*G`` as general
CSC matrices (``buildSparseA``/``buildSparseAG``,
``src/SparsifyingMatrix2D.jl:351-529,806-966``).  But every row of those
matrices is a 3x3 stencil around its diagonal, so the representation here is
a dense *stencil field*: a ``(m, n, 3, 3)`` tensor of per-node coefficients.
A matvec is 9 shifted multiply-adds over the grid, in plain torch (the JAX
package runs the same 9 taps through its compiler on this path), or with
``use_pallas=True`` the hand-written stencil kernel (``ops/stencil_kernels.py``,
the counterpart of the JAX package's Pallas stencil SpMV) for single-RHS
input; the block-tridiagonal structure needed by the direct solver can be read
off directly (``sparse/direct.py``).

Offsets convention: ``values[j, i, dj, di]`` is the coefficient coupling node
(row) ``(j, i)`` to node (column) ``(j + dj - 1, i + di - 1)``; j is the slab
axis (y in 2D), i is x.  In 3D (``StencilMatrix3D``) the rows are 3x3x3
stencils, ``values[p, j, i, dk, dj, di]``, with p the z-plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.ops.stencil_kernels import stencil_matvec_2d


@dataclasses.dataclass(frozen=True)
class StencilMatrix2D:
    """A sparse matrix whose rows are 3x3 stencils on an (m, n) grid.

    ``use_pallas=True`` routes single-RHS matvecs through the stencil kernel
    (float32 arithmetic, as the JAX package's Pallas kernel); multi-RHS input
    keeps the 9 shifted multiply-adds, and every derived matrix
    (``transpose``, ``matrix_transpose``, ``scale_columns``, sums and
    multiples) is built without the flag, as in the JAX package.
    """

    values: torch.Tensor   # (m, n, 3, 3) complex
    use_pallas: bool = False

    @property
    def m(self) -> int:
        return self.values.shape[0]

    @property
    def n(self) -> int:
        return self.values.shape[1]

    @property
    def shape(self):
        return (self.m * self.n, self.m * self.n)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """``y = S u`` via 9 shifted multiply-adds; u flat, (m, n), or with
        trailing RHS columns (m*n, r) / (m, n, r)."""
        m, n = self.m, self.n
        extra = tuple(u.shape[1:] if u.ndim > 1 and u.shape[0] == m * n
                      else u.shape[2:])
        if self.use_pallas and not extra:
            return stencil_matvec_2d(self.values, u)
        u2 = u.reshape((m, n) + extra)
        # F.pad lists the last axis first: grid axes 0 and 1 get one zero
        # line each side, the RHS axes none
        up = F.pad(u2, (0, 0) * len(extra) + (1, 1, 1, 1))
        vals = self.values.reshape((m, n, 3, 3) + (1,) * len(extra))
        out = torch.zeros(
            u2.shape, dtype=torch.result_type(self.values, u), device=u.device
        )
        for dj in range(3):
            for di in range(3):
                out = out + vals[:, :, dj, di] * up[dj : dj + m, di : di + n]
        return out.reshape(u.shape)

    def __matmul__(self, u):
        return self.matvec(u)

    def transpose(self) -> "StencilMatrix2D":
        """``T S T'`` under the grid transposition permutation: swapping
        grid axes and stencil offset axes yields exactly the permuted matrix
        (the x/y swap of ``tests/plasma_example.jl:103-112``)."""
        return StencilMatrix2D(values=self.values.permute(1, 0, 3, 2).contiguous())

    def matrix_transpose(self) -> "StencilMatrix2D":
        """The true matrix transpose ``S^T`` (NOT the grid x/y swap of
        :meth:`transpose`): row (j, i) of ``S^T`` collects, from each
        neighbor, the coefficient of that neighbor's stencil pointing back
        at (j, i).  Used for adjoint solves (``solver/adjoint.py``)."""
        m, n = self.m, self.n
        vp = F.pad(self.values, (0, 0, 0, 0, 1, 1, 1, 1))
        out = torch.empty_like(self.values)
        for dj in range(3):
            for di in range(3):
                out[:, :, dj, di] = vp[dj : dj + m, di : di + n, 2 - dj, 2 - di]
        return StencilMatrix2D(values=out)

    def scale_columns(self, d: torch.Tensor) -> "StencilMatrix2D":
        """``S @ diag(d)`` for a grid field d (m, n): column scaling.

        Used to form ``Msp = As + k^2 (AG) diag(nu)``
        (``examples/example.jl:67``).
        """
        m, n = self.m, self.n
        dp = F.pad(d.reshape(m, n).to(self.values.dtype), (1, 1, 1, 1))
        cols = torch.stack(
            [
                torch.stack([dp[dj : dj + m, di : di + n] for di in range(3)], dim=-1)
                for dj in range(3)
            ],
            dim=-2,
        )  # (m, n, 3, 3) value of d at each column node
        return StencilMatrix2D(values=self.values * cols)

    def __add__(self, other: "StencilMatrix2D") -> "StencilMatrix2D":
        return StencilMatrix2D(values=self.values + other.values)

    def __mul__(self, scalar) -> "StencilMatrix2D":
        return StencilMatrix2D(values=self.values * scalar)

    __rmul__ = __mul__

    def to_dense(self) -> np.ndarray:
        """Dense (N, N) numpy matrix: test oracle only."""
        m, n = self.m, self.n
        vals = self.values.detach().cpu().numpy()
        out = np.zeros((m * n, m * n), dtype=vals.dtype)
        for j in range(m):
            for i in range(n):
                row = j * n + i
                for dj in range(3):
                    for di in range(3):
                        jj, ii = j + dj - 1, i + di - 1
                        if 0 <= jj < m and 0 <= ii < n:
                            out[row, jj * n + ii] = vals[j, i, dj, di]
        return out

    def to_coo(self):
        """COO triplets ``(rows, cols, vals)`` of the assembled sparse matrix,
        host numpy, in the JAX package's order (node-major, then dj, di;
        taps that leave the grid dropped): the export counterpart of the
        reference's ``createIndices`` kron-expansion
        (``src/Functions.jl:7-29``), for ``scipy.sparse.coo_matrix``."""
        m, n = self.m, self.n
        vals = self.values.detach().cpu().numpy()
        j, i, dj, di = np.meshgrid(np.arange(m), np.arange(n), np.arange(3), np.arange(3),
                                   indexing="ij")
        jj, ii = j + dj - 1, i + di - 1
        keep = (jj >= 0) & (jj < m) & (ii >= 0) & (ii < n)
        return (j * n + i)[keep], (jj * n + ii)[keep], vals[keep]


@dataclasses.dataclass(frozen=True)
class StencilMatrix3D:
    """3x3x3 stencil rows on an (l, m, n) grid (27 classes in the reference,
    ``src/SparsifyingMatrix3D.jl``): ``values[p, j, i, dk, dj, di]`` couples
    node (p, j, i) to node (p + dk - 1, j + dj - 1, i + di - 1)."""

    values: torch.Tensor   # (l, m, n, 3, 3, 3) complex

    @property
    def l(self) -> int:
        return self.values.shape[0]

    @property
    def m(self) -> int:
        return self.values.shape[1]

    @property
    def n(self) -> int:
        return self.values.shape[2]

    @property
    def shape(self):
        size = self.l * self.m * self.n
        return (size, size)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """``y = S u``; u flat, (l, m, n), or with trailing RHS columns
        (l*m*n, r) / (l, m, n, r).

        One product of the stencil field with the 3x3x3 windows of the
        zero-padded field and one sum over the 27 taps: three device calls
        where 27 shifted multiply-adds would take 54 (the preconditioner
        apply calls this once, and on the card its host time was the
        largest part of the apply; ``PERF.md``)."""
        l, m, n = self.l, self.m, self.n
        extra = tuple(u.shape[1:] if u.ndim > 1 and u.shape[0] == l * m * n
                      else u.shape[3:])
        u3 = u.reshape((l, m, n) + extra)
        up = F.pad(u3, (0, 0) * len(extra) + (1, 1, 1, 1, 1, 1))
        # windows[p, j, i, ..., dk, dj, di] = u[p + dk - 1, j + dj - 1, i + di - 1, ...]
        windows = up.unfold(0, 3, 1).unfold(1, 3, 1).unfold(2, 3, 1)
        vals = self.values.reshape((l, m, n) + (1,) * len(extra) + (3, 3, 3))
        return (vals * windows).sum((-3, -2, -1)).reshape(u.shape)

    def __matmul__(self, u):
        return self.matvec(u)

    def matrix_transpose(self) -> "StencilMatrix3D":
        """True matrix transpose: the coefficient coupling row node x to
        column node x + o moves to row x + o, offset -o."""
        l, m, n = self.l, self.m, self.n
        vp = F.pad(self.values, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1))
        out = torch.zeros_like(self.values)
        for dk in range(3):
            for dj in range(3):
                for di in range(3):
                    out[:, :, :, dk, dj, di] = vp[
                        dk : dk + l, dj : dj + m, di : di + n, 2 - dk, 2 - dj, 2 - di
                    ]
        return StencilMatrix3D(values=out)

    def scale_columns(self, d: torch.Tensor) -> "StencilMatrix3D":
        """``S @ diag(d)`` for a grid field d (l, m, n): column scaling
        (``Msp = As + k^2 (AG) diag(nu)``)."""
        l, m, n = self.l, self.m, self.n
        dp = F.pad(d.reshape(l, m, n).to(self.values.dtype), (1, 1, 1, 1, 1, 1))
        cols = torch.stack([
            torch.stack([
                torch.stack([dp[dk : dk + l, dj : dj + m, di : di + n] for di in range(3)],
                            dim=-1)
                for dj in range(3)
            ], dim=-2)
            for dk in range(3)
        ], dim=-3)           # (l, m, n, 3, 3, 3) value of d at each column node
        return StencilMatrix3D(values=self.values * cols)

    def __add__(self, other: "StencilMatrix3D") -> "StencilMatrix3D":
        return StencilMatrix3D(values=self.values + other.values)

    def __mul__(self, scalar) -> "StencilMatrix3D":
        return StencilMatrix3D(values=self.values * scalar)

    __rmul__ = __mul__

    def to_dense(self) -> np.ndarray:
        """Dense (N, N) numpy matrix: test oracle only."""
        l, m, n = self.l, self.m, self.n
        vals = self.values.detach().cpu().numpy()
        out = np.zeros((l * m * n, l * m * n), dtype=vals.dtype)
        p, j, i = np.meshgrid(np.arange(l), np.arange(m), np.arange(n), indexing="ij")
        for dk in range(3):
            for dj in range(3):
                for di in range(3):
                    pp, jj, ii = p + dk - 1, j + dj - 1, i + di - 1
                    keep = ((pp >= 0) & (pp < l) & (jj >= 0) & (jj < m)
                            & (ii >= 0) & (ii < n))
                    out[((p * m + j) * n + i)[keep], ((pp * m + jj) * n + ii)[keep]] = (
                        vals[:, :, :, dk, dj, di][keep])
        return out

    def to_coo(self):
        """COO triplets ``(rows, cols, vals)``, host numpy, in the JAX
        package's order (see the 2D version)."""
        l, m, n = self.l, self.m, self.n
        vals = self.values.detach().cpu().numpy()
        p, j, i, dk, dj, di = np.meshgrid(np.arange(l), np.arange(m), np.arange(n),
                                          np.arange(3), np.arange(3), np.arange(3),
                                          indexing="ij")
        pp, jj, ii = p + dk - 1, j + dj - 1, i + di - 1
        keep = (pp >= 0) & (pp < l) & (jj >= 0) & (jj < m) & (ii >= 0) & (ii < n)
        return ((p * m + j) * n + i)[keep], ((pp * m + jj) * n + ii)[keep], vals[keep]
