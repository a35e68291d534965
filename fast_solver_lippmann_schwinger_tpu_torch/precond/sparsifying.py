"""The sparsifying preconditioner in 3D: ``u <- Msp^{-1} (As b)``.

Counterpart of the JAX package's ``precond/sparsifying.py`` for its 3D class
(reference ``SparsifyingPreconditioner`` and its ``\\`` / ``ldiv!``
overloads, ``src/preconditioner.jl:27-58,132-170``).  The MKL-PARDISO
factorization of the reference becomes the z-plane block-Thomas
factorization of ``sparse/direct.py``; ``As * b`` a stencil matvec.  The 2D
classes come with a later slice (``ROADMAP.md``, Queue 1 slice 2).
"""

from __future__ import annotations

import dataclasses

import torch

from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    block_thomas_solve_3d,
    factor_stencil_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import plane_view
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix3D


@dataclasses.dataclass(frozen=True)
class SparsifyingPreconditioner3D:
    factorization: object   # BlockTridiagFactorization3D | PlaneSlabView
    a_s: StencilMatrix3D

    @classmethod
    def build(cls, msp: StencilMatrix3D, a_s: StencilMatrix3D,
              use_pallas: bool = False) -> "SparsifyingPreconditioner3D":
        """``use_pallas`` stores bf16 plane pivots in the plane kernels'
        stack layout (``sparse/plane_kernels.py``): the substitution passes
        then run as the fused CUDA kernels, which stream each (mn, mn) pivot
        plane once per pass.  Otherwise the pivots are dense in the working
        dtype.  (The name is the JAX package's.)"""
        fac = factor_stencil_3d(msp, pivot_dtype="bf16" if use_pallas else "full")
        return cls(factorization=plane_view(fac) if use_pallas else fac, a_s=a_s)

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return block_thomas_solve_3d(self.factorization, self.a_s.matvec(b))

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, l*m*n) joint batch apply (``gmres_batched`` convention): one
        pass over the pivot planes for the whole batch."""
        return self.apply(b_batch.T).T

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply(b)
