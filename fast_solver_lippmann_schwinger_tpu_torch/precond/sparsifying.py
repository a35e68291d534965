"""The sparsifying preconditioner: ``u <- Msp^{-1} (As b)``.

Counterpart of the JAX package's ``precond/sparsifying.py`` (reference
``SparsifyingPreconditioner`` and its ``\\`` / ``ldiv!`` overloads,
``src/preconditioner.jl:27-58,132-170``).  The UMFPACK / MKL-PARDISO
factorization of the reference becomes a block-Thomas factorization of
``sparse/direct.py``; ``As * b`` a stencil matvec.  In 2D the pivots are
dense in the working dtype and the solves are the plain substitution loops,
as in the JAX package (no kernel and no pivot option there);
``SparsifyingPreconditionerT`` is the transposed one of the adjoint solves
(``solver/adjoint.py``).  In 3D the z-plane factorization, on dense pivots or
on the bf16 plane stacks of the plane kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    BlockTridiagFactorization,
    block_thomas_solve,
    block_thomas_solve_3d,
    factor_stencil_2d,
    factor_stencil_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import plane_view
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import (
    StencilMatrix2D,
    StencilMatrix3D,
)


@dataclasses.dataclass(frozen=True)
class SparsifyingPreconditioner:
    """Left preconditioner ``b -> Msp^{-1} (As b)`` for the 2D LS system."""

    factorization: BlockTridiagFactorization
    a_s: StencilMatrix2D

    @classmethod
    def build(cls, msp: StencilMatrix2D, a_s: StencilMatrix2D) -> "SparsifyingPreconditioner":
        return cls(factorization=factor_stencil_2d(msp), a_s=a_s)

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return block_thomas_solve(self.factorization, self.a_s.matvec(b))

    def apply_batch(self, b_batch: torch.Tensor) -> torch.Tensor:
        """(R, m*n) joint batch apply (``gmres_batched`` convention): one
        pass over the pivots for the whole batch."""
        return self.apply(b_batch.T).T

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply(b)


@dataclasses.dataclass(frozen=True)
class SparsifyingPreconditionerT:
    """Transposed sparsifying preconditioner ``b -> As^T (Msp^{-T} b)``.

    ``(Msp^{-1} As)^T = As^T Msp^{-T}``: the preconditioner of the TRANSPOSED
    system that the backward pass of ``solver.adjoint.differentiable_solve``
    solves; the order of the annihilator matvec and the direct solve flips
    against :class:`SparsifyingPreconditioner`.
    """

    factorization: BlockTridiagFactorization   # of Msp^T
    a_s_t: StencilMatrix2D

    @classmethod
    def build(cls, msp: StencilMatrix2D, a_s: StencilMatrix2D) -> "SparsifyingPreconditionerT":
        return cls(factorization=factor_stencil_2d(msp.matrix_transpose()),
                   a_s_t=a_s.matrix_transpose())

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return self.a_s_t.matvec(block_thomas_solve(self.factorization, b))

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.apply(b)


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
