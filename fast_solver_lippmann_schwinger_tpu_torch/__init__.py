"""PyTorch/CUDA port of the fast Lippmann-Schwinger solver.

A second package beside ``fast_solver_lippmann_schwinger_tpu`` (the JAX
package, which stays the reference).  It imports ``torch``, ``numpy`` and
``scipy`` only; every sub-package mirrors its JAX counterpart by name so a
reader finds each module's twin (``ops/fastconv.py`` <-> ``ops/fastconv.py``,
``sparse/pallas_thomas.py`` <-> ``sparse/thomas_kernels.py``,
``sparse/pallas_plane.py`` <-> ``sparse/plane_kernels.py``).

Ported so far (``ROADMAP.md`` lists what is not: the user surface of
``config.py``/``api.py`` with checkpoints, and the multi-device layouts):

* the 2D Lippmann-Schwinger operator on both quadratures (``ops/fastconv.py``;
  the Duan-Rokhlin trapezoidal rule is the default, as in the JAX package),
  the annihilator stencils and the block-Thomas factorization;
* the 801 x 801 plasma scattering solve (``models/plasma2d.py``) on one slab
  and with 16 slabs and the bi-directional sweep (``ddm/sweeps.py``), on
  dense, bf16, int8 and banded+tail kernel pivots and on the JAX package's
  plain banded pivots (``"banded"``, ``"banded_tail"``, ``"banded_lr"``),
  with the stencil matvec kernel under ``use_pallas=True``;
* the reference's canonical example script ``examples/example.jl``
  (``models/bump2d.py``): the 2D Gaussian bump with the 2D sparsifying
  preconditioner (``precond/sparsifying.py``), and the solver extras
  (``solver/adjoint.py``: the transposed apply and a differentiable solve;
  ``ops/special.py``; ``solver/quadratures.py``); the 2D Hankel tables come
  from the OpenMP C++ sampler (``native/sampler.py``);
* the polarized-traces integral system (``ddm/polarized.py``) and its 401 x
  401 plasma solve (``models/plasma_integral2d.py``);
* the 3D bump scattering solve (``models/bump3d.py``) with the sparsifying
  preconditioner, with the z-slab Gauss-Seidel sweep
  (``ddm/subdomain3d.py``) and with the 3D polarized traces
  (``ddm/polarized3d.py``, the plane-trace integral system on the same slab
  systems) on dense, bf16 and int8 plane pivots.

The substitution passes run as hand-written CUDA kernels on an NVIDIA Hopper
card (``csrc/``, built by ``native/cuda_build.py``): the line passes of
``sparse/thomas_kernels.py``, the fused sweeps of ``sparse/sweep_kernels.py``,
the plane passes of ``sparse/plane_kernels.py`` and the stencil matvec of
``ops/stencil_kernels.py``.  ``convert.py`` carries the JAX package's objects
across for the tests.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from fast_solver_lippmann_schwinger_tpu_torch.config import QuadRule, resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner,
    SparsifyingPreconditioner3D,
    SparsifyingPreconditionerT,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.adjoint import (
    apply_transpose,
    differentiable_solve,
)

__all__ = [
    "QuadRule",
    "resolve_device",
    "SparsifyingPreconditioner",
    "SparsifyingPreconditioner3D",
    "SparsifyingPreconditionerT",
    "apply_transpose",
    "differentiable_solve",
]
