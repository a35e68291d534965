"""PyTorch/CUDA port of the fast Lippmann-Schwinger solver.

A second package beside ``fast_solver_lippmann_schwinger_tpu`` (the JAX
package, which stays the reference).  It imports ``torch``, ``numpy`` and
``scipy`` only; every sub-package mirrors its JAX counterpart by name so a
reader finds each module's twin (``ops/fastconv.py`` <-> ``ops/fastconv.py``,
``sparse/pallas_thomas.py`` <-> ``sparse/thomas_kernels.py``,
``sparse/pallas_plane.py`` <-> ``sparse/plane_kernels.py``).

Ported: everything the JAX package does but its TPU machinery
(``utils/host.py``) and its benchmark folders (``ROADMAP.md``):

* the user surface: the typed configuration (``config.py``:
  ``ProblemConfig``, ``SolverConfig``, ``DDMConfig``), the config-driven API
  (``api.py``: ``build_problem``, ``solve_problem``,
  ``solve_problem_batched``), the CLI (``python -m
  fast_solver_lippmann_schwinger_tpu_torch``), checkpoints of the setup
  artifacts under ``cache_dir`` (``utils/checkpoint.py``), field output
  (``utils/fields.py``) and phase timing (``utils/timing.py``);
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
  systems) on dense, bf16 and int8 plane pivots;
* the multi-device layouts (``parallel/``): the slab sweeps (masked and
  wavefront-pipelined, 2D and 3D), the polarized traces and the FFT
  operators over a 1-D ``torch.distributed`` device mesh, one process per
  device, on plain pivots; and the six example scripts of ``examples/``
  (``python -m fast_solver_lippmann_schwinger_tpu_torch.examples.<name>``).

The substitution passes run as hand-written CUDA kernels on an NVIDIA Hopper
card (``csrc/``, built by ``native/cuda_build.py``): the line passes of
``sparse/thomas_kernels.py``, the fused sweeps of ``sparse/sweep_kernels.py``,
the plane passes of ``sparse/plane_kernels.py`` and the stencil matvec of
``ops/stencil_kernels.py``.  ``convert.py`` carries the JAX package's objects
across for the tests.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from fast_solver_lippmann_schwinger_tpu_torch.config import (
    DDMConfig,
    ProblemConfig,
    QuadRule,
    SolverConfig,
    resolve_device,
)
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D, Grid3D
from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import (
    LippmannSchwinger2D,
    LippmannSchwinger3D,
    build_fast_convolution_2d,
    build_fast_convolution_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres
from fast_solver_lippmann_schwinger_tpu_torch.solver.adjoint import (
    apply_transpose,
    differentiable_solve,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix2D
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencils import (
    build_sparse_a_2d,
    build_sparse_a_ag_2d,
)
from fast_solver_lippmann_schwinger_tpu_torch.sparse.direct import (
    BlockTridiagFactorization,
    factor_stencil_2d,
    block_thomas_solve,
)
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditioner,
    SparsifyingPreconditioner3D,
    SparsifyingPreconditionerT,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.subdomain import (
    SlabSystem,
    build_slab_system,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.sweeps import (
    DoubleSweepPreconditioner,
    GSPreconditioner,
    InnerGMRESPreconditioner,
    gs_sweep,
    jacobi_sweep,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized import (
    PolarizedTracesPreconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.parallel.fft import (
    DistributedLS2D,
    DistributedLS3D,
    build_distributed_fast_convolution_2d,
    build_distributed_fast_convolution_3d,
)
from fast_solver_lippmann_schwinger_tpu_torch.parallel.polarized import (
    make_sharded_polarized_preconditioner,
)
from fast_solver_lippmann_schwinger_tpu_torch.parallel.sharded import (
    make_sharded_double_sweep,
    make_sharded_double_sweep_pipelined,
    shard_slab_system,
    sharded_gs_sweep,
    sharded_gs_sweep_pipelined,
)
from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field
from fast_solver_lippmann_schwinger_tpu_torch import api

__version__ = "0.1.0"

__all__ = [
    "QuadRule",
    "SolverConfig",
    "DDMConfig",
    "ProblemConfig",
    "resolve_device",
    "Grid2D",
    "Grid3D",
    "LippmannSchwinger2D",
    "LippmannSchwinger3D",
    "build_fast_convolution_2d",
    "build_fast_convolution_3d",
    "gmres",
    "apply_transpose",
    "differentiable_solve",
    "StencilMatrix2D",
    "build_sparse_a_2d",
    "build_sparse_a_ag_2d",
    "BlockTridiagFactorization",
    "factor_stencil_2d",
    "block_thomas_solve",
    "SparsifyingPreconditioner",
    "SparsifyingPreconditioner3D",
    "SparsifyingPreconditionerT",
    "SlabSystem",
    "build_slab_system",
    "DoubleSweepPreconditioner",
    "GSPreconditioner",
    "InnerGMRESPreconditioner",
    "gs_sweep",
    "jacobi_sweep",
    "PolarizedTracesPreconditioner",
    "DistributedLS2D",
    "DistributedLS3D",
    "build_distributed_fast_convolution_2d",
    "build_distributed_fast_convolution_3d",
    "make_sharded_polarized_preconditioner",
    "make_sharded_double_sweep",
    "make_sharded_double_sweep_pipelined",
    "shard_slab_system",
    "sharded_gs_sweep",
    "sharded_gs_sweep_pipelined",
    "save_field",
    "api",
]
