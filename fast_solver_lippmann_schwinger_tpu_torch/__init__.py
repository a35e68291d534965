"""PyTorch/CUDA port of the fast Lippmann-Schwinger solver.

A second package beside ``fast_solver_lippmann_schwinger_tpu`` (the JAX
package, which stays the reference).  It imports ``torch``, ``numpy`` and
``scipy`` only; every sub-package mirrors its JAX counterpart by name so a
reader finds each module's twin (``ops/fastconv.py`` <-> ``ops/fastconv.py``,
``sparse/pallas_thomas.py`` <-> ``sparse/thomas_kernels.py``,
``sparse/pallas_plane.py`` <-> ``sparse/plane_kernels.py``).

Ported so far: the 801 x 801 plasma scattering solve (``models/plasma2d.py``)
on one slab and with 16 slabs and the bi-directional sweep, whose
block-Thomas substitution passes run as hand-written CUDA kernels, and the
48^3 bump scattering solve with the sparsifying preconditioner
(``models/bump3d.py``), whose plane substitution passes run as three more
(``csrc/``, built by ``native/cuda_build.py``), on an NVIDIA Hopper card.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from fast_solver_lippmann_schwinger_tpu_torch.config import QuadRule, resolve_device

__all__ = ["QuadRule", "resolve_device"]
