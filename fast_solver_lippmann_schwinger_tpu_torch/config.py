"""Typed configuration shared by the port's modules.

Counterpart of the JAX package's ``config.py``: the quadrature rule, the
solver, domain-decomposition and problem dataclasses of the config-driven API
(``api.py``, ``python -m fast_solver_lippmann_schwinger_tpu_torch``), and the
device helpers of the port.  Working dtypes are ``torch.complex64`` /
``torch.complex128``.

The reference exposes configuration only as constants edited inside its
example scripts and scattered keyword arguments (``quadRule`` at
``src/FastConvolution.jl:171``, ``solvertype`` at ``src/subdomains.jl:22``,
``precondtype``/``nIt``/``tol``/``maxIter`` at ``src/preconditioner.jl:70-112``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class QuadRule(str, enum.Enum):
    """Quadrature rule for the singular Green's-function kernel.

    Mirrors the two regimes of the reference (``quadRule`` keyword,
    ``src/FastConvolution.jl:170-236``).
    """

    TRAPEZOIDAL = "trapezoidal"       # Duan-Rokhlin corrected trapezoidal rule
    GREENGARD_VICO = "greengard_vico"  # Fourier-truncated kernel


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Outer Krylov solver configuration (replaces IterativeSolvers.gmres!)."""

    rtol: float = 1e-8           # relative tolerance on preconditioned residual
    restart: int = 20            # GMRES restart length
    maxiter: int = 200           # max total iterations
    dtype: torch.dtype = torch.complex64


@dataclasses.dataclass(frozen=True)
class DDMConfig:
    """Domain-decomposition (polarized traces) configuration.

    Mirrors ``nSubdomains``/``npml`` from ``tests/plasma_example.jl:41,102``
    and the sweep knobs of ``src/preconditioner.jl``.
    """

    n_subdomains: int = 8
    npml: int = 10               # absorbing-extension layers (``ndelta``)
    shift_factor: float = 2.0    # complex-shift scale: shift = shift_factor * k
                                 # (``src/subdomains.jl:53``)
    n_inner_iters: int = 1       # ``nIt`` for the trace-space preconditioner
    inner_tol: float = 1e-2      # inner GMRES tolerance (polarized traces)
    inner_maxiter: int = 40
    # inner-GMRES composite knobs (``precond="gs_inner"`` /
    # ``"double_sweep_inner"``): one restart cycle of length
    # ``inner_gmres_maxiter`` on ``Msp y = As b`` preconditioned by the
    # sweep, the reference's ``Preconditioner``
    # (``src/preconditioner.jl:92-116,186-204``) and the ``maxIter != 0``
    # branch of ``doublePreconditioner`` (``:228-244``, defaults
    # ``maxIter=20, tol=1e-2``)
    inner_gmres_maxiter: int = 20
    inner_gmres_tol: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Full problem description, the typed replacement for the reference's
    edit-the-script-constants workflow (``tests/plasma_example.jl:20-41``).

    ``precond`` names one of the reference's preconditioner families:
    ``sparsifying`` (``SparsifyingPreconditioner``), ``gs`` (one
    single-direction sweep, ``GSPreconditioner``), ``gs_inner`` (inner GMRES
    on the sparsified system preconditioned by the GS sweep, the reference's
    ``Preconditioner``), ``double_sweep`` (``doublePreconditioner`` with
    maxIter=0), ``double_sweep_inner`` (its ``maxIter != 0`` branch),
    ``polarized_traces`` (trace-space inner GMRES), or ``none``.
    """

    dim: int = 2                       # 2 or 3
    medium: str = "gaussian_bump"      # gaussian_bump | plasma
    h: float = 1.0 / 100.0
    a: float = 1.0                     # domain half-extent/size
    k: float | None = None             # defaults to 1/h (reference convention)
    quad_rule: QuadRule = QuadRule.GREENGARD_VICO
    prefer_pow2: bool | None = None    # extended-FFT size class: True = powers
                                       # of two, False or None = 5-smooth sizes
    precond: str = "sparsifying"
    pivot_dtype: str = "full"          # full | bf16 | banded | banded_lr |
                                       # banded_tail | pallas | pallas_int8 |
                                       # pallas_banded_tail (2D slab pivots);
                                       # full | bf16 | int8 | yblock* with an
                                       # optional _pallas suffix (3D)
    pivot_band: int | None = None      # band width for banded/banded_lr
    pivot_rank: int | None = None      # low-rank correction rank (banded_lr)
    cache_dir: str | None = None       # checkpoint directory for the expensive
                                       # setup artifacts (symbol, stencil
                                       # fields, slab factorizations;
                                       # utils/checkpoint.py)
    incident_direction: tuple = (1.0, 0.0)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    ddm: DDMConfig = dataclasses.field(default_factory=DDMConfig)


def default_complex_dtype() -> torch.dtype:
    """complex128 when PyTorch's default float dtype is float64 (the
    counterpart of JAX's x64 mode), else complex64."""
    return torch.complex128 if torch.get_default_dtype() == torch.float64 else torch.complex64


def real_dtype_of(cdtype: torch.dtype) -> torch.dtype:
    """float64 for complex128, float32 for complex64."""
    if cdtype == torch.complex128:
        return torch.float64
    if cdtype == torch.complex64:
        return torch.float32
    raise ValueError(f"expected a complex dtype, got {cdtype}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card and raises when there is none: nothing in
    this package looks for a GPU and quietly carries on on the CPU.  The CPU
    is used only when the caller asks for it by name (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; this package runs on the GPU by "
                'default - pass device="cpu" explicitly to run on the host'
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """Host numpy data -> tensor of ``dtype`` on ``device``."""
    return torch.tensor(np.asarray(arr), dtype=dtype, device=device)


def move_to(obj, device):
    """A copy of one of the port's frozen dataclasses of tensors (a problem,
    a preconditioner, a slab system, a factorization) with every tensor moved
    to ``device``; what is not a tensor is kept as it is.  Cached properties
    are not copied: they are rebuilt on the new device when first read."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: move_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj
