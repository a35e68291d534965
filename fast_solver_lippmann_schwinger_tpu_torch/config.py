"""Typed configuration shared by the port's modules.

Counterpart of the JAX package's ``config.py``; only the pieces the ported
path needs.  Working dtypes are ``torch.complex64`` / ``torch.complex128``.
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
