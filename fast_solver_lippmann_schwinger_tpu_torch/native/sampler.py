"""Host sampler for the Green's-function kernel tables.

Counterpart of the JAX package's ``native/sampler.py``: the tables of
``(i/4) h^2 H0^(1)(k r)`` (2D) and ``exp(i k r) h^2 / (4 pi r)`` (3D) come
from the OpenMP C++ sampler ``hankel_sampler.cpp`` (the port's own copy of
the JAX package's source), the replacement of the reference's multi-process
``sampleGkernelpar`` (``src/FastConvolution.jl:337-401``).  SciPy and numpy
are the plain versions (``*_plain``), which the tests hold the native ones
against (1e-11 relative).

The library is built at first use with ``g++ -O3 -march=native -fopenmp`` into
``build/`` at the repository root (git-ignored), named after the hash of the
source and of the host's CPU, so that a library built for another CPU is never
loaded.  A failed build raises with the compiler's output; nothing falls back
to SciPy quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np
from scipy.special import hankel1

SOURCE = Path(__file__).resolve().with_name("hankel_sampler.cpp")
BUILD = Path(__file__).resolve().parents[2] / "build"

_LOCK = threading.Lock()
_LIB = None

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def _cpu_signature() -> bytes:
    """What ``-march=native`` compiles for: the machine and its CPU flags."""
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine().encode() + flags


def library_path() -> Path:
    """``build/hankel_sampler_<hash>.so``, keyed on the source and the CPU."""
    digest = hashlib.sha256(SOURCE.read_bytes() + _cpu_signature()).hexdigest()[:16]
    return BUILD / f"hankel_sampler_{digest}.so"


def build_library() -> Path:
    """Compile the sampler unless its library exists; returns its path.
    The compiler writes a private file that is then renamed into place, so
    processes building side by side never load a half-written library."""
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"could not run g++ to build the kernel sampler: {err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build the kernel sampler {SOURCE} ({' '.join(cmd)}):\n"
            + proc.stderr
        )
    os.replace(tmp, so)
    return so


def load_library():
    """The sampler library with its argument types set, built first if
    needed (once per process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.sample_hankel0_kernel.argtypes = [
                _DOUBLE_P, ctypes.c_size_t, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, _DOUBLE_P,
            ]
            lib.sample_hankel0_kernel.restype = None
            lib.sample_helmholtz3d_kernel.argtypes = [
                _DOUBLE_P, ctypes.c_size_t, ctypes.c_double, ctypes.c_double, _DOUBLE_P,
            ]
            lib.sample_helmholtz3d_kernel.restype = None
            _LIB = lib
        return _LIB


def _sample(fn, r: np.ndarray, *args) -> np.ndarray:
    """Run a sampler entry point on the distances ``r``; complex128 out."""
    r = np.ascontiguousarray(r, dtype=np.float64)
    out = np.empty(r.shape + (2,), dtype=np.float64)
    fn(r.ctypes.data_as(_DOUBLE_P), r.size, *args, out.ctypes.data_as(_DOUBLE_P))
    return out.view(np.complex128).reshape(r.shape)


def hankel_kernel_table(k: float, r: np.ndarray, h: float) -> np.ndarray:
    """(i/4) h^2 H0^(1)(k r), elementwise over r (any shape, r > 0),
    complex128, from the native sampler."""
    return _sample(load_library().sample_hankel0_kernel, r, float(k), 0.0, 0.25 * h * h)


def hankel_kernel_table_plain(k: float, r: np.ndarray, h: float) -> np.ndarray:
    """:func:`hankel_kernel_table` through SciPy (AMOS)."""
    r = np.ascontiguousarray(r, dtype=np.float64)
    return (0.25j * h * h) * hankel1(0, k * r)


def helmholtz3d_kernel_table(k: float, r: np.ndarray, h: float) -> np.ndarray:
    """exp(i k r) h^2 / (4 pi r), elementwise (r > 0), complex128, from the
    native sampler."""
    return _sample(load_library().sample_helmholtz3d_kernel, r, float(k), h * h)


def helmholtz3d_kernel_table_plain(k: float, r: np.ndarray, h: float) -> np.ndarray:
    """:func:`helmholtz3d_kernel_table` through numpy."""
    r = np.ascontiguousarray(r, dtype=np.float64)
    return np.exp(1j * k * r) * (h * h) / (4.0 * np.pi * r)
