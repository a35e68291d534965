"""Building and loading the port's hand-written CUDA kernels.

Every kernel source ``csrc/<name>.cu`` exports one launcher with a plain C
interface.  The module that wraps a kernel registers it here
(:func:`register`: source name, exported symbol, ctypes argument types), and
this module compiles each registered source with ``nvcc`` for ``sm_90a`` into
its own shared library under ``build/`` at the repository root (git-ignored)
and loads it with ``ctypes``.  Sources are rebuilt when a file in ``csrc/``
is newer than their library, all at once, one ``nvcc`` per source.

Nothing is compiled when a module is imported: the first launch builds what
it needs, and ``chip_smoke.py`` builds everything up front.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"

# ctypes argument types of a launcher: pointers and the stream travel as
# c_void_p (a bare Python int would be cut to 32 bits), ints as c_int,
# unsigned 32-bit counters as c_uint
PTR = ctypes.c_void_p
INT = ctypes.c_int
UINT = ctypes.c_uint

# source name -> (exported launcher, argument types)
_REGISTRY: dict[str, tuple[str, list]] = {}
_functions: dict[str, object] = {}


def register(name: str, symbol: str, argtypes: list) -> None:
    """Declare the kernel source ``csrc/<name>.cu`` and the signature of the
    launcher ``symbol`` it exports (the launcher returns a CUDA error code)."""
    _REGISTRY[name] = (symbol, list(argtypes))


def sources() -> list[str]:
    """Names of the registered sources."""
    return sorted(_REGISTRY)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found: the kernels are compiled from "
            f"{CSRC} on first use and need the CUDA toolkit"
        )
    return path


def _stale(name: str) -> bool:
    so = BUILD / f"lib{name}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return so.stat().st_mtime < newest


def build_kernels(names=None, verbose: bool = False, defines=None,
                  build_dir: Path | None = None) -> dict[str, str]:
    """Compile every source of ``names`` (all registered when ``None``) that
    is missing or older than ``csrc/``, one ``nvcc`` per source, all started
    together.  Returns the compiler's output per source (``-Xptxas -v``
    resource usage when ``verbose``).  ``defines`` (``{"NAME": value}``)
    builds a variant into ``build_dir``, always anew (the ablation study of
    ``benchmarks_torch/thomas_ablation.py``); the package never sets it."""
    names = sources() if names is None else list(names)
    for name in names:
        if name not in _REGISTRY:
            raise KeyError(f"no kernel source registered as {name!r}")
    build = BUILD if build_dir is None else Path(build_dir)
    todo = [name for name in names if defines or _stale(name)]
    if not todo:
        return {}
    nvcc = _nvcc()
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC",
            *(f"-D{key}={value}" for key, value in (defines or {}).items()),
            "-o", str(build / f"lib{name}.so"), str(CSRC / f"{name}.cu"),
        ]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    logs, failed = {}, []
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[name] for name in failed)
        )
    return logs


def load(name: str, build_dir: Path | None = None):
    """The launcher of source ``name`` with its argument types set: from
    ``build/lib<name>.so``, built first if it is missing or stale, or from a
    variant already built into ``build_dir``."""
    if build_dir is None and name in _functions:
        return _functions[name]
    symbol, argtypes = _REGISTRY[name]
    if build_dir is None:
        build_kernels([name])
    lib = ctypes.CDLL(str(Path(build_dir or BUILD) / f"lib{name}.so"))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    if build_dir is None:
        _functions[name] = fn
    return fn
