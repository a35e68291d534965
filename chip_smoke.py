#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc`` and exits non-zero without them.  It
builds every kernel from ``fast_solver_lippmann_schwinger_tpu_torch/csrc``
into ``build/`` (one ``nvcc`` per source, all started together), holds each
kernel against its plain PyTorch version, and drives the port's three paths
through the entry points a user calls: the 801 x 801, k = 800 plasma
scattering solve on the one-slab exact-solve path, the same solve with 16
slabs and the alternating bi-directional sweep (the reference's own
configuration), each single and two-direction, and the 48^3, k = 48 bump
scattering solve with the sparsifying preconditioner on bf16 plane pivots
(``examples/example3D.jl``), single and with two sources, beside the same
solve on dense complex64 pivots.  After each path it holds and times every
kernel of that path at the path's own shapes (r = 1 and r = 2 right-hand
sides; for the sweeps one slab picked among 16, full, truncated and resumed
passes; for the 3D solve the 48 planes of mn = 2304) on the solve's own pivot
planes.  The fourth path is the 96^3, k = 96 bump solve with the z-slab
Gauss-Seidel sweep on int8 y-plane pivots (the JAX package's ``ls3d_96``
benchmark: 6 slabs, npml = 8, ``yblock_int8_pallas``), single and with two
sources, beside the same sweep on bf16 y-planes; before it the int8 plane
kernels on random planes at its width, a small sweep solve on the card
against the CPU, and the 48^3 sweep in the z layout (cached and resumed slab
solves).  The fifth path is the 801 x 801 solve with 16 slabs and the double
sweep again, on banded+tail pivots (``pivot_dtype="pallas_banded_tail"``, band
width 201 by the w(n) rule), where every sweep direction is one launch of the
fused sweep kernels and every other slab solve runs the hybrid substitution
kernels; before it those four kernels on random factors and a 3-slab solve
that holds the fused sweep against the per-slab one.  The sixth path is the
same 16-slab double sweep on int8 line pivots (``pivot_dtype="pallas_int8"``),
whose slab solves run the int8 mode of the line kernels; before it those
kernels on random int8 factors at r = 1, 2 and 3 and a 3-slab int8 solve on
the card against the CPU.  The seventh is ``plasma2d.build_problem(
use_pallas=True)`` with every other argument at its default (full pivots with
bf16 kernel planes beside them), whose preconditioner applies run the stencil
matvec kernel; before it that kernel on a random field.  The eighth is the
reference's second headline example, the 401 x 401, k = 400 polarized-traces
integral system (``tests/plasma_integral_system_example.jl``:
``plasma_integral2d.build_problem(h=1/400, n_subdomains=8, npml=10, n_it=2,
pivot_dtype="pallas")``, the trapezoidal operator), one and two directions at
nIt = 2 and one at nIt = 1, whose local solves run the dense line kernels
with head starts and tails; after it every local-solve shape of that path,
timed from a CUDA graph, and the same solve on dense complex128 pivots as the
reference.  The ninth is the JAX package's record of the 3D polarized traces
(``RESULTS.md``, "3D polarized traces at 48^3": ``bump3d.build_problem(
h=1/48, precond="polarized_traces", n_subdomains=4, npml=6,
pivot_dtype="bf16_pallas")``), at nIt = 2 and 1 and through ``apply_batch``,
whose local solves run the fused bf16 plane passes with head starts and
tails; before it a 16^3 solve against its dense complex128 path, after it the
same 48^3 solve on dense complex128 pivots, one apply's host time beside its
device time, and the plane passes at the path's shapes, graph-timed.  The
same preconditioner also runs inside path 4, on the 96^3 problem's own int8
y-plane slabs.  The tenth is the reference's canonical example script
``examples/example.jl`` (``bump2d.build_problem()``: 201 x 201, k = 200, the
Greengard-Vico operator, the 2D sparsifying preconditioner on dense pivots):
the complex64 solve at rtol 1e-6, the complex128 solves with and without the
preconditioner (their count held to the JAX package's), the joint
two-direction solve, and the adjoint (the transpose pairing, the nu-gradient
of ``differentiable_solve`` against central differences).  The eleventh is
the JAX package's plain banded pivot modes: the 801 x 801 16-slab double
sweep on ``"banded_tail"`` pivots beside path 5's kernel layout of the same
pivots, and ``tests/test_banded_pivots.py``'s configuration in each mode, in
complex64 and complex128 (counts held to the JAX package's in complex128).
No hand-written kernel may launch on paths 10-11.  The twelfth is the user
surface: path 2's and path 9's problems as ``ProblemConfig``s through
``api.build_problem`` with a ``cache_dir`` under a fresh temporary directory
(removed at the end): cold, writing the checkpoints; the joint solve; the
CLI (``python -m fast_solver_lippmann_schwinger_tpu_torch``) in a subprocess
on the same directory, warm; a warm build in this process whose loaded
pivots must equal the built ones bit for bit; the 48^3 polarized solve cold,
then warm.  Each takes its path's count and kernels.  The thirteenth is
the multi-device layer (``parallel/``) on a mesh of one rank: an NCCL process
group on a ``FileStore`` under a fresh temporary directory and
``init_device_mesh("cuda", (1,), mesh_dim_names=("slab",))``; every leg is
held against the one-device solve of the same problem (the same iterations,
solutions within 1e-5, true residuals within 1e-3): path 2's 801^2 problem
on dense pivots through the masked sharded double sweep (one direction) and
through ``DistributedLS2D`` with the pipelined sweep (two), path 9's 48^3
problem through ``DistributedLS3D`` with the pipelined z-slab sweep and with
the sharded 3D polarized traces, path 8's 401^2 polarized traces, and the
96^3 capacity solve of ``benchmarks/capacity3d.py`` (8 z-slabs of bf16
y-planes, 22.2 GB, built slab by slab through ``fac_provider`` on path 4's
operator and stencils); no hand-written kernel may launch there, and a
system whose only pivots are a kernel layout is refused.  Every 2D line
kernel runs the flag-handoff line step (``csrc/thomas_flow.cuh``): the dense
forward and backward passes (rows 1, 2, 4 and 1i, 2i, 4i), the cached
forward pass (rows 3, 5, 6, 3i, 5i), the backward pass on banded+tail pivots
(row 7) and the fused sweeps (rows 8-9); after each path the script prints their
microseconds a line step and checks that repeated launches give the same
bits.  The fused plane passes of the 3D paths (rows 11, 12, 11i, 12i) run the
flag-handoff plane step (``csrc/plane_pass.cuh``): after the 48^3 and 96^3
paths the script prints their microseconds a plane step, with the same check.
Every line kernel takes up to sixteen right-hand sides a launch and every
plane kernel up to eight: paths 1, 2, 5 and 6 also solve eight and sixteen
plane-wave directions (angles 2 pi k / 8, then all sixteen at 2 pi k / 16)
jointly, the 48^3 z-layout sweep four and eight sources and path 4 eight,
each through ``gmres_batched`` with one launch of r = 16, 8 (or 4) a pass or
sweep direction, against the same directions solved as joint pairs (the
same counts, the solutions close, an apply of R directions making one
direction's launches), with ms per direction at R = 1, 2, 8 and 16; path 5
also runs one ``jacobi_sweep`` of the eight (the hybrid passes at one launch
a pass); the kernels line holds every line and sweep kernel at r = 3, 4, 8,
12 and 16 and every plane and plane-apply kernel at r = 3, 4 and 8 on those
solves' pivots.
Each phase prints one JSON line; any failed check raises, so the exit code is
non-zero.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fast_solver_lippmann_schwinger_tpu_torch import api
from fast_solver_lippmann_schwinger_tpu_torch.config import (
    DDMConfig,
    ProblemConfig,
    SolverConfig,
    move_to,
)
from fast_solver_lippmann_schwinger_tpu_torch.ddm import (
    polarized,
    polarized3d,
    subdomain,
    subdomain3d,
    sweeps,
)
from fast_solver_lippmann_schwinger_tpu_torch.models import (
    bump2d,
    bump3d,
    media,
    plasma2d,
    plasma_integral2d,
)
from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build, sampler
from fast_solver_lippmann_schwinger_tpu_torch.ops import stencil_kernels as stk
from fast_solver_lippmann_schwinger_tpu_torch.parallel import fft as pfft
from fast_solver_lippmann_schwinger_tpu_torch.parallel import polarized as ppolarized
from fast_solver_lippmann_schwinger_tpu_torch.parallel import polarized3d as ppolarized3d
from fast_solver_lippmann_schwinger_tpu_torch.parallel import sharded, sharded3d
from fast_solver_lippmann_schwinger_tpu_torch.precond.sparsifying import (
    SparsifyingPreconditionerT,
)
from fast_solver_lippmann_schwinger_tpu_torch.solver import adjoint
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres, gmres_batched
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct, stencils
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import sweep_kernels as sk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (
    card_name_and_power_limit,
    cuda_time_ms as time_ms,
)

# H100 SXM data-sheet peaks used for the bounds
PEAK_BYTES_PER_S = 3.35e12     # HBM3
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_BF16_TENSOR_FLOPS = 989e12  # bf16 on the tensor cores, dense

KERNEL_TOL = 1e-4              # of the max-norm; f32 summation order only
JAX_TPU_ITERATIONS = 6         # recorded by the JAX package for either solve
SOLVE_KW = dict(rtol=1e-6, restart=20, maxiter=12)

# kernel -> (wrapper that launches it, key of the wrapper's ``launches`` by
# pivot layout, or None where the wrapper has a single count)
COUNTERS = {
    "thomas_forward": (tk.forward_substitution, "bf16"),
    "thomas_forward_cached": (tk.forward_substitution_cached, "bf16"),
    "thomas_backward": (tk.backward_substitution, "bf16"),
    "thomas_forward_int8": (tk.forward_substitution, "int8"),
    "thomas_forward_cached_int8": (tk.forward_substitution_cached, "int8"),
    "thomas_backward_int8": (tk.backward_substitution, "int8"),
    "thomas_forward_ht": (tk.forward_substitution_cached, "ht"),
    "thomas_backward_ht": (tk.backward_substitution, "ht"),
    "plane_forward": (pk.plane_forward, "bf16"),
    "plane_backward": (pk.plane_backward, "bf16"),
    "plane_apply": (pk.plane_apply_rows, "bf16"),
    "plane_forward_int8": (pk.plane_forward, "int8"),
    "plane_backward_int8": (pk.plane_backward, "int8"),
    "plane_apply_int8": (pk.plane_apply_rows, "int8"),
    "sweep_down": (sk.sweep_down, None),
    "sweep_up": (sk.sweep_up, None),
    "stencil_matvec": (stk.stencil_matvec_2d, None),
}
_PORT = "fast_solver_lippmann_schwinger_tpu_torch/csrc/"
_TPU = "fast_solver_lippmann_schwinger_tpu/sparse/pallas_thomas.py"
_TPU_PLANE = "fast_solver_lippmann_schwinger_tpu/sparse/pallas_plane.py"
_TPU_SWEEP = "fast_solver_lippmann_schwinger_tpu/sparse/pallas_sweep.py"
_TPU_STENCIL = "fast_solver_lippmann_schwinger_tpu/ops/pallas_stencil.py"
# kernel -> route, name in a trace, source, and the TPU kernel body it
# replaces at r = 1 and at r = 2 (file:line)
KERNEL_INFO = {
    "thomas_forward": dict(
        route="cuda", kernel="thomas::flow_kernel<R, false, Storage::kBf16, SPLIT>",
        source=_PORT + "thomas_fwd.cu", replaces={1: f"{_TPU}:610", 2: f"{_TPU}:610"},
    ),
    "thomas_forward_cached": dict(
        route="cuda", kernel="thomas::cached_kernel<R, false, Storage::kBf16, SPLIT>",
        source=_PORT + "thomas_fwd_cached.cu", replaces={1: f"{_TPU}:221", 2: f"{_TPU}:546"},
    ),
    "thomas_backward": dict(
        route="cuda", kernel="thomas::flow_kernel<R, true, Storage::kBf16, SPLIT>",
        source=_PORT + "thomas_bwd.cu", replaces={1: f"{_TPU}:626", 2: f"{_TPU}:626"},
    ),
    "plane_forward": dict(
        route="cuda", kernel="plane::flow_kernel<R, false, Storage::kBf16>",
        source=_PORT + "plane_fwd.cu",
        replaces={1: f"{_TPU_PLANE}:339", 2: f"{_TPU_PLANE}:339"},
    ),
    "plane_backward": dict(
        route="cuda", kernel="plane::flow_kernel<R, true, Storage::kBf16>",
        source=_PORT + "plane_bwd.cu",
        replaces={1: f"{_TPU_PLANE}:366", 2: f"{_TPU_PLANE}:366"},
    ),
    "plane_apply": dict(
        route="cuda", kernel="plane::apply_kernel<R, Storage::kBf16>",
        source=_PORT + "plane_apply.cu",
        replaces={1: f"{_TPU_PLANE}:140", 2: f"{_TPU_PLANE}:140"},
    ),
    # the int8 mode of rows 10-12: the TPU kernels' nb > 1 branch of
    # _dot_plane (pallas_plane.py:314-326) inside the same bodies
    "plane_forward_int8": dict(
        route="cuda", kernel="plane::flow_kernel<R, false, Storage::kInt8>",
        source=_PORT + "plane_fwd.cu",
        replaces={1: f"{_TPU_PLANE}:339", 2: f"{_TPU_PLANE}:339"},
    ),
    "plane_backward_int8": dict(
        route="cuda", kernel="plane::flow_kernel<R, true, Storage::kInt8>",
        source=_PORT + "plane_bwd.cu",
        replaces={1: f"{_TPU_PLANE}:366", 2: f"{_TPU_PLANE}:366"},
    ),
    "plane_apply_int8": dict(
        route="cuda", kernel="plane::apply_kernel<R, Storage::kInt8>",
        source=_PORT + "plane_apply.cu",
        replaces={1: f"{_TPU_PLANE}:140", 2: f"{_TPU_PLANE}:140"},
    ),
    # the banded+tail layout: the hybrid pair and the fused sweep kernels
    "thomas_forward_ht": dict(
        route="cuda", kernel="thomas::cached_kernel<R, true, Storage::kBf16, SPLIT>",
        source=_PORT + "thomas_fwd_cached.cu", replaces={1: f"{_TPU}:928", 2: f"{_TPU}:928"},
    ),
    "thomas_backward_ht": dict(
        route="cuda", kernel="thomas::pass_map_kernel<R, true, Storage::kBf16, true, SPLIT>",
        source=_PORT + "thomas_bwd.cu", replaces={1: f"{_TPU}:957", 2: f"{_TPU}:957"},
    ),
    "sweep_down": dict(
        route="cuda", kernel="sweep::down_kernel<R, SPLIT>", source=_PORT + "sweep_fused.cu",
        replaces={1: f"{_TPU_SWEEP}:86", 2: f"{_TPU_SWEEP}:86"},
    ),
    "sweep_up": dict(
        route="cuda", kernel="sweep::up_kernel<R, SPLIT>", source=_PORT + "sweep_fused.cu",
        replaces={1: f"{_TPU_SWEEP}:157", 2: f"{_TPU_SWEEP}:157"},
    ),
    # the int8 mode of rows 1-5: the nb > 1 branch of _scaled_dots
    # (pallas_thomas.py:200-211) inside the same bodies
    "thomas_forward_int8": dict(
        route="cuda", kernel="thomas::flow_kernel<R, false, Storage::kInt8, SPLIT>",
        source=_PORT + "thomas_fwd.cu", replaces={1: f"{_TPU}:610", 2: f"{_TPU}:610"},
    ),
    "thomas_forward_cached_int8": dict(
        route="cuda", kernel="thomas::cached_kernel<R, false, Storage::kInt8, SPLIT>",
        source=_PORT + "thomas_fwd_cached.cu", replaces={1: f"{_TPU}:221", 2: f"{_TPU}:546"},
    ),
    "thomas_backward_int8": dict(
        route="cuda", kernel="thomas::flow_kernel<R, true, Storage::kInt8, SPLIT>",
        source=_PORT + "thomas_bwd.cu", replaces={1: f"{_TPU}:626", 2: f"{_TPU}:626"},
    ),
    "stencil_matvec": dict(
        route="cuda", kernel="stencil::matvec_kernel", source=_PORT + "stencil_matvec.cu",
        replaces={1: f"{_TPU_STENCIL}:75"},
    ),
}
# the step of each 2D line kernel and 3D plane pass: the flag-handoff line
# step of csrc/thomas_flow.cuh (flow_kernel, or run_flow driven by a step map)
# and the flag-handoff plane step of csrc/plane_pass.cuh (plane::flow_kernel)
FLOW_STEP = "flag-handoff"
for _info in KERNEL_INFO.values():
    if _info["source"].rsplit("/", 1)[-1] in ("thomas_fwd.cu", "thomas_bwd.cu",
                                              "thomas_fwd_cached.cu", "sweep_fused.cu",
                                              "plane_fwd.cu", "plane_bwd.cu"):
        _info["step"] = FLOW_STEP

# the 2D kernels by pivot layout: dense planes, banded+tail, fused sweeps
DENSE_2D = ("thomas_forward", "thomas_forward_cached", "thomas_backward")
HT_PAIR = ("thomas_forward_ht", "thomas_backward_ht")
SWEEP_PAIR = ("sweep_down", "sweep_up")
INT8_2D = ("thomas_forward_int8", "thomas_forward_cached_int8", "thomas_backward_int8")
INT8_PLANE = ("plane_forward_int8", "plane_backward_int8", "plane_apply_int8")
# on the sweeps' single-RHS path the backward kernel stands for _bwd_kernel
SWEEP_BACKWARD_R1 = f"{_TPU}:241"


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_counts():
    for fn, key in COUNTERS.values():
        if key is None:
            fn.launches = 0
        else:
            fn.launches[key] = 0


def read_counts() -> dict:
    """Launches of each kernel (:data:`COUNTERS`): ``thomas_*`` on dense bf16
    planes, ``thomas_*_int8`` on dense int8 planes, ``thomas_*_ht`` on
    banded+tail pivots; ``plane_*`` on bf16 planes, ``plane_*_int8`` on int8
    planes."""
    return {name: fn.launches if key is None else fn.launches[key]
            for name, (fn, key) in COUNTERS.items()}


def timed_solves(fn, repeats: int = 3, on_reset=None):
    """Run ``fn`` ``repeats`` times, each timed by CUDA events; the launch
    counts are set to 0 just before the last run (and ``on_reset()`` called).
    Returns the last result, every run's milliseconds, and the last run's
    launch counts."""
    times = []
    for i in range(repeats):
        if i == repeats - 1:
            reset_counts()
            if on_reset is not None:
                on_reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, times, read_counts()


def enqueue_ms(fn, repeats: int = 5) -> float:
    """Host milliseconds to enqueue ``fn()`` (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / repeats
    torch.cuda.synchronize()
    return ms


def rel_err(a: torch.Tensor, ref: torch.Tensor):
    abs_err = float((a - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def phase_device() -> str:
    smi = card_name_and_power_limit()
    emit(
        "device", name=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)),
        torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
        # the 3D annihilator Grams subtract nearly equal float32 products:
        # matmuls must run in full float32 (the port changes neither flag)
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        float32_matmul_precision=torch.get_float32_matmul_precision(),
    )
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls run in full float32")
    return smi


def phase_build():
    t0 = time.perf_counter()
    logs = cuda_build.build_kernels(verbose=True)
    for name in cuda_build.sources():
        cuda_build.load(name)
    seconds = time.perf_counter() - t0
    usage = sorted({
        line.strip() for log in logs.values() for line in log.splitlines()
        if "registers" in line or "spill" in line
    })
    # the host's OpenMP Hankel sampler of every 2D setup (g++, native/sampler.py)
    t0 = time.perf_counter()
    sampler.load_library()
    emit("build", seconds=seconds, sources=sorted(logs), ptxas=usage,
         sampler_seconds=time.perf_counter() - t0, sampler=str(sampler.library_path().name))


def random_factorization(rng, S: int, m: int, n: int, device) -> tk.ThomasFactorization:
    """Well-conditioned random factors: ||C_j|| ||band|| < 1, so the
    substitution recurrences contract and values stay O(1)."""
    ld = tk._round_up(n, tk.LEAD_MULTIPLE)

    def planes(diag):
        p = np.zeros((S, m, ld, ld), np.float32)
        p[:, :, :n, :n] = 0.1 * rng.standard_normal((S, m, n, n)) / np.sqrt(n)
        idx = np.arange(n)
        p[:, :, idx, idx] += diag
        return tk.tile_planes(torch.from_numpy(p).to(torch.bfloat16)).to(device)

    def bands():
        b = np.zeros((S, m, 2, 3, ld), np.float32)
        b[..., :n] = rng.uniform(-0.2, 0.2, (S, m, 2, 3, n))
        return torch.from_numpy(b).to(device)

    return tk.ThomasFactorization(
        cinv_t_re=planes(0.2), cinv_t_im=planes(0.0),
        lband=bands(), uband=bands(), n=n,
    )


def phase_kernels(device):
    """Both kernels against their plain versions at the main path's width
    on a short two-slab stack, r = 1 and 2, with and without start/tail."""
    rng = np.random.default_rng(0)
    S, m, n = 2, 64, 801
    fac = random_factorization(rng, S, m, n, device)
    s_idx = torch.tensor([1, 0], dtype=torch.int32, device=device)
    worst = dict.fromkeys(DENSE_2D, 0.0)
    cases = []
    for r in (1, 2):
        for start, tail in ((0, 0), (5, 0), (0, 7), (3, 9)):
            rows = np.zeros((S, m, 2 * r, fac.ld), np.float32)
            rows[:, start:, :, :n] = rng.standard_normal((S, m - start, 2 * r, n))
            b4 = torch.from_numpy(rows).to(device)
            y_k = tk.forward_substitution(fac, s_idx, b4, start=start)
            x_k = tk.backward_substitution(fac, s_idx, y_k, tail=tail)
            torch.cuda.synchronize()
            y_p = tk.forward_substitution_plain(fac, s_idx, b4, start=start)
            x_p = tk.backward_substitution_plain(fac, s_idx, y_k, tail=tail)
            _, e_f = rel_err(y_k, y_p)
            _, e_b = rel_err(x_k, x_p)
            check(bool(torch.isfinite(x_k).all()), "kernel output is finite")
            check(x_k.shape == x_p.shape, "backward output shape")
            worst["thomas_forward"] = max(worst["thomas_forward"], e_f)
            worst["thomas_backward"] = max(worst["thomas_backward"], e_b)
            cases.append(dict(r=r, start=start, tail=tail, fwd=e_f, bwd=e_b))
        # the cached forward kernel: a carry in (also at start = 0), y and t
        # stacks out, written in place on lines >= start only
        t_init = torch.zeros((S, 2 * r, fac.ld), device=device)
        t_init[..., :n] = torch.from_numpy(rng.standard_normal((S, 2 * r, n)).astype(np.float32)).to(device)
        for start, carry in ((0, None), (0, t_init), (40, t_init)):
            out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
            y_k, t_k = tk.forward_substitution_cached(fac, s_idx, b4, carry, start=start, out=out)
            torch.cuda.synchronize()
            zero = torch.zeros_like(t_init)
            y_p, t_p = tk.forward_substitution_cached_plain(
                fac, s_idx, b4, zero if carry is None else carry, start=start)
            _, e_y = rel_err(y_k[:, start:], y_p[:, start:])
            _, e_t = rel_err(t_k[:, start:], t_p[:, start:])
            check(bool((y_k[:, :start] == 7.0).all()) and bool((t_k[:, :start] == -7.0).all()),
                  "the cached forward kernel leaves the lines above its start alone")
            check(bool(torch.isfinite(t_k[:, start:]).all()), "cached forward output is finite")
            worst["thomas_forward_cached"] = max(worst["thomas_forward_cached"], e_y, e_t)
            cases.append(dict(r=r, start=start, t_init=carry is not None, fwd_cached_y=e_y,
                              fwd_cached_t=e_t))
    # times of the last case's shape with start = tail = 0 (S = 2, r = 2)
    y_k = tk.forward_substitution(fac, s_idx, b4)
    line_bytes = 2 * fac.ld * fac.ld * 2 + 2 * 3 * fac.ld * 4 + 2 * (2 * r * fac.ld * 4)
    bound_ms = 1e3 * S * m * line_bytes / PEAK_BYTES_PER_S
    timing = {
        "thomas_forward": dict(
            kernel_ms=time_ms(lambda: tk.forward_substitution(fac, s_idx, b4), 5),
            plain_ms=time_ms(lambda: tk.forward_substitution_plain(fac, s_idx, b4), 2)),
        "thomas_forward_cached": dict(
            kernel_ms=time_ms(lambda: tk.forward_substitution_cached(fac, s_idx, b4, t_init), 5),
            plain_ms=time_ms(lambda: tk.forward_substitution_cached_plain(fac, s_idx, b4, t_init), 2)),
        "thomas_backward": dict(
            kernel_ms=time_ms(lambda: tk.backward_substitution(fac, s_idx, y_k), 5),
            plain_ms=time_ms(lambda: tk.backward_substitution_plain(fac, s_idx, y_k), 2)),
    }
    emit("kernels", shape=dict(S=S, m=m, n=n, ld=fac.ld), tolerance=KERNEL_TOL,
         max_rel_err=worst, timing_r2=timing, bound_ms=bound_ms, cases=cases,
         launches=read_counts())
    for name, err in worst.items():
        check(err <= KERNEL_TOL, f"{name} within {KERNEL_TOL} of its plain version ({err})")


def phase_small_reference(device, n_subdomains: int, double_sweep: bool, rtol: float):
    """Kernel path (complex64, stopped at ``rtol``) against the dense
    full-precision path (complex128) on a small grid, for one configuration."""
    kw = dict(h=1 / 40, n_subdomains=n_subdomains, npml=6, double_sweep=double_sweep,
              device=device)
    p_k = plasma2d.build_problem(dtype=torch.complex64, pivot_dtype="pallas", **kw)
    p_f = plasma2d.build_problem(dtype=torch.complex128, pivot_dtype="full", **kw)
    x_k, i_k = plasma2d.solve(p_k, **dict(SOLVE_KW, rtol=rtol))
    x_f, i_f = plasma2d.solve(p_f, **SOLVE_KW)
    _, err = rel_err(x_k.to(torch.complex128), x_f)
    emit("small_reference", n=p_k.grid.n, n_subdomains=n_subdomains, double_sweep=double_sweep,
         rtol=[rtol, SOLVE_KW["rtol"]],
         iterations=[int(i_k.n_iterations), int(i_f.n_iterations)],
         true_residual=[float(i_k.true_residual), float(i_f.true_residual)],
         rel_err_vs_dense_complex128=err, tolerance=1e-4)
    check(bool(i_k.converged) and bool(i_f.converged), "small solves converged")
    check(err <= 1e-4, f"kernel-path solution within 1e-4 of the dense path ({err})")


def phase_solve(device, name: str, n_subdomains: int, double_sweep: bool, path_kernels,
                repeats: int, pivot_dtype: str = "pallas", jax_iterations=JAX_TPU_ITERATIONS,
                absent=()):
    """Build one 801 x 801 problem through ``plasma2d.build_problem`` and run
    ``plasma2d.solve`` on it; ``path_kernels`` must all have launched, the
    kernels of ``absent`` not at all."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = plasma2d.build_problem(
        h=1.0 / 800.0, n_subdomains=n_subdomains, npml=10, dtype=torch.complex64,
        double_sweep=double_sweep, pivot_dtype=pivot_dtype, device=device,
    )
    setup_s = time.perf_counter() - t0

    plasma2d.solve(problem, (1.0, 0.0), **SOLVE_KW)          # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: plasma2d.solve(problem, (1.0, 0.0), **SOLVE_KW), repeats)
    n_it = int(info.n_iterations)
    SOLVE_RESULTS[name] = dict(ms=sorted(times)[len(times) // 2], iterations=n_it,
                               x=x.cpu())
    emit(
        name, grid=[problem.grid.m, problem.grid.n], k=problem.k,
        n_subdomains=n_subdomains, double_sweep=double_sweep, pivot_dtype=pivot_dtype,
        setup_seconds=problem.setup_seconds, setup_total_seconds=setup_s,
        solve_ms=sorted(times)[len(times) // 2], solve_ms_runs=times, iterations=n_it,
        jax_tpu_iterations=jax_iterations, converged=bool(info.converged),
        residuals=[float(v) for v in info.residuals[: n_it + 1]],
        true_residual=float(info.true_residual),
        peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts,
    )
    check(tuple(x.shape) == (problem.grid.size,), "solution shape")
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "solution is finite")
    check(bool(info.converged), f"801^2 {name} converged")
    check(float(info.true_residual) <= 1e-3, "true residual <= 1e-3")
    check(all(counts[k] > 0 for k in path_kernels),
          f"every kernel of the path launched in {name} ({counts})")
    check(all(counts[k] == 0 for k in absent), f"no kernel of {absent} launched in {name}")
    return problem, counts


DIRECTIONS = ((1.0, 0.0), (0.0, 1.0))
# median solve milliseconds, iterations and the solution (on the host) of each
# phase_solve, by phase name; path 9's iterations under "polarized3d_solve"
SOLVE_RESULTS: dict = {}


def phase_solve_batched(problem, name: str, path_kernels, repeats: int,
                        jax_iterations=JAX_TPU_ITERATIONS, absent=()):
    dirs = DIRECTIONS
    plasma2d.solve_batched(problem, dirs, **SOLVE_KW)        # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: plasma2d.solve_batched(problem, dirs, **SOLVE_KW), repeats)
    ms = sorted(times)[len(times) // 2]
    SOLVE_RESULTS[name] = dict(ms=ms, iterations=[int(v) for v in info.n_iterations])
    emit(
        name, directions=dirs, solve_ms=ms, solve_ms_runs=times,
        ms_per_direction=ms / len(dirs),
        iterations=[int(v) for v in info.n_iterations],
        jax_tpu_iterations=[jax_iterations] * len(dirs),
        converged=[bool(v) for v in info.converged],
        true_residual=[float(v) for v in info.true_residual], launches=counts,
    )
    check(tuple(x.shape) == (len(dirs), problem.grid.size), "batched solution shape")
    check(bool(info.converged.all()), f"both directions converged in {name}")
    check(float(info.true_residual.max()) <= 1e-3, "batched true residuals <= 1e-3")
    check(all(counts[k] > 0 for k in path_kernels),
          f"every kernel of the path launched in {name} ({counts})")
    check(all(counts[k] == 0 for k in absent), f"no kernel of {absent} launched in {name}")
    return counts


def product_ms(flops: float, r: int) -> float:
    """Least milliseconds of a pass's products of ``flops`` operations: f32
    multiply-adds at r <= 2 (the card's float32 rate), tensor-core products
    at r = 4 and 8, where the rows enter as three bf16 terms
    (``csrc/wide_mma.cuh``: three times the operations at the bf16 rate)."""
    return 1e3 * (flops / PEAK_F32_FLOPS if r <= 2 else 3 * flops / PEAK_BF16_TENSOR_FLOPS)


def pass_bound(lines: int, n: int, ld: int, r: int, stacks: int):
    """Least time for ``lines`` lines of a substitution pass: the n input rows
    of two bf16 planes of ld output lanes (the kernels read no padding row),
    the band and ``stacks`` row stacks of 2r x ld floats per line (right-hand
    rows in, y/t/x rows out), plus the carry and the slab index, against the
    card's memory rate; the products of those entries (:func:`product_ms`)."""
    row = 2 * r * ld * 4
    line_bytes = 2 * n * ld * 2 + 2 * 3 * ld * 4 + stacks * row
    bytes_ms = 1e3 * (lines * line_bytes + row + 4) / PEAK_BYTES_PER_S
    flops_ms = product_ms(lines * 2 * (2 * (2 * r) * n * ld), r)
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def library_pass_ms(rows: torch.Tensor, dense_re, dense_im, lines, graph=False) -> float:
    """Yardstick: a loop of library bf16 matrix products of one (2r, ld) row
    block with the dense planes of ``lines`` (no band term, no dependency);
    ``graph`` times it from a CUDA graph, as :func:`kernel_entry` does the
    kernel it stands beside."""
    rows_bf16 = rows.to(torch.bfloat16)

    def loop():
        for j in lines:
            torch.matmul(rows_bf16, dense_re[j])
            torch.matmul(rows_bf16, dense_im[j])

    # a graph of 200 loops of a long pass would hold hundreds of thousands of
    # nodes: a few loops, as many products in all as 200 launches of one line
    return graph_ms(loop, launches=max(1, 200 // len(lines))) if graph else time_ms(loop, 2)


def graph_ms(fn, launches: int = 200, replays: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``launches`` calls captured into a
    CUDA graph and replayed, for a kernel that takes less time on the card
    than its wrapper on the host (back-to-back calls would time the host).
    The capture runs on a stream of its own whose exchange buffer starts
    fresh (``thomas_kernels.reset_exchange``): the graph then zeroes it and
    every replay of the flag-handoff passes waits on flags no earlier replay
    left."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    tk.reset_exchange(stream)
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def kernel_entry(name, r, path, launches, kernel, plain, bound, library_ms, shape,
                 variant="", replaces=None, graph=False) -> dict:
    """Hold one kernel against its plain version on the same inputs and time
    both; ``kernel``/``plain`` return the tensor (or tuple) to compare;
    ``graph`` times both from a CUDA graph (:func:`graph_ms`; pass the
    library yardstick timed the same way).  Otherwise the plain version's
    time is that of the call the comparison makes (CUDA events; a Python loop
    over lines or planes, whose warm-up changes nothing measurable)."""
    got = kernel()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_once_ms = start.elapsed_time(end)
    if isinstance(got, tuple):
        got, want = (torch.cat([t.reshape(-1) for t in ts]) for ts in (got, want))
    abs_err, err = rel_err(got, want)
    check(err <= KERNEL_TOL,
          f"{name}{variant} at the shape of {path} (r={r}) within {KERNEL_TOL} ({err})")
    info = dict(KERNEL_INFO[name])
    # r > 2 runs the body of the r = 2 TPU kernel (which takes any r)
    info["replaces"] = replaces or info["replaces"][min(r, 2)]
    return dict(
        name=f"{name}{variant}_r{r}", **info, path=path, launches=launches,
        max_abs_err=abs_err, max_rel_err=err, tolerance_rel=KERNEL_TOL,
        ms=graph_ms(kernel) if graph else time_ms(kernel, 5),
        plain_ms=graph_ms(plain, launches=20) if graph else plain_once_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms, shape=shape,
    )


def line_step_report(path: str, r: int, entries: list, runs: dict, phase: str = "line_step"):
    """Print microseconds a line step (``phase="plane_step"``: a plane step)
    of each kernel entry (``entries``: (entry, steps of one launch) pairs)
    and check that three more launches of each kernel (``runs``: name ->
    launch) give the same bits as the first: the flag handoff leaves no sum
    to timing."""
    identical = {}
    for name, fn in runs.items():
        outs = []
        for _ in range(4):
            got = fn()
            outs.append(tuple(t.clone() for t in got) if isinstance(got, tuple)
                        else (got.clone(),))
        identical[name] = all(all(torch.equal(a, b) for a, b in zip(o, outs[0]))
                              for o in outs[1:])
    emit(phase, path=path, r=r, bit_identical_over_repeats=identical,
         us_per_step={e["name"]: 1e3 * e["ms"] / steps for e, steps in entries})
    check(all(identical.values()), f"repeated launches give the same bits ({identical})")


def phase_kernel_times(problem, path_counts: dict) -> list:
    """Each kernel at the shapes of the one-slab paths (S = 1, m = n = 801;
    r = 1 for ``solve``, r = 2 for ``solve_batched``) on the solve's own pivot
    planes and right-hand sides: kernel against plain version, their times,
    the bound, and the library yardstick.  ``path_counts[r]`` holds the launch
    counts read after the path with r right-hand sides."""
    pc = problem.precond
    fac = pc.slabs.pfac
    m, n, ld = fac.m, fac.n, fac.ld
    s_idx = fac.slab_ids
    dense_re = tk.dense_planes(fac.cinv_t_re[0])       # (m, ld, ld) copies for
    dense_im = tk.dense_planes(fac.cinv_t_im[0])       # the library yardstick
    kernels = []
    for r, path in ((1, "solve"), (2, "solve_batched")):
        # right-hand sides of the path itself: As . (incident-field sources)
        rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:r]))     # (r, N)
        b = pc.a_s.matvec(rhs.T.contiguous()).reshape(1, m, n, r)
        b4 = tk._to_rows_b(fac, b)
        y4 = tk.forward_substitution(fac, s_idx, b4)
        library_ms = library_pass_ms(b4[0, 0], dense_re, dense_im, range(m))
        runs = {
            "thomas_forward": (
                lambda: tk.forward_substitution(fac, s_idx, b4),
                lambda: tk.forward_substitution_plain(fac, s_idx, b4),
            ),
            "thomas_backward": (
                lambda: tk.backward_substitution(fac, s_idx, y4),
                lambda: tk.backward_substitution_plain(fac, s_idx, y4),
            ),
        }
        for name, (kernel, plain) in runs.items():
            kernels.append(kernel_entry(
                name, r, path, path_counts[r][name], kernel, plain,
                pass_bound(m, n, ld, r, stacks=2), library_ms,
                dict(B=1, S=1, m=m, n=n, ld=ld, r=r)))
        # the flag-handoff step's line, and no race in its handoff: repeats of
        # each pass give the same bits (no sum depends on timing)
        repeats = {name: [kernel() for _ in range(3)] for name, (kernel, _) in runs.items()}
        identical = {name: all(torch.equal(out, outs[0]) for out in outs[1:])
                     for name, outs in repeats.items()}
        emit("line_step", path=path, r=r, m=m, n=n, bit_identical_over_repeats=identical,
             us_per_line={e["name"]: 1e3 * e["ms"] / m for e in kernels[-2:]})
        check(all(identical.values()), f"repeated passes give the same bits ({identical})")
    return kernels


def phase_sweeps(problem) -> dict:
    """One Gauss-Seidel and one block-Jacobi sweep over the 16 slabs at full
    width on the solve's own right-hand side.  The Jacobi sweep is the path
    that runs the plain forward kernel at one batch row per slab.  Also the
    times of a double-sweep apply (device, and the host's to enqueue it)."""
    pc = problem.precond
    rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:1]))[0]
    b = pc.a_s.matvec(rhs)
    reset_counts()
    u_gs = sweeps.gs_sweep(pc.slabs, b)
    torch.cuda.synchronize()
    counts_gs = read_counts()
    reset_counts()
    u_j = sweeps.jacobi_sweep(pc.slabs, b)
    torch.cuda.synchronize()
    counts_j = read_counts()
    res = {}
    for name, u in (("gs_sweep", u_gs), ("jacobi_sweep", u_j)):
        check(bool(torch.isfinite(torch.view_as_real(u)).all()), f"{name} output is finite")
        res[name] = float(torch.linalg.vector_norm(pc.msp.matvec(u) - b)
                          / torch.linalg.vector_norm(b))
    emit("sweeps", n_subdomains=pc.slabs.n_subs, m1_max=pc.slabs.m1_max,
         trace_tail=pc.slabs.trace_tail, residual_of_msp=res,
         gs_sweep_ms=time_ms(lambda: sweeps.gs_sweep(pc.slabs, b), 3),
         jacobi_sweep_ms=time_ms(lambda: sweeps.jacobi_sweep(pc.slabs, b), 3),
         apply_ms=time_ms(lambda: pc.apply(rhs), 3),
         apply_enqueue_ms=enqueue_ms(lambda: pc.apply(rhs), 3),
         launches=dict(gs_sweep=counts_gs, jacobi_sweep=counts_j))
    check(all(counts_j[name] > 0 for name in DENSE_2D),
          f"jacobi_sweep runs all three dense 2D kernels ({counts_j})")
    return counts_j


def phase_sweep_kernel_times(problem, path_counts: dict, jacobi_counts: dict) -> list:
    """Each kernel at the shapes of the 16-slab sweep paths, on the solve's own
    planes: one batch row, a slab picked among 16, m = m1_max lines; the cached
    forward pass in full and resumed at ``m - trace_tail``; the backward pass
    in full and truncated to ``trace_tail``; r = 1 for ``solve``, r = 2 for
    ``solve_batched``.  Then the batched pair at one batch row per slab
    (``jacobi_sweep``).  Also reports whether a resumed solve equals the full
    solve of the same right-hand side bit for bit."""
    pc = problem.precond
    slabs = pc.slabs
    fac = slabs.pfac
    S, m, n, ld, tail = fac.n_slabs, fac.m, fac.n, fac.ld, slabs.trace_tail
    j0 = m - tail
    slab = S // 2                                       # an inner slab
    s_idx = fac.slab_ids[slab : slab + 1]
    dense_re = tk.dense_planes(fac.cinv_t_re[slab])
    dense_im = tk.dense_planes(fac.cinv_t_im[slab])
    kernels, resume_checks = [], []
    for r, path in ((1, "sweep_solve"), (2, "sweep_solve_batched")):
        rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:r]))     # (r, N)
        cols = rhs.T.contiguous() if r > 1 else rhs[0]
        part = subdomain.partition_source(slabs, pc.a_s.matvec(cols))        # (S, m, n[, r])
        b4 = tk._to_rows_b(fac, part[slab : slab + 1])
        y4, t4 = tk.forward_substitution_cached(fac, s_idx, b4)
        # the up pass's right-hand side: new rows on the last `tail` lines
        b4_up = b4.clone()
        b4_up[:, j0:] += y4[:, j0:].flip(1)
        t_init = t4[:, j0 - 1].contiguous()
        shape = dict(B=1, S=S, slab=slab, m=m, n=n, ld=ld, r=r)
        lib_full = library_pass_ms(b4[0, 0], dense_re, dense_im, range(m))
        lib_tail = library_pass_ms(b4[0, 0], dense_re, dense_im, range(j0, m))
        counts = path_counts[r]

        # a resumed pass writes lines >= j0 of the stacks it is handed
        out_k, out_p = (y4.clone(), t4.clone()), (y4.clone(), t4.clone())

        def resumed(fn, out):
            y, t = fn(fac, s_idx, b4_up, t_init, start=j0, out=out)
            return y[:, j0:], t[:, j0:]

        zero = torch.zeros_like(t_init)
        replaces_bwd = SWEEP_BACKWARD_R1 if r == 1 else None
        kernels += [
            kernel_entry(
                "thomas_forward_cached", r, path, counts["thomas_forward_cached"],
                lambda: tk.forward_substitution_cached(fac, s_idx, b4),
                lambda: tk.forward_substitution_cached_plain(fac, s_idx, b4, zero),
                pass_bound(m, n, ld, r, stacks=3), lib_full, shape),
            kernel_entry(
                "thomas_forward_cached", r, path, counts["thomas_forward_cached"],
                lambda: resumed(tk.forward_substitution_cached, out_k),
                lambda: resumed(tk.forward_substitution_cached_plain, out_p),
                pass_bound(tail, n, ld, r, stacks=3), lib_tail, dict(shape, start=j0),
                variant="_resumed"),
            kernel_entry(
                "thomas_backward", r, path, counts["thomas_backward"],
                lambda: tk.backward_substitution(fac, s_idx, y4),
                lambda: tk.backward_substitution_plain(fac, s_idx, y4),
                pass_bound(m, n, ld, r, stacks=2), lib_full, shape,
                variant="_slab", replaces=replaces_bwd),
            kernel_entry(
                "thomas_backward", r, path, counts["thomas_backward"],
                lambda: tk.backward_substitution(fac, s_idx, y4, tail=tail),
                lambda: tk.backward_substitution_plain(fac, s_idx, y4, tail=tail),
                pass_bound(tail, n, ld, r, stacks=2), lib_tail, dict(shape, tail=tail),
                variant="_slab_tail", replaces=replaces_bwd),
        ]
        line_step_report(path, r, [(kernels[-4], m), (kernels[-3], tail)], {
            "thomas_forward_cached": lambda: tk.forward_substitution_cached(fac, s_idx, b4),
            "thomas_forward_cached_resumed": lambda: resumed(tk.forward_substitution_cached,
                                                             out_k)})
        # solve_resume against solve on the same right-hand side
        rhs_slab = part[slab]
        _, y_c, t_c = tk.solve_cached(fac, slab, rhs_slab, tail)
        rhs_up = rhs_slab.clone()
        rhs_up[j0:] += rhs_slab[:tail].flip(0) + 1.0
        x_res = tk.solve_resume(fac, slab, rhs_up, y_c, t_c, tail)
        x_full = tk.solve(fac, slab, rhs_up)
        _, err = rel_err(x_res, x_full)
        resume_checks.append(dict(r=r, bit_equal=bool(torch.equal(x_res, x_full)), rel_err=err))
        check(err <= KERNEL_TOL, f"solve_resume within {KERNEL_TOL} of solve (r={r}: {err})")
    emit("resume_equals_full_solve", slab=slab, resume=tail, cases=resume_checks)

    # the batched pair with one batch row per slab (jacobi_sweep's solve_all)
    rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:1]))[0]
    b4 = tk._to_rows_b(fac, subdomain.partition_source(slabs, pc.a_s.matvec(rhs)))
    y4 = tk.forward_substitution(fac, fac.slab_ids, b4)
    shape = dict(B=S, S=S, m=m, n=n, ld=ld, r=1)
    bound = pass_bound(S * m, n, ld, 1, stacks=2)
    # the same count of products of the same shapes, on one slab's planes
    lib_all = library_pass_ms(b4[0, 0], dense_re, dense_im, list(range(m)) * S)
    runs = {
        "thomas_forward": (lambda: tk.forward_substitution(fac, fac.slab_ids, b4),
                           lambda: tk.forward_substitution_plain(fac, fac.slab_ids, b4)),
        "thomas_backward": (lambda: tk.backward_substitution(fac, fac.slab_ids, y4),
                            lambda: tk.backward_substitution_plain(fac, fac.slab_ids, y4)),
    }
    for name, (kernel, plain) in runs.items():
        kernels.append(kernel_entry(name, 1, "jacobi_sweep", jacobi_counts[name], kernel, plain,
                                    bound, lib_all, shape, variant="_all_slabs"))
    return kernels

# ---------------------------------------------------------------------------
# Wide batches: up to eight right-hand sides in one launch of a plane kernel
# and sixteen in one of a line kernel (the joint solves of paths 1, 2, 4, 5
# and 6)
# ---------------------------------------------------------------------------

WIDE_R = 8
LINE_R = 16                         # the widest launch of the line kernels
# plane-wave directions at angles 2 pi k / 16 (examples/example_multisource2d.py;
# in 3D in the x-y plane), those at 2 pi k / 8 first: the R = 8 solves take
# the first eight, the R = 16 ones all sixteen
WIDE_DIRECTIONS = tuple((float(np.cos(2 * np.pi * k / LINE_R)),
                         float(np.sin(2 * np.pi * k / LINE_R)))
                        for k in tuple(range(0, LINE_R, 2)) + tuple(range(1, LINE_R, 2)))
WIDE_RS = (3, 4, 8)                 # the wide entries of the kernels line
LINE_RS = WIDE_RS + (12, LINE_R)    # ... of the line kernels (r = 12 one launch of 16)
LINE_STEP_RS = (4, 8, LINE_R)       # the launch widths of the wide step


def wide_counts_of(wide: dict, r: int) -> dict:
    """The launches of the joint solve whose launch width carries ``r``
    right-hand sides (R = 8 up to eight, R = 16 above)."""
    return wide[WIDE_R if r <= WIDE_R else LINE_R]
# each direction's solution against its joint-pair solve: 1e-5, or twice the
# spread between the path's own r = 1 and r = 2 solves of the first direction
# where that is larger.  Launches of different widths sum in different orders
# (at 801 lanes r = 8 takes two CTAs a tile, r <= 2 one), and a complex64
# solve stopped at rtol 1e-6 carries such rounding into its solution: at
# 801^2 the r = 1 and r = 2 solves of one direction differ by 2.6e-4 on the
# parent's kernels (PERF.md, PR 16), the 48^3 ones by 4.6e-6
WIDE_SOLUTION_LIMIT = 1e-5
WIDE_TRUE_RESIDUAL_LIMIT = 1e-3


def launches_of(fn) -> dict:
    """Launches of one ``fn()``: the counts set to 0 just before it and read
    just after."""
    reset_counts()
    fn()
    torch.cuda.synchronize()
    return read_counts()


def phase_wide_solves(name: str, solve, rhs: torch.Tensor, apply_one, apply_batch, widths,
                      ms_per_direction: dict, path_kernels, allowed=(), repeats: int = 3,
                      true_residual_limit: float = WIDE_TRUE_RESIDUAL_LIMIT) -> dict:
    """The joint solve of the first R wide directions for each R of
    ``widths`` (``solve(a, b)``: directions a .. b - 1 in one
    ``gmres_batched``; warm-up, median of ``repeats``), every substitution
    pass one launch of R right-hand sides; then the same directions again as
    joint pairs (the r = 2 launches).  Checks every direction converged with
    a true residual within the limit, its iteration count equal to the pair
    solve's and its solution within 1e-5 of it (or within twice the spread
    between the r = 1 and r = 2 solves of the first direction,
    ``WIDE_SOLUTION_LIMIT``); and, from the wrapper
    counters, that one preconditioner apply of R directions (``apply_batch``
    of ``rhs[:R]``) launches exactly what the apply of a pair does, kernel by
    kernel, and as many kernels as the single-direction apply
    (``apply_one(rhs[0])``): one launch a pass.  ``ms_per_direction`` holds
    the path's R = 1 and 2 figures; every kernel of ``path_kernels`` must
    launch, no kernel outside them and ``allowed``.  Returns the launch counts
    of each width's joint solve."""
    top = max(widths)
    allowed = tuple(path_kernels) + tuple(allowed)
    (pairs, times_pairs, _) = timed_solves(
        lambda: [solve(i, i + 2) for i in range(0, top, 2)], 1)
    x_pairs = torch.cat([x for x, _ in pairs])
    its_pairs = [int(v) for _, info in pairs for v in info.n_iterations]
    x_one, _ = solve(0, 1)
    spread = rel_err(x_one[0], x_pairs[0])[1]
    limit = max(WIDE_SOLUTION_LIMIT, 2 * spread)
    applies = {1: launches_of(lambda: apply_one(rhs[0])),
               2: launches_of(lambda: apply_batch(rhs[:2]))}
    out, report = {}, {}
    for width in widths:
        solve(0, width)                                       # warm-up
        torch.cuda.synchronize()
        (x, info), times, counts = timed_solves(lambda: solve(0, width), repeats)
        applies[width] = launches_of(lambda: apply_batch(rhs[:width]))
        ms = sorted(times)[len(times) // 2]
        its = [int(v) for v in info.n_iterations]
        errs = [rel_err(x[q], x_pairs[q])[1] for q in range(width)]
        report[width] = dict(
            solve_ms=ms, solve_ms_runs=times, ms_per_direction=ms / width, iterations=its,
            converged=[bool(v) for v in info.converged],
            true_residual=[float(v) for v in info.true_residual],
            rel_err_vs_pairs=errs, launches=counts)
        out[width] = counts
        check(tuple(x.shape) == (width, x_pairs.shape[1]), f"{name}: solution shape (R={width})")
        check(bool(torch.isfinite(torch.view_as_real(x)).all()), f"{name}: solution is finite")
        check(bool(info.converged.all()), f"{name}: every direction converged (R={width}: {its})")
        check(float(info.true_residual.max()) <= true_residual_limit,
              f"{name}: true residuals <= {true_residual_limit} (R={width})")
        check(its == its_pairs[:width],
              f"{name}: each direction takes its joint-pair count ({its}, {its_pairs[:width]})")
        check(max(errs) <= limit,
              f"{name}: solutions within {limit} of the pair solves ({errs})")
        check(all(counts[k] > 0 for k in path_kernels)
              and not any(counts[k] for k in COUNTERS if k not in allowed),
              f"{name}: the path's kernels launched, and no other (R={width}: {counts})")
        check(applies[width] == applies[2]
              and sum(applies[width].values()) == sum(applies[1].values()),
              f"{name}: an apply of {width} directions makes the launches of one direction's "
              f"({applies[width]}, {applies[2]}, {applies[1]})")
    pair_ms = sorted(times_pairs)[len(times_pairs) // 2]
    per_direction = dict(ms_per_direction)
    per_direction.update({w: report[w]["ms_per_direction"] for w in widths})
    emit(name, directions=[list(d) for d in WIDE_DIRECTIONS[:top]], widths=list(widths),
         ms_per_direction=per_direction,
         pairs=dict(solve_ms=pair_ms, ms_per_direction=pair_ms / top, iterations=its_pairs),
         runs={w: report[w] for w in widths}, apply_launches=applies,
         r1_vs_r2_spread=spread, solution_limit=limit, true_residual_limit=true_residual_limit)
    return out


def phase_wide_2d(problem, name: str, single: str, batched: str, path_kernels,
                  allowed=()) -> dict:
    """Path 1's, 2's, 5's or 6's problem: ``plasma2d.solve_batched`` over the
    first eight wide directions (R = 8) and over all sixteen (R = 16, one
    launch of sixteen a pass), beside the path's single and two-direction
    solves (``single``, ``batched``: their phases)."""
    rhs = plasma2d.incident_rhs(problem, np.asarray(WIDE_DIRECTIONS))
    ms = {1: SOLVE_RESULTS[single]["ms"], 2: SOLVE_RESULTS[batched]["ms"] / 2}
    return phase_wide_solves(
        name, lambda a, b: plasma2d.solve_batched(problem, WIDE_DIRECTIONS[a:b], **SOLVE_KW),
        rhs, problem.precond.apply, problem.precond.apply_batch, (WIDE_R, LINE_R), ms,
        path_kernels, allowed)


def wide_line_entries(problem, path: str, wide: dict) -> list:
    """The dense line kernels of a 2D path at r = 3, 4, 8, 12 and 16 (one
    launch each: r = 3 padded to four, 12 to sixteen) on the solve's own
    planes and right-hand sides (As b of the first r wide directions): on one
    slab the forward and backward passes over its 801 lines; with 16 slabs
    the cached forward pass and the backward pass on an inner slab's lines,
    in the path's storage.  ``wide`` holds the launches of the path's R = 8
    and R = 16 joint solves (:func:`wide_counts_of`)."""
    pc = problem.precond
    slabs = pc.slabs
    fac = slabs.pfac
    S, m, n, ld = fac.n_slabs, fac.m, fac.n, fac.ld
    slab = S // 2
    s_idx = fac.slab_ids[slab : slab + 1]
    int8 = fac.storage == "int8"
    suffix = "_int8" if int8 else ""
    bound = int8_pass_bound if int8 else pass_bound
    dense_re = tk.dense_planes(fac.cinv_t_re[slab]).to(torch.bfloat16)
    dense_im = tk.dense_planes(fac.cinv_t_im[slab]).to(torch.bfloat16)
    kernels = []
    for r in LINE_RS:
        counts = wide_counts_of(wide, r)
        rhs = plasma2d.incident_rhs(problem, np.asarray(WIDE_DIRECTIONS[:r]))   # (r, N)
        b = pc.a_s.matvec(rhs.T.contiguous())
        part = (b.reshape(1, m, n, r) if S == 1 else subdomain.partition_source(slabs, b))
        b4 = tk._to_rows_b(fac, part[slab : slab + 1])
        shape = dict(B=1, S=S, slab=slab, m=m, n=n, ld=ld, r=r,
                     launch_width=tk.line_width(fac, r))
        lib = library_pass_ms(b4[0, 0], dense_re, dense_im, range(m))
        if S == 1:
            y4 = tk.forward_substitution(fac, s_idx, b4)
            runs = (("thomas_forward", "",
                     lambda: tk.forward_substitution(fac, s_idx, b4),
                     lambda: tk.forward_substitution_plain(fac, s_idx, b4), 2),
                    ("thomas_backward", "",
                     lambda: tk.backward_substitution(fac, s_idx, y4),
                     lambda: tk.backward_substitution_plain(fac, s_idx, y4), 2))
        else:
            y4, _ = tk.forward_substitution_cached(fac, s_idx, b4)
            zero = torch.zeros_like(b4[:, 0])
            runs = (("thomas_forward_cached" + suffix, "",
                     lambda: tk.forward_substitution_cached(fac, s_idx, b4),
                     lambda: tk.forward_substitution_cached_plain(fac, s_idx, b4, zero), 3),
                    ("thomas_backward" + suffix, "_slab",
                     lambda: tk.backward_substitution(fac, s_idx, y4),
                     lambda: tk.backward_substitution_plain(fac, s_idx, y4), 2))
        for kname, variant, kernel, plain, stacks in runs:
            entry = kernel_entry(kname, r, path, counts[kname], kernel, plain,
                                 bound(m, n, ld, r, stacks=stacks), lib, shape, variant=variant)
            if int8:
                entry["library_call"] = LIBRARY_CALL_INT8
            kernels.append(entry)
        if r in LINE_STEP_RS:
            # the wide step's line (PERF.md section 6), and no race in its
            # handoff: repeats of each pass give the same bits
            line_step_report(path, r, [(e, m) for e in kernels[-len(runs):]],
                             {kname + variant: kernel
                              for kname, variant, kernel, _, _ in runs})
    del dense_re, dense_im
    return kernels


# ---------------------------------------------------------------------------
# The 3D path: the 48^3 bump solve on bf16 plane pivots
# ---------------------------------------------------------------------------

BUMP3D_H = 1.0 / 48.0
BUMP3D_SOLVE_KW = dict(rtol=1e-6, restart=20, maxiter=16)
JAX_ITERATIONS_3D_FULL_1E8 = 13     # RESULTS.md: full complex64 pivots, rtol 1e-8


def random_plane_view(rng, l: int, m: int, n: int, device) -> pk.PlaneSlabView:
    """Contracting random plane factors (||P|| ||S|| < 1) in the kernels'
    layout, so that the passes' recurrences keep values O(1)."""
    mn = m * n
    ld = tk._round_up(mn, tk.LEAD_MULTIPLE)
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))

    def planes(diag):
        p = torch.zeros((l, ld, ld), dtype=torch.bfloat16, device=device)
        p[:, :mn, :mn] = (0.1 / mn ** 0.5) * torch.randn((l, mn, mn), generator=g, device=device)
        idx = torch.arange(mn, device=device)
        p[:, idx, idx] += diag
        return tk.tile_planes(p)

    def sten():
        s = rng.uniform(-0.05, 0.05, (l, m, n, 3, 3, 2)).astype(np.float32)
        return torch.view_as_complex(torch.from_numpy(s)).to(device)

    stack = pk.PlaneStack(p_re=planes(0.2), p_im=planes(0.0), mn=mn, l1=l)
    return pk.PlaneSlabView(stack=stack, lsten=sten(), usten=sten())


def plane_kernel_cases(view, starts, suffix: str = "") -> tuple[dict, list]:
    """The three plane kernels against their plain versions on one view,
    r = 1 and 2: the forward pass from each of ``starts``, with and without a
    carry, with and without the t stack (``collect_t``), planes above the
    start left alone; the backward pass full and with a tail of 2; one plane
    apply at the first and last planes.  Returns the worst relative error by
    kernel (names + ``suffix``) and every case."""
    rng = np.random.default_rng(view.stack.mn)
    st, ld, mn, l = view.stack, view.stack.ld, view.stack.mn, view.stack.l1
    n = view.lsten.shape[2]
    fwd, bwd, app = (f"plane_{k}{suffix}" for k in ("forward", "backward", "apply"))
    worst = {fwd: 0.0, bwd: 0.0, app: 0.0}
    cases = []
    for r in (1, 2):
        b4 = torch.zeros((l, 2 * r, ld), device=st.p_re.device)
        b4[..., :mn] = torch.from_numpy(rng.standard_normal((l, 2 * r, mn)).astype(np.float32))
        t_init = torch.zeros((2 * r, ld), device=st.p_re.device)
        t_init[:, :mn] = torch.from_numpy(rng.standard_normal((2 * r, mn)).astype(np.float32))
        for start in starts:
            for carry in (None, t_init):
                out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
                y_k, t_k = pk.plane_forward(st, b4, view.lrows, n, 0, start, carry, out=out)
                y_k2, none = pk.plane_forward(st, b4, view.lrows, n, 0, start, carry,
                                              collect_t=False)
                torch.cuda.synchronize()
                y_p, t_p = pk.plane_forward_plain(st, b4, view.lrows, n, 0, start, carry)
                _, e_y = rel_err(y_k[start:], y_p[start:])
                _, e_t = rel_err(t_k[start:], t_p[start:])
                _, e_y2 = rel_err(y_k2[start:], y_p[start:])
                check(bool((y_k[:start] == 7.0).all()) and bool((t_k[:start] == -7.0).all()),
                      "the forward plane kernel leaves the planes above its start alone")
                check(bool(torch.isfinite(t_k[start:]).all()), "plane forward output is finite")
                check(none is None, "no t stack without collect_t")
                worst[fwd] = max(worst[fwd], e_y, e_t, e_y2)
                cases.append(dict(r=r, start=start, t_init=carry is not None, fwd_y=e_y,
                                  fwd_t=e_t, fwd_y_without_t_stack=e_y2))
        y4 = pk.plane_forward(st, b4, view.lrows, n)[0]
        for tail in (0, 2):
            start = tail and l - tail
            x_k = pk.plane_backward(st, y4, view.urows, n, 0, start)
            torch.cuda.synchronize()
            x_p = pk.plane_backward_plain(st, y4, view.urows, n, 0, start)
            _, e_x = rel_err(x_k, x_p)
            check(bool(torch.isfinite(x_k).all()) and not bool(x_k[:start].any()),
                  "plane backward output is finite, zero above its tail")
            worst[bwd] = max(worst[bwd], e_x)
            cases.append(dict(r=r, tail=tail, bwd=e_x))
        for k in (0, l - 1):
            z_k = pk.plane_apply_rows(st, k, b4[k])
            torch.cuda.synchronize()
            _, e_a = rel_err(z_k, pk.plane_apply_rows_plain(st, k, b4[k]))
            worst[app] = max(worst[app], e_a)
            cases.append(dict(r=r, plane=k, apply=e_a))
    return worst, cases


def phase_plane_kernels(device):
    """The three plane kernels against their plain versions on a short
    random bf16 stack at the 48^3 path's width (6 planes, mn = 2304)."""
    rng = np.random.default_rng(1)
    l, m, n = 6, 48, 48
    view = random_plane_view(rng, l, m, n, device)
    worst, cases = plane_kernel_cases(view, (0, 3))
    emit("plane_kernels", shape=dict(l=l, m=m, n=n, mn=view.stack.mn, ld=view.stack.ld),
         tolerance=KERNEL_TOL, max_rel_err=worst, cases=cases)
    for name, err in worst.items():
        check(err <= KERNEL_TOL, f"{name} within {KERNEL_TOL} of its plain version ({err})")


def phase_small_reference_3d(device):
    """The kernel path (complex64, bf16 plane pivots) against the dense path
    (complex128, full pivots) on a 16^3 grid.  The complex64 solve stops at
    rtol 1e-5: on this grid its preconditioned residual stalls at the float32
    floor, about 1.5e-6 of its start (at 48^3 the floor is far below 1e-6)."""
    p_k = bump3d.build_problem(h=1 / 16, dtype=torch.complex64, pivot_dtype="bf16_pallas",
                               device=device)
    p_f = bump3d.build_problem(h=1 / 16, dtype=torch.complex128, pivot_dtype="full",
                               device=device)
    x_k, i_k = bump3d.solve(p_k, rtol=1e-5, restart=20, maxiter=16)
    x_f, i_f = bump3d.solve(p_f, rtol=1e-8, restart=20, maxiter=16)
    _, err = rel_err(x_k.to(torch.complex128), x_f)
    emit("small_reference_3d", n=p_k.grid.n, rtol=[1e-5, 1e-8],
         iterations=[int(i_k.n_iterations), int(i_f.n_iterations)],
         true_residual=[float(i_k.true_residual), float(i_f.true_residual)],
         rel_err_vs_dense_complex128=err, tolerance=1e-4)
    check(bool(i_k.converged) and bool(i_f.converged), "small 3D solves converged")
    check(err <= 1e-4, f"3D kernel-path solution within 1e-4 of the dense path ({err})")


def plane_wave_rhs(problem, axis: int) -> torch.Tensor:
    """``-(M u - u)`` for the plane wave ``exp(i k x_axis)`` (axis 0: x, the
    problem's own incident field; 1: y)."""
    X, Y, _ = problem.grid.mesh()
    coord = torch.as_tensor((X, Y)[axis].ravel(), device=problem.rhs.device)
    u = torch.exp(1j * problem.k * coord).to(problem.rhs.dtype)
    return -(problem.op.apply(u) - u)


def plane_waves_3d(problem, r: int) -> torch.Tensor:
    """``-(M u - u)`` for the plane waves ``exp(i k d . x)`` of the first r
    wide directions d (in the x-y plane; the first is the problem's own x
    wave), as an (r, N) batch."""
    X, Y, _ = problem.grid.mesh()
    out = []
    for dx, dy in WIDE_DIRECTIONS[:r]:
        phase = torch.as_tensor((dx * X + dy * Y).ravel(), device=problem.rhs.device)
        u = torch.exp(1j * problem.k * phase).to(problem.rhs.dtype)
        out.append(-(problem.op.apply(u) - u))
    return torch.stack(out)


def phase_wide_3d(problem, name: str, widths, ms_per_direction: dict, path_kernels,
                  solve_kw: dict) -> dict:
    """``gmres_batched`` of the first R wide plane waves over the problem's
    preconditioner ``apply_batch``, the route of ``api.solve_problem_batched``
    (``SingleSweepPreconditioner3D``: As b, then the z-slab sweep, the body
    of ``GSPreconditioner3D.apply_batch``), for each R of ``widths``."""
    pc = problem.precond
    rhs = plane_waves_3d(problem, max(widths))
    return phase_wide_solves(
        name, lambda a, b: gmres_batched(problem.op.apply, rhs[a:b],
                                         preconditioner=pc.apply_batch, **solve_kw),
        rhs, pc.apply, pc.apply_batch, widths, ms_per_direction, path_kernels)


def phase_bump3d_solve(device, repeats: int = 3):
    """``bump3d.build_problem(h=1/48, complex64, "sparsifying", "bf16_pallas")``
    and ``bump3d.solve`` at rtol 1e-6: three timed solves after a warm-up,
    then the joint two-source solve through ``apply_batch`` (r = 2).  Beside
    it, the same problem on dense complex64 pivots at rtol 1e-8 (the JAX
    package's recorded count) and at 1e-6."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = bump3d.build_problem(h=BUMP3D_H, dtype=torch.complex64, precond="sparsifying",
                                   pivot_dtype="bf16_pallas", device=device)
    setup_s = time.perf_counter() - t0
    bump3d.solve(problem, **BUMP3D_SOLVE_KW)                  # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: bump3d.solve(problem, **BUMP3D_SOLVE_KW), repeats)
    peak = torch.cuda.max_memory_allocated()
    n_it = int(info.n_iterations)

    pc = problem.precond
    rhs2 = torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])
    (x2, info2), times2, counts2 = timed_solves(
        lambda: gmres_batched(problem.op.apply, rhs2, preconditioner=pc.apply_batch,
                              **BUMP3D_SOLVE_KW), repeats)

    full = bump3d.build_problem(h=BUMP3D_H, dtype=torch.complex64, precond="sparsifying",
                                pivot_dtype="full", device=device)
    x8, info8 = bump3d.solve(full, rtol=1e-8, restart=20, maxiter=40)
    _, info6 = bump3d.solve(full, **BUMP3D_SOLVE_KW)
    _, err = rel_err(x, x8)
    emit(
        "bump3d_solve", grid=list(problem.grid.shape), k=problem.k, unknowns=problem.grid.size,
        pivot_dtype="bf16_pallas", setup_seconds=problem.setup_seconds,
        setup_total_seconds=setup_s, solve_ms=sorted(times)[len(times) // 2],
        solve_ms_runs=times, iterations=n_it, converged=bool(info.converged),
        residuals=[float(v) for v in info.residuals[: n_it + 1]],
        true_residual=float(info.true_residual), peak_memory_bytes=peak, launches=counts,
        two_sources=dict(solve_ms=sorted(times2)[len(times2) // 2], solve_ms_runs=times2,
                         iterations=[int(v) for v in info2.n_iterations],
                         converged=[bool(v) for v in info2.converged],
                         true_residual=[float(v) for v in info2.true_residual],
                         launches=counts2),
        full_pivots=dict(
            setup_seconds=full.setup_seconds,
            rtol_1e8=dict(iterations=int(info8.n_iterations), converged=bool(info8.converged),
                          jax_package_iterations=JAX_ITERATIONS_3D_FULL_1E8,
                          residuals=[float(v) for v in
                                     info8.residuals[: int(info8.n_iterations) + 1]],
                          true_residual=float(info8.true_residual)),
            rtol_1e6=dict(iterations=int(info6.n_iterations), converged=bool(info6.converged),
                          true_residual=float(info6.true_residual))),
        rel_err_vs_full_pivots_rtol_1e8=err,
    )
    check(tuple(x.shape) == (problem.grid.size,), "3D solution shape")
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "3D solution is finite")
    check(bool(info.converged) and n_it <= BUMP3D_SOLVE_KW["maxiter"],
          f"48^3 solve converged within maxiter ({n_it})")
    check(float(info.true_residual) <= 1e-3, "3D true residual <= 1e-3")
    check(bool(info2.converged.all()) and float(info2.true_residual.max()) <= 1e-3,
          "two-source 3D solve converged")
    check(err <= 1e-3, f"bf16 solution within 1e-3 of the full-pivot one ({err})")
    for c in (counts, counts2):
        check(c["plane_forward"] > 0 and c["plane_backward"] > 0,
              f"both fused plane kernels launched on the 3D path ({c})")
    del full, x8
    torch.cuda.empty_cache()
    return problem, {1: counts, 2: counts2}


PLANE_APPLY_RS = (1, 2) + WIDE_RS


def phase_plane_apply_path(problem) -> dict:
    """One ``block_thomas_solve_3d`` at 48^3 through the per-plane branch
    (``fused=False``: one plane apply per plane and pass) against the fused
    branch on the same planes and right-hand sides, for r = 1, 2 (the x and
    y waves) and 3, 4, 8 (wide directions: one apply launch a plane and
    pass).  Returns the launch counts of the per-plane solves by r."""
    view = problem.precond.factorization
    rhs2 = torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])
    counts, errs = {}, {}
    for r in PLANE_APPLY_RS:
        sources = rhs2[:r] if r <= 2 else plane_waves_3d(problem, r)
        b = problem.precond.a_s.matvec(sources.T.contiguous())[:, : r]
        b = b[:, 0] if r == 1 else b
        x_fused = direct.block_thomas_solve_3d(view, b)
        reset_counts()
        x_plane = direct.block_thomas_solve_3d(dataclasses.replace(view, fused=False), b)
        torch.cuda.synchronize()
        counts[r] = read_counts()
        _, errs[r] = rel_err(x_plane, x_fused)
    emit("plane_apply_path", planes=view.stack.l1, launches=counts, max_rel_err=errs,
         tolerance=KERNEL_TOL)
    for r in PLANE_APPLY_RS:
        check(counts[r]["plane_apply"] == 2 * view.stack.l1,
              f"the per-plane branch launched plane_apply once per plane and pass ({counts})")
        check(errs[r] <= KERNEL_TOL,
              f"per-plane branch within {KERNEL_TOL} of the fused one (r={r}: {errs[r]})")
    return counts


def plane_bound(planes: int, ld: int, r: int, stacks: int, weights: bool = True,
                storage: str = "bf16"):
    """Least time for ``planes`` plane steps: two bf16 planes (or two int8
    planes and their f32 scales, one per 128 input rows and output lane), the
    packed weight rows and ``stacks`` row stacks of 2r x ld floats per plane,
    plus the carry, against the card's memory rate; the products
    (:func:`product_ms`)."""
    row = 2 * r * ld * 4
    pivots = 2 * ld * ld * 2 if storage == "bf16" else 2 * ld * ld + 2 * (ld // 128) * ld * 4
    plane_bytes = pivots + (2 * 9 * ld * 4 if weights else 0) + stacks * row
    bytes_ms = 1e3 * (planes * plane_bytes + row) / PEAK_BYTES_PER_S
    flops_ms = product_ms(planes * 2 * (2 * (2 * r) * ld * ld), r)
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def phase_plane_kernel_times(problem, path_counts: dict, apply_counts: dict) -> list:
    """Each plane kernel at the 3D path's shapes (l = 48 planes of mn = 2304)
    on the solve's own planes and right-hand sides: r = 1 (``solve``) and
    r = 2 (``apply_batch`` of two sources); the plane apply at one plane,
    with the launches of the per-plane solves (``apply_counts[r]``)."""
    view = problem.precond.factorization
    st = view.stack
    l, ld, mn, n = st.l1, st.ld, st.mn, view.lsten.shape[2]
    dense_re = tk.dense_planes(st.p_re)           # (l, ld, ld) copies for the
    dense_im = tk.dense_planes(st.p_im)           # library yardstick
    kernels = []
    rhs2 = torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])
    for r, path in ((1, "bump3d_solve"), (2, "bump3d_apply_batch")):
        b = problem.precond.a_s.matvec(rhs2[:r].T.contiguous())          # (N, r)
        b4 = pk._rows_of(b.reshape(l, mn, r), ld)
        y4 = pk.plane_forward(st, b4, view.lrows, n)[0]
        library_ms = library_pass_ms(b4[0], dense_re, dense_im, range(l))
        shape = dict(l=l, mn=mn, ld=ld, r=r)
        counts = path_counts[r]
        kernels += [
            kernel_entry("plane_forward", r, path, counts["plane_forward"],
                         lambda: pk.plane_forward(st, b4, view.lrows, n),
                         lambda: pk.plane_forward_plain(st, b4, view.lrows, n),
                         plane_bound(l, ld, r, stacks=3), library_ms, shape),
            kernel_entry("plane_backward", r, path, counts["plane_backward"],
                         lambda: pk.plane_backward(st, y4, view.urows, n),
                         lambda: pk.plane_backward_plain(st, y4, view.urows, n),
                         plane_bound(l, ld, r, stacks=2), library_ms, shape),
            kernel_entry("plane_apply", r, "plane_apply_path", apply_counts[r]["plane_apply"],
                         lambda: pk.plane_apply_rows(st, l // 2, b4[l // 2]),
                         lambda: pk.plane_apply_rows_plain(st, l // 2, b4[l // 2]),
                         plane_bound(1, ld, r, stacks=2, weights=False),
                         library_pass_ms(b4[0], dense_re, dense_im, range(1), graph=True),
                         dict(shape, plane=l // 2), graph=True),
        ]
        line_step_report(path, r, [(kernels[-3], l), (kernels[-2], l)], {
            "plane_forward": lambda: pk.plane_forward(st, b4, view.lrows, n),
            "plane_backward": lambda: pk.plane_backward(st, y4, view.urows, n),
        }, phase="plane_step")
    # the plane apply at r = 3, 4 and 8 (one launch each, tensor cores), on
    # the wide directions' rows
    for r in WIDE_RS:
        b = problem.precond.a_s.matvec(plane_waves_3d(problem, r).T.contiguous())
        b4 = pk._rows_of(b.reshape(l, mn, r), ld)
        kernels.append(kernel_entry(
            "plane_apply", r, "plane_apply_path", apply_counts[r]["plane_apply"],
            lambda: pk.plane_apply_rows(st, l // 2, b4[l // 2]),
            lambda: pk.plane_apply_rows_plain(st, l // 2, b4[l // 2]),
            plane_bound(1, ld, r, stacks=2, weights=False),
            library_pass_ms(b4[0], dense_re, dense_im, range(1), graph=True),
            dict(l=l, mn=mn, ld=ld, r=r, plane=l // 2), graph=True))
    del dense_re, dense_im
    return kernels


# ---------------------------------------------------------------------------
# The 3D sweeps: the 96^3 z-slab Gauss-Seidel solve on int8 y-plane pivots
# ---------------------------------------------------------------------------

# bench.py's ls3d_96: bump3d.build_problem(h=1/96, precond="gs",
# pivot_dtype="yblock_int8_pallas", n_subdomains=6, npml=8), restart=20,
# maxiter=12
GS96 = dict(h=1.0 / 96.0, n_subdomains=6, npml=8)
GS96_SOLVE_KW = dict(rtol=1e-6, restart=20, maxiter=12)
# RESULTS.md (round 5) and VERDICT.md (weak #2): the JAX package's int8 sweep
# converges in 10 iterations at rtol 1e-6 on the left-preconditioned residual
# with a TRUE relative residual of 3.6e-3.  The port does not reproduce that
# gap (its true residual is near 1.5e-6 on int8 and on bf16 y-planes, PERF.md),
# so it is held to the 1e-3 of the other paths; the JAX figures are printed
# beside it for information only
JAX_GS96_ITERATIONS = 10
JAX_GS96_TRUE_RESIDUAL = 3.6e-3
GS96_TRUE_RESIDUAL_LIMIT = 1e-3
GS48 = dict(h=1.0 / 48.0, n_subdomains=4, npml=5)
GS48_SOLVE_KW = dict(rtol=1e-6, restart=20, maxiter=16)
# (l, m, n) of the random int8 stacks and the forward passes' starts
INT8_CASES = (((96, 32, 96), (0, 40)), ((5, 10, 30), (0, 3)))
LIBRARY_CALL_INT8 = ("bf16 torch.matmul over dense planes of the same shape (no PyTorch call "
                     "multiplies int8 planes with block scales)")


def random_int8_plane_view(rng, l: int, m: int, n: int, device) -> pk.PlaneSlabView:
    """Contracting random plane factors (||P|| ||S|| < 1), quantized plane by
    plane by the port's own ``direct._quantize_t_int8`` and packed into an
    int8 stack."""
    mn = m * n
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    stack = pk.empty_plane_stack(l, mn, l, "int8", device)

    def sten():
        s = rng.uniform(-0.05, 0.05, (l, m, n, 3, 3, 2)).astype(np.float32)
        return torch.view_as_complex(torch.from_numpy(s)).to(device)

    lsten, usten = sten(), sten()
    eye = 0.2 * torch.eye(mn, device=device)
    for k in range(l):
        (q_re, s_re), (q_im, s_im) = (
            direct._quantize_t_int8(d + (0.1 / mn ** 0.5) * torch.randn(
                (mn, mn), generator=g, device=device)) for d in (eye, 0.0))
        pk.pack_planes(stack, k, direct.BlockTridiagFactorization3DInt8(
            q_re=q_re[None], q_im=q_im[None], s_re=s_re[None], s_im=s_im[None],
            lsten=lsten[k : k + 1], usten=usten[k : k + 1]))
    return pk.PlaneSlabView(stack=stack, lsten=lsten, usten=usten)


def phase_plane_kernels_int8(device):
    """The three plane kernels on int8 planes against their plain versions:
    at the 96^3 sweep's shape (96 y-planes of 32 x 96, mn = ld = 3072, 24
    scale blocks) and at a width that is not a multiple of 128 (5 planes of
    10 x 30, mn = 300 in ld = 384)."""
    rng = np.random.default_rng(2)
    reset_counts()
    worst, shapes = {}, []
    for (l, m, n), starts in INT8_CASES:
        view = random_int8_plane_view(rng, l, m, n, device)
        w, cases = plane_kernel_cases(view, starts, "_int8")
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in w.items()}
        shapes.append(dict(l=l, m=m, n=n, mn=view.stack.mn, ld=view.stack.ld, cases=cases))
        del view
        torch.cuda.empty_cache()
    counts = read_counts()
    emit("plane_kernels_int8", tolerance=KERNEL_TOL, max_rel_err=worst, shapes=shapes,
         launches=counts)
    for name, err in worst.items():
        check(err <= KERNEL_TOL, f"{name} within {KERNEL_TOL} of its plain version ({err})")
    check(all(counts[name] > 0 for name in INT8_PLANE), f"the int8 kernels launched ({counts})")


def phase_small_reference_gs3d(device):
    """The z-slab sweep solve of a 16^3 bump (2 slabs, npml = 5), set up on
    the CPU and moved to the card: the solve on the card (kernels) against
    the same solve on the CPU (plain versions) on the same planes, for the
    z layout on bf16 planes and the y layout on int8 planes.  Both stop at
    rtol 1e-5: at 16^3 the complex64 solve meets its float32 floor near
    1e-6."""
    kw = dict(rtol=1e-5, restart=20, maxiter=16)
    out = {}
    for mode in ("bf16_pallas", "yblock_int8_pallas"):
        p_cpu = bump3d.build_problem(h=1 / 16, dtype=torch.complex64, precond="gs",
                                     n_subdomains=2, npml=5, pivot_dtype=mode, device="cpu")
        p_card = move_to(p_cpu, device)
        reset_counts()
        x_k, i_k = bump3d.solve(p_card, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        x_c, i_c = bump3d.solve(p_cpu, **kw)
        _, err = rel_err(x_k.cpu(), x_c)
        out[mode] = dict(iterations=[int(i_k.n_iterations), int(i_c.n_iterations)],
                         true_residual=[float(i_k.true_residual), float(i_c.true_residual)],
                         rel_err_card_vs_cpu=err, launches=counts)
        check(bool(i_k.converged) and bool(i_c.converged), f"small sweep solves converged ({mode})")
        check(err <= 1e-4, f"card sweep solve within 1e-4 of the CPU one ({mode}: {err})")
        pair = ("plane_forward_int8", "plane_backward_int8") if "int8" in mode else (
            "plane_forward", "plane_backward")
        check(all(counts[k] > 0 for k in pair), f"the {mode} sweep ran the fused kernels ({counts})")
    emit("small_reference_gs3d", n=16, n_subdomains=2, npml=5, rtol=kw["rtol"],
         tolerance=1e-4, cases=out)


def slab_rows(slabs, rhs_s):
    """One slab's right-hand side (l1_max, mn[, r]) as the rows its plane
    view solves: y-major for the y layout (as ``slab_solve_3d``)."""
    view = slabs.slab_facs[0]
    b = rhs_s.reshape((slabs.l1_max, slabs.m, slabs.n, -1))
    if slabs.pivot_layout == "y":
        b = b.movedim(1, 0)
    return pk._rows_of(b.reshape(view.lsten.shape[0], view.stack.mn, -1), view.stack.ld)


def phase_gs3d_48_z(device, repeats: int = 3) -> list:
    """``bump3d.build_problem(h=1/48, precond="gs", n_subdomains=4, npml=5,
    pivot_dtype="bf16_pallas")``: the z layout, whose down solves keep the
    forward stacks and truncate the backward pass to ``trace_tail`` planes and
    whose up solves resume from them, so the fused passes run with start,
    t_init, collect_t and tail on a real slab system.  ``solve`` at rtol 1e-6
    (warm-up, median of 3).  Then, on an inner slab's own planes, the resumed
    solve against the full one and the resumed and truncated passes against
    their plain versions (kernels line entries)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = bump3d.build_problem(dtype=torch.complex64, precond="gs",
                                   pivot_dtype="bf16_pallas", device=device, **GS48)
    setup_s = time.perf_counter() - t0
    bump3d.solve(problem, **GS48_SOLVE_KW)                    # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: bump3d.solve(problem, **GS48_SOLVE_KW), repeats)
    n_it = int(info.n_iterations)

    pc = problem.precond
    slabs = pc.slabs
    s = 1
    view = slabs.slab_facs[s]
    st, n, base, tail = view.stack, view.lsten.shape[2], view.base, slabs.trace_tail
    l = view.lsten.shape[0]
    j0 = l - tail
    rhs = subdomain3d.partition_source_3d(slabs, pc.a_s.matvec(problem.rhs))[s]
    _, y_c, t_c = direct.block_thomas_solve_cached_3d(view, rhs, tail)
    rhs_up = rhs.clone()
    rhs_up[j0:] += rhs[:tail].flip(0) + 1.0                  # new sources on the last planes only
    x_res = direct.block_thomas_solve_resume_3d(view, rhs_up, y_c, t_c, tail)
    x_full = direct.block_thomas_solve_3d(view, rhs_up)
    _, err_resume = rel_err(x_res, x_full)

    b4 = slab_rows(slabs, rhs_up)
    y4, t4 = pk.plane_forward(st, b4, view.lrows, n, base)
    t_init = t4[j0 - 1].contiguous()
    out_k, out_p = (y4.clone(), t4.clone()), (y4.clone(), t4.clone())

    def resumed(fn, out):
        y, t = fn(st, b4, view.lrows, n, base, j0, t_init, out=out)
        return y[j0:], t[j0:]

    dense_re = tk.dense_planes(st.p_re[base : base + l])
    dense_im = tk.dense_planes(st.p_im[base : base + l])
    shape = dict(slab=s, l=l, mn=st.mn, ld=st.ld, r=1)
    kernels = [
        kernel_entry("plane_forward", 1, "gs3d_48_z", counts["plane_forward"],
                     lambda: resumed(pk.plane_forward, out_k),
                     lambda: resumed(pk.plane_forward_plain, out_p),
                     plane_bound(tail, st.ld, 1, stacks=3),
                     library_pass_ms(b4[0], dense_re, dense_im, range(j0, l)),
                     dict(shape, start=j0), variant="_resumed"),
        kernel_entry("plane_backward", 1, "gs3d_48_z", counts["plane_backward"],
                     lambda: pk.plane_backward(st, y4, view.urows, n, base, j0),
                     lambda: pk.plane_backward_plain(st, y4, view.urows, n, base, j0),
                     plane_bound(tail, st.ld, 1, stacks=2),
                     library_pass_ms(b4[0], dense_re, dense_im, range(j0, l)),
                     dict(shape, tail=tail), variant="_tail"),
    ]
    emit(
        "gs3d_48_z", grid=list(problem.grid.shape), k=problem.k, pivot_dtype="bf16_pallas",
        pivot_layout=slabs.pivot_layout, n_subdomains=slabs.n_subs, l1_max=slabs.l1_max,
        trace_tail=tail, setup_seconds=problem.setup_seconds, setup_total_seconds=setup_s,
        solve_ms=sorted(times)[len(times) // 2], solve_ms_runs=times, iterations=n_it,
        converged=bool(info.converged), residuals=[float(v) for v in info.residuals[: n_it + 1]],
        true_residual=float(info.true_residual), stack_bytes=st.nbytes,
        peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts,
        resume_vs_full_solve_rel_err=err_resume,
    )
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "48^3 sweep solution is finite")
    check(bool(info.converged), f"48^3 z-layout sweep converged within maxiter ({n_it})")
    check(float(info.true_residual) <= 1e-3, "48^3 sweep true residual <= 1e-3")
    check(counts["plane_forward"] > 0 and counts["plane_backward"] > 0,
          f"the z-layout sweep ran both fused passes ({counts})")
    check(err_resume <= KERNEL_TOL,
          f"resumed slab solve within {KERNEL_TOL} of the full one ({err_resume})")
    del dense_re, dense_im
    # four and eight plane waves in one joint solve (path (c) of the wide
    # batches), and the fused passes at r = 3, 4 and 8 on an inner slab
    wide = phase_wide_3d(problem, "gs3d_48_wide", (4, WIDE_R),
                         {1: sorted(times)[len(times) // 2]}, ("plane_forward", "plane_backward"),
                         GS48_SOLVE_KW)
    kernels += sweep_kernel_times(problem, {r: "gs3d_48_wide" for r in WIDE_RS},
                                  {r: wide[4 if r <= 4 else WIDE_R] for r in WIDE_RS},
                                  variant="_gs48")
    del problem
    torch.cuda.empty_cache()
    return kernels


def phase_gs3d_96_solve(device, repeats: int = 3):
    """The slice's path at full width, nothing cut: ``bump3d.build_problem(
    h=1/96, complex64, precond="gs", n_subdomains=6, npml=8,
    pivot_dtype="yblock_int8_pallas")``, ``solve`` at the JAX bench's budget
    (warm-up, median of 3), then the joint two-source solve through
    ``apply_batch`` (r = 2)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = bump3d.build_problem(dtype=torch.complex64, precond="gs",
                                   pivot_dtype="yblock_int8_pallas", device=device, **GS96)
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated()
    bump3d.solve(problem, **GS96_SOLVE_KW)                    # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: bump3d.solve(problem, **GS96_SOLVE_KW), repeats)
    n_it = int(info.n_iterations)
    pc = problem.precond
    rhs2 = torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])
    (x2, info2), times2, counts2 = timed_solves(
        lambda: gmres_batched(problem.op.apply, rhs2, preconditioner=pc.apply_batch,
                              **GS96_SOLVE_KW), repeats)
    slabs = pc.slabs
    SOLVE_RESULTS["gs3d_96_solve"] = dict(ms=sorted(times)[len(times) // 2], iterations=n_it)
    SOLVE_RESULTS["gs3d_96_apply_batch"] = dict(ms=sorted(times2)[len(times2) // 2])
    emit(
        "gs3d_96_solve", grid=list(problem.grid.shape), k=problem.k, unknowns=problem.grid.size,
        pivot_dtype="yblock_int8_pallas", pivot_layout=slabs.pivot_layout,
        n_subdomains=slabs.n_subs, npml=GS96["npml"], l1_max=slabs.l1_max,
        plane_width=slabs.pfac.mn, planes=slabs.pfac.n_planes, stack_bytes=slabs.pfac.nbytes,
        setup_seconds=problem.setup_seconds, setup_total_seconds=setup_s,
        solve_ms=sorted(times)[len(times) // 2], solve_ms_runs=times, iterations=n_it,
        jax_package_iterations=JAX_GS96_ITERATIONS, converged=bool(info.converged),
        residuals=[float(v) for v in info.residuals[: n_it + 1]],
        true_residual=float(info.true_residual),
        true_residual_limit=GS96_TRUE_RESIDUAL_LIMIT,
        jax_package_true_residual=JAX_GS96_TRUE_RESIDUAL,
        true_residual_limit_why=(
            "the 1e-3 of the other paths; the JAX package's own true residual at this "
            f"configuration, {JAX_GS96_TRUE_RESIDUAL} with {JAX_GS96_ITERATIONS} iterations "
            "(RESULTS.md round 5, VERDICT.md weak #2), is for information only"),
        peak_memory_setup_bytes=peak_setup, peak_memory_bytes=torch.cuda.max_memory_allocated(),
        launches=counts,
        two_sources=dict(solve_ms=sorted(times2)[len(times2) // 2], solve_ms_runs=times2,
                         iterations=[int(v) for v in info2.n_iterations],
                         converged=[bool(v) for v in info2.converged],
                         true_residual=[float(v) for v in info2.true_residual],
                         launches=counts2),
    )
    check(tuple(x.shape) == (problem.grid.size,), "96^3 solution shape")
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "96^3 solution is finite")
    check(bool(info.converged), f"96^3 int8 sweep solve converged within maxiter ({n_it})")
    check(float(info.true_residual) <= GS96_TRUE_RESIDUAL_LIMIT,
          f"96^3 true residual <= {GS96_TRUE_RESIDUAL_LIMIT} ({float(info.true_residual)})")
    check(bool(torch.isfinite(torch.view_as_real(x2)).all()) and bool(info2.converged.all())
          and float(info2.true_residual.max()) <= GS96_TRUE_RESIDUAL_LIMIT,
          "two-source 96^3 solve converged")
    for c in (counts, counts2):
        check(c["plane_forward_int8"] > 0 and c["plane_backward_int8"] > 0,
              f"both int8 fused plane kernels launched on the 96^3 path ({c})")
    return problem, {1: counts, 2: counts2}


def slab_rhs(problem, r: int, s: int):
    """Slab ``s``'s share of the sweep's right-hand side ``As b`` for the
    x-wave (r = 1), the x- and y-waves (r = 2) or the first r wide
    directions (r > 2), and the slab's rows."""
    pc = problem.precond
    sources = (torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])[:r] if r <= 2
               else plane_waves_3d(problem, r))
    b = pc.a_s.matvec(sources.T.contiguous())
    rhs_s = subdomain3d.partition_source_3d(pc.slabs, b[:, 0] if r == 1 else b)[s]
    return rhs_s, slab_rows(pc.slabs, rhs_s)


def phase_plane_apply_path_int8(problem) -> dict:
    """One slab solve of the 96^3 sweep (an inner slab, 96 y-planes) through
    the per-plane branch (``fused=False``: the int8 plane apply once per
    plane and pass) against the fused branch on the same planes, r = 1, 2
    and 3, 4, 8.  Returns the launch counts of the per-plane solves by r."""
    slabs = problem.precond.slabs
    s = slabs.n_subs // 2
    view = slabs.slab_facs[s]
    counts, errs = {}, {}
    for r in PLANE_APPLY_RS:
        rhs_s, _ = slab_rhs(problem, r, s)
        x_fused = subdomain3d.slab_solve_3d(slabs, view, rhs_s)
        reset_counts()
        x_plane = subdomain3d.slab_solve_3d(slabs, dataclasses.replace(view, fused=False), rhs_s)
        torch.cuda.synchronize()
        counts[r] = read_counts()
        _, errs[r] = rel_err(x_plane, x_fused)
    planes = view.lsten.shape[0]
    emit("plane_apply_path_int8", slab=s, planes=planes, launches=counts, max_rel_err=errs,
         tolerance=KERNEL_TOL)
    for r in PLANE_APPLY_RS:
        check(counts[r]["plane_apply_int8"] == 2 * planes,
              f"the per-plane branch launched the int8 plane apply once per plane and pass "
              f"({counts})")
        check(errs[r] <= KERNEL_TOL,
              f"int8 per-plane branch within {KERNEL_TOL} of the fused one (r={r}: {errs[r]})")
    return counts


def sweep_kernel_times(problem, paths: dict, path_counts: dict, apply_counts=None,
                       variant=None) -> list:
    """Each plane kernel of the problem's stack storage at the 96^3 path's
    shapes (an inner slab's 96 y-planes of mn = ld = 3072) on the solve's own
    planes and right-hand sides: the fused passes for each ``r`` of ``paths``
    (r -> path name) with that path's launches ``path_counts[r]``; with
    ``apply_counts``, the plane apply at one plane with the launches of the
    per-plane solves.  ``variant`` names the entries (default: none for int8
    planes, ``"_gs96"`` for bf16 ones)."""
    slabs = problem.precond.slabs
    s = slabs.n_subs // 2
    view = slabs.slab_facs[s]
    st, n, base = view.stack, view.lsten.shape[2], view.base
    l, ld, storage = view.lsten.shape[0], st.ld, st.storage
    # int8 kernels have names of their own; the bf16 passes are those of the
    # 48^3 path, here at the 96^3 sweep's shape
    suffix, default = ("_int8", "") if storage == "int8" else ("", "_gs96")
    variant = default if variant is None else variant
    # the library yardstick's dense bf16 planes, of the same shape
    dense_re = tk.dense_planes(st.p_re[base : base + l]).to(torch.bfloat16)
    dense_im = tk.dense_planes(st.p_im[base : base + l]).to(torch.bfloat16)
    kernels = []
    for r, path in paths.items():
        _, b4 = slab_rhs(problem, r, s)
        y4 = pk.plane_forward(st, b4, view.lrows, n, base)[0]
        library_ms = library_pass_ms(b4[0], dense_re, dense_im, range(l))
        shape = dict(slab=s, l=l, mn=st.mn, ld=ld, r=r, storage=storage)
        counts = path_counts[r]
        entries = [
            kernel_entry("plane_forward" + suffix, r, path, counts["plane_forward" + suffix],
                         lambda: pk.plane_forward(st, b4, view.lrows, n, base),
                         lambda: pk.plane_forward_plain(st, b4, view.lrows, n, base),
                         plane_bound(l, ld, r, stacks=3, storage=storage), library_ms, shape,
                         variant=variant),
            kernel_entry("plane_backward" + suffix, r, path, counts["plane_backward" + suffix],
                         lambda: pk.plane_backward(st, y4, view.urows, n, base),
                         lambda: pk.plane_backward_plain(st, y4, view.urows, n, base),
                         plane_bound(l, ld, r, stacks=2, storage=storage), library_ms, shape,
                         variant=variant),
        ]
        if apply_counts is not None:
            entries.append(kernel_entry(
                "plane_apply" + suffix, r, "plane_apply_path" + suffix,
                apply_counts[r]["plane_apply" + suffix],
                lambda: pk.plane_apply_rows(st, base + l // 2, b4[l // 2]),
                lambda: pk.plane_apply_rows_plain(st, base + l // 2, b4[l // 2]),
                plane_bound(1, ld, r, stacks=2, weights=False, storage=storage),
                library_pass_ms(b4[0], dense_re, dense_im, range(1), graph=True),
                dict(shape, plane=l // 2), variant=variant, graph=True))
        if storage == "int8":
            for e in entries:
                e["library_call"] = LIBRARY_CALL_INT8
        kernels += entries
        line_step_report(path, r, [(entries[0], l), (entries[1], l)], {
            "plane_forward" + suffix: lambda: pk.plane_forward(st, b4, view.lrows, n, base),
            "plane_backward" + suffix: lambda: pk.plane_backward(st, y4, view.urows, n, base),
        }, phase="plane_step")
    del dense_re, dense_im
    torch.cuda.empty_cache()
    return kernels


def phase_gs3d_96_bf16(problem, repeats: int = 1) -> list:
    """The same operator and stencils with the slabs rebuilt on bf16
    y-planes (``yblock_bf16_pallas``, 21.7 GB of planes) from the problem's
    own ``a_s``/``ag_s``, the int8 slabs freed first: iterations and true
    residual at the same budget, which says whether int8 storage is what
    costs the true residual.  Then the bf16 fused passes on an inner slab's
    96 y-planes against their plain versions (kernels line entries)."""
    problem.precond = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seconds = {}
    X, Y, Z = problem.grid.mesh()
    slabs = subdomain3d.build_slab_system_3d(
        problem.a_s, problem.ag_s, media.gaussian_bump_3d(X, Y, Z), problem.grid.x,
        problem.grid.h, problem.k, GS96["n_subdomains"], npml=GS96["npml"],
        pivot_dtype="yblock_bf16_pallas", timings=seconds)
    problem.precond = subdomain3d.SingleSweepPreconditioner3D(slabs=slabs, a_s=problem.a_s)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bump3d.solve(problem, **GS96_SOLVE_KW)                    # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: bump3d.solve(problem, **GS96_SOLVE_KW), repeats)
    n_it = int(info.n_iterations)
    emit(
        "gs3d_96_bf16", pivot_dtype="yblock_bf16_pallas", pivot_layout=slabs.pivot_layout,
        stack_bytes=slabs.pfac.nbytes, setup_seconds=seconds,
        setup_total_seconds=setup_s, solve_ms=sorted(times)[len(times) // 2],
        solve_ms_runs=times, iterations=n_it, converged=bool(info.converged),
        residuals=[float(v) for v in info.residuals[: n_it + 1]],
        true_residual=float(info.true_residual), true_residual_limit=GS96_TRUE_RESIDUAL_LIMIT,
        peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts,
    )
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "96^3 bf16 solution is finite")
    check(bool(info.converged), f"96^3 bf16 sweep solve converged within maxiter ({n_it})")
    check(float(info.true_residual) <= GS96_TRUE_RESIDUAL_LIMIT,
          f"96^3 bf16 true residual <= {GS96_TRUE_RESIDUAL_LIMIT} ({float(info.true_residual)})")
    check(counts["plane_forward"] > 0 and counts["plane_backward"] > 0
          and counts["plane_forward_int8"] == 0,
          f"the bf16 sweep ran the bf16 fused kernels ({counts})")
    return sweep_kernel_times(problem, {1: "gs3d_96_bf16"}, {1: counts})


# ---------------------------------------------------------------------------
# Path 5: the 801^2, 16-slab double sweep on banded+tail pivots
# ---------------------------------------------------------------------------

# RESULTS.md round 5: the JAX package's banded+tail hybrid at this configuration
# takes 9 and 9 outer iterations on its TPU (dense bf16 pivots: 6 and 6); printed
# for information only
JAX_HT_ITERATIONS = 9
# (S, m, n, width, tail lines) of the random hybrid factors; trace lines of a
# 3-slab chain on them as build_slab_system sets them (l0, l1, ln, lnp)
HT_RANDOM = (3, 20, 301, 41, 6)
HT_TRACES = dict(l0=4, l1=5, ln=13, lnp=14)


def random_banded_tail(rng, S: int, m: int, n: int, width: int, tail_lines: int,
                       device) -> tk.BandedTailFactorization:
    """Contracting random factors (||C|| ||band|| < 1) packed into the hybrid
    layout by the port's own builder."""
    def cplx(re, im):
        return torch.complex(torch.from_numpy(re.astype(np.float32)),
                             torch.from_numpy(im.astype(np.float32))).to(device)

    cinv = cplx(*(0.1 * rng.standard_normal((2, S, m, n, n)) / np.sqrt(n)))
    cinv = cinv + 0.2 * torch.eye(n, device=device)
    lband, uband = (cplx(*rng.uniform(-0.2, 0.2, (2, S, m, n, 3))) for _ in range(2))
    fac = direct.BlockTridiagFactorization(cinv=cinv, lband=lband, uband=uband)
    return tk.build_banded_tail_factorization(fac, width=width, tail_lines=tail_lines)


def random_rows(rng, shape, n: int, device) -> torch.Tensor:
    """f32 rows (..., ld) with random true lanes and zero padding."""
    rows = np.zeros(shape, np.float32)
    rows[..., :n] = rng.standard_normal(shape[:-1] + (n,))
    return torch.from_numpy(rows).to(device)


def phase_ht_kernels(device):
    """The four kernels of the banded+tail path against their plain versions on
    random hybrid factors (S = 3, m = 20, n = 301, width 41, 6 tail lines: the
    windows start at both parities of a 16-row k-step), r = 1, 2, 4 and 8: the
    forward pass from a zero carry and from t_init, starting in the head and
    in the tail; the backward pass full and truncated (inside the tail lines
    and across into the head); the down and up sweep kernels on a 3-slab
    chain whose backward tail (8 lines) reaches into the head."""
    rng = np.random.default_rng(3)
    S, m, n, width, tail_lines = HT_RANDOM
    fac = random_banded_tail(rng, S, m, n, width, tail_lines, device)
    ld, ts = fac.ld, fac.tail_start
    s_idx = torch.tensor([2, 0], dtype=torch.int32, device=device)
    tr = HT_TRACES
    tt = m - tr["ln"] + 1
    meta = torch.tensor([[0, tr["l0"], tr["l0"]], [0, tr["l1"], tr["l1"]],
                         [tr["ln"], tr["ln"], 0], [tr["lnp"], tr["lnp"], 0],
                         [0, 1, 1], [1, 1, 0]], dtype=torch.int32, device=device)
    worst = dict.fromkeys(HT_PAIR + SWEEP_PAIR, 0.0)
    cases = []
    reset_counts()
    for r in (1, 2, 4, 8):
        b4 = random_rows(rng, (2, m, 2 * r, ld), n, device)
        t_init = random_rows(rng, (2, 2 * r, ld), n, device)
        zero = torch.zeros_like(t_init)
        for start, carry in ((0, None), (0, t_init), (9, t_init), (ts + 2, t_init)):
            out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
            y_k, t_k = tk.forward_substitution_cached(fac, s_idx, b4, carry, start, out=out)
            torch.cuda.synchronize()
            y_p, t_p = tk.forward_substitution_ht_plain(
                fac, s_idx, b4, zero if carry is None else carry, start)
            _, e_y = rel_err(y_k[:, start:], y_p[:, start:])
            _, e_t = rel_err(t_k[:, start:], t_p[:, start:])
            check(bool((y_k[:, :start] == 7.0).all()) and bool((t_k[:, :start] == -7.0).all()),
                  "the hybrid forward kernel leaves the lines above its start alone")
            check(bool(torch.isfinite(t_k[:, start:]).all()), "hybrid forward output is finite")
            worst["thomas_forward_ht"] = max(worst["thomas_forward_ht"], e_y, e_t)
            cases.append(dict(r=r, start=start, t_init=carry is not None, fwd_y=e_y, fwd_t=e_t))
        y4 = tk.forward_substitution_ht_plain(fac, s_idx, b4, zero)[0]
        for tail in (0, tail_lines - 2, tail_lines + 3):
            x_k = tk.backward_substitution(fac, s_idx, y4, tail)
            torch.cuda.synchronize()
            _, e_x = rel_err(x_k, tk.backward_substitution_ht_plain(fac, s_idx, y4, tail))
            check(bool(torch.isfinite(x_k).all()), "hybrid backward output is finite")
            worst["thomas_backward_ht"] = max(worst["thomas_backward_ht"], e_x)
            cases.append(dict(r=r, tail=tail, bwd=e_x))
        # the sweep kernels; the up kernel is held on the down kernel's outputs
        bs = random_rows(rng, (S, m, 2 * r, ld), n, device)
        cpl = [random_rows(rng, (S, 2, 3, ld), n, device) * 0.2 for _ in range(4)]
        down_k = sk.sweep_down(fac, meta, bs, cpl[0], cpl[1], tt)
        torch.cuda.synchronize()
        down_p = sk.sweep_down_plain(fac, meta, bs, cpl[0], cpl[1], tt)
        e_d = max(rel_err(k, p)[1] for k, p in zip(down_k, down_p))
        u_k = sk.sweep_up(fac, meta, bs, cpl[2], cpl[3], *down_k, tt)
        torch.cuda.synchronize()
        _, e_u = rel_err(u_k, sk.sweep_up_plain(fac, meta, bs, cpl[2], cpl[3], *down_k, tt))
        check(bool(torch.isfinite(u_k).all()), "fused sweep output is finite")
        worst["sweep_down"] = max(worst["sweep_down"], e_d)
        worst["sweep_up"] = max(worst["sweep_up"], e_u)
        cases.append(dict(r=r, trace_tail=tt, sweep_down=e_d, sweep_up=e_u))
    counts = read_counts()
    emit("ht_kernels", shape=dict(S=S, m=m, n=n, ld=ld, width=fac.width, tail_start=ts,
                                  trace_tail=tt), tolerance=KERNEL_TOL, max_rel_err=worst,
         cases=cases, launches=counts)
    for name, err in worst.items():
        check(err <= KERNEL_TOL, f"{name} within {KERNEL_TOL} of its plain version ({err})")
    check(all(counts[k] > 0 for k in HT_PAIR + SWEEP_PAIR), f"the four kernels launched ({counts})")


def sweep_rows(problem, r: int, slabs=None):
    """``As b`` of the incident fields (r = 1: the x-wave; 2: both) and its
    per-slab rows in the kernels' layout."""
    pc = problem.precond
    slabs = slabs or pc.slabs
    rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:r]))
    b = pc.a_s.matvec(rhs.T.contiguous() if r > 1 else rhs[0])
    return b, tk._to_rows_b(slabs.pfac, subdomain.partition_source(slabs, b))


def phase_small_reference_ht(device):
    """The 3-slab, h = 1/40 double-sweep problem on banded+tail pivots (band
    width 21): one ``gs_sweep`` through the fused kernels against the per-slab
    sweep on the same layout (the hybrid pass kernels) and against the plain
    fused sweep, then the solve, converged at rtol 1e-5 (the float32 floor of
    this grid is near 1e-6)."""
    problem = plasma2d.build_problem(h=1 / 40, n_subdomains=3, double_sweep=True,
                                     pivot_dtype="pallas_banded_tail", pivot_band=21,
                                     dtype=torch.complex64, device=device)
    slabs = problem.precond.slabs
    b, b4 = sweep_rows(problem, 1)
    reset_counts()
    u_fused = sweeps.gs_sweep(slabs, b)
    torch.cuda.synchronize()
    counts_fused = read_counts()
    reset_counts()
    u_slab = sweeps._gs_sweep_per_slab(slabs, b)
    torch.cuda.synchronize()
    counts_slab = read_counts()
    tables = slabs.sweep_tables
    u4 = sk.sweep_fused_plain(slabs.pfac, tables.meta, b4, tables, slabs.trace_tail)
    u_plain = subdomain.gather_interior(
        slabs, tk._from_rows_b(u4, slabs.n, b.dtype, slabs.m1_max)[..., 0])
    _, e_slab = rel_err(u_fused, u_slab)
    _, e_plain = rel_err(u_fused, u_plain)
    x, info = plasma2d.solve(problem, (1.0, 0.0), rtol=1e-5, restart=20, maxiter=12)
    emit("small_reference_ht", n=problem.grid.n, n_subdomains=3, width=slabs.pfac.width,
         tail_start=slabs.pfac.tail_start, m1_max=slabs.m1_max, trace_tail=slabs.trace_tail,
         fused_vs_per_slab=e_slab, fused_vs_plain=e_plain, tolerance=KERNEL_TOL,
         launches=dict(fused=counts_fused, per_slab=counts_slab),
         iterations=int(info.n_iterations), true_residual=float(info.true_residual))
    check(e_slab <= KERNEL_TOL and e_plain <= KERNEL_TOL,
          f"fused sweep within {KERNEL_TOL} of the per-slab and plain sweeps ({e_slab}, {e_plain})")
    check(counts_fused["sweep_down"] == counts_fused["sweep_up"] == 1
          and not any(counts_fused[k] for k in HT_PAIR + DENSE_2D),
          f"gs_sweep ran the fused kernels only ({counts_fused})")
    check(all(counts_slab[k] > 0 for k in HT_PAIR)
          and not any(counts_slab[k] for k in SWEEP_PAIR + DENSE_2D),
          f"the per-slab sweep ran the hybrid passes only ({counts_slab})")
    check(bool(info.converged) and float(info.true_residual) <= 1e-3,
          "small banded+tail solve converged")


def phase_ht_sweeps(problem) -> dict:
    """One ``gs_sweep`` (the fused kernels, two launches) and one
    ``jacobi_sweep`` (the hybrid passes) at full width on the solve's own
    right-hand side, at r = 1 and at r = 2 (both incident fields), and the
    times of a double-sweep apply (device, and the host's to enqueue it) for
    the fused and the per-slab route.  Returns the launch counts by path."""
    pc = problem.precond
    slabs = pc.slabs
    b, _ = sweep_rows(problem, 1)
    b2, _ = sweep_rows(problem, 2)
    counts = {}
    for path, fn in (("gs_sweep", lambda: sweeps.gs_sweep(slabs, b)),
                     ("jacobi_sweep", lambda: sweeps.jacobi_sweep(slabs, b)),
                     ("gs_sweep_r2", lambda: sweeps.gs_sweep(slabs, b2)),
                     ("jacobi_sweep_r2", lambda: sweeps.jacobi_sweep(slabs, b2))):
        reset_counts()
        u = fn()
        torch.cuda.synchronize()
        counts[path] = read_counts()
        check(bool(torch.isfinite(torch.view_as_real(u)).all()), f"{path} output is finite")
    res = {name: float(torch.linalg.vector_norm(pc.msp.matvec(fn()) - b)
                       / torch.linalg.vector_norm(b))
           for name, fn in (("gs_sweep", lambda: sweeps.gs_sweep(slabs, b)),
                            ("gs_sweep_per_slab", lambda: sweeps._gs_sweep_per_slab(slabs, b)),
                            ("jacobi_sweep", lambda: sweeps.jacobi_sweep(slabs, b)))}
    rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:1]))[0]

    def apply_per_slab():
        # the double-sweep apply with both sweeps on the per-slab route
        sp = pc.a_s.matvec(rhs)
        u = sweeps._gs_sweep_per_slab(pc.slabs, sp)
        err = pc.msp.matvec(u) - sp
        return u - pc._transpose_flat(sweeps._gs_sweep_per_slab(pc.slabs_t, pc._transpose_flat(err)))

    times = dict(
        gs_sweep_ms=time_ms(lambda: sweeps.gs_sweep(slabs, b), 5),
        gs_sweep_per_slab_ms=time_ms(lambda: sweeps._gs_sweep_per_slab(slabs, b), 3),
        jacobi_sweep_ms=time_ms(lambda: sweeps.jacobi_sweep(slabs, b), 3),
        apply_ms=time_ms(lambda: pc.apply(rhs), 5),
        apply_enqueue_ms=enqueue_ms(lambda: pc.apply(rhs)),
        apply_per_slab_ms=time_ms(apply_per_slab, 3),
        apply_per_slab_enqueue_ms=enqueue_ms(apply_per_slab, 3),
    )
    _, e_apply = rel_err(pc.apply(rhs), apply_per_slab())
    emit("ht_sweeps", n_subdomains=slabs.n_subs, m1_max=slabs.m1_max,
         trace_tail=slabs.trace_tail, tail_start=slabs.pfac.tail_start,
         width=slabs.pfac.width, residual_of_msp=res, apply_fused_vs_per_slab=e_apply,
         **times, launches=counts)
    for path in ("gs_sweep", "gs_sweep_r2"):
        c = counts[path]
        check(c["sweep_down"] == c["sweep_up"] == 1
              and not any(c[k] for k in HT_PAIR + DENSE_2D),
              f"{path} launched the two fused kernels and nothing else ({c})")
    for path in ("jacobi_sweep", "jacobi_sweep_r2"):
        c = counts[path]
        check(all(c[k] > 0 for k in HT_PAIR) and not any(c[k] for k in SWEEP_PAIR + DENSE_2D),
              f"{path} ran the hybrid passes only ({c})")
    check(e_apply <= 1e-3, f"fused and per-slab double-sweep applies agree ({e_apply})")
    return counts


def ht_line_rows(fac) -> tuple:
    """(head, tail): the pivot entries one line needs, summed over its tiles
    of 8 output lanes: a head tile's window rows that lie in [0, n), min(8t + 8
    + half, n) - max(8t - half, 0), and a tail tile's n rows (the rest is zero
    padding, which the kernels neither read nor multiply), times 8 lanes."""
    n, half, lanes = fac.n, fac.half, tk.LEAD_MULTIPLE
    tiles = fac.ld // lanes
    head = sum(min(lanes * t + lanes + half, n) - max(lanes * t - half, 0)
               for t in range(tiles))
    return head * lanes, tiles * n * lanes


def ht_plane_bytes(fac, lines) -> int:
    """Bytes of the hybrid pivots of ``lines`` of one slab: each line's
    entries (:func:`ht_line_rows`) in two bf16 planes."""
    head, tail = ht_line_rows(fac)
    return sum(2 * 2 * (head if j < fac.tail_start else tail) for j in lines)


def ht_flops(fac, r: int, lines) -> int:
    """Operations of the pivot products of ``lines`` (both planes, 2r rows, a
    multiply and an add per entry)."""
    head, tail = ht_line_rows(fac)
    return sum(2 * 2 * 2 * r * (head if j < fac.tail_start else tail) for j in lines)


def bound_of(nbytes: int, flops: int, r: int = 1):
    """The larger of the bytes' time and the products' (:func:`product_ms`:
    f32 at r <= 2, three bf16 terms on the tensor cores at r = 4 and 8)."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    flops_ms = product_ms(flops, r)
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def ht_pass_bound(fac, r: int, lines, stacks: int, batch: int = 1):
    """A hybrid pass over ``lines`` for ``batch`` rows of distinct slabs: each
    line's pivots and band once, ``stacks`` row stacks per line, the carry."""
    row = 2 * r * fac.ld * 4
    nbytes = batch * (ht_plane_bytes(fac, lines) + len(lines) * (24 * fac.ld + stacks * row) + row)
    return bound_of(nbytes, batch * ht_flops(fac, r, lines), r)


def ht_sweep_bound(fac, r: int, tt: int, up: bool):
    """One fused sweep direction over all slabs, each input read once and each
    output written once: every line's pivots once (the down kernel's backward
    pass re-reads its tail lines, not counted), the bands, rows and traces."""
    S, m, ld = fac.n_slabs, fac.m, fac.ld
    row = 2 * r * ld * 4
    lines = range(m)
    if up:    # bands: l of tt lines, u of m; rows: b of tt, the y cache of m - tt, t carry, u out
        per_slab = (tt + m) * 24 * ld + (tt + (m - tt) + 1 + m) * row
        flops = ht_flops(fac, r, range(m - tt, m)) + ht_flops(fac, r, lines)
    else:     # bands: l of m, u of tt; rows: b in, y and t out
        per_slab = (m + tt) * 24 * ld + 3 * m * row
        flops = ht_flops(fac, r, lines) + ht_flops(fac, r, range(m - tt, m))
    nbytes = S * (ht_plane_bytes(fac, lines) + per_slab + row + 2 * 24 * ld) + 6 * S * 4
    return bound_of(nbytes, S * flops, r)


def library_ht_ms(fac, rows: torch.Tensor, slab_lines, dense_re, dense_im) -> float:
    """Yardstick: library bf16 products of one (2r, ld) row block with the
    pivots of ``slab_lines`` ((slab, line) pairs): batched over tiles against
    the head windows, dense against the tail planes (``dense_*[s, k]``, line
    ``tail_start + k``); no band term, no dependency."""
    wt = 8 + 2 * fac.half
    win = torch.nn.functional.pad(rows, (fac.half, fac.half)).unfold(-1, wt, tk.LEAD_MULTIPLE)
    win = win.transpose(0, 1).to(torch.bfloat16).contiguous()        # (tiles, 2r, wt)
    rows_bf16 = rows.to(torch.bfloat16)
    ts = fac.tail_start
    ops = [(win, fac.head_re[s, j], fac.head_im[s, j]) if j < ts
           else (rows_bf16, dense_re[s, j - ts], dense_im[s, j - ts]) for s, j in slab_lines]

    def loop():
        for a, p_re, p_im in ops:
            torch.matmul(a, p_re)
            torch.matmul(a, p_im)

    return time_ms(loop, 2)


def phase_ht_kernel_times(problem, path_counts: dict, sweep_counts: dict) -> list:
    """Each kernel of the banded+tail path on the solve's own pivots and
    right-hand sides, r = 1 (``solve``) and r = 2 (``solve_batched``): the
    fused sweep kernels over the 16 slabs (with the solve's launches); the
    hybrid passes at one inner slab, the forward pass in full and resumed at
    ``m - trace_tail``, the backward pass in full and truncated to
    ``trace_tail``, and at one batch row per slab (``jacobi_sweep``'s solves
    of all slabs), each with ``jacobi_sweep``'s launches at its r."""
    slabs = problem.precond.slabs
    fac = slabs.pfac
    S, m, n, ld, tt = fac.n_slabs, fac.m, fac.n, fac.ld, slabs.trace_tail
    j0 = m - tt
    slab = S // 2
    s_idx = fac.slab_ids[slab : slab + 1]
    tables = slabs.sweep_tables
    dense_re, dense_im = tk.dense_planes(fac.tail_re), tk.dense_planes(fac.tail_im)
    all_lines = [(s, j) for s in range(S) for j in range(m)]
    kernels = []
    for r, path in ((1, "ht_solve"), (2, "ht_solve_batched")):
        _, b4s = sweep_rows(problem, r)
        shape = dict(S=S, m=m, n=n, ld=ld, width=fac.width, tail_start=fac.tail_start,
                     trace_tail=tt, r=r)
        y4s, t4s, unps = sk.sweep_down(fac, tables.meta, b4s, tables.c01, tables.c10, tt)
        lib_down = library_ht_ms(fac, b4s[0, 0], all_lines + [(s, j) for s in range(S)
                                                              for j in range(j0, m)],
                                 dense_re, dense_im)
        lib_up = library_ht_ms(fac, b4s[0, 0], [(s, j) for s in range(S) for j in range(j0, m)]
                               + all_lines, dense_re, dense_im)
        kernels += [
            kernel_entry("sweep_down", r, path, path_counts[r]["sweep_down"],
                         lambda: sk.sweep_down(fac, tables.meta, b4s, tables.c01, tables.c10, tt),
                         lambda: sk.sweep_down_plain(fac, tables.meta, b4s, tables.c01,
                                                     tables.c10, tt),
                         ht_sweep_bound(fac, r, tt, up=False), lib_down, shape),
            kernel_entry("sweep_up", r, path, path_counts[r]["sweep_up"],
                         lambda: sk.sweep_up(fac, tables.meta, b4s, tables.cnpn, tables.cnnp,
                                             y4s, t4s, unps, tt),
                         lambda: sk.sweep_up_plain(fac, tables.meta, b4s, tables.cnpn,
                                                   tables.cnnp, y4s, t4s, unps, tt),
                         ht_sweep_bound(fac, r, tt, up=True), lib_up, shape),
        ]
        line_step_report(path, r, [(kernels[-2], S * (m + tt)), (kernels[-1], S * (tt + m))], {
            "sweep_down": lambda: sk.sweep_down(fac, tables.meta, b4s, tables.c01,
                                                tables.c10, tt),
            "sweep_up": lambda: sk.sweep_up(fac, tables.meta, b4s, tables.cnpn, tables.cnnp,
                                            y4s, t4s, unps, tt)})
        # the hybrid passes at one inner slab, with jacobi_sweep's launches
        counts = sweep_counts["jacobi_sweep" if r == 1 else "jacobi_sweep_r2"]
        cpath = "ht_jacobi_sweep" if r == 1 else "ht_jacobi_sweep_r2"
        b4 = b4s[slab : slab + 1].contiguous()
        y4, t4 = tk.forward_substitution_cached(fac, s_idx, b4)
        b4_up = b4.clone()
        b4_up[:, j0:] += y4[:, j0:].flip(1)
        t_init = t4[:, j0 - 1].contiguous()
        zero = torch.zeros_like(t_init)
        out_k, out_p = (y4.clone(), t4.clone()), (y4.clone(), t4.clone())

        def resumed(fn, out):
            y, t = fn(fac, s_idx, b4_up, t_init, start=j0, out=out)
            return y[:, j0:], t[:, j0:]

        one = dict(shape, B=1, slab=slab)
        lines, tail_lines = range(m), range(j0, m)
        lib_full = library_ht_ms(fac, b4[0, 0], [(slab, j) for j in lines], dense_re, dense_im)
        lib_tail = library_ht_ms(fac, b4[0, 0], [(slab, j) for j in tail_lines],
                                 dense_re, dense_im)
        kernels += [
            kernel_entry("thomas_forward_ht", r, cpath, counts["thomas_forward_ht"],
                         lambda: tk.forward_substitution_cached(fac, s_idx, b4),
                         lambda: tk.forward_substitution_ht_plain(fac, s_idx, b4, zero),
                         ht_pass_bound(fac, r, lines, 3), lib_full, one),
            kernel_entry("thomas_forward_ht", r, cpath, counts["thomas_forward_ht"],
                         lambda: resumed(tk.forward_substitution_cached, out_k),
                         lambda: resumed(tk.forward_substitution_ht_plain, out_p),
                         ht_pass_bound(fac, r, tail_lines, 3), lib_tail, dict(one, start=j0),
                         variant="_resumed"),
            kernel_entry("thomas_backward_ht", r, cpath, counts["thomas_backward_ht"],
                         lambda: tk.backward_substitution(fac, s_idx, y4),
                         lambda: tk.backward_substitution_ht_plain(fac, s_idx, y4),
                         ht_pass_bound(fac, r, lines, 2), lib_full, one),
            kernel_entry("thomas_backward_ht", r, cpath, counts["thomas_backward_ht"],
                         lambda: tk.backward_substitution(fac, s_idx, y4, tail=tt),
                         lambda: tk.backward_substitution_ht_plain(fac, s_idx, y4, tail=tt),
                         ht_pass_bound(fac, r, tail_lines, 2), lib_tail, dict(one, tail=tt),
                         variant="_tail"),
        ]
        line_step_report(cpath, r, [(kernels[-4], m), (kernels[-3], tt), (kernels[-2], m),
                                    (kernels[-1], tt)], {
            "thomas_forward_ht": lambda: tk.forward_substitution_cached(fac, s_idx, b4),
            "thomas_forward_ht_resumed": lambda: resumed(tk.forward_substitution_cached,
                                                         out_k),
            "thomas_backward_ht": lambda: tk.backward_substitution(fac, s_idx, y4),
            "thomas_backward_ht_tail": lambda: tk.backward_substitution(fac, s_idx, y4,
                                                                        tail=tt)})
        if r == 1:      # jacobi_sweep's solves of all slabs at once
            yall, _ = tk.forward_substitution_cached(fac, fac.slab_ids, b4s)
            counts = sweep_counts["jacobi_sweep"]
            lib_all = library_ht_ms(fac, b4s[0, 0], all_lines, dense_re, dense_im)
            kernels += [
                kernel_entry("thomas_forward_ht", r, "ht_jacobi_sweep",
                             counts["thomas_forward_ht"],
                             lambda: tk.forward_substitution_cached(fac, fac.slab_ids, b4s),
                             lambda: tk.forward_substitution_ht_plain(
                                 fac, fac.slab_ids, b4s, torch.zeros_like(b4s[:, 0])),
                             ht_pass_bound(fac, r, lines, 3, batch=S), lib_all,
                             dict(shape, B=S), variant="_all_slabs"),
                kernel_entry("thomas_backward_ht", r, "ht_jacobi_sweep",
                             counts["thomas_backward_ht"],
                             lambda: tk.backward_substitution(fac, fac.slab_ids, yall),
                             lambda: tk.backward_substitution_ht_plain(fac, fac.slab_ids, yall),
                             ht_pass_bound(fac, r, lines, 2, batch=S), lib_all,
                             dict(shape, B=S), variant="_all_slabs"),
            ]
    del dense_re, dense_im
    torch.cuda.empty_cache()
    return kernels


def phase_ht_wide(problem, sweep_counts: dict) -> list:
    """Path 5 (e): the first eight wide directions in one joint solve on
    banded+tail pivots, every sweep direction one launch of eight, and all
    sixteen, one launch of sixteen (the fused kernels only: no hybrid pass
    and no dense line kernel may launch), beside the same directions as joint
    pairs; then one ``jacobi_sweep`` of the eight on the same problem, the
    hybrid passes at one launch a pass (as many launches as its r = 1 sweep);
    then rows 6–9 at r = 3, 4, 8, 12 and 16 on the solve's own pivots and
    right-hand sides (As b of the first r wide directions; r = 3 one launch
    of four, 12 of sixteen): the fused sweep kernels over the 16 slabs with
    the joint solve's launches, the hybrid passes on an inner slab (full; the
    backward pass also over the last trace_tail lines) and, at r = 8, on all
    16 slabs as batch rows (``jacobi_sweep``'s shapes), with the r = 8
    ``jacobi_sweep``'s launches; repeats of each at r = 4, 8 and 16
    bit-identical."""
    wide = phase_wide_2d(problem, "ht_sweep_wide", "ht_solve", "ht_solve_batched", SWEEP_PAIR)
    pc = problem.precond
    slabs = pc.slabs
    fac = slabs.pfac
    S, m, n, ld, tt = fac.n_slabs, fac.m, fac.n, fac.ld, slabs.trace_tail
    rhs = plasma2d.incident_rhs(problem, np.asarray(WIDE_DIRECTIONS))
    b8 = pc.a_s.matvec(rhs[:WIDE_R].T.contiguous())
    jacobi = launches_of(lambda: sweeps.jacobi_sweep(slabs, b8))
    r1 = sweep_counts["jacobi_sweep"]
    emit("ht_jacobi_sweep_wide", r=WIDE_R, launches=jacobi, launches_r1=r1)
    check(all(jacobi[k] == r1[k] > 0 for k in HT_PAIR)
          and not any(jacobi[k] for k in SWEEP_PAIR + DENSE_2D),
          f"jacobi_sweep of {WIDE_R} runs the hybrid passes at one launch a pass "
          f"({jacobi}, r = 1: {r1})")
    tables = slabs.sweep_tables
    slab = S // 2
    s_idx = fac.slab_ids[slab : slab + 1]
    dense_re, dense_im = tk.dense_planes(fac.tail_re), tk.dense_planes(fac.tail_im)
    all_lines = [(s, j) for s in range(S) for j in range(m)]
    tail_all = [(s, j) for s in range(S) for j in range(m - tt, m)]
    lines, tail_lines = range(m), range(m - tt, m)
    kernels = []
    for r in LINE_RS:
        counts = wide_counts_of(wide, r)
        b = pc.a_s.matvec(rhs[:r].T.contiguous())
        b4s = tk._to_rows_b(fac, subdomain.partition_source(slabs, b))
        shape = dict(S=S, m=m, n=n, ld=ld, width=fac.width, tail_start=fac.tail_start,
                     trace_tail=tt, r=r, launch_width=tk.line_width(fac, r, inject=True))
        y4s, t4s, unps = sk.sweep_down(fac, tables.meta, b4s, tables.c01, tables.c10, tt)
        down = lambda: sk.sweep_down(fac, tables.meta, b4s, tables.c01, tables.c10, tt)  # noqa: E731
        up = lambda: sk.sweep_up(fac, tables.meta, b4s, tables.cnpn, tables.cnnp,  # noqa: E731
                                 y4s, t4s, unps, tt)
        path = "ht_sweep_wide"
        kernels += [
            kernel_entry("sweep_down", r, path, counts["sweep_down"], down,
                         lambda: sk.sweep_down_plain(fac, tables.meta, b4s, tables.c01,
                                                     tables.c10, tt),
                         ht_sweep_bound(fac, r, tt, up=False),
                         library_ht_ms(fac, b4s[0, 0], all_lines + tail_all, dense_re, dense_im),
                         shape),
            kernel_entry("sweep_up", r, path, counts["sweep_up"], up,
                         lambda: sk.sweep_up_plain(fac, tables.meta, b4s, tables.cnpn,
                                                   tables.cnnp, y4s, t4s, unps, tt),
                         ht_sweep_bound(fac, r, tt, up=True),
                         library_ht_ms(fac, b4s[0, 0], tail_all + all_lines, dense_re, dense_im),
                         shape),
        ]
        runs = {"sweep_down": down, "sweep_up": up}
        steps = [(kernels[-2], S * (m + tt)), (kernels[-1], S * (tt + m))]
        # the hybrid passes on an inner slab, with the r = 8 jacobi_sweep's launches
        b4 = b4s[slab : slab + 1].contiguous()
        y4, _ = tk.forward_substitution_cached(fac, s_idx, b4)
        zero = torch.zeros_like(b4[:, 0])
        one = dict(shape, B=1, slab=slab, launch_width=tk.line_width(fac, r))
        cpath = "ht_jacobi_sweep_wide"
        lib_full = library_ht_ms(fac, b4[0, 0], [(slab, j) for j in lines], dense_re, dense_im)
        lib_tail = library_ht_ms(fac, b4[0, 0], [(slab, j) for j in tail_lines],
                                 dense_re, dense_im)
        fwd = lambda: tk.forward_substitution_cached(fac, s_idx, b4)  # noqa: E731
        bwd = lambda: tk.backward_substitution(fac, s_idx, y4)  # noqa: E731
        bwd_tail = lambda: tk.backward_substitution(fac, s_idx, y4, tail=tt)  # noqa: E731
        kernels += [
            kernel_entry("thomas_forward_ht", r, cpath, jacobi["thomas_forward_ht"], fwd,
                         lambda: tk.forward_substitution_ht_plain(fac, s_idx, b4, zero),
                         ht_pass_bound(fac, r, lines, 3), lib_full, one),
            kernel_entry("thomas_backward_ht", r, cpath, jacobi["thomas_backward_ht"], bwd,
                         lambda: tk.backward_substitution_ht_plain(fac, s_idx, y4),
                         ht_pass_bound(fac, r, lines, 2), lib_full, one),
            kernel_entry("thomas_backward_ht", r, cpath, jacobi["thomas_backward_ht"], bwd_tail,
                         lambda: tk.backward_substitution_ht_plain(fac, s_idx, y4, tail=tt),
                         ht_pass_bound(fac, r, tail_lines, 2), lib_tail, dict(one, tail=tt),
                         variant="_tail"),
        ]
        runs.update(thomas_forward_ht=fwd, thomas_backward_ht=bwd,
                    thomas_backward_ht_tail=bwd_tail)
        steps += [(kernels[-3], m), (kernels[-2], m), (kernels[-1], tt)]
        if r == WIDE_R:       # jacobi_sweep's solves of all slabs at once
            yall, _ = tk.forward_substitution_cached(fac, fac.slab_ids, b4s)
            lib_all = library_ht_ms(fac, b4s[0, 0], all_lines, dense_re, dense_im)
            kernels += [
                kernel_entry("thomas_forward_ht", r, cpath, jacobi["thomas_forward_ht"],
                             lambda: tk.forward_substitution_cached(fac, fac.slab_ids, b4s),
                             lambda: tk.forward_substitution_ht_plain(
                                 fac, fac.slab_ids, b4s, torch.zeros_like(b4s[:, 0])),
                             ht_pass_bound(fac, r, lines, 3, batch=S), lib_all,
                             dict(shape, B=S), variant="_all_slabs"),
                kernel_entry("thomas_backward_ht", r, cpath, jacobi["thomas_backward_ht"],
                             lambda: tk.backward_substitution(fac, fac.slab_ids, yall),
                             lambda: tk.backward_substitution_ht_plain(fac, fac.slab_ids, yall),
                             ht_pass_bound(fac, r, lines, 2, batch=S), lib_all,
                             dict(shape, B=S), variant="_all_slabs"),
            ]
        if r in LINE_STEP_RS:
            # the wide step's line on this layout (PERF.md section 6), and no
            # race in its handoff: repeats of each kernel give the same bits
            line_step_report(path, r, steps, runs)
    del dense_re, dense_im
    torch.cuda.empty_cache()
    return kernels


# ---------------------------------------------------------------------------
# Path 6: the 801^2, 16-slab double sweep on int8 line pivots
# ---------------------------------------------------------------------------

# RESULTS.md "Pivot-storage precision ladder": the JAX package's int8 line
# pivots at this configuration take 11 and 11 outer iterations on its TPU (bf16
# planes: 6 and 6); printed for information only
JAX_INT8_ITERATIONS = 11
# the one-slab kernel shapes of the int8 check: (S, m, lines resumed, tail)
INT8_SLAB = (16, 70, 48, 22)


def random_int8_factorization(rng, S: int, m: int, n: int, device) -> tk.ThomasFactorization:
    """Contracting random factors (||C|| ||band|| < 1) quantized by the port's
    own int8 packing, a chunk of lines at a time (bounds the temporaries)."""
    ld = tk._round_up(n, tk.LEAD_MULTIPLE)
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    tiles, nb = ld // tk.LEAD_MULTIPLE, tk.n_scale_blocks(ld)
    q = [torch.empty((S, m, tiles, ld, tk.LEAD_MULTIPLE), dtype=torch.int8, device=device)
         for _ in range(2)]
    scale = torch.empty((S, m, tiles, nb, 2, tk.LEAD_MULTIPLE), device=device)
    eye = torch.eye(n, device=device)
    for s in range(S):
        for j0 in range(0, m, 64):
            j1 = min(j0 + 64, m)
            parts = []
            for k, diag in enumerate((0.2, 0.0)):
                p = (0.1 / n ** 0.5) * torch.randn((j1 - j0, n, n), generator=g, device=device)
                q[k][s, j0:j1], sc = tk.quantize_planes(p + diag * eye, ld)
                parts.append(sc)
            scale[s, j0:j1] = tk.tile_scales(*parts)
    bands = [random_rows(rng, (S, m, 2, 3, ld), n, device) * 0.2 for _ in range(2)]
    return tk.ThomasFactorization(q[0], q[1], bands[0], bands[1], n, scale=scale)


def phase_int8_line_kernels(device):
    """The three line kernels on int8 planes against their plain versions on
    random factors at the path's shapes: S = 1, m = n = 801 (rows 1i-2i: the
    forward pass from line 0 and from line 5, the backward pass full and over
    the last 7 lines) and one slab among 16 of m = 70 (rows 3i-5i: the cached
    forward pass in full and resumed at line 48, the backward pass in full and
    over the last 22 lines), at r = 1, 2 and 3 (3 through the grouping, two
    launches)."""
    rng = np.random.default_rng(6)
    worst = dict.fromkeys(INT8_2D, 0.0)
    cases = []
    reset_counts()
    fac = random_int8_factorization(rng, 1, 801, 801, device)
    s_idx = fac.slab_ids
    for r in (1, 2, 3):
        b4 = random_rows(rng, (1, 801, 2 * r, fac.ld), 801, device)
        for start, tail in ((0, 0), (5, 7)):
            y_k = tk.forward_substitution(fac, s_idx, b4, start=start)
            x_k = tk.backward_substitution(fac, s_idx, y_k, tail=tail)
            torch.cuda.synchronize()
            _, e_f = rel_err(y_k, tk.forward_substitution_plain(fac, s_idx, b4, start))
            _, e_b = rel_err(x_k, tk.backward_substitution_plain(fac, s_idx, y_k, tail))
            check(bool(torch.isfinite(x_k).all()), "int8 kernel output is finite")
            worst["thomas_forward_int8"] = max(worst["thomas_forward_int8"], e_f)
            worst["thomas_backward_int8"] = max(worst["thomas_backward_int8"], e_b)
            cases.append(dict(S=1, m=801, r=r, start=start, tail=tail, fwd=e_f, bwd=e_b))
    del fac, b4, y_k, x_k
    S, m, j0, tail = INT8_SLAB
    fac = random_int8_factorization(rng, S, m, 801, device)
    s_idx = fac.slab_ids[S // 2 : S // 2 + 1]
    for r in (1, 2, 3):
        b4 = random_rows(rng, (1, m, 2 * r, fac.ld), 801, device)
        zero = torch.zeros_like(b4[:, 0])
        y4, t4 = tk.forward_substitution_cached(fac, s_idx, b4)
        torch.cuda.synchronize()
        y_p, t_p = tk.forward_substitution_cached_plain(fac, s_idx, b4, zero)
        e_c = max(rel_err(y4, y_p)[1], rel_err(t4, t_p)[1])
        b_up = b4.clone()
        b_up[:, j0:] += y4[:, j0:].flip(1)
        t_init = t4[:, j0 - 1].contiguous()
        out_k, out_p = (y4.clone(), t4.clone()), (y4.clone(), t4.clone())
        yr, tr = tk.forward_substitution_cached(fac, s_idx, b_up, t_init, start=j0, out=out_k)
        torch.cuda.synchronize()
        yr_p, tr_p = tk.forward_substitution_cached_plain(fac, s_idx, b_up, t_init, j0, out_p)
        e_r = max(rel_err(yr[:, j0:], yr_p[:, j0:])[1], rel_err(tr[:, j0:], tr_p[:, j0:])[1])
        e_b = 0.0
        for tl in (0, tail):
            x_k = tk.backward_substitution(fac, s_idx, y4, tail=tl)
            torch.cuda.synchronize()
            e_b = max(e_b, rel_err(x_k, tk.backward_substitution_plain(fac, s_idx, y4, tl))[1])
        worst["thomas_forward_cached_int8"] = max(worst["thomas_forward_cached_int8"], e_c, e_r)
        worst["thomas_backward_int8"] = max(worst["thomas_backward_int8"], e_b)
        cases.append(dict(S=S, m=m, r=r, cached=e_c, resumed=e_r, start=j0, bwd=e_b, tail=tail))
    counts = read_counts()
    emit("int8_line_kernels", n=801, ld=fac.ld, scale_blocks=tk.n_scale_blocks(fac.ld),
         tolerance=KERNEL_TOL, max_rel_err=worst, cases=cases, launches=counts)
    for name, err in worst.items():
        check(err <= KERNEL_TOL, f"{name} within {KERNEL_TOL} of its plain version ({err})")
    check(all(counts[k] > 0 for k in INT8_2D) and not any(counts[k] for k in DENSE_2D),
          f"the int8 kernels ran, and no bf16 line kernel ({counts})")
    del fac
    torch.cuda.empty_cache()


def phase_small_reference_int8(device):
    """The 3-slab, h = 1/40 double-sweep problem on int8 line pivots, set up on
    the CPU and moved to the card: the solve on the card (the int8 kernels)
    against the same solve on the CPU (plain versions) on the same planes, both
    stopped at rtol 1e-5 (the float32 floor of this grid is near 1e-6)."""
    kw = dict(rtol=1e-5, restart=20, maxiter=20)
    p_cpu = plasma2d.build_problem(h=1 / 40, n_subdomains=3, npml=6, double_sweep=True,
                                   pivot_dtype="pallas_int8", device="cpu")
    p_card = move_to(p_cpu, device)
    reset_counts()
    x_k, i_k = plasma2d.solve(p_card, (1.0, 0.0), **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    x_c, i_c = plasma2d.solve(p_cpu, (1.0, 0.0), **kw)
    _, err = rel_err(x_k.cpu(), x_c)
    emit("small_reference_int8", n=41, n_subdomains=3, rtol=kw["rtol"],
         iterations=[int(i_k.n_iterations), int(i_c.n_iterations)],
         true_residual=[float(i_k.true_residual), float(i_c.true_residual)],
         rel_err_card_vs_cpu=err, tolerance=1e-4, launches=counts)
    check(bool(i_k.converged) and bool(i_c.converged), "small int8 solves converged")
    check(err <= 1e-4, f"card int8 solve within 1e-4 of the CPU one ({err})")
    check(all(counts[k] > 0 for k in ("thomas_forward_cached_int8", "thomas_backward_int8"))
          and not any(counts[k] for k in DENSE_2D), f"the int8 kernels ran ({counts})")


def phase_int8_sweeps(problem) -> dict:
    """``jacobi_sweep`` over both directions' slabs at r = 1 and 2 (the path
    of rows 1i-2i: one batched launch over the 16 slabs per solve of all
    slabs), a ``gs_sweep`` and an apply, with their times.  Returns the launch
    counts by path."""
    pc = problem.precond
    counts, res = {}, {}
    for r in (1, 2):
        b, _ = sweep_rows(problem, r)
        for name, slabs, vec in (("y", pc.slabs, b), ("x", pc.slabs_t, pc._transpose_flat(b))):
            reset_counts()
            u = sweeps.jacobi_sweep(slabs, vec)
            torch.cuda.synchronize()
            counts[f"jacobi_sweep_{name}_r{r}"] = read_counts()
            check(bool(torch.isfinite(torch.view_as_real(u)).all()), "jacobi_sweep output is finite")
    b, _ = sweep_rows(problem, 1)
    for name, fn in (("gs_sweep", sweeps.gs_sweep), ("jacobi_sweep", sweeps.jacobi_sweep)):
        res[name] = float(torch.linalg.vector_norm(pc.msp.matvec(fn(pc.slabs, b)) - b)
                          / torch.linalg.vector_norm(b))
    rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:1]))[0]
    emit("int8_sweeps", n_subdomains=pc.slabs.n_subs, m1_max=pc.slabs.m1_max,
         trace_tail=pc.slabs.trace_tail, storage=[pc.slabs.pfac.storage, pc.slabs_t.pfac.storage],
         residual_of_msp=res,
         gs_sweep_ms=time_ms(lambda: sweeps.gs_sweep(pc.slabs, b), 3),
         jacobi_sweep_ms=time_ms(lambda: sweeps.jacobi_sweep(pc.slabs, b), 3),
         apply_ms=time_ms(lambda: pc.apply(rhs), 3),
         apply_enqueue_ms=enqueue_ms(lambda: pc.apply(rhs), 3), launches=counts)
    for path, c in counts.items():
        check(c["thomas_forward_int8"] > 0 and c["thomas_backward_int8"] > 0
              and not any(c[k] for k in DENSE_2D + HT_PAIR + SWEEP_PAIR),
              f"{path} ran the int8 pair and no other line kernel ({c})")
    return counts


def int8_pass_bound(lines: int, n: int, ld: int, r: int, stacks: int, batch: int = 1):
    """Least time for ``lines`` lines of an int8 pass for ``batch`` rows of
    distinct slabs: the n input rows of two int8 planes of ld output lanes
    (the kernels read no padding row) and their scales, the band and
    ``stacks`` row stacks per line, plus the carry, against the card's memory
    rate; the products (:func:`product_ms`) and the dequantization (one
    operation per entry) against its float32 rate."""
    row = 2 * r * ld * 4
    nb = tk.n_scale_blocks(ld)
    line_bytes = 2 * n * ld + 2 * nb * ld * 4 + 2 * 3 * ld * 4 + stacks * row
    bytes_ms = 1e3 * batch * (lines * line_bytes + row) / PEAK_BYTES_PER_S
    ops_ms = (product_ms(batch * lines * 2 * 2 * (2 * r) * n * ld, r)
              + 1e3 * batch * lines * 2 * n * ld / PEAK_F32_FLOPS)
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_int8_kernel_times(problem, path_counts: dict, jacobi_counts: dict,
                            wide_counts: dict) -> list:
    """Each int8 kernel on the solve's own planes and right-hand sides: at one
    inner slab among 16 (m = 70), the cached forward pass in full and resumed
    at ``m - trace_tail``, the backward pass in full and truncated to
    ``trace_tail``, r = 1 (``int8_sweep_solve``) and r = 2
    (``int8_sweep_solve_batched``); then the forward and backward passes at
    one batch row per slab (``jacobi_sweep``'s solves of all slabs), r = 1
    and 2, and the forward pass there at r = 3, 4, 8, 12 and 16, its launches
    read from ``int8_sweep_wide``'s R = 8 and R = 16 joint solves
    (``wide_counts``, by width: :func:`wide_counts_of`).  The
    library yardstick is the bf16 ``torch.matmul`` of the same rows with
    planes of the same shape."""
    pc = problem.precond
    slabs = pc.slabs
    fac = slabs.pfac
    S, m, n, ld, tail = fac.n_slabs, fac.m, fac.n, fac.ld, slabs.trace_tail
    j0 = m - tail
    slab = S // 2
    s_idx = fac.slab_ids[slab : slab + 1]
    dense_re = tk.dense_planes(fac.cinv_t_re[slab]).to(torch.bfloat16)
    dense_im = tk.dense_planes(fac.cinv_t_im[slab]).to(torch.bfloat16)
    kernels = []
    for r, path in ((1, "int8_sweep_solve"), (2, "int8_sweep_solve_batched")):
        _, b4s = sweep_rows(problem, r)
        b4 = b4s[slab : slab + 1].contiguous()
        y4, t4 = tk.forward_substitution_cached(fac, s_idx, b4)
        b4_up = b4.clone()
        b4_up[:, j0:] += y4[:, j0:].flip(1)
        t_init = t4[:, j0 - 1].contiguous()
        zero = torch.zeros_like(t_init)
        out_k, out_p = (y4.clone(), t4.clone()), (y4.clone(), t4.clone())

        def resumed(fn, out):
            y, t = fn(fac, s_idx, b4_up, t_init, start=j0, out=out)
            return y[:, j0:], t[:, j0:]

        shape = dict(B=1, S=S, slab=slab, m=m, n=n, ld=ld, r=r)
        lib_full = library_pass_ms(b4[0, 0], dense_re, dense_im, range(m))
        lib_tail = library_pass_ms(b4[0, 0], dense_re, dense_im, range(j0, m))
        counts = path_counts[r]
        replaces_bwd = SWEEP_BACKWARD_R1 if r == 1 else None
        kernels += [
            kernel_entry(
                "thomas_forward_cached_int8", r, path, counts["thomas_forward_cached_int8"],
                lambda: tk.forward_substitution_cached(fac, s_idx, b4),
                lambda: tk.forward_substitution_cached_plain(fac, s_idx, b4, zero),
                int8_pass_bound(m, n, ld, r, stacks=3), lib_full, shape),
            kernel_entry(
                "thomas_forward_cached_int8", r, path, counts["thomas_forward_cached_int8"],
                lambda: resumed(tk.forward_substitution_cached, out_k),
                lambda: resumed(tk.forward_substitution_cached_plain, out_p),
                int8_pass_bound(tail, n, ld, r, stacks=3), lib_tail, dict(shape, start=j0),
                variant="_resumed"),
            kernel_entry(
                "thomas_backward_int8", r, path, counts["thomas_backward_int8"],
                lambda: tk.backward_substitution(fac, s_idx, y4),
                lambda: tk.backward_substitution_plain(fac, s_idx, y4),
                int8_pass_bound(m, n, ld, r, stacks=2), lib_full, shape,
                variant="_slab", replaces=replaces_bwd),
            kernel_entry(
                "thomas_backward_int8", r, path, counts["thomas_backward_int8"],
                lambda: tk.backward_substitution(fac, s_idx, y4, tail=tail),
                lambda: tk.backward_substitution_plain(fac, s_idx, y4, tail=tail),
                int8_pass_bound(tail, n, ld, r, stacks=2), lib_tail, dict(shape, tail=tail),
                variant="_slab_tail", replaces=replaces_bwd),
        ]
        line_step_report(path, r, [(kernels[-4], m), (kernels[-3], tail)], {
            "thomas_forward_cached_int8": lambda: tk.forward_substitution_cached(fac, s_idx, b4),
            "thomas_forward_cached_int8_resumed": lambda: resumed(
                tk.forward_substitution_cached, out_k)})
        # the batched pair with one batch row per slab (jacobi_sweep's solve_all)
        yall = tk.forward_substitution(fac, fac.slab_ids, b4s)
        jc = jacobi_counts[f"jacobi_sweep_y_r{r}"]
        shape_all = dict(B=S, S=S, m=m, n=n, ld=ld, r=r)
        bound = int8_pass_bound(m, n, ld, r, stacks=2, batch=S)
        # the same count of products of the same shapes, on one slab's planes
        # (each slab's 70 lines of planes are 183 MB, past the L2 cache)
        lib_all = library_pass_ms(b4[0, 0], dense_re, dense_im, list(range(m)) * S)
        kernels += [
            kernel_entry("thomas_forward_int8", r, f"int8_jacobi_sweep_r{r}",
                         jc["thomas_forward_int8"],
                         lambda: tk.forward_substitution(fac, fac.slab_ids, b4s),
                         lambda: tk.forward_substitution_plain(fac, fac.slab_ids, b4s),
                         bound, lib_all, shape_all),
            kernel_entry("thomas_backward_int8", r, f"int8_jacobi_sweep_r{r}",
                         jc["thomas_backward_int8"],
                         lambda: tk.backward_substitution(fac, fac.slab_ids, yall),
                         lambda: tk.backward_substitution_plain(fac, fac.slab_ids, yall),
                         bound, lib_all, shape_all),
        ]
    # the forward pass at r = 3, 4, 8, 12 and 16 (one launch each) on the
    # same 16 batch rows, As b of the first r wide directions
    for r in LINE_RS:
        rhs = plasma2d.incident_rhs(problem, np.asarray(WIDE_DIRECTIONS[:r]))
        b4s = tk._to_rows_b(fac, subdomain.partition_source(slabs, pc.a_s.matvec(
            rhs.T.contiguous())))
        entry = kernel_entry(
            "thomas_forward_int8", r, "int8_sweep_wide",
            wide_counts_of(wide_counts, r)["thomas_forward_int8"],
            lambda: tk.forward_substitution(fac, fac.slab_ids, b4s),
            lambda: tk.forward_substitution_plain(fac, fac.slab_ids, b4s),
            int8_pass_bound(m, n, ld, r, stacks=2, batch=S),
            library_pass_ms(b4s[0, 0], dense_re, dense_im, list(range(m)) * S),
            dict(B=S, S=S, m=m, n=n, ld=ld, r=r, launch_width=tk.line_width(fac, r)))
        entry["library_call"] = LIBRARY_CALL_INT8
        kernels.append(entry)
    del dense_re, dense_im
    torch.cuda.empty_cache()
    return kernels


# ---------------------------------------------------------------------------
# Path 7: build_problem(use_pallas=True), the stencil matvec kernel
# ---------------------------------------------------------------------------

# path 2 (dense bf16 planes, the same sweeps): 6 iterations (PERF.md)
PATH2_ITERATIONS = 6


def stencil_bound(m: int, n: int):
    """The field (9 complex64 a node), u and y (one complex64 a node each),
    each once, against the card's memory rate; 9 complex multiply-adds a
    node against its float32 rate."""
    return bound_of(m * n * (72 + 8 + 8), m * n * 9 * 8)


def stencil_csr(values: torch.Tensor) -> torch.Tensor:
    """The assembled (mn, mn) sparse CSR matrix of a (m, n, 3, 3) complex64
    stencil field (taps that leave the grid dropped), for the library
    yardstick; never used by the port."""
    m, n = values.shape[:2]
    dev = values.device
    j = torch.arange(m, device=dev)[:, None].expand(m, n)
    i = torch.arange(n, device=dev)[None, :].expand(m, n)
    rows, cols, vals = [], [], []
    for dj in range(3):
        for di in range(3):
            jj, ii = j + dj - 1, i + di - 1
            keep = (jj >= 0) & (jj < m) & (ii >= 0) & (ii < n)
            rows.append((j * n + i)[keep])
            cols.append((jj * n + ii)[keep])
            vals.append(values[:, :, dj, di][keep])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals).to(torch.complex64), (m * n, m * n))
    return coo.coalesce().to_sparse_csr()


def library_stencil_ms(csr: torch.Tensor, u_col: torch.Tensor) -> tuple:
    """The cuSPARSE CSR matvec of the stencil's matrix, from a CUDA graph as
    the kernel beside it; back to back where it cannot be captured.
    Returns (ms, how it was timed)."""
    try:
        return graph_ms(lambda: csr @ u_col), "graph"
    except RuntimeError as exc:
        torch.cuda.synchronize()
        emit("stencil_library_not_captured", error=str(exc)[:300])
        return time_ms(lambda: csr @ u_col, 20), "back-to-back"


def stencil_entry(values, u, path: str, launches: int) -> dict:
    """The stencil kernel held against its plain version on ``values`` and
    ``u``, both timed from a CUDA graph (the kernel is shorter than its
    wrapper's host work), with the bound and the cuSPARSE CSR matvec of the
    same matrix as the library yardstick."""
    m, n = values.shape[:2]
    csr = stencil_csr(values)
    u_col = u.reshape(-1, 1).to(torch.complex64)
    library_ms, library_timing = library_stencil_ms(csr, u_col)
    # the same matrix: the sums cancel (|S u| is far below |S| |u| for the
    # annihilator stencils), so two summation orders differ near 2e-5
    _, err = rel_err((csr @ u_col).reshape(-1), stk.stencil_matvec_2d_plain(values, u).reshape(-1))
    check(err <= KERNEL_TOL, f"the CSR yardstick computes the same matvec ({err})")
    del csr
    return kernel_entry("stencil_matvec", 1, path, launches,
                        lambda: stk.stencil_matvec_2d(values, u),
                        lambda: stk.stencil_matvec_2d_plain(values, u),
                        stencil_bound(m, n), library_ms,
                        dict(m=m, n=n, dtype=str(values.dtype), library_timing=library_timing),
                        graph=True)


def phase_stencil_kernel(device):
    """The stencil kernel against its plain version on a random complex64
    field and u at 801^2, and on a complex128 one (computed in complex64,
    returned in complex128); each timed from a CUDA graph and back to back
    (the wrapper's host work), the complex64 one beside the cuSPARSE CSR
    matvec of the same matrix."""
    g = torch.Generator(device=device).manual_seed(13)
    out = {}
    for dtype in (torch.complex64, torch.complex128):
        values = torch.randn((801, 801, 3, 3), dtype=dtype, generator=g, device=device)
        u = torch.randn((801 * 801,), dtype=dtype, generator=g, device=device)
        got = stk.stencil_matvec_2d(values, u)
        torch.cuda.synchronize()
        _, err = rel_err(got, stk.stencil_matvec_2d_plain(values, u))
        check(got.dtype == dtype and tuple(got.shape) == (801 * 801,), "stencil output shape")
        check(err <= KERNEL_TOL, f"stencil kernel within {KERNEL_TOL} ({dtype}: {err})")
        out[str(dtype)] = dict(
            max_rel_err=err, graph_ms=graph_ms(lambda: stk.stencil_matvec_2d(values, u)),
            back_to_back_ms=time_ms(lambda: stk.stencil_matvec_2d(values, u), 20))
        if dtype == torch.complex64:
            csr = stencil_csr(values)
            out[str(dtype)]["library_ms"], out[str(dtype)]["library_timing"] = (
                library_stencil_ms(csr, u.reshape(-1, 1)))
            del csr
    emit("stencil_kernel", m=801, n=801, tolerance=KERNEL_TOL, cases=out,
         bound_ms=stencil_bound(801, 801)[0])


class CountingPreconditioner:
    """A preconditioner that counts its single-RHS applies."""

    def __init__(self, inner):
        self.inner = inner
        self.applies = 0

    def apply(self, b):
        self.applies += int(b.ndim == 1)
        return self.inner.apply(b)

    def apply_batch(self, b):
        return self.inner.apply_batch(b)


def phase_pallas_stencil_solve(device, repeats: int = 3) -> list:
    """``plasma2d.build_problem(use_pallas=True)`` with every other argument
    at its default (h = 1/800, 16 slabs, the double sweep, full pivots with
    bf16 kernel planes attached to both directions), and ``solve`` on it: the
    stencil kernel must launch once per single-RHS preconditioner apply, the
    dense bf16 line kernels must run, nothing else.  Returns the stencil
    kernel's entry, on the solve's own field."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = plasma2d.build_problem(use_pallas=True, device=device)
    setup_s = time.perf_counter() - t0
    pc = problem.precond
    check(pc.a_s.use_pallas and not pc.msp.use_pallas, "the flag is on a_s only")
    check(all(sl.pfac.storage == "bf16" and sl.fac.cinv.shape[-1] == sl.n
              for sl in (pc.slabs, pc.slabs_t)), "full pivots with bf16 planes beside them")
    counting = CountingPreconditioner(pc)
    cproblem = dataclasses.replace(problem, precond=counting)

    def reset_applies():
        counting.applies = 0

    plasma2d.solve(cproblem, (1.0, 0.0), **SOLVE_KW)          # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: plasma2d.solve(cproblem, (1.0, 0.0), **SOLVE_KW), repeats, reset_applies)
    n_it = int(info.n_iterations)
    emit("pallas_stencil_solve", grid=[problem.grid.m, problem.grid.n], k=problem.k,
         n_subdomains=pc.slabs.n_subs, pivot_dtype="full", use_pallas=True,
         setup_seconds=problem.setup_seconds, setup_total_seconds=setup_s,
         solve_ms=sorted(times)[len(times) // 2], solve_ms_runs=times, iterations=n_it,
         path2_iterations=PATH2_ITERATIONS, converged=bool(info.converged),
         residuals=[float(v) for v in info.residuals[: n_it + 1]],
         true_residual=float(info.true_residual), single_rhs_applies=counting.applies,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts)
    check(tuple(x.shape) == (problem.grid.size,), "solution shape")
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "solution is finite")
    check(bool(info.converged), "801^2 use_pallas solve converged")
    check(float(info.true_residual) <= 1e-3, "true residual <= 1e-3")
    check(counting.applies > 0 and counts["stencil_matvec"] == counting.applies,
          f"one stencil launch per single-RHS apply ({counts['stencil_matvec']} against "
          f"{counting.applies})")
    check(all(counts[k] > 0 for k in ("thomas_forward_cached", "thomas_backward"))
          and not any(counts[k] for k in INT8_2D + HT_PAIR + SWEEP_PAIR),
          f"the sweeps ran the dense bf16 kernels only ({counts})")
    rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:1]))[0]
    entry = stencil_entry(pc.a_s.values, rhs, "pallas_stencil_solve", counts["stencil_matvec"])
    del problem, cproblem, counting, pc
    torch.cuda.empty_cache()
    return [entry]


# ---------------------------------------------------------------------------
# Path 8: the 401^2 polarized-traces solve on the dense line kernels
# ---------------------------------------------------------------------------

# tests/plasma_integral_system_example.jl at full size: h = 1/400, k = 400,
# 8 slabs, npml = 10, the trapezoidal operator (build_problem's default)
POLARIZED = dict(h=1.0 / 400.0, n_subdomains=8, npml=10)
JAX_POLARIZED_ITERATIONS = {2: 6, 1: 5}     # RESULTS.md, by nIt


class InnerSolves:
    """Counts the inner GMRES solves of a polarized preconditioner and their
    iterations (the joint solve's: the most any direction took) while it is
    entered, by wrapping ``gmres`` and ``gmres_batched`` of its module
    (``polarized`` in 2D, ``polarized3d`` in 3D)."""

    def __init__(self, module=polarized):
        self.module = module
        self.solves = self.iterations = 0

    def reset(self):
        self.solves = self.iterations = 0

    def _counted(self, fn):
        def run(*args, **kwargs):
            x, info = fn(*args, **kwargs)
            self.solves += 1
            self.iterations += int(info.n_iterations.max())
            return x, info
        return run

    def __enter__(self):
        self._saved = (self.module.gmres, self.module.gmres_batched)
        self.module.gmres, self.module.gmres_batched = map(self._counted, self._saved)
        return self

    def __exit__(self, *exc):
        self.module.gmres, self.module.gmres_batched = self._saved


def phase_polarized_solve(device, repeats: int = 3):
    """``plasma_integral2d.build_problem`` at the reference configuration on
    bf16 kernel planes, then ``solve`` (nIt = 2), ``solve_batched`` over two
    directions, and ``solve`` with the same slabs at nIt = 1; each timed
    (median of ``repeats`` after a warm-up) with its iterations beside the JAX
    record, its inner GMRES iterations per outer apply and its launches.  Only
    the dense bf16 line kernels may launch.  Returns the problem and the
    launch counts of the single and the joint solve, and the single solve's
    solution."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = plasma_integral2d.build_problem(**POLARIZED, n_it=2, dtype=torch.complex64,
                                              pivot_dtype="pallas", device=device)
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    slabs = problem.precond.slabs
    check(polarized.pallas_only(slabs) and slabs.pfac.storage == "bf16",
          "the polarized slabs keep bf16 kernel planes only")
    # the local solves: solve_all (the forward and backward passes) and
    # solve_support (at r = 1 the cached forward and the backward pass, at
    # r = 2 solve_all's pair); the joint solve runs r = 2 only
    absent = tuple(k for k in COUNTERS if k not in DENSE_2D)
    runs = (
        ("polarized_solve", problem, 2, DENSE_2D,
         lambda p: plasma_integral2d.solve(p, DIRECTIONS[0], **SOLVE_KW)),
        ("polarized_solve_batched", problem, 2, ("thomas_forward", "thomas_backward"),
         lambda p: plasma_integral2d.solve_batched(p, DIRECTIONS, **SOLVE_KW)),
        ("polarized_solve_nit1",
         dataclasses.replace(problem, precond=dataclasses.replace(problem.precond, n_it=1)),
         1, DENSE_2D, lambda p: plasma_integral2d.solve(p, DIRECTIONS[0], **SOLVE_KW)),
    )
    counts, solutions = {}, {}
    for name, prob, n_it, path_kernels, run in runs:
        with InnerSolves() as inner:
            run(prob)                                          # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (x, info), times, c = timed_solves(lambda: run(prob), repeats, inner.reset)
        batched = info.n_iterations.ndim == 1
        its = [int(v) for v in info.n_iterations.reshape(-1)]
        true_res = [float(v) for v in info.true_residual.reshape(-1)]
        emit(name, grid=[prob.grid.m, prob.grid.n], k=prob.k, n_subdomains=slabs.n_subs,
             npml=POLARIZED["npml"], n_it=n_it, quad_rule=prob.op.quad_rule,
             pivot_dtype="pallas", m1_max=slabs.m1_max, trace_head=slabs.trace_head,
             trace_tail=slabs.trace_tail, directions=DIRECTIONS if batched else DIRECTIONS[:1],
             solve_ms=sorted(times)[len(times) // 2], solve_ms_runs=times, iterations=its,
             jax_tpu_iterations=[JAX_POLARIZED_ITERATIONS[n_it]] * len(its),
             converged=[bool(v) for v in info.converged.reshape(-1)], true_residual=true_res,
             inner_solves=inner.solves,
             inner_iterations_per_apply=inner.iterations / max(inner.solves, 1),
             setup_seconds=problem.setup_seconds, setup_total_seconds=setup_s,
             setup_peak_memory_bytes=setup_peak,
             peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=c)
        want = (len(DIRECTIONS), prob.grid.size) if batched else (prob.grid.size,)
        check(tuple(x.shape) == want, f"{name} solution shape")
        check(bool(torch.isfinite(torch.view_as_real(x)).all()), f"{name} solution is finite")
        check(bool(info.converged.all()), f"401^2 {name} converged")
        check(max(true_res) <= 1e-3, f"{name} true residual <= 1e-3 ({true_res})")
        check(all(c[k] > 0 for k in path_kernels),
              f"every kernel of the path launched in {name} ({c})")
        check(not any(c[k] for k in absent), f"no kernel of {absent} launched in {name}")
        counts[name], solutions[name] = c, x
    return problem, counts, solutions["polarized_solve"]


def phase_polarized_reference(device, x_kernel: torch.Tensor):
    """The same configuration on dense complex128 pivots (``"full"``, the
    plain block-Thomas solves of ``sparse/direct.py``, no kernel): its
    iterations beside the kernel path's, and the kernel path's complex64
    solution against its solution."""
    t0 = time.perf_counter()
    problem = plasma_integral2d.build_problem(**POLARIZED, n_it=2, dtype=torch.complex128,
                                              pivot_dtype="full", device=device)
    setup_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    x, info = plasma_integral2d.solve(problem, DIRECTIONS[0], **SOLVE_KW)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    _, err = rel_err(x_kernel.to(torch.complex128), x)
    n_it = int(info.n_iterations)
    emit("polarized_reference", pivot_dtype="full", dtype="complex128", iterations=n_it,
         jax_tpu_iterations=JAX_POLARIZED_ITERATIONS[2], converged=bool(info.converged),
         residuals=[float(v) for v in info.residuals[: n_it + 1]],
         true_residual=float(info.true_residual), setup_total_seconds=setup_s,
         solve_seconds=solve_s, kernel_path_rel_err=err, tolerance=1e-4)
    check(bool(info.converged), "the dense complex128 polarized solve converged")
    check(not any(counts.values()), f"the dense pivots launch no kernel ({counts})")
    check(err <= 1e-4, f"the kernel path's solution within 1e-4 of the dense one ({err})")
    del problem
    torch.cuda.empty_cache()


def profiled_device_ms(fn) -> float:
    """Device milliseconds of one ``fn()``: the sum of its kernels' times
    under torch.profiler, whoever sets the pace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3


def phase_polarized_enqueue(problem, module=polarized, rhs=None, phase="polarized_enqueue"):
    """One preconditioner apply (its inner GMRES reads one number an
    iteration), one inner block Gauss-Seidel (the D-inverse recursions and
    the couplings; no read) and one MM apply: the host's milliseconds to
    enqueue each beside the device's (its kernels' sum under torch.profiler)
    and the stream's (CUDA events).  ``module`` is the trace system's
    (``polarized3d`` in 3D) and ``rhs`` the source (default: the 2D path's
    first incident direction)."""
    pc = problem.precond
    slabs = pc.slabs
    if rhs is None:
        rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:1]))[0]
    f_pol = pc._polarized_rhs(pc.a_s.matvec(rhs))
    v = module.permute_to_pairs(slabs, f_pol)
    parts = {
        "apply": lambda: pc.apply(rhs),
        "inner_gauss_seidel": lambda: module.precond_gauss_seidel(slabs, v, pc.n_it),
        "apply_mm": lambda: module.apply_mm(slabs, f_pol),
    }
    out = {}
    for name, fn in parts.items():
        out[name] = dict(enqueue_ms=enqueue_ms(fn, 3), device_ms=profiled_device_ms(fn),
                         events_ms=time_ms(fn, 3))
        out[name]["device_idle_share"] = 1.0 - out[name]["device_ms"] / out[name]["events_ms"]
    emit(phase, trace_unknowns=int(f_pol.shape[0]), parts=out)


def phase_polarized_kernel_times(problem, counts: dict) -> list:
    """Each local-solve shape of the polarized path on the solve's own planes
    and right-hand sides (the traces of the two incident fields' sources),
    held against its plain version and timed from a CUDA graph: ``solve_all``
    over the 8 slabs with the head start at ``trace_head`` (``block_apply``,
    r = 2) and with none (the partitioned sources, r = 1); ``solve_support``
    on an inner slab with the head start and the tail of the down recursion
    and with the head start of the up recursion, r = 1 (the cached forward
    and the single-batch-row backward pass) and r = 2 (``solve_all``'s
    pair).  ``launches`` is the kernel's count in one nIt = 2 solve;
    ``launches_solve_batched`` in the two-direction solve."""
    pc = problem.precond
    slabs = pc.slabs
    fac = slabs.pfac
    S, m, n, ld = fac.n_slabs, fac.m, fac.n, fac.ld
    head, tail = slabs.trace_head, slabs.trace_tail
    up = m - tail
    slab = S // 2
    s_one, s_all = fac.slab_ids[slab : slab + 1], fac.slab_ids
    rhs = plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS))           # (2, N)
    asb = pc.a_s.matvec(rhs.T.contiguous())                                # (N, 2)
    traces = polarized.extract_rhs_traces(slabs, asb)                     # (S, n, 2) each
    single, joint = counts["polarized_solve"], counts["polarized_solve_batched"]
    dense_re = tk.dense_planes(fac.cinv_t_re[slab])      # (m, ld, ld) copies for
    dense_im = tk.dense_planes(fac.cinv_t_im[slab])      # the library yardstick

    def cols(t, r):
        return t[..., 0] if r == 1 else t[..., :r]

    def rows(b):
        return tk._to_rows_b(fac, b)

    def fwd(s_idx, b4, start):
        return (lambda: tk.forward_substitution(fac, s_idx, b4, start=start),
                lambda: tk.forward_substitution_plain(fac, s_idx, b4, start))

    def fwd_cached(s_idx, b4, start):
        zero = b4.new_zeros((1, b4.shape[2], ld))
        return (lambda: tk.forward_substitution_cached(fac, s_idx, b4, start=start),
                lambda: tk.forward_substitution_cached_plain(fac, s_idx, b4, zero, start))

    def bwd(s_idx, y4, t):
        return (lambda: tk.backward_substitution(fac, s_idx, y4, tail=t),
                lambda: tk.backward_substitution_plain(fac, s_idx, y4, t))

    kernels = []

    def add(name, variant, r, fns, b4, lines, stacks, shape, replaces=None):
        # yardstick: the same count of library products of the same shapes,
        # on one slab's planes, timed from a CUDA graph as the kernel
        library_ms = library_pass_ms(b4[0, 0], dense_re, dense_im,
                                     [j % m for j in range(lines)], graph=True)
        kernels.append(dict(kernel_entry(
            name, r, "polarized_solve", single[name], *fns,
            pass_bound(lines, n, ld, r, stacks), library_ms, dict(shape, r=r),
            variant=variant, replaces=replaces, graph=True),
            launches_solve_batched=joint[name]))

    # all slabs: block_apply's trace sources (r = 2, head start) and the
    # partitioned sources of extract_rhs_traces / reconstruction (r = 1)
    b_head = rows(polarized._block_rhs(slabs, *(cols(t, 2) for t in traces)))
    b_src = rows(subdomain.partition_source(slabs, asb[:, 0]))
    for r, b4, start in ((2, b_head, head), (1, b_src, 0)):
        shape = dict(B=S, S=S, m=m, n=n, ld=ld, start=start)
        variant = "_pt_all_slabs" + ("_head" if start else "")
        y4 = tk.forward_substitution(fac, s_all, b4, start=start)
        add("thomas_forward", variant, r, fwd(s_all, b4, start), b4, S * (m - start), 2, shape)
        add("thomas_backward", variant, r, bwd(s_all, y4, 0), b4, S * m, 2, shape)
    # one inner slab: the down recursion drives its top traces and reads its
    # bottom ones (head start and tail), the up recursion the mirror image
    for r in (1, 2):
        v = [cols(t, r)[slab] for t in traces]
        for direction, srcs, start, t in (("down", (v[0], v[1], None, None), head, tail),
                                          ("up", (None, None, v[2], v[3]), up, 0)):
            b4 = rows(polarized._slab_rhs(slabs, slab, *srcs)[None])
            shape = dict(B=1, S=S, slab=slab, m=m, n=n, ld=ld, start=start, tail=t)
            variant = f"_pt_{direction}"
            if r == 1:
                y4, _ = tk.forward_substitution_cached(fac, s_one, b4, start=start)
                add("thomas_forward_cached", variant, r, fwd_cached(s_one, b4, start), b4,
                    m - start, 3, shape)
            else:
                y4 = tk.forward_substitution(fac, s_one, b4, start=start)
                add("thomas_forward", variant, r, fwd(s_one, b4, start), b4, m - start, 2,
                    shape)
            add("thomas_backward", variant + ("_tail" if t else ""), r, bwd(s_one, y4, t), b4,
                t or m, 2, shape, replaces=SWEEP_BACKWARD_R1 if r == 1 else None)
    emit("polarized_kernels", tolerance=KERNEL_TOL, timing="cuda_graph",
         cases=[{k: e[k] for k in ("name", "ms", "bound_ms", "plain_ms", "max_rel_err",
                                   "launches", "launches_solve_batched", "shape")}
                for e in kernels])
    return kernels


# ---------------------------------------------------------------------------
# Path 9: the 48^3 polarized-traces solve on the fused plane kernels
# ---------------------------------------------------------------------------

# RESULTS.md:318-323, "3D polarized traces at 48^3": k = 48, 4 z-slabs, npml
# = 6, nIt = 2, complex64, rtol 1e-6; the JAX package took 5 outer iterations
# (printed for information; its time is a TPU time and no target)
POLARIZED3D = dict(h=1.0 / 48.0, n_subdomains=4, npml=6)
POLARIZED3D_SOLVE_KW = dict(rtol=1e-6, restart=20, maxiter=40)
JAX_POLARIZED3D_ITERATIONS = 5
NO_JAX_RECORD = "no JAX record exists for this configuration"
PLANE_PAIR = ("plane_forward", "plane_backward")
INT8_PLANE_PAIR = ("plane_forward_int8", "plane_backward_int8")
# the kernel path's complex64 solution on bf16 planes against the dense
# complex128 one at 48^3: path 3's bound between bf16 and full pivots
POLARIZED3D_DENSE_TOL = 1e-3


def polarized3d_checks(name, c, pair, true_res, info, x, size):
    """The checks every 3D polarized solve meets: shape, finite, converged,
    true residual <= 1e-3, the fused passes of ``pair`` launched and no other
    kernel (the per-plane apply and every 2D line kernel absent)."""
    absent = tuple(k for k in COUNTERS if k not in pair)
    check(tuple(x.shape) == (size,), f"{name} solution shape")
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), f"{name} solution is finite")
    check(bool(info.converged), f"{name} converged")
    check(true_res <= 1e-3, f"{name} true residual <= 1e-3 ({true_res})")
    check(all(c[k] > 0 for k in pair), f"both fused plane passes launched in {name} ({c})")
    check(not any(c[k] for k in absent), f"no kernel of {absent} launched in {name} ({c})")


def phase_small_reference_polarized3d(device):
    """The 3D polarized kernel path (complex64, bf16 planes, the plane kernels)
    against its dense path (complex128, full pivots, no kernel) on a 16^3
    grid with 3 slabs and npml = 5, so the recursions run an inner slab.  The
    complex64 solve stops at rtol 1e-5 (its float32 floor on this grid, as in
    ``small_reference_3d``)."""
    kw = dict(h=1 / 16, precond="polarized_traces", n_subdomains=3, npml=5, device=device)
    p_k = bump3d.build_problem(dtype=torch.complex64, pivot_dtype="bf16_pallas", **kw)
    p_f = bump3d.build_problem(dtype=torch.complex128, pivot_dtype="full", **kw)
    reset_counts()
    x_k, i_k = bump3d.solve(p_k, rtol=1e-5, restart=20, maxiter=16)
    torch.cuda.synchronize()
    counts = read_counts()
    x_f, i_f = bump3d.solve(p_f, rtol=1e-8, restart=20, maxiter=16)
    _, err = rel_err(x_k.to(torch.complex128), x_f)
    slabs = p_k.precond.slabs
    emit("small_reference_polarized3d", n=p_k.grid.n, n_subdomains=3, npml=5,
         rtol=[1e-5, 1e-8], l1_max=slabs.l1_max, trace_head=slabs.trace_head,
         trace_tail=slabs.trace_tail, iterations=[int(i_k.n_iterations), int(i_f.n_iterations)],
         true_residual=[float(i_k.true_residual), float(i_f.true_residual)],
         rel_err_vs_dense_complex128=err, tolerance=1e-4, launches=counts)
    check(bool(i_k.converged) and bool(i_f.converged), "small 3D polarized solves converged")
    check(all(counts[k] > 0 for k in PLANE_PAIR), f"the small kernel path ran the passes ({counts})")
    check(err <= 1e-4, f"3D polarized kernel path within 1e-4 of the dense path ({err})")


def phase_polarized3d_solve(device, repeats: int = 3):
    """``bump3d.build_problem(h=1/48, complex64, precond="polarized_traces",
    n_subdomains=4, npml=6, pivot_dtype="bf16_pallas")``, the JAX record's
    configuration at full size: ``solve`` at nIt = 2, then with the same slabs
    at nIt = 1, each timed (median of ``repeats`` after a warm-up) with its
    iterations, inner GMRES iterations an apply and launches; then the joint
    apply of the two plane waves' sources through ``apply_batch`` (r = 2;
    its MM apply carries 4 columns, two groups of two) held row by row
    against single applies.  Returns the problem, the nIt = 2
    solve's launches and its solution."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = bump3d.build_problem(dtype=torch.complex64, precond="polarized_traces",
                                   pivot_dtype="bf16_pallas", device=device, **POLARIZED3D)
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    pc = problem.precond
    slabs = pc.slabs
    check(slabs.pfac is not None and slabs.pfac.storage == "bf16"
          and slabs.fac.cinv.shape[-1] == 0
          and all(isinstance(f, pk.PlaneSlabView) for f in slabs.slab_facs),
          "the 3D polarized slabs keep bf16 plane stacks only, a view per slab")
    runs = (("polarized3d_solve", pc, JAX_POLARIZED3D_ITERATIONS),
            ("polarized3d_solve_nit1", dataclasses.replace(pc, n_it=1), NO_JAX_RECORD))
    out = {}
    for name, pcx, record in runs:
        prob = dataclasses.replace(problem, precond=pcx)
        with InnerSolves(polarized3d) as inner:
            bump3d.solve(prob, **POLARIZED3D_SOLVE_KW)          # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (x, info), times, c = timed_solves(
                lambda: bump3d.solve(prob, **POLARIZED3D_SOLVE_KW), repeats, inner.reset)
        n_it = int(info.n_iterations)
        true_res = float(info.true_residual)
        emit(name, grid=list(problem.grid.shape), k=problem.k, unknowns=problem.grid.size,
             n_subdomains=slabs.n_subs, npml=POLARIZED3D["npml"], n_it=pcx.n_it,
             pivot_dtype="bf16_pallas", l1_max=slabs.l1_max, trace_head=slabs.trace_head,
             trace_tail=slabs.trace_tail, up_recursion_start=slabs.l1_max - slabs.trace_tail,
             solve_ms=sorted(times)[len(times) // 2], solve_ms_runs=times, iterations=n_it,
             jax_package_iterations=record, converged=bool(info.converged),
             residuals=[float(v) for v in info.residuals[: n_it + 1]], true_residual=true_res,
             inner_solves=inner.solves,
             inner_iterations_per_apply=inner.iterations / max(inner.solves, 1),
             setup_seconds=problem.setup_seconds, setup_total_seconds=setup_s,
             setup_peak_memory_bytes=setup_peak, stack_bytes=slabs.pfac.nbytes,
             peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=c)
        polarized3d_checks(name, c, PLANE_PAIR, true_res, info, x, problem.grid.size)
        out[name] = (c, x)
        SOLVE_RESULTS[name] = dict(ms=sorted(times)[len(times) // 2], iterations=n_it)

    rhs2 = torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])
    reset_counts()
    joint = pc.apply_batch(rhs2)
    torch.cuda.synchronize()
    c2 = read_counts()
    errs = [rel_err(joint[r], pc.apply(rhs2[r]))[1] for r in range(2)]
    emit("polarized3d_apply_batch", directions=["x", "y"], rel_err_vs_single_apply=errs,
         tolerance=1e-4, launches=c2)
    check(bool(torch.isfinite(torch.view_as_real(joint)).all()), "joint 3D apply is finite")
    check(max(errs) <= 1e-4, f"each row of the joint 3D apply within 1e-4 of its apply ({errs})")
    check(all(c2[k] > 0 for k in PLANE_PAIR) and not any(
        c2[k] for k in COUNTERS if k not in PLANE_PAIR),
        f"the joint apply (R x 2 columns in groups of two) ran the fused passes only ({c2})")
    return problem, out["polarized3d_solve"][0], out["polarized3d_solve"][1]


def phase_polarized3d_reference(device, x_kernel: torch.Tensor):
    """The same 48^3 configuration on dense complex128 pivots (``"full"``,
    96 planes of 2304^2, the plain block-Thomas solves of
    ``sparse/direct.py``, no kernel): its iterations beside the kernel
    path's and the JAX record, and the kernel path's complex64 solution
    against its solution.  Freed before path 9's kernel timings."""
    t0 = time.perf_counter()
    problem = bump3d.build_problem(dtype=torch.complex128, precond="polarized_traces",
                                   pivot_dtype="full", device=device, **POLARIZED3D)
    setup_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    x, info = bump3d.solve(problem, **POLARIZED3D_SOLVE_KW)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    _, err = rel_err(x_kernel.to(torch.complex128), x)
    n_it = int(info.n_iterations)
    emit("polarized3d_reference", pivot_dtype="full", dtype="complex128", iterations=n_it,
         jax_package_iterations=JAX_POLARIZED3D_ITERATIONS, converged=bool(info.converged),
         residuals=[float(v) for v in info.residuals[: n_it + 1]],
         true_residual=float(info.true_residual), setup_seconds=problem.setup_seconds,
         setup_total_seconds=setup_s, solve_seconds=solve_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), kernel_path_rel_err=err,
         tolerance=POLARIZED3D_DENSE_TOL)
    check(bool(info.converged), "the dense complex128 3D polarized solve converged")
    check(float(info.true_residual) <= 1e-3, "dense 3D polarized true residual <= 1e-3")
    check(not any(counts.values()), f"the dense pivots launch no kernel ({counts})")
    check(err <= POLARIZED3D_DENSE_TOL,
          f"the kernel path within {POLARIZED3D_DENSE_TOL} of the dense complex128 one ({err})")
    del problem, x
    torch.cuda.empty_cache()


def phase_polarized3d_kernel_times(problem, counts: dict) -> list:
    """The plane passes at the shapes of the 48^3 polarized path, on an inner
    slab's own planes and the traces of the two plane waves' sources, held
    against their plain versions and timed from a CUDA graph: the down
    recursion's forward pass from ``trace_head`` (no carry, no t stack) and
    its backward pass over the last ``trace_tail`` planes (r = 1); the block
    apply's passes at r = 2 (its forward from ``trace_head``, its backward
    whole); the up recursion's forward pass from ``l1_max - trace_tail``
    (r = 1).  ``launches`` is the kernel's count in one nIt = 2 solve."""
    pc = problem.precond
    slabs = pc.slabs
    s = 1
    view = slabs.slab_facs[s]
    st, n, base = view.stack, view.lsten.shape[2], view.base
    l, ld, mn = view.lsten.shape[0], st.ld, st.mn
    head, tail = slabs.trace_head, slabs.trace_tail
    up = l - tail
    rhs2 = torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])
    traces = polarized3d.extract_rhs_traces(slabs, pc.a_s.matvec(rhs2.T.contiguous()))
    dense_re = tk.dense_planes(st.p_re[base : base + l])   # (l, ld, ld) copies for
    dense_im = tk.dense_planes(st.p_im[base : base + l])   # the library yardstick

    def fwd(b4, start):
        return (lambda: pk.plane_forward(st, b4, view.lrows, n, base, start,
                                         collect_t=False)[0][start:],
                lambda: pk.plane_forward_plain(st, b4, view.lrows, n, base, start,
                                               collect_t=False)[0][start:])

    def bwd(y4, start):
        return (lambda: pk.plane_backward(st, y4, view.urows, n, base, start),
                lambda: pk.plane_backward_plain(st, y4, view.urows, n, base, start))

    down = [t[s, :, 0] for t in traces]
    block = polarized3d._trace_sources(
        slabs, traces[0].new_zeros((slabs.n_subs, l, mn, 2)), *traces, add=False)[s]
    cases = (
        ("_pt_down_head", 1, slab_rows(slabs, polarized3d._slab_rhs(
            slabs, s, down[0], down[1], None, None)), head, tail),
        ("_pt_block_head", 2, slab_rows(slabs, block), head, 0),
        ("_pt_up", 1, slab_rows(slabs, polarized3d._slab_rhs(
            slabs, s, None, None, down[2], down[3])), up, None),
    )
    kernels = []
    for variant, r, b4, start, bwd_tail in cases:
        shape = dict(slab=s, l=l, mn=mn, ld=ld, r=r, start=start)
        y4 = pk.plane_forward(st, b4, view.lrows, n, base, start, collect_t=False)[0]
        kernels.append(kernel_entry(
            "plane_forward", r, "polarized3d_solve", counts["plane_forward"], *fwd(b4, start),
            plane_bound(l - start, ld, r, stacks=2),
            library_pass_ms(b4[0], dense_re, dense_im, range(start, l), graph=True),
            shape, variant=variant, graph=True))
        if bwd_tail is None:
            continue
        b_start = l - bwd_tail if bwd_tail else 0
        kernels.append(kernel_entry(
            "plane_backward", r, "polarized3d_solve", counts["plane_backward"],
            *bwd(y4, b_start), plane_bound(l - b_start, ld, r, stacks=2),
            library_pass_ms(b4[0], dense_re, dense_im, range(b_start, l), graph=True),
            dict(shape, start=b_start, tail=bwd_tail), graph=True,
            variant=variant.replace("_head", "") + ("_tail" if bwd_tail else "")))
    emit("polarized3d_kernels", tolerance=KERNEL_TOL, timing="cuda_graph",
         trace_head=head, trace_tail=tail, l1_max=l,
         cases=[{k: e[k] for k in ("name", "ms", "bound_ms", "plain_ms", "library_ms",
                                   "max_rel_err", "launches", "shape")} for e in kernels])
    del dense_re, dense_im
    torch.cuda.empty_cache()
    return kernels


def phase_polarized3d_96(problem) -> list:
    """The 3D polarized traces at 96^3 on path 4's own slab system (6 slabs,
    npml = 8, int8 y-planes; no second setup): ``solve`` at rtol 1e-6 (one
    warm-up, one timed run), the int8 fused passes the only kernels
    launched; then those passes at r = 1 on an inner slab's planes with this
    solve's launches."""
    pc = polarized3d.PolarizedTracesPreconditioner3D(slabs=problem.precond.slabs,
                                                     a_s=problem.a_s)
    prob = dataclasses.replace(problem, precond=pc)
    slabs = pc.slabs
    torch.cuda.reset_peak_memory_stats()
    with InnerSolves(polarized3d) as inner:
        bump3d.solve(prob, **POLARIZED3D_SOLVE_KW)                # warm-up
        torch.cuda.synchronize()
        (x, info), times, c = timed_solves(
            lambda: bump3d.solve(prob, **POLARIZED3D_SOLVE_KW), 1, inner.reset)
    n_it = int(info.n_iterations)
    true_res = float(info.true_residual)
    emit("polarized3d_96", grid=list(problem.grid.shape), k=problem.k,
         unknowns=problem.grid.size, n_subdomains=slabs.n_subs, npml=GS96["npml"],
         pivot_dtype="yblock_int8_pallas", pivot_layout=slabs.pivot_layout,
         l1_max=slabs.l1_max, n_it=pc.n_it, solve_ms=times[-1], iterations=n_it,
         jax_package_iterations=NO_JAX_RECORD, converged=bool(info.converged),
         residuals=[float(v) for v in info.residuals[: n_it + 1]], true_residual=true_res,
         inner_solves=inner.solves,
         inner_iterations_per_apply=inner.iterations / max(inner.solves, 1),
         peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=c)
    polarized3d_checks("polarized3d_96", c, INT8_PLANE_PAIR, true_res, info, x,
                       problem.grid.size)
    return sweep_kernel_times(prob, {1: "polarized3d_96"}, {1: c}, variant="_pt96")


# Path 10: examples/example.jl, the 201^2 bump with the sparsifying preconditioner
# ---------------------------------------------------------------------------

BUMP2D_H = 0.005                # k = 200, 201 x 201: bump2d.build_problem's default
# the JAX package's counts for this problem on the CPU in complex128 at rtol
# 1e-8 (models/bump2d.solve: preconditioned; unpreconditioned at maxiter 400):
# no TPU record of them exists
JAX_BUMP2D_ITERATIONS = 5
JAX_BUMP2D_ITERATIONS_PLAIN = 20
# no kernel runs on paths 10-11: every counter must stay at 0
ALL_KERNELS = tuple(COUNTERS)


def check_no_launch(counts: dict, what: str):
    check(all(counts[k] == 0 for k in ALL_KERNELS),
          f"no hand-written kernel launched in {what} ({counts})")


def phase_bump2d_solve(device, repeats: int = 3):
    """``bump2d.build_problem()`` at the reference's size in complex64 and a
    preconditioned ``solve`` at rtol 1e-6."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = bump2d.build_problem(h=BUMP2D_H, dtype=torch.complex64, device=device)
    setup_s = time.perf_counter() - t0
    bump2d.solve(problem, rtol=1e-6)                         # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(lambda: bump2d.solve(problem, rtol=1e-6), repeats)
    n_it = int(info.n_iterations)
    emit(
        "bump2d_solve", grid=[problem.grid.m, problem.grid.n], k=problem.k,
        quad_rule=problem.op.quad_rule, setup_seconds=problem.setup_seconds,
        setup_total_seconds=setup_s, solve_ms=sorted(times)[len(times) // 2],
        solve_ms_runs=times, iterations=n_it, converged=bool(info.converged),
        residuals=[float(v) for v in info.residuals[: n_it + 1]],
        true_residual=float(info.true_residual),
        peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts,
    )
    check(tuple(x.shape) == (problem.grid.size,), "bump2d solution shape")
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "bump2d solution is finite")
    check(bool(info.converged), "bump2d converged")
    check(float(info.true_residual) <= 1e-3, "bump2d true residual <= 1e-3")
    check_no_launch(counts, "bump2d_solve")


def phase_bump2d_batched(problem, n_it: int, rtol: float, repeats: int = 3):
    """Both directions of :data:`DIRECTIONS` in one ``gmres_batched`` through
    ``apply_batch``: each direction takes its single solve's iterations
    (``n_it`` for direction (1, 0), solved before at the same ``rtol``)."""
    pc, op = problem.precond, problem.op
    rhs = torch.stack([bump2d.incident_rhs(problem.op, problem.grid, problem.k, d)[0]
                       for d in DIRECTIONS])
    check(float((rhs[0] - problem.rhs).abs().max()) == 0.0, "bump2d rhs of direction (1, 0)")
    reset_counts()
    _, single = gmres(op.apply, rhs[1], preconditioner=pc.apply, rtol=rtol)
    singles = [n_it, int(single.n_iterations)]

    def joint():
        return gmres_batched(op.apply, rhs, preconditioner=pc.apply_batch, rtol=rtol,
                             restart=20, maxiter=200)

    joint()                                                   # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(joint, repeats)
    ms = sorted(times)[len(times) // 2]
    emit("bump2d_solve_batched", dtype=str(rhs.dtype), rtol=rtol, directions=DIRECTIONS,
         solve_ms=ms, solve_ms_runs=times,
         ms_per_direction=ms / len(DIRECTIONS), iterations=[int(v) for v in info.n_iterations],
         single_iterations=singles, converged=[bool(v) for v in info.converged],
         true_residual=[float(v) for v in info.true_residual], launches=counts)
    check(tuple(x.shape) == (2, problem.grid.size), "bump2d batched solution shape")
    check(bool(info.converged.all()), "bump2d batched converged")
    check([int(v) for v in info.n_iterations] == singles,
          f"each direction takes its single solve's iterations ({singles})")
    check(float(info.true_residual.max()) <= 1e-3, "bump2d batched true residuals <= 1e-3")
    check_no_launch(counts, "bump2d_solve_batched")


def phase_bump2d_c128(device):
    """The same problem in complex128 at the module's rtol 1e-8: the
    preconditioned and the unpreconditioned solve (``maxiter=400``, as
    ``examples/example2d.py``), against each other and the JAX count."""
    problem = bump2d.build_problem(h=BUMP2D_H, dtype=torch.complex128, device=device)
    reset_counts()
    ms, out = [], []
    for kw in (dict(), dict(preconditioned=False, maxiter=400)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(bump2d.solve(problem, **kw))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    counts = read_counts()
    (xp, ip), (xu, iu) = out
    agree = float(torch.linalg.vector_norm(xp - xu) / torch.linalg.vector_norm(xp))
    its = [int(ip.n_iterations), int(iu.n_iterations)]
    emit("bump2d_c128", setup_seconds=problem.setup_seconds, solve_ms=ms,
         iterations=its, jax_cpu_iterations=[JAX_BUMP2D_ITERATIONS, JAX_BUMP2D_ITERATIONS_PLAIN],
         converged=[bool(ip.converged), bool(iu.converged)],
         true_residual=[float(ip.true_residual), float(iu.true_residual)],
         residuals=[float(v) for v in ip.residuals[: its[0] + 1]],
         solutions_rel_diff=agree, launches=counts)
    check(bool(ip.converged) and bool(iu.converged), "bump2d complex128 solves converged")
    check(agree <= 1e-5, f"preconditioned and plain solutions agree ({agree})")
    check(its[0] < its[1], f"the preconditioner saves iterations ({its})")
    check(its[0] == JAX_BUMP2D_ITERATIONS,
          f"the JAX package's count at this size ({its[0]} != {JAX_BUMP2D_ITERATIONS})")
    check_no_launch(counts, "bump2d_c128")
    return problem, its[0]


def phase_bump2d_adjoint(problem, nodes=((100, 100), (90, 112), (118, 86)), eps: float = 1e-6):
    """The adjoint at the reference's size in complex128: the transpose
    pairing, and the nu-gradient of ``sum(w |u|^2)`` from
    ``differentiable_solve`` with both sparsifying preconditioners against
    central differences at three nodes."""
    op, grid, k = problem.op, problem.grid, problem.k
    device = op.symbol.device
    gen = torch.Generator(device="cpu").manual_seed(7)

    def crandn():
        return torch.complex(torch.randn(grid.size, generator=gen, dtype=torch.float64),
                             torch.randn(grid.size, generator=gen, dtype=torch.float64)).to(device)

    x, y = crandn(), crandn()
    lhs = (op.apply(x) * y).sum()
    rhs = (x * adjoint.apply_transpose(op, y)).sum()
    pairing = float((lhs - rhs).abs() / lhs.abs())

    reset_counts()
    t0 = time.perf_counter()
    a_st, ag_st = stencils.build_sparse_a_ag_2d(k, grid.x, grid.y, grid.h,
                                                dtype=torch.complex128, device=device)
    nu_host = media.gaussian_bump_2d(*grid.mesh())
    pc_t = SparsifyingPreconditionerT.build(stencils.build_msp_2d(a_st, ag_st, nu_host, k), a_st)
    torch.cuda.synchronize()
    setup_t = time.perf_counter() - t0
    w = torch.randn(grid.size, generator=gen, dtype=torch.float64).to(device)
    solve_kw = dict(rtol=1e-12, restart=20, maxiter=200)

    t0 = time.perf_counter()
    nu = op.nu.clone().requires_grad_()
    u = adjoint.differentiable_solve(dataclasses.replace(op, nu=nu), problem.rhs,
                                     problem.precond.apply, pc_t.apply, **solve_kw)
    (w * u.abs() ** 2).sum().backward()
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0

    def loss(nu_arr):
        v, _ = gmres(dataclasses.replace(op, nu=nu_arr).apply, problem.rhs,
                     preconditioner=problem.precond.apply, **solve_kw)
        return float((w * v.abs() ** 2).sum())

    grads, fds = [], []
    for j, i in nodes:
        e = torch.zeros_like(op.nu)
        e[j, i] = eps
        fds.append((loss(op.nu + e) - loss(op.nu - e)) / (2 * eps))
        grads.append(float(nu.grad[j, i]))
    rel = [abs(g - f) / abs(f) for g, f in zip(grads, fds)]
    counts = read_counts()
    emit("bump2d_adjoint", pairing_rel_err=pairing, transposed_setup_seconds=setup_t,
         gradient_seconds=grad_s, nodes=nodes, gradient=grads, central_differences=fds,
         rel_err=rel, eps=eps, launches=counts)
    check(pairing <= 1e-10, f"<M x, y> = <x, M^T y> ({pairing})")
    check(all(r <= 1e-3 for r in rel), f"nu-gradient against central differences ({rel})")
    check(bool(torch.isfinite(nu.grad).all()), "the nu-gradient is finite")
    check_no_launch(counts, "bump2d_adjoint")


# Path 11: the plain banded pivot modes (the JAX package's XLA-side ones)
# ---------------------------------------------------------------------------

# tests/test_banded_pivots.py's configuration (pivot_band 51, pivot_rank 24)
BANDED_KW = dict(h=1.0 / 100.0, n_subdomains=4, npml=8)
BANDED_SOLVE = dict(rtol=1e-6, restart=20, maxiter=40)
BANDED_MODES = ("full", "banded", "banded_tail", "banded_lr")
# the JAX package's counts there on the CPU.  In complex64 (the JAX test's
# dtype) float32's floor of the Arnoldi estimate decides them (the port's
# own CPU run takes 22 for full, the card 5); complex128 is the comparison
JAX_BANDED_ITERATIONS = {
    torch.complex64: {"full": 9, "banded": 7, "banded_tail": 15, "banded_lr": 6},
    torch.complex128: {"full": 5, "banded": 6, "banded_tail": 5, "banded_lr": 6},
}
# the JAX test's pins, iterations over full pivots: banded <= full + 3,
# banded_tail <= full + 2; held where the JAX package's own counts keep them
JAX_BANDED_PINS = {"banded": 3, "banded_tail": 2}


def phase_banded_801(device):
    """801^2, 16 slabs, double sweep on the plain ``"banded_tail"`` pivots
    (w = 201 by the rule): one warm-up and one timed solve, no kernel; the
    milliseconds beside path 5's kernel layout of the same pivots."""
    problem, counts = phase_solve(device, "banded_tail_solve", 16, True, (), repeats=1,
                                  pivot_dtype="banded_tail", jax_iterations=JAX_HT_ITERATIONS,
                                  absent=ALL_KERNELS)
    fac = problem.precond.slabs.fac
    info = dict(width=int(fac.band_re.shape[-1]), tail_start=fac.tail_start,
                m1_max=problem.precond.slabs.m1_max)
    del problem
    plain, kernels = SOLVE_RESULTS["banded_tail_solve"], SOLVE_RESULTS.get("ht_solve")
    emit("banded_tail_vs_kernels", plain_ms=plain["ms"], iterations=plain["iterations"],
         kernel_layout_ms=kernels and kernels["ms"],
         kernel_layout_iterations=kernels and kernels["iterations"],
         ratio=kernels and plain["ms"] / kernels["ms"], **info)
    check(info["width"] == direct.default_band_width(801) == 201, "the w(n) rule's 201")
    check(8 <= plain["iterations"] <= 10,
          f"{plain['iterations']} iterations within 8-10 (the JAX record 9, path 5 9)")


def phase_banded_modes(device):
    """The JAX test's configuration in each plain mode, in complex64 and
    complex128: every solve converges and launches no kernel; in complex128
    each count lies within 1 of the JAX package's, and the JAX test's pins
    hold where the JAX package's own counts keep them."""
    for dtype in (torch.complex64, torch.complex128):
        its, want = {}, JAX_BANDED_ITERATIONS[dtype]
        for mode in BANDED_MODES:
            extra = {} if mode == "full" else dict(pivot_band=51)
            if mode == "banded_lr":
                extra["pivot_rank"] = 24
            t0 = time.perf_counter()
            problem = plasma2d.build_problem(**BANDED_KW, dtype=dtype, pivot_dtype=mode,
                                             device=device, **extra)
            setup_s = time.perf_counter() - t0
            reset_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            x, info = plasma2d.solve(problem, (1.0, 0.0), **BANDED_SOLVE)
            end.record()
            torch.cuda.synchronize()
            counts = read_counts()
            its[mode] = n_it = int(info.n_iterations)
            emit("banded_modes", dtype=str(dtype), pivot_dtype=mode, setup_seconds=setup_s,
                 solve_ms=start.elapsed_time(end), iterations=n_it,
                 jax_cpu_iterations=want[mode], converged=bool(info.converged),
                 true_residual=float(info.true_residual),
                 residuals=[float(v) for v in info.residuals[: n_it + 1]], launches=counts)
            check(bool(torch.isfinite(torch.view_as_real(x)).all()), f"{mode} solution is finite")
            check(bool(info.converged), f"{mode} {dtype} converged")
            check(float(info.true_residual) <= 1e-3, f"{mode} true residual <= 1e-3")
            if dtype == torch.complex128:
                check(abs(n_it - want[mode]) <= 1,
                      f"{mode}: {n_it} iterations within 1 of the JAX package's {want[mode]}")
            check_no_launch(counts, f"banded_modes {mode}")
            del problem
        pins = {}
        for mode, extra in JAX_BANDED_PINS.items():
            jax_keeps = want[mode] <= want["full"] + extra
            pins[mode] = dict(port=its[mode] <= its["full"] + extra, jax_cpu=jax_keeps)
            if dtype == torch.complex128 and jax_keeps:
                check(pins[mode]["port"], f"{mode} <= full + {extra} ({its})")
        emit("banded_pins", dtype=str(dtype), iterations=its, jax_cpu_iterations=want, pins=pins)


# Path 12: the user surface, api.py, the CLI and cache_dir checkpoints
# ---------------------------------------------------------------------------

# path 2's problem (the reference's configuration) as a ProblemConfig
API_2D = dict(dim=2, medium="plasma", h=1.0 / 800.0, precond="double_sweep",
              pivot_dtype="pallas")
API_2D_DDM = dict(n_subdomains=16, npml=10)
# path 9's problem (the JAX package's 3D polarized record)
API_3D = dict(dim=3, h=1.0 / 48.0, precond="polarized_traces", pivot_dtype="bf16_pallas")
API_3D_DDM = dict(n_subdomains=4, npml=6, n_inner_iters=2)
API_SOLVER = dict(rtol=1e-6)
# the rows path 12 runs: the 801^2 double sweep's line kernels, the 48^3
# polarized traces' fused plane passes
API_2D_PAIR = ("thomas_forward_cached", "thomas_backward")
# launches of each path 12 phase, by phase (for the kernels line)
API_LAUNCHES: dict = {}


def api_config(cache_dir: str, dim: int) -> ProblemConfig:
    if dim == 2:
        return ProblemConfig(**API_2D, cache_dir=cache_dir, ddm=DDMConfig(**API_2D_DDM),
                             solver=SolverConfig(**API_SOLVER, dtype=torch.complex64))
    return ProblemConfig(**API_3D, cache_dir=cache_dir, ddm=DDMConfig(**API_3D_DDM),
                         solver=SolverConfig(**API_SOLVER))


def cache_files(cache_dir: str) -> dict:
    """Bytes of each checkpoint file, by name."""
    return {name: os.path.getsize(os.path.join(cache_dir, name))
            for name in sorted(os.listdir(cache_dir))}


def cache_kinds(files: dict) -> dict:
    """Bytes by artifact kind (the file prefix: symbol, stencils, slabfac,
    slabfac3d)."""
    kinds = {}
    for name, size in files.items():
        kind = name.rsplit("_", 1)[0]
        kinds[kind] = kinds.get(kind, 0) + size
    return kinds


def timed_build(cfg, device):
    """``api.build_problem`` and its wall seconds, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problem = api.build_problem(cfg, device=device)
    torch.cuda.synchronize()
    return problem, time.perf_counter() - t0


def solve_tensors(problem) -> dict:
    """Every tensor of the problem's slab systems (both sweep directions or
    the 3D slabs): factorizations and kernel layouts, by field path."""
    out = {}

    def walk(obj, prefix):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name), f"{prefix}.{f.name}")

    pc = problem.precond
    for name in ("slabs", "slabs_t"):
        if hasattr(pc, name):
            walk(getattr(pc, name).fac, f"{name}.fac")
            walk(getattr(pc, name).pfac, f"{name}.pfac")
    return out


def phase_api_solve(device, cache_dir: str, smi: str, repeats: int = 3):
    """Path 2's problem through ``api.build_problem`` on an empty
    ``cache_dir`` (cold: it writes the checkpoints), then ``solve_problem``
    timed as path 2 times its solve: the same count, a solution within 1e-5
    of path 2's, and only path 2's line kernels."""
    free = shutil.disk_usage(cache_dir).free
    torch.cuda.reset_peak_memory_stats()
    problem, setup_s = timed_build(api_config(cache_dir, 2), device)
    files = cache_files(cache_dir)
    api.solve_problem(problem)                                # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(lambda: api.solve_problem(problem), repeats)
    API_LAUNCHES["api_solve"] = counts
    n_it = int(info.n_iterations)
    ref = SOLVE_RESULTS["sweep_solve"]
    _, err = rel_err(x.cpu(), ref["x"])
    absent = tuple(k for k in COUNTERS if k not in API_2D_PAIR)
    emit("api_solve", card=smi, config=dict(API_2D, ddm=API_2D_DDM, solver=API_SOLVER),
         setup_seconds_cold=setup_s, cache_free_bytes_before=free, cache_files_bytes=files,
         cache_bytes_by_kind=cache_kinds(files), solve_ms=sorted(times)[len(times) // 2],
         solve_ms_runs=times, path2_solve_ms=ref["ms"], iterations=n_it,
         path2_iterations=ref["iterations"], converged=bool(info.converged),
         residuals=[float(v) for v in info.residuals[: n_it + 1]],
         true_residual=float(info.true_residual), rel_err_vs_path2=err,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts)
    check(sorted(cache_kinds(files)) == ["slabfac", "stencils", "symbol"]
          and sum(k.startswith("slabfac") for k in files) == 2,
          f"the cold build wrote the symbol, the stencils and both directions ({files})")
    check(tuple(x.shape) == (problem.grid.size,), "api solution shape")
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), "api solution is finite")
    check(n_it == ref["iterations"], f"api_solve takes path 2's count ({n_it}, {ref['iterations']})")
    check(err <= 1e-5, f"api_solve within 1e-5 of path 2's solution ({err})")
    check(float(info.true_residual) <= 1e-3, "api_solve true residual <= 1e-3")
    check(all(counts[k] > 0 for k in API_2D_PAIR) and not any(counts[k] for k in absent),
          f"api_solve launched path 2's line kernels and no other ({counts})")
    return problem, x, setup_s


def phase_api_solve_batched(problem, smi: str, repeats: int = 3):
    """``solve_problem_batched`` on the two directions: each takes the count
    of its single ``solve_problem``, on path 2's line kernels only."""
    singles = []
    for d in DIRECTIONS:
        single = dataclasses.replace(problem, config=dataclasses.replace(
            problem.config, incident_direction=d))
        singles.append(int(api.solve_problem(single)[1].n_iterations))
    api.solve_problem_batched(problem, DIRECTIONS)            # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(
        lambda: api.solve_problem_batched(problem, DIRECTIONS), repeats)
    API_LAUNCHES["api_solve_batched"] = counts
    its = [int(v) for v in info.n_iterations]
    absent = tuple(k for k in COUNTERS if k not in API_2D_PAIR)
    ms = sorted(times)[len(times) // 2]
    emit("api_solve_batched", card=smi, directions=DIRECTIONS, solve_ms=ms, solve_ms_runs=times,
         ms_per_direction=ms / len(DIRECTIONS), iterations=its, single_iterations=singles,
         converged=[bool(v) for v in info.converged],
         true_residual=[float(v) for v in info.true_residual], launches=counts)
    check(tuple(x.shape) == (len(DIRECTIONS), problem.grid.size), "api batched solution shape")
    check(its == singles, f"each direction takes its single count ({its}, {singles})")
    check(float(info.true_residual.max()) <= 1e-3, "api batched true residuals <= 1e-3")
    check(all(counts[k] > 0 for k in API_2D_PAIR) and not any(counts[k] for k in absent),
          f"api_solve_batched launched path 2's line kernels and no other ({counts})")


def phase_cli_warm(device, problem, x, tmp: str, cold_s: float, smi: str):
    """The CLI in a subprocess on the same ``cache_dir`` (warm: it loads the
    checkpoints), then a warm ``build_problem`` in this process: the same
    count, the CLI's field within 1e-6 of ``api_solve``'s solution, and every
    loaded pivot tensor bit-identical to the built one."""
    cfg_path, base = os.path.join(tmp, "cfg.json"), os.path.join(tmp, "u")
    cfg = dict(API_2D, cache_dir=os.path.join(tmp, "cache"), ddm=API_2D_DDM,
               solver=dict(API_SOLVER, dtype="complex64"))
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "fast_solver_lippmann_schwinger_tpu_torch", "--config", cfg_path,
         "--save-field", base], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(out.returncode == 0, f"the CLI ran ({out.returncode}): {out.stderr[-2000:]}")
    timer = json.loads(out.stderr.strip().splitlines()[-1])
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("iterations to")]
    cli_its = int(line.split(":")[1])
    u = torch.from_numpy(np.load(base + ".npz")["u"]).reshape(-1)
    _, err = rel_err(u, x.cpu())

    warm, warm_s = timed_build(problem.config, device)
    built, loaded = solve_tensors(problem), solve_tensors(warm)
    identical = {k: built[k].dtype == loaded[k].dtype and torch.equal(built[k], loaded[k])
                 for k in built}
    x_warm, info_warm = api.solve_problem(warm)
    emit("cli_warm", card=smi, setup_seconds_cold=cold_s, setup_seconds_cli_warm=timer["phases_s"]
         ["setup"], cli_phases_s=timer["phases_s"], cli_process_seconds=cli_s,
         setup_seconds_in_process_warm=warm_s, iterations=cli_its,
         in_process_warm_iterations=int(info_warm.n_iterations), cli_rel_err_vs_api_solve=err,
         pivot_tensors=len(built), pivot_bytes=sum(t.numel() * t.element_size()
                                                   for t in built.values()),
         pivots_bit_identical=all(identical.values()) and built.keys() == loaded.keys(),
         warm_solution_bit_identical=bool(torch.equal(x_warm, x)))
    check(cli_its == int(info_warm.n_iterations) == SOLVE_RESULTS["sweep_solve"]["iterations"],
          f"the warm CLI and in-process solves take path 2's count ({cli_its})")
    check(err <= 1e-6, f"the CLI's field within 1e-6 of api_solve's solution ({err})")
    check(built.keys() == loaded.keys() and all(identical.values()),
          f"loaded pivot tensors bit-identical to the built ones "
          f"({[k for k, v in identical.items() if not v]})")
    check(len(cache_files(cfg["cache_dir"])) == 4, "the warm runs wrote no new checkpoint")


def phase_api_3d(device, cache_dir: str, smi: str, repeats: int = 3):
    """Path 9's configuration through the API, cold on an empty directory and
    then warm in the same process: path 9's count on the fused plane passes
    and no other kernel, and the warm build's plane stack bit-identical."""
    cfg = api_config(cache_dir, 3)
    problem, cold_s = timed_build(cfg, device)
    files = cache_files(cache_dir)
    api.solve_problem(problem)                                # warm-up
    torch.cuda.synchronize()
    (x, info), times, counts = timed_solves(lambda: api.solve_problem(problem), repeats)
    API_LAUNCHES["api_3d"] = counts
    built = solve_tensors(problem)
    warm, warm_s = timed_build(cfg, device)
    loaded = solve_tensors(warm)
    identical = built.keys() == loaded.keys() and all(
        built[k].dtype == loaded[k].dtype and torch.equal(built[k], loaded[k]) for k in built)
    n_it = int(info.n_iterations)
    want = SOLVE_RESULTS["polarized3d_solve"]["iterations"]
    emit("api_3d", card=smi, config=dict(API_3D, ddm=API_3D_DDM, solver=API_SOLVER),
         setup_seconds_cold=cold_s, setup_seconds_warm=warm_s, cache_files_bytes=files,
         cache_bytes_by_kind=cache_kinds(files), solve_ms=sorted(times)[len(times) // 2],
         solve_ms_runs=times, iterations=n_it, path9_iterations=want,
         converged=bool(info.converged), residuals=[float(v) for v in info.residuals[: n_it + 1]],
         true_residual=float(info.true_residual), stack_bit_identical=identical,
         stack_bytes=problem.precond.slabs.pfac.nbytes, launches=counts)
    polarized3d_checks("api_3d", counts, PLANE_PAIR, float(info.true_residual), info, x,
                       problem.grid.size)
    check(n_it == want, f"api_3d takes path 9's count ({n_it}, {want})")
    check(identical, "the warm 3D build loads a bit-identical plane stack")
    check(sorted(cache_kinds(files)) == ["slabfac3d", "stencils", "symbol"],
          f"the cold 3D build wrote its checkpoints ({files})")


def path12(device, smi: str):
    """Path 12: the user surface at full width, with its cache under a fresh
    temporary directory, removed at the end."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache)
        problem, x, cold_s = phase_api_solve(device, cache, smi)
        phase_api_solve_batched(problem, smi)
        phase_cli_warm(device, problem, x, tmp, cold_s, smi)
        del problem, x
        torch.cuda.empty_cache()
        cache3d = os.path.join(tmp, "cache3d")
        os.makedirs(cache3d)
        phase_api_3d(device, cache3d, smi)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def with_api_launches(kernels: list) -> list:
    """Each kernel entry of a row that path 12 ran gains ``api_launches``: its
    launches in each path 12 phase that launched it."""
    names = {info["kernel"]: name for name, info in KERNEL_INFO.items()}
    for entry in kernels:
        name = names[entry["kernel"]]
        runs = {phase: c[name] for phase, c in API_LAUNCHES.items() if c[name]}
        if runs:
            entry["api_launches"] = runs
    return kernels


# ---------------------------------------------------------------------------
# Path 13: the multi-device layouts of parallel/ at world size 1 over NCCL
# ---------------------------------------------------------------------------

# the one card runs the sharded code as a mesh of one rank; the exchanges
# between ranks are held by the CPU tests (gloo, 2 and 4 ranks)
SHARDED_SOLUTION_LIMIT = 1e-5
SHARDED_TRUE_RESIDUAL_LIMIT = 1e-3
# benchmarks/capacity3d.py: 96^3 on [0, 1)^3, k = 96, 8 z-slabs, npml 8,
# y-blocked bf16 plane pivots, gmres(rtol=1e-4, restart=10, maxiter=10)
CAPACITY = dict(nn=96, n_subs=8, npml=8, pivot_dtype="yblock_bf16")
CAPACITY_SOLVE_KW = dict(rtol=1e-4, restart=10, maxiter=10)
# RESULTS.md, "Beyond-HBM capacity demonstration" (a virtual CPU mesh of the
# JAX package, slabs factored on its TPU): 12 iterations, true residual
# 1.2e-5, 22.49 GB of pivots; the JAX counts on its TPU run 1-3 above the
# card's (ROADMAP.md, Queue 3), so the record bounds the count from above
JAX_CAPACITY_ITERATIONS = 12
JAX_CAPACITY_TRUE_RESIDUAL = 1.2e-5
JAX_CAPACITY_PIVOT_BYTES = 22.49e9
# path 4's 96^3 operator and stencils, kept for the capacity solve: the
# annihilator stencils and the symbol depend on (n, h, k) only, not on the
# medium or the grid's offset
CAPACITY_PARTS = {}
# path 2's configuration, the reference's tests/plasma_example.jl
SHARDED_2D = dict(h=1.0 / 800.0, n_subdomains=16, npml=10)


def sharded_world(device, tmp: str):
    """A process group of one rank over NCCL on a ``FileStore`` under
    ``tmp`` and its 1-D ``("slab",)`` device mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(device)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("slab",))
    emit("sharded_world", backend=str(dist.get_backend()), world_size=dist.get_world_size(),
         nccl=str(torch.cuda.nccl.version()), mesh_shape=list(mesh.shape),
         mesh_dim_names=list(mesh.mesh_dim_names), device=str(sharded.shard_device(mesh)))
    return mesh


def one_timed(fn, warm):
    """``fn()`` timed once by CUDA events after ``warm()`` (one
    preconditioner apply: the first call's allocations and library set-up
    stay out of the solve's time).  Returns the result and milliseconds."""
    warm()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def sharded_leg(name: str, one, sharded_run, what: dict):
    """One leg of path 13: the one-device solve ``one = (x, info, ms)`` and
    the sharded one (``sharded_run() -> (x, info, ms)``), held to the same
    iterations, a relative solution difference within
    :data:`SHARDED_SOLUTION_LIMIT` and true residuals within
    :data:`SHARDED_TRUE_RESIDUAL_LIMIT`; no kernel may launch."""
    x1, info1, ms1 = one
    reset_counts()
    x, info, ms = sharded_run()
    torch.cuda.synchronize()
    counts = read_counts()
    its, its1 = info.n_iterations.reshape(-1).tolist(), info1.n_iterations.reshape(-1).tolist()
    diff = float(torch.linalg.vector_norm(x - x1) / torch.linalg.vector_norm(x1))
    true_res = info.true_residual.reshape(-1).tolist()
    emit(name, **what, iterations=its, one_device_iterations=its1,
         converged=info.converged.reshape(-1).tolist(), true_residual=true_res,
         one_device_true_residual=info1.true_residual.reshape(-1).tolist(),
         rel_solution_diff=diff, rel_solution_limit=SHARDED_SOLUTION_LIMIT,
         solve_ms=ms, one_device_solve_ms=ms1, launches=counts)
    check(bool(torch.isfinite(torch.view_as_real(x)).all()), f"{name} solution is finite")
    check(tuple(x.shape) == tuple(x1.shape), f"{name} solution shape")
    check(bool(info.converged.all()), f"{name} converged")
    check(its == its1, f"{name} takes the one-device iterations ({its} vs {its1})")
    check(diff <= SHARDED_SOLUTION_LIMIT, f"{name} solution within 1e-5 of one device ({diff})")
    check(max(true_res) <= SHARDED_TRUE_RESIDUAL_LIMIT, f"{name} true residual ({true_res})")
    check_no_launch(counts, name)
    return counts


def apply_host_device(name: str, fns: dict):
    """Host milliseconds to enqueue one apply beside its device
    milliseconds (CUDA events), for each of ``fns``: one timed apply of
    each after a warm-up (these applies run the plain loops, seconds each)."""
    out = {}
    for label, fn in fns.items():
        out[label] = dict(host_enqueue_ms=enqueue_ms(fn, repeats=1), device_ms=time_ms(fn, 1))
    emit(name, **out)


def phase_sharded_2d(device, mesh):
    """13a: the reference's 801^2 plasma configuration, 16 slabs, the double
    sweep on dense complex64 pivots (``pivot_dtype="full"``, the
    Greengard-Vico operator): the masked ``make_sharded_double_sweep`` with
    ``gmres`` on one direction, and the production path,
    ``DistributedLS2D.apply_batch`` + ``make_sharded_double_sweep_pipelined(
    rhs_block=2)`` + ``gmres_batched`` on two, each against the one-device
    solve of the same problem."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = plasma2d.build_problem(**SHARDED_2D, dtype=torch.complex64, double_sweep=True,
                                     pivot_dtype="full", device=device)
    setup_s = time.perf_counter() - t0
    pc, op = problem.precond, problem.op
    pivot_bytes = sum(s.fac.cinv.numel() * s.fac.cinv.element_size()
                      for s in (pc.slabs, pc.slabs_t))
    what = dict(grid=list(problem.grid.shape), n_subdomains=pc.slabs.n_subs,
                npml=SHARDED_2D["npml"], pivot_dtype="full",
                pivot_bytes=pivot_bytes, setup_seconds=setup_s)
    rhs = plasma2d.incident_rhs(problem, DIRECTIONS[:1])[0]
    one = one_timed(lambda: gmres(op.apply, rhs, preconditioner=pc.apply, **SOLVE_KW),
                    lambda: pc.apply(rhs))
    masked = sharded.make_sharded_double_sweep(pc.slabs, pc.slabs_t, pc.msp, pc.a_s, mesh)

    def run_masked():
        (x, info), ms = one_timed(
            lambda: gmres(op.apply, rhs, preconditioner=masked, **SOLVE_KW),
            lambda: masked(rhs))
        return x, info, ms

    counts = sharded_leg("sharded_2d_masked", (*one[0], one[1]), run_masked,
                         dict(what, directions=1))
    apply_host_device("sharded_2d_apply", {"one_device": lambda: pc.apply(rhs),
                                           "sharded_masked": lambda: masked(rhs)})

    rhs2 = plasma2d.incident_rhs(problem, DIRECTIONS)
    one2 = one_timed(lambda: gmres_batched(op.apply, rhs2, preconditioner=pc.apply_batch,
                                           **SOLVE_KW),
                     lambda: pc.apply_batch(rhs2))
    grid = problem.grid
    op_d = pfft.build_distributed_fast_convolution_2d(
        grid.x, grid.y, grid.h, problem.k, op.nu.cpu().numpy(), mesh, dtype=torch.complex64)
    op_err = rel_err(op_d.apply_batch(rhs2), op.apply(rhs2))[1]
    pipe = sharded.make_sharded_double_sweep_pipelined(pc.slabs, pc.slabs_t, pc.msp, pc.a_s,
                                                        mesh, rhs_block=2)

    def run_pipelined():
        (x, info), ms = one_timed(
            lambda: gmres_batched(op_d.apply_batch, rhs2, preconditioner=pipe, **SOLVE_KW),
            lambda: pipe(rhs2))
        return x, info, ms

    counts2 = sharded_leg("sharded_2d_pipelined", (*one2[0], one2[1]), run_pipelined,
                          dict(what, directions=2, rhs_block=2,
                               operator_rel_err_vs_one_device=op_err,
                               peak_memory_bytes=torch.cuda.max_memory_allocated()))
    apply_host_device("sharded_2d_apply_batch", {
        "one_device": lambda: pc.apply_batch(rhs2), "sharded_pipelined": lambda: pipe(rhs2),
        "operator_one_device": lambda: op.apply(rhs2),
        "operator_distributed": lambda: op_d.apply_batch(rhs2)})
    check(op_err <= 1e-5, f"the distributed 801^2 operator matches the one-device one ({op_err})")
    return [counts, counts2]


def phase_sharded_3d(device, mesh):
    """13b: path 9's configuration (48^3, 4 z-slabs, npml 6) on dense
    complex64 z-plane pivots: ``DistributedLS3D.apply_batch`` +
    ``make_sharded_sweep_preconditioner_3d_pipelined(rhs_block=2)`` and
    ``make_sharded_polarized_preconditioner_3d`` (nIt = 2), each with
    ``gmres_batched`` on two sources, against the one-device ``precond="gs"``
    and ``precond="polarized_traces"`` solves on the same slabs."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = bump3d.build_problem(dtype=torch.complex64, precond="gs", pivot_dtype="full",
                                   device=device, **POLARIZED3D)
    setup_s = time.perf_counter() - t0
    slabs, a_s, op = problem.precond.slabs, problem.a_s, problem.op
    what = dict(grid=list(problem.grid.shape), n_subdomains=slabs.n_subs,
                npml=POLARIZED3D["npml"],
                pivot_dtype="full", pivot_layout=slabs.pivot_layout, sources=2,
                pivot_bytes=slabs.fac.cinv.numel() * slabs.fac.cinv.element_size(),
                setup_seconds=setup_s)
    rhs2 = torch.stack([problem.rhs, plane_wave_rhs(problem, 1)])
    x = problem.grid.x
    op_d = pfft.build_distributed_fast_convolution_3d(x, x, x, problem.grid.h, problem.k,
                                                      op.nu.cpu().numpy(), mesh,
                                                      dtype=torch.complex64)
    op_err = rel_err(op_d.apply_batch(rhs2), op.apply(rhs2))[1]
    check(op_err <= 1e-5, f"the distributed 48^3 operator matches the one-device one ({op_err})")
    counts = []
    legs = (
        ("sharded_3d_gs", problem.precond.apply_batch,
         sharded3d.make_sharded_sweep_preconditioner_3d_pipelined(slabs, a_s, mesh, rhs_block=2),
         dict(rhs_block=2)),
        ("sharded_3d_polarized",
         polarized3d.PolarizedTracesPreconditioner3D(slabs=slabs, a_s=a_s, n_it=2).apply_batch,
         ppolarized3d.make_sharded_polarized_preconditioner_3d(slabs, a_s, mesh, n_it=2),
         dict(n_it=2)),
    )
    for name, one_pc, sharded_pc, extra in legs:
        one = one_timed(lambda: gmres_batched(op.apply, rhs2, preconditioner=one_pc,
                                              **POLARIZED3D_SOLVE_KW),
                        lambda: one_pc(rhs2))

        def run(sharded_pc=sharded_pc):
            (xs, info), ms = one_timed(
                lambda: gmres_batched(op_d.apply_batch, rhs2, preconditioner=sharded_pc,
                                      **POLARIZED3D_SOLVE_KW),
                lambda: sharded_pc(rhs2))
            return xs, info, ms

        counts.append(sharded_leg(name, (*one[0], one[1]), run,
                                  dict(what, **extra, operator_rel_err_vs_one_device=op_err)))
    apply_host_device("sharded_3d_apply", {
        "one_device_gs": lambda: legs[0][1](rhs2), "sharded_gs_pipelined": lambda: legs[0][2](rhs2)})
    emit("sharded_3d_memory", peak_memory_bytes=torch.cuda.max_memory_allocated())
    return counts


def phase_sharded_polarized_2d(device, mesh):
    """13c: path 8's configuration (401^2, 8 slabs, npml 10, nIt = 2, the
    trapezoidal operator) on dense complex64 pivots:
    ``make_sharded_polarized_preconditioner`` with the distributed
    trapezoidal operator and ``gmres_batched`` on two directions, against
    ``plasma_integral2d.solve_batched`` on the same problem."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = plasma_integral2d.build_problem(**POLARIZED, n_it=2, dtype=torch.complex64,
                                              pivot_dtype="full", device=device)
    setup_s = time.perf_counter() - t0
    pc, op, grid = problem.precond, problem.op, problem.grid
    rhs2 = plasma2d.incident_rhs(problem, DIRECTIONS)
    one = one_timed(lambda: plasma_integral2d.solve_batched(problem, DIRECTIONS, **SOLVE_KW),
                    lambda: pc.apply_batch(rhs2))
    op_d = pfft.build_distributed_fast_convolution_2d(
        grid.x, grid.y, grid.h, problem.k, op.nu.cpu().numpy(), mesh,
        quad_rule="trapezoidal", dtype=torch.complex64)
    op_err = rel_err(op_d.apply_batch(rhs2), op.apply(rhs2))[1]
    check(op_err <= 1e-5, f"the distributed 401^2 operator matches the one-device one ({op_err})")
    spc = ppolarized.make_sharded_polarized_preconditioner(pc.slabs, pc.a_s, mesh, n_it=2)

    def run():
        (x, info), ms = one_timed(
            lambda: gmres_batched(op_d.apply_batch, rhs2, preconditioner=spc, **SOLVE_KW),
            lambda: spc(rhs2))
        return x, info, ms

    counts = sharded_leg("sharded_polarized_2d", (*one[0], one[1]), run, dict(
        grid=list(grid.shape), n_subdomains=pc.slabs.n_subs, npml=POLARIZED["npml"], n_it=2,
        pivot_dtype="full",
        quad_rule="trapezoidal", directions=2, setup_seconds=setup_s,
        operator_rel_err_vs_one_device=op_err,
        peak_memory_bytes=torch.cuda.max_memory_allocated()))
    apply_host_device("sharded_polarized_2d_apply", {"one_device": lambda: pc.apply_batch(rhs2),
                                                      "sharded": lambda: spc(rhs2)})
    return counts


def phase_capacity(device, mesh):
    """13d: ``benchmarks/capacity3d.py`` on the card: 96^3 on [0, 1)^3, k = 96,
    8 z-slabs, npml 8, y-blocked bf16 pivots built through ``fac_provider``
    (a provider that factors one slab at a time with the ``factor_one`` it
    is given and fills the stacked factorization slab by slab), solved by the
    masked ``make_sharded_sweep_preconditioner_3d`` with ``gmres(rtol=1e-4,
    restart=10, maxiter=10)``, against the one-device sweep on the same
    slabs."""
    parts = CAPACITY_PARTS
    nn = CAPACITY["nn"]
    h, k = 1.0 / nn, float(nn)
    x = np.arange(nn) * h
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    nu = media.gaussian_bump_3d(X, Y, Z)
    op = dataclasses.replace(parts["op"], nu=torch.as_tensor(nu, dtype=torch.float32,
                                                             device=device))
    check((op.n, op.m, op.l) == (nn, nn, nn), "path 4's operator is the 96^3 one")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    provided = []

    def provider(h_sten, dtype, factor_one):
        kind, fields = None, None
        for s in range(h_sten.shape[0]):
            t0 = time.perf_counter()
            fac_s = factor_one(torch.as_tensor(h_sten[s]).to(device=device, dtype=dtype))
            if fields is None:
                kind = type(fac_s)
                fields = {f.name: getattr(fac_s, f.name).new_empty(
                    (h_sten.shape[0],) + tuple(getattr(fac_s, f.name).shape))
                    for f in dataclasses.fields(fac_s)}
            for name, t in fields.items():
                t[s] = getattr(fac_s, name)
            del fac_s
            torch.cuda.synchronize()
            provided.append(time.perf_counter() - t0)
        return kind(**fields), None

    t0 = time.perf_counter()
    timings = {}
    slabs = subdomain3d.build_slab_system_3d(
        parts["a_s"], parts["ag_s"], nu, x, h, k, CAPACITY["n_subs"], npml=CAPACITY["npml"],
        pivot_dtype=CAPACITY["pivot_dtype"], fac_provider=provider, timings=timings)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    pivot_bytes = sum(getattr(slabs.fac, f.name).numel() * getattr(slabs.fac, f.name).element_size()
                      for f in dataclasses.fields(slabs.fac) if f.name.startswith("cinv"))
    u_inc = torch.exp(1j * k * torch.as_tensor(X.ravel(), device=device)).to(torch.complex64)
    rhs = -(op.apply(u_inc) - u_inc)
    a_s = parts["a_s"]

    def one_pc(v):
        return subdomain3d.gs_sweep_3d(slabs, a_s.matvec(v))

    one = one_timed(lambda: gmres(op.apply, rhs, preconditioner=one_pc, **CAPACITY_SOLVE_KW),
                    lambda: one_pc(rhs))
    spc = sharded3d.make_sharded_sweep_preconditioner_3d(slabs, a_s, mesh)

    def run():
        (xs, info), ms = one_timed(
            lambda: gmres(op.apply, rhs, preconditioner=spc, **CAPACITY_SOLVE_KW),
            lambda: spc(rhs))
        return xs, info, ms

    counts = sharded_leg("capacity_96", (*one[0], one[1]), run, dict(
        grid=[nn] * 3, k=k, n_subdomains=CAPACITY["n_subs"], npml=CAPACITY["npml"],
        pivot_dtype=CAPACITY["pivot_dtype"], pivot_layout=slabs.pivot_layout,
        l1_max=slabs.l1_max, pivot_bytes=pivot_bytes,
        jax_package_pivot_bytes=JAX_CAPACITY_PIVOT_BYTES,
        setup_seconds=setup_s, setup_seconds_by_part=timings,
        seconds_per_provided_slab=provided, peak_memory_setup_bytes=setup_peak,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        jax_package_iterations=JAX_CAPACITY_ITERATIONS,
        jax_package_true_residual=JAX_CAPACITY_TRUE_RESIDUAL, solve_kw=CAPACITY_SOLVE_KW))
    its = int(one[0][1].n_iterations)
    check(its <= JAX_CAPACITY_ITERATIONS,
          f"capacity solve within the JAX record's {JAX_CAPACITY_ITERATIONS} iterations ({its})")
    check(len(provided) == CAPACITY["n_subs"], "the provider factored every slab")
    return counts


def path13(device, smi: str) -> dict:
    """Path 13: the sharded code of ``parallel/`` on a mesh of one rank over
    NCCL, under a fresh temporary directory (the store), removed at the end.
    Returns each kernel's launches summed over the path's sharded legs, all
    0."""
    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    counts = []
    try:
        mesh = sharded_world(device, tmp)
        marks = [("13a", time.perf_counter())]
        counts += phase_sharded_2d(device, mesh)
        torch.cuda.empty_cache()
        marks.append(("13b", time.perf_counter()))
        counts += phase_sharded_3d(device, mesh)
        torch.cuda.empty_cache()
        marks.append(("13c", time.perf_counter()))
        counts.append(phase_sharded_polarized_2d(device, mesh))
        torch.cuda.empty_cache()
        marks.append(("13d", time.perf_counter()))
        counts.append(phase_capacity(device, mesh))
        torch.cuda.empty_cache()
        marks.append(("end", time.perf_counter()))
        # a system whose only pivots are a kernel layout is refused
        small = plasma2d.build_problem(h=1.0 / 40.0, n_subdomains=2, npml=6,
                                       dtype=torch.complex64, pivot_dtype="pallas",
                                       device=device).precond.slabs
        try:
            sharded.sharded_gs_sweep(small, torch.zeros(41 * 41, dtype=torch.complex64,
                                                        device=device), mesh)
            refused = ""
        except ValueError as e:
            refused = str(e)
        emit("sharded_kernel_layout_refused", message=refused, card=smi,
             seconds={a[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})
        check("pivot_dtype='pallas'" in refused, "a pallas-only slab system is refused")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    total = {name: sum(c[name] for c in counts) for name in COUNTERS}
    check_no_launch(total, "path 13")
    return total


def with_path13_launches(kernels: list, total: dict) -> list:
    """Each kernel entry gains ``path13_launches``: its launches over path
    13's sharded legs (0: no hand-written kernel lies on the sharded path)."""
    names = {info["kernel"]: name for name, info in KERNEL_INFO.items()}
    for entry in kernels:
        entry["path13_launches"] = total[names[entry["kernel"]]]
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    # wall seconds from the start to each path's first phase and to the end
    marks = [("start", time.perf_counter())]
    smi = phase_device()
    phase_build()
    phase_kernels(device)
    phase_small_reference(device, n_subdomains=1, double_sweep=False, rtol=1e-6)
    # on a 41 x 41 grid the complex64 double-sweep solve reaches the float32
    # rounding floor of an apply at 1e-6: its last iteration would be noise
    phase_small_reference(device, n_subdomains=3, double_sweep=True, rtol=1e-5)

    marks.append(("path 1", time.perf_counter()))
    # path 1: one slab, the sweep is the exact solve of the sparsified system
    pair = ("thomas_forward", "thomas_backward")
    problem, counts = phase_solve(device, "solve", 1, False, pair, repeats=3)
    counts_batched = phase_solve_batched(problem, "solve_batched", pair, repeats=3)
    kernels = phase_kernel_times(problem, {1: counts, 2: counts_batched})
    # (a) eight and sixteen directions in one joint solve: r = 8, 16 a launch
    wide = phase_wide_2d(problem, "wide_solve", "solve", "solve_batched", pair)
    kernels += wide_line_entries(problem, "wide_solve", wide)
    del problem
    torch.cuda.empty_cache()

    marks.append(("path 2", time.perf_counter()))
    # path 2: 16 slabs, alternating bi-directional sweep
    pair = ("thomas_forward_cached", "thomas_backward")
    problem, counts = phase_solve(device, "sweep_solve", 16, True, pair, repeats=3)
    counts_batched = phase_solve_batched(problem, "sweep_solve_batched", pair, repeats=3)
    # (b) eight and sixteen directions through the 16-slab double sweep
    wide = phase_wide_2d(problem, "sweep_wide", "sweep_solve", "sweep_solve_batched", pair,
                         allowed=DENSE_2D)
    kernels += wide_line_entries(problem, "sweep_wide", wide)
    jacobi_counts = phase_sweeps(problem)
    kernels += phase_sweep_kernel_times(problem, {1: counts, 2: counts_batched}, jacobi_counts)
    del problem
    torch.cuda.empty_cache()

    marks.append(("path 3", time.perf_counter()))
    # path 3: the 48^3 bump solve through the fused plane kernels
    phase_plane_kernels(device)
    phase_small_reference_3d(device)
    problem, counts3d = phase_bump3d_solve(device)
    apply_counts = phase_plane_apply_path(problem)
    kernels += phase_plane_kernel_times(problem, counts3d, apply_counts)
    del problem
    torch.cuda.empty_cache()

    marks.append(("path 4", time.perf_counter()))
    # path 4: the 96^3 z-slab sweep through the int8 plane kernels
    phase_plane_kernels_int8(device)
    phase_small_reference_gs3d(device)
    kernels += phase_gs3d_48_z(device)
    problem, counts96 = phase_gs3d_96_solve(device)
    # (d) eight plane waves in one joint solve on the int8 y-planes
    wide = phase_wide_3d(problem, "gs3d_96_wide", (WIDE_R,),
                         {1: SOLVE_RESULTS["gs3d_96_solve"]["ms"],
                          2: SOLVE_RESULTS["gs3d_96_apply_batch"]["ms"] / 2},
                         ("plane_forward_int8", "plane_backward_int8"), GS96_SOLVE_KW)
    apply_counts = phase_plane_apply_path_int8(problem)
    kernels += sweep_kernel_times(problem, {1: "gs3d_96_solve", 2: "gs3d_96_apply_batch"},
                                  counts96, apply_counts)
    kernels += sweep_kernel_times(problem, {r: "gs3d_96_wide" for r in WIDE_RS},
                                  {r: wide[WIDE_R] for r in WIDE_RS}, apply_counts)
    marks.append(("path 4 polarized", time.perf_counter()))
    # the 3D polarized traces on the same int8 y-plane slabs (path 9's module)
    kernels += phase_polarized3d_96(problem)
    marks.append(("path 4 bf16", time.perf_counter()))
    kernels += phase_gs3d_96_bf16(problem)
    # path 13's capacity solve reuses the 96^3 operator and stencils
    CAPACITY_PARTS.update(op=problem.op, a_s=problem.a_s, ag_s=problem.ag_s)
    del problem
    torch.cuda.empty_cache()

    marks.append(("path 5", time.perf_counter()))
    # path 5: 16 slabs, double sweep, banded+tail pivots: each sweep direction
    # is one launch of a fused sweep kernel
    phase_ht_kernels(device)
    phase_small_reference_ht(device)
    problem, counts = phase_solve(device, "ht_solve", 16, True, SWEEP_PAIR, repeats=3,
                                  pivot_dtype="pallas_banded_tail",
                                  jax_iterations=JAX_HT_ITERATIONS, absent=HT_PAIR + DENSE_2D)
    counts_batched = phase_solve_batched(problem, "ht_solve_batched", SWEEP_PAIR, repeats=3,
                                         jax_iterations=JAX_HT_ITERATIONS,
                                         absent=HT_PAIR + DENSE_2D)
    sweep_counts = phase_ht_sweeps(problem)
    kernels += phase_ht_kernel_times(problem, {1: counts, 2: counts_batched}, sweep_counts)
    # (e) eight and sixteen directions in one joint solve: each sweep
    # direction one launch of eight or sixteen; one jacobi_sweep of eight;
    # rows 6-9 at r = 3, 4, 8, 12, 16
    kernels += phase_ht_wide(problem, sweep_counts)
    del problem
    torch.cuda.empty_cache()

    marks.append(("path 6", time.perf_counter()))
    # path 6: 16 slabs, double sweep, int8 line pivots: every local solve runs
    # the int8 mode of the line kernels
    phase_int8_line_kernels(device)
    phase_small_reference_int8(device)
    pair = ("thomas_forward_cached_int8", "thomas_backward_int8")
    absent = DENSE_2D + HT_PAIR + SWEEP_PAIR
    problem, counts = phase_solve(device, "int8_sweep_solve", 16, True, pair, repeats=3,
                                  pivot_dtype="pallas_int8",
                                  jax_iterations=JAX_INT8_ITERATIONS, absent=absent)
    counts_batched = phase_solve_batched(problem, "int8_sweep_solve_batched", pair, repeats=3,
                                         jax_iterations=JAX_INT8_ITERATIONS, absent=absent)
    # (b) the same eight and sixteen directions on the int8 line planes
    wide = phase_wide_2d(problem, "int8_sweep_wide", "int8_sweep_solve",
                         "int8_sweep_solve_batched", pair, allowed=INT8_2D)
    kernels += wide_line_entries(problem, "int8_sweep_wide", wide)
    jacobi_counts = phase_int8_sweeps(problem)
    kernels += phase_int8_kernel_times(problem, {1: counts, 2: counts_batched}, jacobi_counts,
                                       wide)
    del problem
    torch.cuda.empty_cache()

    marks.append(("path 7", time.perf_counter()))
    # path 7: build_problem(use_pallas=True): the stencil matvec kernel
    phase_stencil_kernel(device)
    kernels += phase_pallas_stencil_solve(device)

    marks.append(("path 8", time.perf_counter()))
    # path 8: the 401^2 polarized-traces solve, 8 slabs: its local solves run
    # the dense bf16 line kernels with head starts and tails
    problem, counts, x = phase_polarized_solve(device)
    phase_polarized_enqueue(problem)
    kernels += phase_polarized_kernel_times(problem, counts)
    del problem
    torch.cuda.empty_cache()
    phase_polarized_reference(device, x)

    marks.append(("path 9", time.perf_counter()))
    # path 9: the 48^3 polarized-traces solve, 4 z-slabs: its local solves run
    # the fused bf16 plane passes with head starts and tails
    phase_small_reference_polarized3d(device)
    problem, counts, x = phase_polarized3d_solve(device)
    phase_polarized3d_reference(device, x)
    phase_polarized_enqueue(problem, polarized3d, problem.rhs, "polarized3d_enqueue")
    kernels += phase_polarized3d_kernel_times(problem, counts)
    del problem, x
    torch.cuda.empty_cache()

    marks.append(("path 10", time.perf_counter()))
    # path 10: examples/example.jl, the 201^2 bump with the sparsifying
    # preconditioner, and the adjoint solves: no hand-written kernel
    phase_bump2d_solve(device)
    # complex128 at rtol 1e-8: the complex64 solve at 1e-6 runs into the
    # float32 floor of its Arnoldi estimate (restart-driven counts), where
    # two directions' counts are noise
    problem, n_it = phase_bump2d_c128(device)
    phase_bump2d_batched(problem, n_it, rtol=1e-8)
    phase_bump2d_adjoint(problem)
    del problem
    torch.cuda.empty_cache()

    marks.append(("path 11", time.perf_counter()))
    # path 11: the plain banded pivot modes (banded, banded_tail, banded_lr):
    # no hand-written kernel
    phase_banded_801(device)
    torch.cuda.empty_cache()
    phase_banded_modes(device)

    marks.append(("path 12", time.perf_counter()))
    # path 12: the user surface (api.py, the CLI, cache_dir) on path 2's and
    # path 9's problems
    path12(device, smi)
    kernels = with_api_launches(kernels)

    marks.append(("path 13", time.perf_counter()))
    # path 13: the multi-device layouts (parallel/) on a mesh of one rank
    # over NCCL; no hand-written kernel
    kernels = with_path13_launches(kernels, path13(device, smi))

    marks.append(("end", time.perf_counter()))
    emit("timeline", seconds_from_start={name: t - marks[0][1] for name, t in marks[1:]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
