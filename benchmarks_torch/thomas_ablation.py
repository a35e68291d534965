"""Where one line of the dense substitution passes, or one step of the fused
sweeps, spends its time.

    python3 benchmarks_torch/thomas_ablation.py [--trace-only | --sweep] [--r 1,2,4,8]

Needs one CUDA card and nvcc.  ``ncu`` and ``nsys`` are not always at hand,
so this script measures by ablation: it builds ``csrc/thomas_fwd.cu`` once per
case with ``-DTHOMAS_ABLATE=<mask>`` (see ``csrc/thomas_flow.cuh``),
which leaves single phases of the flag-handoff line step out (the results
are then wrong; only the time is read): the flag wait, the carry's load
altogether, the band step, the products, the bulk copies of the planes or of
the band and right-hand rows.  It also builds whole the flag-handoff step
with one and with two CTAs a tile (``-DTHOMAS_SPLIT=1``, ``2``; the package
picks per launch) and with one item of look-ahead (``-DTHOMAS_STAGES=2``).  It times the
forward pass through the package's wrapper at one slab of m = n = 801 lines
for r = 1 and 2, and at 16 batch rows of 70 lines for r = 1 (``--r`` gives
the right-hand sides of both shapes instead, e.g. ``--r 2,8`` for the wide
step), and prints microseconds per line for every case.  The libraries go to
``build/ablation/``.  Last, a build with ``-DTHOMAS_TRACE=1`` stamps the SM's
cycle counter at each phase of a line step in every CTA: it prints the median
of each phase, and at one slab, by the global timer, the handoff (from the
last publication of a line to a CTA's carry of the next) and the line period.
(The stamps cost time of their own; the phase after the block's barrier reads
longer than the code it holds, so the ablation, not the trace, gives the
breakdown.)

At r = 4, 8 and 16 (the wide step, ``csrc/thomas_flow.cuh`` note "Wide
batches") the masks of :data:`WIDE_CASES` take the new step's phases apart
instead: the handoff (no flag wait: flags unchecked; no release fences: the
producers' fences before their flags; no rows copy: neither flags nor the
rows' copy and edge terms, w stale; no edge terms), the band step (the producer's, on its
tile's lanes; the consumers have none), the products, the plane copies, the
producer's loads of the next line's band and right-hand rows, the outputs (y
and t); also the step whole with one and with two CTAs a tile.  The
trace's phases there: stage wait, the rows' flags, copy, edge terms and
split, the products, the warps' sums and barrier, the sums, band step and
publication.

With ``--sweep`` it builds ``csrc/sweep_fused.cu`` and
``csrc/thomas_fwd_cached.cu`` once per case of :data:`SWEEP_CASES` instead
(into ``build/ablation/sweep/``): the flag-handoff step whole, and without
one phase of its step each: the flag
wait, the injection (the trace's words and the coupling products), the
outputs (y, t, the traces for the next launch and the private y lines), the
carry's load, the band step, the products, the bulk copies.  It times the
down and the up kernel on random banded+tail factors at the 801^2 solve's
shape (16 slabs of 70 lines, width 201, trace tail 22; ``thomas_probe.py``),
and the cached forward pass at one slab of 70 lines on random bf16 planes
(rows 3 and 5), for r = 1 and 2, and prints microseconds a step.
"""

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
    cuda_time_ms,
)

# bits of THOMAS_ABLATE, as in csrc/thomas_flow.cuh
NO_BAND_STEP, NO_PRODUCTS, NO_PLANE_COPIES, NO_ROW_COPIES, NO_CARRY_LOAD = 1, 2, 8, 16, 32
NO_FLAG_WAIT, NO_INJECTION, NO_OUTPUTS, NO_FENCES, NO_EDGES = 64, 128, 256, 512, 1024
NO_COPIES = NO_PLANE_COPIES | NO_ROW_COPIES
CASES = [
    ("one CTA a tile, whole", {"THOMAS_SPLIT": 1}),
    ("two CTAs a tile, whole", {"THOMAS_SPLIT": 2}),
    ("full", {"THOMAS_ABLATE": 0}),
    ("no flag wait", {"THOMAS_ABLATE": NO_FLAG_WAIT}),
    ("no carry load", {"THOMAS_ABLATE": NO_CARRY_LOAD}),
    ("no carry load + band step", {"THOMAS_ABLATE": NO_BAND_STEP}),
    ("no products", {"THOMAS_ABLATE": NO_PRODUCTS}),
    ("no plane copies", {"THOMAS_ABLATE": NO_PLANE_COPIES}),
    ("no band/rhs copies", {"THOMAS_ABLATE": NO_ROW_COPIES}),
    ("no copies", {"THOMAS_ABLATE": NO_COPIES}),
    ("no carry, no copies", {"THOMAS_ABLATE": NO_BAND_STEP | NO_COPIES}),
    ("no carry, copies, products", {"THOMAS_ABLATE": NO_BAND_STEP | NO_COPIES | NO_PRODUCTS}),
    ("none of them", {"THOMAS_ABLATE": NO_BAND_STEP | NO_COPIES | NO_PRODUCTS}),
    # one item of look-ahead instead of two
    ("two stages", {"THOMAS_STAGES": 2}),
]
# the wide step's phases (r = 4, 8)
WIDE_CASES = [
    ("one CTA a tile, whole", {"THOMAS_SPLIT": 1}),
    ("two CTAs a tile, whole", {"THOMAS_SPLIT": 2}),
    ("full", {"THOMAS_ABLATE": 0}),
    ("no flag wait", {"THOMAS_ABLATE": NO_FLAG_WAIT}),
    ("no release fences", {"THOMAS_ABLATE": NO_FENCES}),
    ("no rows copy (no handoff)", {"THOMAS_ABLATE": NO_CARRY_LOAD}),
    ("no edge terms", {"THOMAS_ABLATE": NO_EDGES}),
    ("no band step", {"THOMAS_ABLATE": NO_BAND_STEP}),
    ("no products", {"THOMAS_ABLATE": NO_PRODUCTS}),
    ("no plane copies", {"THOMAS_ABLATE": NO_PLANE_COPIES}),
    ("no band/rhs loads", {"THOMAS_ABLATE": NO_ROW_COPIES}),
    ("no outputs", {"THOMAS_ABLATE": NO_OUTPUTS}),
    ("no handoff, no products", {"THOMAS_ABLATE": NO_CARRY_LOAD | NO_PRODUCTS}),
    ("no handoff, copies, products", {"THOMAS_ABLATE": NO_CARRY_LOAD | NO_COPIES | NO_PRODUCTS}),
    ("none of them", {"THOMAS_ABLATE": NO_CARRY_LOAD | NO_COPIES | NO_PRODUCTS | NO_BAND_STEP
                      | NO_OUTPUTS}),
]


SWEEP_CASES = [
    ("full", {"THOMAS_ABLATE": 0}),
    ("no flag wait", {"THOMAS_ABLATE": NO_FLAG_WAIT}),
    ("no injection", {"THOMAS_ABLATE": NO_INJECTION}),
    ("no outputs", {"THOMAS_ABLATE": NO_OUTPUTS}),
    ("no carry load", {"THOMAS_ABLATE": NO_CARRY_LOAD}),
    ("no carry load + band step", {"THOMAS_ABLATE": NO_BAND_STEP}),
    ("no products", {"THOMAS_ABLATE": NO_PRODUCTS}),
    ("no plane copies", {"THOMAS_ABLATE": NO_PLANE_COPIES}),
    ("no band/rhs copies", {"THOMAS_ABLATE": NO_ROW_COPIES}),
    ("none of them", {"THOMAS_ABLATE": NO_BAND_STEP | NO_COPIES | NO_PRODUCTS | NO_FLAG_WAIT
                      | NO_INJECTION | NO_OUTPUTS}),
]


def sweep_ablation(dev, g):
    """Microseconds a step of the fused sweep kernels for each case of
    :data:`SWEEP_CASES`, every build started at once."""
    from thomas_probe import TRACE_TAIL, random_banded, sweep_operands, sweep_runs

    sources = ["sweep_fused", "thomas_fwd_cached"]
    dirs = [ROOT / "build" / "ablation" / "sweep" / str(i) for i in range(len(SWEEP_CASES))]
    with ThreadPoolExecutor(len(SWEEP_CASES)) as pool:
        list(pool.map(lambda i: cuda_build.build_kernels(
            sources, defines=SWEEP_CASES[i][1], build_dir=dirs[i]),
            range(len(SWEEP_CASES))))
    cached = [cuda_build.load("thomas_fwd_cached", build_dir=d) for d in dirs]
    dense = random_factors(g, 16, 70, 801, dev)
    for r in (1, 2):
        b4 = torch.zeros((1, 70, 2 * r, dense.ld), device=dev)
        b4[..., :801] = torch.randn((1, 70, 2 * r, 801), generator=g, device=dev)
        for (name, _), lib in zip(SWEEP_CASES, cached):
            cuda_build._functions["thomas_fwd_cached"] = lib
            tk._EXCHANGES = {}
            ms = cuda_time_ms(lambda: tk.forward_substitution_cached(
                dense, dense.slab_ids[8:9], b4), 10)
            print(f"cached r={r}  {name:28s} {1e3 * ms / 70:7.3f} us/line", flush=True)
    del dense
    libs = [cuda_build.load("sweep_fused", build_dir=d) for d in dirs]
    fac = random_banded(g, 16, 70, dev)
    steps = fac.n_slabs * (fac.m + TRACE_TAIL)
    for r in (1, 2):
        cuda_build._functions["sweep_fused"] = libs[0]       # the up launch's inputs
        runs = sweep_runs(fac, *sweep_operands(fac, r, g, dev))
        for (name, _), lib in zip(SWEEP_CASES, libs):
            cuda_build._functions["sweep_fused"] = lib
            tk._EXCHANGES = {}
            us = {k: 1e3 * cuda_time_ms(fn, 5) / steps for k, fn in runs.items()}
            print(f"sweep r={r}  {name:28s} down {us['down']:7.3f}  up {us['up']:7.3f} us/step",
                  flush=True)


def ablated_libraries(cases) -> dict:
    """One build of the forward pass per set of defines among ``cases``, all
    started together; returns the launchers by case name."""
    keys = list(dict.fromkeys(tuple(sorted(defines.items())) for _, defines in cases))
    dirs = [ROOT / "build" / "ablation" / "_".join(f"{k}{v}" for k, v in key) for key in keys]
    with ThreadPoolExecutor(len(keys)) as pool:     # each build is one nvcc
        list(pool.map(lambda i: cuda_build.build_kernels(
            ["thomas_fwd"], defines=dict(keys[i]), build_dir=dirs[i]), range(len(keys))))
    built = {key: cuda_build.load("thomas_fwd", build_dir=d) for key, d in zip(keys, dirs)}
    return {name: built[tuple(sorted(defines.items()))] for name, defines in cases}


TRACE_SHAPE = (264, 64, 8)     # csrc/thomas_flow.cuh: kTraceCtas, kTraceItems, kTracePoints
PHASES = ("stage wait", "carry wait + load", "band step + products", "warp sums + barrier",
          "sum + publish")
WIDE_PHASES = ("stage wait", "rows wait + copy + split", "products", "warp sums + barrier",
               "sum + band step + publish")


def trace_library():
    """The forward pass built with -DTHOMAS_TRACE=1, and its trace reader."""
    d = ROOT / "build" / "ablation" / "trace"
    cuda_build.build_kernels(["thomas_fwd"], defines={"THOMAS_TRACE": 1}, build_dir=d)
    lib = ctypes.CDLL(str(d / "libthomas_fwd.so"))
    lib.thomas_trace_read.argtypes = [ctypes.c_void_p]
    lib.thomas_trace_read.restype = ctypes.c_int
    return cuda_build.load("thomas_fwd", build_dir=d), lib.thomas_trace_read


def trace_report(read, run, label, single_tile: bool, phase_names=PHASES):
    """Medians over CTAs and traced items of each phase of a line step (SM
    cycles), and at one tile a CTA (B = 1) the handoff: from the last
    publication of line k - 1 to a CTA's carry of line k, and the line
    period (global timer, ns)."""
    run()
    torch.cuda.synchronize()
    stamps = np.zeros(TRACE_SHAPE, dtype=np.int64)
    if read(stamps.ctypes.data):
        raise RuntimeError("thomas_trace_read failed")
    ctas = np.flatnonzero((stamps[:, :, 0] > 0).all(axis=1))
    t = stamps[ctas].astype(np.float64)
    phases = {name: float(np.median(t[:, :, k + 1] - t[:, :, k]))
              for k, name in enumerate(phase_names)}
    out = dict(case=label, ctas=len(ctas), phase_cycles=phases,
               item_cycles=float(np.median(np.diff(t[:, :, 0], axis=1))))
    if single_tile:
        published = t[:, :, 7].max(axis=0)                      # last publication, per line
        out["handoff_ns"] = float(np.median(t[:, 1:, 6] - published[None, :-1]))
        out["line_period_ns"] = float(np.median(np.diff(published)))
    print(json.dumps(out), flush=True)


def random_factors(g, S, m, n, dev):
    ld = tk._round_up(n, tk.LEAD_MULTIPLE)
    planes = []
    for _ in range(2):
        p = torch.zeros((S, m, ld, ld), dtype=torch.bfloat16, device=dev)
        p[:, :, :n, :n] = (0.1 / n ** 0.5) * torch.randn((S, m, n, n), generator=g, device=dev)
        planes.append(tk.tile_planes(p))
    bands = torch.zeros((S, m, 2, 3, ld), device=dev)
    bands[..., :n] = 0.4 * torch.rand((S, m, 2, 3, n), generator=g, device=dev) - 0.2
    return tk.ThomasFactorization(planes[0], planes[1], bands, bands, n)


def main():
    print(card_name_and_power_limit(), flush=True)
    if "--sweep" in sys.argv[1:]:
        sweep_ablation(torch.device("cuda", 0),
                       torch.Generator(device="cuda").manual_seed(0))
        return
    trace_only = "--trace-only" in sys.argv[1:]
    argv = sys.argv[1:]
    wanted = tuple(int(r) for r in argv[argv.index("--r") + 1].split(",")) if "--r" in argv else None
    narrow = any(r <= 2 for r in wanted or (1,))
    wide = any(r > 2 for r in wanted or ())
    libs = {}                   # (wide, case name) -> launcher
    for is_wide, cases in ((False, CASES), (True, WIDE_CASES)):
        if not trace_only and (wide if is_wide else narrow):
            libs.update({(is_wide, name): lib for name, lib in ablated_libraries(cases).items()})
    trace_lib, read = trace_library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    n = 801
    # one slab of 801 lines (the one-slab solve), and 16 batch rows of 70
    # lines, one per slab (jacobi_sweep)
    for S, m, rs in ((1, 801, wanted or (1, 2)), (16, 70, wanted or (1,))):
        fac = random_factors(g, S, m, n, dev)
        for r in rs:
            b4 = torch.zeros((S, m, 2 * r, fac.ld), device=dev)
            b4[..., :n] = torch.randn((S, m, 2 * r, n), generator=g, device=dev)
            for name, _ in WIDE_CASES if r > 2 else CASES:
                lib = libs.get((r > 2, name))
                if lib is None:         # --trace-only
                    continue
                cuda_build._functions["thomas_fwd"] = lib
                tk._EXCHANGES = {}      # every case on exchange buffers of its own
                try:
                    ms = cuda_time_ms(lambda: tk.forward_substitution(fac, fac.slab_ids, b4), 5)
                except ValueError:      # a forced split whose stage buffers do not fit
                    print(f"B={S:2d} m={m} r={r}  {name:28s} refused", flush=True)
                    continue
                print(f"B={S:2d} m={m} r={r}  {name:28s} {ms / m * 1e3:7.3f} us/line",
                      flush=True)
        for r in rs:
            b4 = torch.zeros((S, m, 2 * r, fac.ld), device=dev)
            b4[..., :n] = torch.randn((S, m, 2 * r, n), generator=g, device=dev)
            cuda_build._functions["thomas_fwd"] = trace_lib
            tk._EXCHANGES = {}
            trace_report(read, lambda: tk.forward_substitution(fac, fac.slab_ids, b4),
                         f"B={S} m={m} r={r}", single_tile=S == 1,
                         phase_names=WIDE_PHASES if r > 2 else PHASES)
        del fac
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
