"""Time the joint multi-direction solves of the port at R = 1, 2, 8 and 16
right-hand sides, and the dense line and plane passes of their paths at
r = 1, 2, 8 and 16 on the solves' own planes, for one checkout of the package.

    python3 benchmarks_torch/wide_rhs_probe.py [--tree DIR] [--paths a,b,b8,c,d,e]
                                               [--widths 1,2,8,16] [--repeats 3]
                                               [--tag NAME] [--device-time]

``--tree`` is the root of the checkout whose package is timed (default: the
one that holds this script).  To compare a change with its parent on one
card, unpack the parent into a git-ignored directory and run this script
once per tree, in turns (parent, change, change, parent), in one call.

The paths are the joint solves of ``chip_smoke.py``: ``a`` the 801^2 one-slab
solve (``plasma2d.build_problem(h=1/800, n_subdomains=1, npml=10,
pivot_dtype="pallas")``), ``b`` the 16-slab double sweep on bf16 line pivots
(``tests/plasma_example.jl``), ``b8`` the same on int8 line pivots, ``e`` the
same on banded+tail pivots (``pivot_dtype="pallas_banded_tail"``, w = 201 by
the rule: each sweep direction one launch of a fused sweep kernel), ``c`` the
48^3 z-slab Gauss-Seidel sweep (``bump3d.build_problem(h=1/48, precond="gs",
n_subdomains=4, npml=5, pivot_dtype="bf16_pallas")``) and ``d`` the 96^3 one
on int8 y-planes (6 slabs, npml 8, ``"yblock_int8_pallas"``).  For each: the
setup, then the solve of one plane wave and the joint solves of two, eight
and sixteen (``--widths``; plane waves at angles 2 pi k / 16, those at 2 pi k
/ 8 first; ``plasma2d.solve_batched``; in 3D ``gmres_batched`` over the
preconditioner's ``apply_batch``), each after a warm-up, the median of
``--repeats`` by CUDA events, with ms per direction, iterations and the
launches of each substitution wrapper in the solves of more than two
(``--device-time``:
also the device time of one more solve at each R, the sum of its kernels'
times under torch.profiler, so that a solve whose wall time moves between
runs can be told host from device); then the path's
passes (one slab's lines or planes) at the same widths on the solve's own
planes and right-hand sides (As b of the plane waves), the mean of 20
back-to-back launches (path ``e``: the cached forward and backward passes on
the hybrid layout, and the two fused sweep kernels over the 16 slabs).  On a
tree whose launches take fewer right-hand sides (``max_rhs`` in the output)
the wider figures are its groups; the 3D plane passes take at most eight.
Prints one JSON line per path, with the card's name and power limit.  Needs
one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ARGS = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ARGS.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
ARGS.add_argument("--paths", default="a,b,b8,c,d,e")
ARGS.add_argument("--widths", default="1,2,8,16")
ARGS.add_argument("--repeats", type=int, default=3)
ARGS.add_argument("--tag", default="")
ARGS.add_argument("--device-time", action="store_true")
OPTS = ARGS.parse_args()
sys.path.insert(0, str(Path(OPTS.tree).resolve()))

from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain, subdomain3d  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d, plasma2d  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres_batched  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import sweep_kernels as sk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402

WIDTHS = tuple(int(w) for w in OPTS.widths.split(","))
DIRECTIONS = tuple((float(np.cos(2 * np.pi * k / 16)), float(np.sin(2 * np.pi * k / 16)))
                   for k in tuple(range(0, 16, 2)) + tuple(range(1, 16, 2)))
SOLVE_2D = dict(rtol=1e-6, restart=20, maxiter=12)
SOLVE_48 = dict(rtol=1e-6, restart=20, maxiter=16)
SOLVE_96 = dict(rtol=1e-6, restart=20, maxiter=12)
WRAPPERS = {"forward": tk.forward_substitution, "forward_cached": tk.forward_substitution_cached,
            "backward": tk.backward_substitution, "plane_forward": pk.plane_forward,
            "plane_backward": pk.plane_backward, "sweep_down": sk.sweep_down,
            "sweep_up": sk.sweep_up}


def launches() -> dict:
    """Each wrapper's launch counts, by layout ({"all": n} for the fused
    sweeps' single count)."""
    return {name: dict(fn.launches) if isinstance(fn.launches, dict) else {"all": fn.launches}
            for name, fn in WRAPPERS.items()}


def median_ms(fn, repeats: int):
    """Warm-up, then the median of ``repeats`` runs timed by CUDA events;
    returns (ms, runs, last result)."""
    fn()
    torch.cuda.synchronize()
    runs, out = [], None
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return sorted(runs)[len(runs) // 2], runs, out


def mean_ms(fn, launches: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def device_ms(fn) -> float:
    """Device milliseconds of one ``fn()``: the sum of its kernels' times
    under torch.profiler (after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3


def joint_solves(solve, repeats: int, widths=WIDTHS) -> dict:
    """ms, ms per direction and iterations of the joint solves of ``widths``
    directions, and the launches of those of more than two."""
    out = {}
    for width in widths:
        before = launches()
        ms, runs, (_, info) = median_ms(lambda: solve(width), repeats)
        after = launches()
        its = info.n_iterations
        out[width] = dict(ms=ms, ms_runs=runs, ms_per_direction=ms / width,
                          iterations=[int(v) for v in its.reshape(-1)])
        if width > 2:
            # the counters moved over warm-up and repeats: one solve's share
            out[width]["launches_per_solve"] = {
                name: {k: (after[name][k] - before[name][k]) / (repeats + 1) for k in after[name]}
                for name in after}
        if OPTS.device_time:
            out[width]["device_ms"] = device_ms(lambda: solve(width))
    return out


def line_passes(fac, b_of, cached: bool) -> dict:
    """The dense passes of one slab (``b_of(r)``: its (1, m, 2r, ld) rows) at
    each width: ms a call."""
    slab = fac.n_slabs // 2
    s_idx = fac.slab_ids[slab : slab + 1]
    out = {}
    for r in WIDTHS:
        b4 = b_of(r)
        if cached:
            y4, _ = tk.forward_substitution_cached(fac, s_idx, b4)
            fwd = mean_ms(lambda: tk.forward_substitution_cached(fac, s_idx, b4))
        else:
            y4 = tk.forward_substitution(fac, s_idx, b4)
            fwd = mean_ms(lambda: tk.forward_substitution(fac, s_idx, b4))
        out[r] = dict(forward_ms=fwd, backward_ms=mean_ms(
            lambda: tk.backward_substitution(fac, s_idx, y4)))
    return out


def path_2d(name: str, n_subdomains: int, pivot_dtype: str) -> dict:
    t0 = time.perf_counter()
    problem = plasma2d.build_problem(h=1.0 / 800.0, n_subdomains=n_subdomains, npml=10,
                                     dtype=torch.complex64, double_sweep=n_subdomains > 1,
                                     pivot_dtype=pivot_dtype, device="cuda")
    setup_s = time.perf_counter() - t0
    solves = joint_solves(
        lambda w: plasma2d.solve_batched(problem, DIRECTIONS[:w], **SOLVE_2D), OPTS.repeats)
    pc = problem.precond
    slabs = pc.slabs
    fac = slabs.pfac
    m, n = fac.m, fac.n
    slab = fac.n_slabs // 2

    def rows(r):
        b = pc.a_s.matvec(plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:r])).T.contiguous())
        part = b.reshape(1, m, n, r) if fac.n_slabs == 1 else subdomain.partition_source(slabs, b)
        return tk._to_rows_b(fac, part[slab : slab + 1].contiguous())

    passes = line_passes(fac, rows, cached=fac.n_slabs > 1)
    extra = {}
    if isinstance(fac, tk.BandedTailFactorization):
        extra = dict(sweeps=fused_sweeps(problem), shape_ht=dict(
            width=fac.width, tail_start=fac.tail_start, trace_tail=slabs.trace_tail))
    del problem
    torch.cuda.empty_cache()
    return dict(path=name, pivot_dtype=pivot_dtype, n_subdomains=n_subdomains,
                setup_seconds=setup_s, solves=solves, passes=passes,
                shape=dict(m=m, n=n, ld=fac.ld), **extra)


def fused_sweeps(problem) -> dict:
    """The two fused sweep kernels over all slabs (one launch each up to
    this tree's widest width) on the solve's own rows: ms a call."""
    pc = problem.precond
    slabs = pc.slabs
    fac, tt, tables = slabs.pfac, slabs.trace_tail, slabs.sweep_tables
    out = {}
    for r in WIDTHS:
        b = pc.a_s.matvec(plasma2d.incident_rhs(problem, np.asarray(DIRECTIONS[:r])).T.contiguous())
        b4 = tk._to_rows_b(fac, subdomain.partition_source(slabs, b))
        down = sk.sweep_down(fac, tables.meta, b4, tables.c01, tables.c10, tt)
        out[r] = dict(
            down_ms=mean_ms(lambda: sk.sweep_down(fac, tables.meta, b4, tables.c01,
                                                  tables.c10, tt), 10),
            up_ms=mean_ms(lambda: sk.sweep_up(fac, tables.meta, b4, tables.cnpn, tables.cnnp,
                                              *down, tt), 10),
            steps=fac.n_slabs * (fac.m + tt))
    return out


def plane_waves(problem, r: int) -> torch.Tensor:
    X, Y, _ = problem.grid.mesh()
    out = []
    for dx, dy in DIRECTIONS[:r]:
        phase = torch.as_tensor((dx * X + dy * Y).ravel(), device=problem.rhs.device)
        u = torch.exp(1j * problem.k * phase).to(problem.rhs.dtype)
        out.append(-(problem.op.apply(u) - u))
    return torch.stack(out)


def path_3d(name: str, kw: dict, pivot_dtype: str, solve_kw: dict) -> dict:
    t0 = time.perf_counter()
    problem = bump3d.build_problem(dtype=torch.complex64, precond="gs", pivot_dtype=pivot_dtype,
                                   device="cuda", **kw)
    setup_s = time.perf_counter() - t0
    pc = problem.precond
    widths = tuple(w for w in WIDTHS if w <= pk.MAX_RHS)
    rhs = plane_waves(problem, max(widths))
    solves = joint_solves(
        lambda w: gmres_batched(problem.op.apply, rhs[:w], preconditioner=pc.apply_batch,
                                **solve_kw), OPTS.repeats, widths)
    slabs = pc.slabs
    s = slabs.n_subs // 2
    view = slabs.slab_facs[s]
    st, n, base = view.stack, view.lsten.shape[2], view.base
    passes = {}
    for r in widths:
        b = pc.a_s.matvec(rhs[:r].T.contiguous())
        rhs_s = subdomain3d.partition_source_3d(slabs, b)[s]
        bl = rhs_s.reshape((slabs.l1_max, slabs.m, slabs.n, -1))
        if slabs.pivot_layout == "y":
            bl = bl.movedim(1, 0)
        b4 = pk._rows_of(bl.reshape(view.lsten.shape[0], st.mn, -1), st.ld)
        y4 = pk.plane_forward(st, b4, view.lrows, n, base)[0]
        passes[r] = dict(
            forward_ms=mean_ms(lambda: pk.plane_forward(st, b4, view.lrows, n, base)),
            backward_ms=mean_ms(lambda: pk.plane_backward(st, y4, view.urows, n, base)))
    out = dict(path=name, pivot_dtype=pivot_dtype, setup_seconds=setup_s, solves=solves,
               passes=passes, shape=dict(planes=view.lsten.shape[0], mn=st.mn, ld=st.ld,
                                         storage=st.storage))
    del problem, rhs
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wide_rhs_probe: needs one CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    runs = {
        "a": lambda: path_2d("a", 1, "pallas"),
        "b": lambda: path_2d("b", 16, "pallas"),
        "b8": lambda: path_2d("b8", 16, "pallas_int8"),
        "e": lambda: path_2d("e", 16, "pallas_banded_tail"),
        "c": lambda: path_3d("c", dict(h=1.0 / 48.0, n_subdomains=4, npml=5), "bf16_pallas",
                             SOLVE_48),
        "d": lambda: path_3d("d", dict(h=1.0 / 96.0, n_subdomains=6, npml=8),
                             "yblock_int8_pallas", SOLVE_96),
    }
    for key in OPTS.paths.split(","):
        record = runs[key]()
        print(json.dumps(dict(record, tag=OPTS.tag, tree=OPTS.tree, card=smi,
                              max_rhs=tk.MAX_RHS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
