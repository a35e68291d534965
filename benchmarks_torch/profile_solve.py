"""Where the time of the 801 x 801 plasma solve, of the 48^3 bump solve, or
of the 96^3 bump solve with the z-slab sweep goes on the card.

    python3 benchmarks_torch/profile_solve.py                      # one slab
    python3 benchmarks_torch/profile_solve.py --n-subdomains 16 --double-sweep
    python3 benchmarks_torch/profile_solve.py --n-subdomains 16 --double-sweep \
        --pivot-dtype pallas_banded_tail                           # fused sweep kernels
    python3 benchmarks_torch/profile_solve.py --bump3d             # 48^3, bf16 planes
    python3 benchmarks_torch/profile_solve.py --gs3d               # 96^3, int8 y-planes
    python3 benchmarks_torch/profile_solve.py --gs3d --pivot-dtype yblock_bf16_pallas

Needs one CUDA card and nvcc.  Times the solve and its parts with CUDA
events, then traces one solve with torch.profiler and prints the device time
by kernel, the device's idle share of the solve and the host's time per
preconditioner apply (in all, and by Python function under cProfile) beside
the device's (2D: the kernels of one apply under torch.profiler).  One JSON
line per measurement.
"""

import argparse
import cProfile
import json
import pstats
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain, subdomain3d, sweeps  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d, plasma2d  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres_batched  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
    cuda_time_ms as time_ms,
)

DIRS = ((1.0, 0.0), (0.0, 1.0))
KW = dict(rtol=1e-6, restart=20, maxiter=12)


def host_ms(fn, repeats: int) -> float:
    """Host milliseconds to ENQUEUE ``fn()`` (no synchronisation inside the
    timed region; the stream is drained before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / repeats
    torch.cuda.synchronize()
    return ms


def device_ms(fn) -> float:
    """Device milliseconds of one ``fn()``: the sum of its kernels' times
    under torch.profiler (what the card runs, whoever sets the pace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3


def host_profile(fn, top: int = 14) -> list:
    """Where the host spends one enqueue of ``fn()``: the ``top`` functions
    by their own time under cProfile (which inflates every Python call, so
    read the shares, not the sum)."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats           # (file, line, name) -> (cc, nc, tt, ct, callers)
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [dict(function=f"{Path(k[0]).name}:{k[1]}:{k[2]}"[-60:], calls=v[1],
                 own_ms=1e3 * v[2], cumulative_ms=1e3 * v[3]) for k, v in rows]


def one_slab_parts(p, r, cols, rhs):
    """The parts of one preconditioner apply on the one-slab path."""
    pc = p.precond
    fac = pc.slabs.pfac
    part = subdomain.partition_source(pc.slabs, pc.a_s.matvec(cols))
    rows = tk._to_rows_b(fac, part)
    y4 = tk.forward_substitution(fac, fac.slab_ids, rows)
    x4 = tk.backward_substitution(fac, fac.slab_ids, y4)
    return dict(
        to_rows=lambda: tk._to_rows_b(fac, part),
        thomas_forward=lambda: tk.forward_substitution(fac, fac.slab_ids, rows),
        thomas_backward=lambda: tk.backward_substitution(fac, fac.slab_ids, y4),
        from_rows=lambda: tk._from_rows_b(x4, fac.n, part.dtype, fac.m),
    )


def sweep_parts(p, r, cols, rhs):
    """The parts of one double-sweep apply: the two sweeps, the residual of
    the sparsified system between them, and one local solve of each kind."""
    pc = p.precond
    slabs, fac = pc.slabs, pc.slabs.pfac
    sp = pc.a_s.matvec(cols)
    u = sweeps.gs_sweep(slabs, sp)
    err_t = pc._transpose_flat(pc.msp.matvec(u) - sp)
    s = slabs.n_subs // 2
    rhs_s = subdomain.partition_source(slabs, sp)[s]
    _, y_c, t_c = tk.solve_cached(fac, s, rhs_s, slabs.trace_tail)
    return dict(
        gs_sweep=lambda: sweeps.gs_sweep(slabs, sp),
        gs_sweep_per_slab=lambda: sweeps._gs_sweep_per_slab(slabs, sp),
        gs_sweep_transposed=lambda: sweeps.gs_sweep(pc.slabs_t, err_t),
        msp_residual_and_transposes=lambda: pc._transpose_flat(
            pc._transpose_flat(pc.msp.matvec(u) - sp).contiguous()),
        partition_source=lambda: subdomain.partition_source(slabs, sp),
        gather_interior=lambda: subdomain.gather_interior(
            slabs, subdomain.partition_source(slabs, sp)),
        local_solve_cached=lambda: tk.solve_cached(fac, s, rhs_s, slabs.trace_tail),
        local_solve_resume=lambda: tk.solve_resume(fac, s, rhs_s, y_c, t_c, slabs.trace_tail),
    )


def bump3d_parts(p, r, cols):
    """The parts of one sparsifying preconditioner apply on the 48^3 path."""
    pc = p.precond
    view = pc.factorization
    st, n = view.stack, view.lsten.shape[2]
    b = pc.a_s.matvec(cols).reshape(st.l1, st.mn, -1)
    b4 = pk._rows_of(b, st.ld)
    y4 = pk.plane_forward(st, b4, view.lrows, n)[0]
    x4 = pk.plane_backward(st, y4, view.urows, n)
    return dict(
        to_rows=lambda: pk._rows_of(b, st.ld),
        plane_forward=lambda: pk.plane_forward(st, b4, view.lrows, n),
        plane_backward=lambda: pk.plane_backward(st, y4, view.urows, n),
        from_rows=lambda: pk._unrows(x4, st.mn, b.dtype, b.shape),
    )


def gs3d_parts(p, r, cols):
    """The parts of one z-slab sweep apply at 96^3: the sweep, the source
    partition, and one local solve of an inner slab with its two fused
    passes (y layout: the right-hand side transposed to y-major rows)."""
    pc = p.precond
    slabs = pc.slabs
    sp = pc.a_s.matvec(cols)
    rhs = subdomain3d.partition_source_3d(slabs, sp)
    s = slabs.n_subs // 2
    view = slabs.slab_facs[s]
    st, n = view.stack, view.lsten.shape[2]
    planes = view.lsten.shape[0]
    b = rhs[s].reshape((slabs.l1_max, slabs.m, slabs.n, -1))
    if slabs.pivot_layout == "y":
        b = b.movedim(1, 0)
    b4 = pk._rows_of(b.reshape(planes, st.mn, -1), st.ld)
    y4 = pk.plane_forward(st, b4, view.lrows, n, view.base)[0]
    return dict(
        gs_sweep=lambda: subdomain3d.gs_sweep_3d(slabs, sp),
        partition_source=lambda: subdomain3d.partition_source_3d(slabs, sp),
        slab_solve=lambda: subdomain3d.slab_solve_3d(slabs, view, rhs[s]),
        plane_forward=lambda: pk.plane_forward(st, b4, view.lrows, n, view.base),
        plane_backward=lambda: pk.plane_backward(st, y4, view.urows, n, view.base),
    )


def profile_runs(runs: dict, solve_ms: dict):
    """Trace one solve per entry of ``runs`` (r -> callable returning (x,
    info)) with torch.profiler: device time by kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    for r, run in runs.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, info = run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total = sum(e.device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.device_time_total)[:12]
        print(json.dumps(dict(
            r=r, iterations=np.asarray(info.n_iterations).tolist(),
            solve_wall_ms_under_profiler=wall_ms, profiler_device_ms_total=total,
            device_idle_share_under_profiler=1.0 - total / wall_ms,
            solve_ms=solve_ms[r], device_idle_share=1.0 - total / solve_ms[r],
            top=[dict(name=e.key[:60], ms=e.device_time_total / 1e3, calls=e.count) for e in top],
        )), flush=True)


def main_bump3d(gs3d: bool = False, pivot_dtype: str = "yblock_int8_pallas"):
    """The 48^3 bump solve on bf16 plane pivots, or (``gs3d``) the 96^3 bump
    solve with the z-slab sweep of the JAX package's ``ls3d_96`` benchmark
    (6 slabs, npml = 8, ``pivot_dtype``): r = 1 (``solve``) and r = 2 (two
    sources, x and y plane waves, through ``apply_batch``)."""
    if gs3d:
        kw = dict(rtol=1e-6, restart=20, maxiter=12)
        p = bump3d.build_problem(h=1 / 96, dtype=torch.complex64, precond="gs",
                                 n_subdomains=6, npml=8, pivot_dtype=pivot_dtype)
        parts_of = gs3d_parts
        stack_bytes = p.precond.slabs.pfac.nbytes
    else:
        kw = dict(rtol=1e-6, restart=20, maxiter=16)
        p = bump3d.build_problem(h=1 / 48, dtype=torch.complex64, pivot_dtype="bf16_pallas")
        parts_of = bump3d_parts
        stack_bytes = p.precond.factorization.stack.nbytes
    print(json.dumps(dict(bump3d=True, grid=list(p.grid.shape),
                          precond="gs" if gs3d else "sparsifying",
                          pivot_dtype=pivot_dtype if gs3d else "bf16_pallas",
                          setup_seconds=p.setup_seconds, stack_bytes=stack_bytes,
                          peak_memory_bytes=torch.cuda.max_memory_allocated())), flush=True)
    pc, op = p.precond, p.op
    X, Y, _ = p.grid.mesh()
    u_y = torch.exp(1j * p.k * torch.as_tensor(Y.ravel(), device=p.rhs.device)).to(p.rhs.dtype)
    rhs2 = torch.stack([p.rhs, -(op.apply(u_y) - u_y)])
    runs = {1: lambda: bump3d.solve(p, **kw),
            2: lambda: gmres_batched(op.apply, rhs2, preconditioner=pc.apply_batch, **kw)}
    solve_ms = {}
    for r in (1, 2):
        rhs = rhs2[:r]
        cols = rhs.T.contiguous() if r > 1 else rhs[0]
        parts = dict(
            operator_apply=lambda: op.apply(rhs),
            stencil_matvec=lambda: pc.a_s.matvec(cols),
            **parts_of(p, r, cols),
            preconditioner_apply=lambda: pc.apply(cols),
            solve=runs[r],
        )
        ms = {k: time_ms(f, 5) for k, f in parts.items()}
        solve_ms[r] = ms["solve"]
        print(json.dumps(dict(r=r, ms=ms, host_enqueue_ms=dict(
            preconditioner_apply=host_ms(parts["preconditioner_apply"], 5),
            operator_apply=host_ms(parts["operator_apply"], 5)))), flush=True)
        print(json.dumps(dict(r=r, host_profile_of_preconditioner_apply=host_profile(
            parts["preconditioner_apply"]))), flush=True)
    profile_runs(runs, solve_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-subdomains", type=int, default=1)
    ap.add_argument("--double-sweep", action="store_true")
    ap.add_argument("--bump3d", action="store_true")
    ap.add_argument("--gs3d", action="store_true")
    ap.add_argument("--pivot-dtype", default=None,
                    help="pivot storage: 2D pallas (default) or pallas_banded_tail; "
                         "--gs3d yblock_int8_pallas (default) or another 3D mode")
    args = ap.parse_args()

    print(card_name_and_power_limit())
    if args.bump3d or args.gs3d:
        return main_bump3d(args.gs3d, args.pivot_dtype or "yblock_int8_pallas")
    pivot_dtype = args.pivot_dtype or "pallas"
    p = plasma2d.build_problem(h=1 / 800, n_subdomains=args.n_subdomains, npml=10,
                               dtype=torch.complex64, double_sweep=args.double_sweep,
                               pivot_dtype=pivot_dtype)
    print(json.dumps(dict(n_subdomains=args.n_subdomains, double_sweep=args.double_sweep,
                          pivot_dtype=pivot_dtype,
                          setup_seconds=p.setup_seconds,
                          peak_memory_bytes=torch.cuda.max_memory_allocated())))
    pc, op = p.precond, p.op
    solve_ms = {}
    for r in (1, 2):
        dirs = np.asarray(DIRS[:r])
        rhs = plasma2d.incident_rhs(p, dirs)                   # (r, N)
        cols = rhs.T.contiguous() if r > 1 else rhs[0]          # preconditioner layout
        parts = dict(
            incident_rhs=lambda: plasma2d.incident_rhs(p, dirs),
            operator_apply=lambda: op.apply(rhs),
            stencil_matvec=lambda: pc.a_s.matvec(cols),
            **(sweep_parts if args.double_sweep else one_slab_parts)(p, r, cols, rhs),
            preconditioner_apply=lambda: pc.apply(cols),
            solve=(lambda: plasma2d.solve(p, DIRS[0], **KW)) if r == 1
            else (lambda: plasma2d.solve_batched(p, DIRS, **KW)),
        )
        ms = {k: time_ms(f, 5) for k, f in parts.items()}
        solve_ms[r] = ms["solve"]
        print(json.dumps(dict(r=r, ms=ms,
                              host_enqueue_ms=dict(
                                  preconditioner_apply=host_ms(parts["preconditioner_apply"], 5),
                                  operator_apply=host_ms(parts["operator_apply"], 5)),
                              device_ms=dict(
                                  preconditioner_apply=device_ms(parts["preconditioner_apply"])))),
              flush=True)
        print(json.dumps(dict(r=r, host_profile_of_preconditioner_apply=host_profile(
            parts["preconditioner_apply"]))), flush=True)

    profile_runs({1: lambda: plasma2d.solve(p, DIRS[0], **KW),
                  2: lambda: plasma2d.solve_batched(p, DIRS, **KW)}, solve_ms)


if __name__ == "__main__":
    main()
