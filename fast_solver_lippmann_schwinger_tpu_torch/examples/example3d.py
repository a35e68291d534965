"""3D Gaussian bump with the sparsifying preconditioner.

Counterpart of ``examples/example3d.py``, the reference's
``examples/example3D.jl`` (h = 1/48, k = 48); ``--precond gs`` is the 3D
z-slab sweep and ``polarized_traces`` the plane-trace integral system (both
beyond the reference).

Run: python -m fast_solver_lippmann_schwinger_tpu_torch.examples.example3d [--n 48]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--precond", default="sparsifying",
                    choices=["sparsifying", "gs", "polarized_traces"],
                    help="'gs' = 3D z-slab sweep; 'polarized_traces' = plane-trace integral "
                         "system (both beyond the reference)")
    ap.add_argument("--subs", type=int, default=4)
    ap.add_argument("--npml", type=int, default=5)
    ap.add_argument("--pivot-dtype", default="full",
                    choices=["full", "bf16", "yblock", "yblock_bf16", "yblock_int8"],
                    help="3D plane-pivot storage (yblock_bf16 = the 96^3-on-one-device "
                         "memory layout)")
    ap.add_argument("--cache-dir", default=None,
                    help="persist/reuse the setup's artifacts (symbol, stencils, slabs)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--save-field", metavar="BASE", default="bump3d_field",
                    help="write BASE.npz/.png (middle z-slice); '' disables")
    args = ap.parse_args(argv)

    from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
    from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d
    from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device("cpu" if args.cpu else None)
    dtype = torch.complex128 if args.x64 else torch.complex64
    timer = PhaseTimer(device=device)
    with timer.phase("setup"):
        problem = bump3d.build_problem(
            h=1.0 / args.n, dtype=dtype, precond=args.precond, n_subdomains=args.subs,
            npml=args.npml, pivot_dtype=args.pivot_dtype, cache_dir=args.cache_dir,
            device=device)
    with timer.phase("solve"):
        u, info = bump3d.solve(problem, rtol=args.rtol, maxiter=args.maxiter)
    res = info.residuals.numpy()
    out = dict(iterations=int(info.n_iterations), residuals=res[res > 0].tolist())
    print(f"iterations: {out['iterations']}")
    print("residuals:", res[res > 0])
    if args.save_field:
        from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field

        out["files"] = save_field(args.save_field, u, problem.grid.shape, residuals=res,
                                  title=f"bump3d {problem.grid.shape} k={problem.k:g}")
        print("field artifacts:", " ".join(out["files"]))
    timer.log(grid=problem.grid.shape, k=problem.k)
    return out


if __name__ == "__main__":
    main()
