"""2D Gaussian bump with the sparsifying preconditioner.

Counterpart of ``examples/example2d.py``, the reference script
``examples/example.jl`` (h = 0.005, k = 200, Greengard-Vico quadrature):
preconditioned against unpreconditioned GMRES residual histories.

Run: python -m fast_solver_lippmann_schwinger_tpu_torch.examples.example2d [--h 0.005] [--cpu]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=0.005)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--save-field", metavar="BASE", default="bump2d_field",
                    help="write BASE.npz/.png of the solution "
                         "(the reference script's imshow, example.jl:96-98); '' disables")
    args = ap.parse_args(argv)

    from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
    from fast_solver_lippmann_schwinger_tpu_torch.models import bump2d
    from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device("cpu" if args.cpu else None)
    dtype = torch.complex128 if args.x64 else torch.complex64
    timer = PhaseTimer(device=device)
    with timer.phase("setup"):
        problem = bump2d.build_problem(h=args.h, dtype=dtype, device=device)
    with timer.phase("solve_preconditioned"):
        u, info = bump2d.solve(problem)
    res = info.residuals.numpy()
    out = dict(iterations=int(info.n_iterations), residuals=res[res > 0].tolist())
    print(f"preconditioned: {out['iterations']} iterations")
    print("residuals:", res[res > 0])

    with timer.phase("solve_unpreconditioned"):
        _, info2 = bump2d.solve(problem, preconditioned=False, maxiter=400)
    res2 = info2.residuals.numpy()
    out.update(iterations_unpreconditioned=int(info2.n_iterations),
               residuals_unpreconditioned=res2[res2 > 0][:20].tolist())
    print(f"unpreconditioned: {out['iterations_unpreconditioned']} iterations")
    print("residuals (first 20):", res2[res2 > 0][:20])
    if args.save_field:
        from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field

        out["files"] = save_field(args.save_field, u, problem.grid.shape, residuals=res,
                                  title=f"bump2d {problem.grid.shape} k={problem.k:g}")
        print("field artifacts:", " ".join(out["files"]))
    timer.log(grid=problem.grid.shape, k=problem.k)
    return out


if __name__ == "__main__":
    main()
