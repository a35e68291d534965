"""2D plasma with the alternating bi-directional sweep preconditioner.

Counterpart of ``examples/example_plasma2d.py``, the reference's
``tests/plasma_example.jl`` (h = 1/800, k = 800, 16 slabs, npml = 10, two
incident directions).

Run: python -m fast_solver_lippmann_schwinger_tpu_torch.examples.example_plasma2d [--h 0.00125] [--subs 16]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=1.0 / 800.0)
    ap.add_argument("--subs", type=int, default=16)
    ap.add_argument("--npml", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--save-field", metavar="BASE", default="plasma2d_field",
                    help="write BASE_<dir>.npz/.png per incident direction "
                         "(the reference script's plots); '' disables")
    args = ap.parse_args(argv)

    from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
    from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d
    from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device("cpu" if args.cpu else None)
    dtype = torch.complex128 if args.x64 else torch.complex64
    timer = PhaseTimer(device=device)
    with timer.phase("setup+factorization"):
        problem = plasma2d.build_problem(h=args.h, n_subdomains=args.subs, npml=args.npml,
                                         dtype=dtype, device=device)
    out = {}
    for direction in [(1.0, 0.0), (0.0, 1.0)]:
        with timer.phase(f"solve_{direction}"):
            u, info = plasma2d.solve(problem, incident_direction=direction)
        res = info.residuals.numpy()
        out[direction] = dict(iterations=int(info.n_iterations), residuals=res[res > 0].tolist())
        print(f"direction {direction}: iterations to convergence = {int(info.n_iterations)}")
        print("residual history:", res[res > 0])
        if args.save_field:
            from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field

            tag = f"{direction[0]:g}_{direction[1]:g}".replace("-", "m")
            out[direction]["files"] = save_field(
                f"{args.save_field}_{tag}", u, problem.grid.shape, residuals=res,
                title=f"plasma {problem.grid.shape} k={problem.k:g} dir={direction}")
            print("field artifacts:", " ".join(out[direction]["files"]))
    timer.log(grid=problem.grid.shape, k=problem.k, n_subs=args.subs)
    return out


if __name__ == "__main__":
    main()
