"""Command line: ``python -m fast_solver_lippmann_schwinger_tpu_torch``.

Counterpart of the JAX package's ``__main__.py``, with the same flags: runs
any reference configuration from a JSON config file and/or flags, the
typed-config replacement for the reference's edit-the-script workflow.  It
runs on the CUDA card (and raises where there is none) unless ``--cpu`` is
given.

Examples:
    python -m fast_solver_lippmann_schwinger_tpu_torch --dim 2 --medium plasma \\
        --h 0.025 --precond double_sweep --subs 3 --cpu --x64
    python -m fast_solver_lippmann_schwinger_tpu_torch --config problem.json

Prints the iteration count and the residual history on stdout, and the
configuration and one JSON line of phase seconds (``setup``, ``solve``) on
stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

# a config file's "dtype" string -> the working dtype
_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fast_solver_lippmann_schwinger_tpu_torch"
    )
    ap.add_argument("--config", help="JSON file with ProblemConfig fields")
    ap.add_argument("--dim", type=int)
    ap.add_argument("--medium", choices=["gaussian_bump", "plasma"])
    ap.add_argument("--h", type=float)
    ap.add_argument("--k", type=float)
    ap.add_argument("--quad", choices=["trapezoidal", "greengard_vico"])
    ap.add_argument("--precond", choices=[
        "sparsifying", "gs", "gs_inner", "double_sweep",
        "double_sweep_inner", "polarized_traces", "none",
    ])
    ap.add_argument("--inner-maxiter", type=int,
                    help="inner-GMRES restart length for *_inner preconds "
                         "(reference maxIter, default 20)")
    ap.add_argument("--inner-tol", type=float,
                    help="inner-GMRES tolerance for *_inner preconds "
                         "(reference tol, default 1e-2)")
    ap.add_argument("--pivot-dtype", choices=[
        "full", "bf16", "banded", "banded_lr", "banded_tail",
        "pallas", "pallas_int8", "pallas_banded_tail"])
    ap.add_argument("--pivot-band", type=int,
                    help="band width for banded pivot modes (default: the "
                         "measured w(n) rule, ~n/4)")
    ap.add_argument("--pivot-rank", type=int,
                    help="low-rank correction rank for banded_lr")
    ap.add_argument("--subs", type=int, help="number of DDM slabs")
    ap.add_argument("--npml", type=int)
    ap.add_argument("--rtol", type=float)
    ap.add_argument("--maxiter", type=int)
    ap.add_argument("--direction", type=float, nargs="+",
                    help="incident direction components")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the CUDA card")
    ap.add_argument("--x64", action="store_true",
                    help="complex128 unless the config file names a dtype")
    ap.add_argument("--save-field", metavar="BASE",
                    help="write the solution field + residual history to "
                         "BASE.npz and BASE.png (the reference scripts' "
                         "imshow role, examples/example.jl:96-98)")
    args = ap.parse_args(argv)

    from fast_solver_lippmann_schwinger_tpu_torch import api
    from fast_solver_lippmann_schwinger_tpu_torch.config import (
        DDMConfig,
        ProblemConfig,
        QuadRule,
        SolverConfig,
        resolve_device,
    )
    from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device("cpu" if args.cpu else None)
    raw = {}
    if args.config:
        with open(args.config) as fh:
            raw = json.load(fh)
    solver_kw = dict(raw.pop("solver", {}))
    ddm_kw = dict(raw.pop("ddm", {}))
    if args.rtol is not None:
        solver_kw["rtol"] = args.rtol
    if args.maxiter is not None:
        solver_kw["maxiter"] = args.maxiter
    if "dtype" in solver_kw:
        # a config-file dtype arrives as a string ("complex64"/"complex128");
        # --x64 only fills the default, it never clobbers an explicit choice
        solver_kw["dtype"] = _DTYPES[solver_kw["dtype"]]
    else:
        solver_kw["dtype"] = torch.complex128 if args.x64 else torch.complex64
    if args.subs is not None:
        ddm_kw["n_subdomains"] = args.subs
    if args.npml is not None:
        ddm_kw["npml"] = args.npml
    if args.inner_maxiter is not None:
        ddm_kw["inner_gmres_maxiter"] = args.inner_maxiter
    if args.inner_tol is not None:
        ddm_kw["inner_gmres_tol"] = args.inner_tol
    for flag, key in [
        ("dim", "dim"), ("medium", "medium"), ("h", "h"), ("k", "k"),
        ("quad", "quad_rule"), ("precond", "precond"),
        ("pivot_dtype", "pivot_dtype"), ("pivot_band", "pivot_band"),
        ("pivot_rank", "pivot_rank"),
    ]:
        v = getattr(args, flag)
        if v is not None:
            raw[key] = v
    if args.direction is not None:
        raw["incident_direction"] = tuple(args.direction)
    if "quad_rule" in raw:
        raw["quad_rule"] = QuadRule(raw["quad_rule"])
    if "incident_direction" in raw:
        raw["incident_direction"] = tuple(raw["incident_direction"])

    cfg = ProblemConfig(
        solver=SolverConfig(**solver_kw), ddm=DDMConfig(**ddm_kw), **raw
    )
    print(f"config: {dataclasses.asdict(cfg)}", file=sys.stderr)

    timer = PhaseTimer(device=device)
    with timer.phase("setup"):
        problem = api.build_problem(cfg, device=device)
    with timer.phase("solve"):
        u, info = api.solve_problem(problem)
    res = info.residuals.numpy()
    print(f"iterations to convergence: {int(info.n_iterations)}")
    print("residual history:", res[res > 0])
    if args.save_field:
        from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field

        files = save_field(
            args.save_field, u, problem.grid.shape, residuals=res,
            title=f"{cfg.medium} {problem.grid.shape} k={problem.k:g} "
                  f"precond={cfg.precond}",
        )
        print("field artifacts:", " ".join(files))
    # on the card, the peak of the device memory PyTorch allocated
    peak = ({"peak_memory_bytes": torch.cuda.max_memory_allocated(device)}
            if device.type == "cuda" else {})
    timer.log(grid=list(problem.grid.shape), k=problem.k,
              precond=cfg.precond, **peak)


if __name__ == "__main__":
    main()
