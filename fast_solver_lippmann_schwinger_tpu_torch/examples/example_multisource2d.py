"""Multi-source 2D plasma solve: many incident directions in ONE batched
GMRES.

Counterpart of ``examples/example_multisource2d.py``.  The reference's
headline script loops its two plane-wave directions serially
(``tests/plasma_example.jl:160,172``); a joint batch of directions rides
each sweep, whose local solves stream their pivots once for the batch.

One device:     python -m fast_solver_lippmann_schwinger_tpu_torch.examples.example_multisource2d --h 0.02
Several devices: torchrun --nproc-per-node D -m
                fast_solver_lippmann_schwinger_tpu_torch.examples.example_multisource2d
                --mesh D --rhs-block 2
                runs the wavefront-pipelined sharded double sweep
                (``parallel/sharded.py``) with 2-wide right-hand-side blocks
                a pipeline round, one process per device; ``--mesh`` must
                equal the world size (``--mesh 1`` on one card runs the same
                code on one rank).  With ``--cpu`` the ranks talk over gloo.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def _mesh(n: int, cpu: bool):
    """The 1-D ``("slab",)`` device mesh of ``n`` ranks, from the process
    group ``torchrun`` describes in the environment (or one that is already
    initialized); on the card each rank takes the card of its local rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")
    if dist.get_world_size() != n:
        raise ValueError(f"--mesh {n} needs a world of {n} processes, this one has "
                         f"{dist.get_world_size()} (torchrun --nproc-per-node {n})")
    return init_device_mesh("cpu" if cpu else "cuda", (n,), mesh_dim_names=("slab",))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=1.0 / 100.0)
    ap.add_argument("--subs", type=int, default=4)
    ap.add_argument("--npml", type=int, default=8)
    ap.add_argument("--n-dirs", type=int, default=6)
    ap.add_argument("--rtol", type=float, default=1e-6)
    ap.add_argument("--mesh", type=int, default=0,
                    help="devices for the sharded pipelined sweep (0 = one device)")
    ap.add_argument("--rhs-block", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--save-field", metavar="BASE", default="multisource2d_field",
                    help="write BASE.npz/.png of the first direction's field; '' disables")
    args = ap.parse_args(argv)

    from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
    from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d

    dtype = torch.complex128 if args.x64 else torch.complex64
    dirs = np.stack([np.cos(2 * np.pi * np.arange(args.n_dirs) / args.n_dirs),
                     np.sin(2 * np.pi * np.arange(args.n_dirs) / args.n_dirs)], axis=1)
    mesh = _mesh(args.mesh, args.cpu) if args.mesh else None
    if mesh is None:
        device = resolve_device("cpu" if args.cpu else None)
    else:
        from fast_solver_lippmann_schwinger_tpu_torch.parallel.sharded import shard_device

        device = shard_device(mesh)
    # every rank of a mesh computes the same; rank 0 speaks
    speak = mesh is None or mesh.get_local_rank("slab") == 0

    def say(*a):
        if speak:
            print(*a, flush=True)

    t0 = time.time()
    problem = plasma2d.build_problem(h=args.h, n_subdomains=args.subs, npml=args.npml,
                                     dtype=dtype, double_sweep=True, device=device)
    say(f"setup: {time.time() - t0:.1f}s  grid {problem.grid.shape}  k={problem.k:.0f}  "
        f"{args.n_dirs} directions")

    t0 = time.time()
    if mesh is not None:
        from fast_solver_lippmann_schwinger_tpu_torch.parallel.sharded import (
            make_sharded_double_sweep_pipelined,
            shard_slab_system,
        )
        from fast_solver_lippmann_schwinger_tpu_torch.solver.gmres import gmres_batched

        pc = problem.precond
        precond = make_sharded_double_sweep_pipelined(
            shard_slab_system(pc.slabs, mesh), shard_slab_system(pc.slabs_t, mesh), pc.msp,
            pc.a_s, mesh, rhs_block=args.rhs_block)
        rhs = plasma2d.incident_rhs(problem, dirs)
        x, info = gmres_batched(problem.op.apply, rhs, preconditioner=precond,
                                rtol=args.rtol, restart=20, maxiter=60)
        mode = f"{args.mesh}-device pipelined sweep, rhs_block={args.rhs_block}"
    else:
        x, info = plasma2d.solve_batched(problem, incident_directions=dirs, rtol=args.rtol,
                                         maxiter=60)
        mode = "one-device joint batch"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    iters = info.n_iterations.tolist()
    say(f"{mode}: solve {time.time() - t0:.1f}s; iterations per direction: {iters}")
    res = info.residuals.numpy()
    out = dict(mode=mode, iterations=iters,
               residuals=[res[r][res[r] > 0].tolist() for r in range(args.n_dirs)])
    for r in range(args.n_dirs):
        say(f"  dir ({dirs[r, 0]:+.2f},{dirs[r, 1]:+.2f}): {out['residuals'][r][-1]:.2e} "
            f"preconditioned residual after {iters[r]} iters")
    if args.save_field and speak:
        from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field

        out["files"] = save_field(args.save_field, x[0], problem.grid.shape, residuals=res[0],
                                  title=f"multisource plasma {problem.grid.shape} "
                                        f"k={problem.k:g} dir 0")
        say("field artifacts:", " ".join(out["files"]))
    return out


if __name__ == "__main__":
    main()
