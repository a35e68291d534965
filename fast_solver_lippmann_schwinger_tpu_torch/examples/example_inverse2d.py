"""Inverse medium reconstruction by gradient descent through the solver.

Counterpart of ``examples/example_inverse2d.py`` (beyond the reference,
which is forward-only): the scattering solve is differentiable
(``solver/adjoint.py``), so an unknown medium is recovered from
scattered-field data by minimizing

    L(nu) = sum_s || u_s(nu) - u_s(nu_true) ||^2 / sum_s || u_s(nu_true) ||^2

over incident directions s with ``torch.optim.Adam`` (betas 0.9 / 0.999, eps
1e-8: ``optax.adam``'s defaults, which the JAX script uses); each gradient
costs one forward and one transposed GMRES solve per source.

Run: python -m fast_solver_lippmann_schwinger_tpu_torch.examples.example_inverse2d [--h 0.04] [--steps 60] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=0.04)
    ap.add_argument("--k", type=float, default=10.0)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--save-field", metavar="BASE", default="inverse2d_field",
                    help="write BASE.npz/.png of recovered vs true medium; '' disables")
    args = ap.parse_args(argv)

    from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device
    from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D
    from fast_solver_lippmann_schwinger_tpu_torch.models import media
    from fast_solver_lippmann_schwinger_tpu_torch.ops.fastconv import build_fast_convolution_2d
    from fast_solver_lippmann_schwinger_tpu_torch.solver.adjoint import differentiable_solve

    device = resolve_device("cpu" if args.cpu else None)
    dtype = torch.complex128 if args.x64 else torch.complex64
    grid = Grid2D(a=1.0, h=args.h)
    k = args.k
    X, Y = grid.mesh()
    nu_true = media.gaussian_bump_2d(X, Y)
    op = build_fast_convolution_2d(grid.x, grid.y, grid.h, k, nu_true, quad_rule="trapezoidal",
                                   dtype=dtype, device=device)

    # synthetic data: scattered fields for a few incident plane waves
    dirs = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    phases = dirs[:, 0:1] * X.ravel()[None] + dirs[:, 1:2] * Y.ravel()[None]
    u_inc = torch.as_tensor(np.exp(1j * k * phases), device=device).to(dtype)   # (S, N)

    def forward(nu):
        op2 = dataclasses.replace(op, nu=nu)
        return [differentiable_solve(op2, -(op2.apply(ui) - ui), rtol=1e-8, restart=30,
                                     maxiter=120) for ui in u_inc]

    with torch.no_grad():
        data = forward(op.nu)
    scale = sum(float(torch.sum(torch.abs(d) ** 2)) for d in data)

    def loss_fn(nu):
        return sum(torch.sum(torch.abs(u - d) ** 2) for u, d in zip(forward(nu), data)) / scale

    nu = torch.zeros_like(op.nu, requires_grad=True)          # start from free space
    opt = torch.optim.Adam([nu], lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    nu_ref = np.asarray(nu_true)
    losses, errors = [], []
    for step in range(args.steps):
        opt.zero_grad()
        loss = loss_fn(nu)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        errors.append(float(np.linalg.norm(nu.detach().cpu().numpy() - nu_ref)
                            / np.linalg.norm(nu_ref)))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.3e}  medium rel err {errors[-1]:.3f}",
                  flush=True)
    print("final relative medium error:", errors[-1] if errors else None)
    out = dict(losses=losses, errors=errors, nu=nu.detach().cpu())
    if args.save_field:
        from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field

        out["files"] = save_field(args.save_field, nu.detach(), grid.shape,
                                  title="inverse2d: recovered medium nu")
        print("field artifacts:", " ".join(out["files"]))
    return out


if __name__ == "__main__":
    main()
