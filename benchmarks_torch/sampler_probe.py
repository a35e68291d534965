"""The 2D stencil setup stage with the native Hankel sampler against the same
stage on its SciPy plain version, in turns, in one process.

    python3 benchmarks_torch/sampler_probe.py            # on the CUDA card
    python3 benchmarks_torch/sampler_probe.py --cpu      # stencils on the host

Times ``stencils.build_sparse_a_ag_2d`` (the ``setup_seconds.stencils`` stage
of ``plasma2d.build_problem`` and ``bump2d.build_problem``: the annihilator
rows sampled from ``greens.sample_g_rows_2d``) at h = 1/800 (paths 1-2 of
``chip_smoke.py``) and h = 0.005 (path 10), with ``greens.hankel_kernel_table``
as the port has it (``native/sampler.py``) and with
``sampler.hankel_kernel_table_plain`` put in its place, in turns (plain,
native, plain, native), and the two stencil fields' largest difference
(each row's phase taken out).  The
3D stencils (path 3) sample the Green's function through the fast operator
and use no Hankel table.  One JSON line per measurement; the last line names
the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fast_solver_lippmann_schwinger_tpu_torch.config import resolve_device  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.native import sampler  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.ops import greens  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
)


def stencil_stage(h: float, device, table):
    """Seconds of ``build_sparse_a_ag_2d`` at step ``h`` with ``table`` as the
    Hankel sampler, and the host fields it built."""
    greens.hankel_kernel_table = table
    grid = Grid2D(a=1.0, h=h)
    t0 = time.perf_counter()
    _, _, a_np, ag_np = stencils.build_sparse_a_ag_2d(1.0 / h, grid.x, grid.y, h,
                                                      dtype=torch.complex64,
                                                      return_host=True, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, a_np, ag_np


def unphased(a_np, ag_np):
    """The fields with each row's phase taken out: an annihilator row is a
    singular vector, fixed up to a phase that the two samplers' last bits
    may flip; a row of AG carries the same phase as its row of A."""
    centre = a_np[..., 1, 1]
    phase = (centre / np.abs(centre))[..., None, None]
    return a_np / phase, ag_np / phase


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="build the stencils on the host")
    args = ap.parse_args()
    device = resolve_device("cpu" if args.cpu else None)
    native = greens.hankel_kernel_table
    t0 = time.perf_counter()
    sampler.load_library()
    print(json.dumps({"phase": "sampler_build", "seconds": time.perf_counter() - t0}),
          flush=True)
    for h in (1.0 / 800.0, 0.005):
        runs = {"plain": [], "native": []}
        fields = {}
        for name in ("plain", "native", "plain", "native"):
            table = sampler.hankel_kernel_table_plain if name == "plain" else native
            seconds, a_np, ag_np = stencil_stage(h, device, table)
            runs[name].append(seconds)
            fields[name] = (a_np, ag_np)
        diff = max(float(np.abs(got - want).max() / np.abs(want).max())
                   for got, want in zip(unphased(*fields["native"]), unphased(*fields["plain"])))
        print(json.dumps({"phase": "stencils", "h": h, "grid": int(round(1.0 / h)) + 1,
                          "seconds_plain": runs["plain"], "seconds_native": runs["native"],
                          "fields_max_rel_diff": diff}), flush=True)
    greens.hankel_kernel_table = native
    print(card_name_and_power_limit() if device.type == "cuda" else "host only", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
