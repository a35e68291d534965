"""Where one line of the substitution kernel spends its time.

    python3 benchmarks_torch/thomas_ablation.py

Needs one CUDA card and nvcc.  ``ncu`` and ``nsys`` are not always at hand,
so this script measures by ablation: it builds ``csrc/thomas_fwd.cu`` once per
case with ``-DTHOMAS_ABLATE=<mask>`` (see ``csrc/thomas_line.cuh``), which
leaves single phases of a line out (the results are then wrong; only the time
is read), and times the forward pass at m = n = 801 for r = 1 and 2.  The
libraries go to ``build/ablation/``.  Prints microseconds per line for every
case.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
    cuda_time_ms,
)

# bits of THOMAS_ABLATE, as in csrc/thomas_line.cuh
NO_BAND_STEP, NO_PRODUCTS, NO_BARRIER, NO_PLANE_COPIES, NO_ROW_COPIES, NO_CARRY_LOAD = (
    1, 2, 4, 8, 16, 32)
NO_COPIES = NO_PLANE_COPIES | NO_ROW_COPIES
CASES = [
    ("full", 0),
    ("no carry load + band step", NO_BAND_STEP),
    ("no carry load", NO_CARRY_LOAD),
    ("no products", NO_PRODUCTS),
    ("no grid barrier", NO_BARRIER),
    ("no plane copies", NO_PLANE_COPIES),
    ("no band/rhs copies", NO_ROW_COPIES),
    ("no copies", NO_COPIES),
    ("no carry, no copies", NO_BAND_STEP | NO_COPIES),
    ("no carry, copies, products", NO_BAND_STEP | NO_COPIES | NO_PRODUCTS),
    ("none of them", NO_BAND_STEP | NO_COPIES | NO_PRODUCTS | NO_BARRIER),
]


def ablated_libraries() -> dict:
    """One build of the forward kernel per mask, all started together;
    returns mask -> launcher."""
    masks = sorted({mask for _, mask in CASES})
    dirs = {mask: ROOT / "build" / "ablation" / str(mask) for mask in masks}
    with ThreadPoolExecutor(len(masks)) as pool:     # each build is one nvcc
        list(pool.map(lambda mask: cuda_build.build_kernels(
            ["thomas_fwd"], defines={"THOMAS_ABLATE": mask}, build_dir=dirs[mask]), masks))
    return {mask: cuda_build.load("thomas_fwd", build_dir=dirs[mask]) for mask in masks}


def main():
    print(card_name_and_power_limit())
    libs = ablated_libraries()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    m = n = 801
    ld = tk._round_up(n, tk.LEAD_MULTIPLE)
    planes = []
    for _ in range(2):
        p = torch.zeros((1, m, ld, ld), dtype=torch.bfloat16, device=dev)
        p[:, :, :n, :n] = (0.1 / n ** 0.5) * torch.randn((1, m, n, n), generator=g, device=dev)
        planes.append(tk.tile_planes(p))
    bands = torch.zeros((1, m, 2, 3, ld), device=dev)
    bands[..., :n] = 0.4 * torch.rand((1, m, 2, 3, n), generator=g, device=dev) - 0.2
    s_idx = torch.zeros(1, dtype=torch.int32, device=dev)
    for r in (1, 2):
        b4 = torch.zeros((1, m, 2 * r, ld), device=dev)
        b4[..., :n] = torch.randn((1, m, 2 * r, n), generator=g, device=dev)
        y4 = torch.empty_like(b4)
        carry = torch.zeros((2, 1, 2 * r, ld), device=dev)
        for name, mask in CASES:
            def run():
                err = libs[mask](
                    b4.data_ptr(), bands.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(),
                    s_idx.data_ptr(), y4.data_ptr(), carry.data_ptr(), 1, m, n, ld, r, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"thomas_forward: CUDA error {err}")
            print(f"r={r}  {name:32s} {cuda_time_ms(run, 5) / m * 1e3:6.3f} us/line", flush=True)


if __name__ == "__main__":
    main()
