"""Time the plane kernels of the 3D solves alone, on random planes.

    python3 benchmarks_torch/plane_probe.py                   # bf16 planes
    python3 benchmarks_torch/plane_probe.py --storage int8    # int8 planes + scales

Needs one CUDA card and nvcc.  Prints one JSON line per measurement:

* the forward and backward passes and the plane apply at l = 48 planes, r = 1
  and 2, microseconds per plane and the plane bytes' rate.  bf16: plane
  widths mn = 2112, 2304 (the 48^3 solve) and 2640: at 2112 the 264 tiles of
  8 output lanes fill the 132 SMs twice over, at 2304 the 288 tiles leave the
  last round part-empty, at 2640 the 330 tiles fill 2.5 rounds.  int8:
  mn = 2816, 3072 (the y-planes of the 96^3 sweep) and 3328, 352, 384 and 416
  tiles, each step half the bytes of a bf16 step of the same width;
* where a plane step of the forward pass spends its time, by ablation (at
  2304 in bf16, 3072 in int8): the kernel is built once per case with
  ``-DPLANE_ABLATE=<mask>`` (see ``csrc/plane_pass.cuh``), which leaves single
  phases out (the results are then wrong; only the time is read).  The
  libraries go to ``build/plane_ablation/``.
"""

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
    cuda_time_ms as time_ms,
)

L = 48
NO_BARRIER, NO_STENCIL, NO_STREAM = 1, 2, 4
CASES = [
    ("all phases", 0),
    ("no barriers", NO_BARRIER),
    ("no stencil phase", NO_STENCIL),
    ("no pivot columns", NO_STREAM),
    ("no stencil phase, no barriers", NO_STENCIL | NO_BARRIER),
    ("no pivot columns, no barriers", NO_STREAM | NO_BARRIER),
    ("none of them", NO_STREAM | NO_STENCIL | NO_BARRIER),
]


def random_view(g, mn: int, dev, storage: str = "bf16") -> pk.PlaneSlabView:
    """l = 48 random planes of width mn (one plane row: a = 1, b = mn, so
    the stencil's flat shifts are +-1 and +-(mn + 1); the kernel reads the
    same weights whatever the shape).  int8: random entries and scales, zero
    padding with scale 1."""
    sten = 0.05 * torch.randn((L, 1, mn, 3, 3), generator=g, device=dev, dtype=torch.complex64)
    if storage == "int8":
        st = pk.empty_plane_stack(L, mn, L, "int8", dev)
        for p in (st.p_re, st.p_im):
            p.copy_(torch.randint(-127, 128, p.shape, generator=g, device=dev, dtype=torch.int16))
            p[:, :, mn:] = 0
            p[:, mn // tk.LEAD_MULTIPLE:] = 0
        st.scale.copy_(0.1 / (127 * mn ** 0.5) * torch.rand(st.scale.shape, generator=g,
                                                             device=dev))
        return pk.PlaneSlabView(stack=st, lsten=sten, usten=sten)
    ld = tk._round_up(mn, tk.LEAD_MULTIPLE)

    def planes():
        p = torch.zeros((L, ld, ld), dtype=torch.bfloat16, device=dev)
        p[:, :mn, :mn] = (0.1 / mn ** 0.5) * torch.randn((L, mn, mn), generator=g, device=dev)
        return tk.tile_planes(p)

    return pk.PlaneSlabView(stack=pk.PlaneStack(planes(), planes(), mn, L), lsten=sten,
                            usten=sten)


def passes(view, g, dev):
    st, ld, n = view.stack, view.stack.ld, view.lsten.shape[2]
    for r in (1, 2):
        b4 = torch.randn((L, 2 * r, ld), generator=g, device=dev)
        b4[..., st.mn:] = 0
        y4 = pk.plane_forward(st, b4, view.lrows, n)[0]
        plane_bytes = st.nbytes // st.n_planes
        ms = dict(
            forward=time_ms(lambda: pk.plane_forward(st, b4, view.lrows, n), 10),
            backward=time_ms(lambda: pk.plane_backward(st, y4, view.urows, n), 10),
            apply=time_ms(lambda: pk.plane_apply_rows(st, 0, b4[0]), 50),
        )
        print(json.dumps(dict(
            storage=st.storage, mn=st.mn, tiles=ld // 8, r=r, ms=ms,
            us_per_plane={k: 1e3 * v / (1 if k == "apply" else L) for k, v in ms.items()},
            plane_gb_per_s={k: plane_bytes * (1 if k == "apply" else L) / (1e-3 * v) / 1e9
                            for k, v in ms.items()},
        )), flush=True)


def ablation(view, g, dev):
    masks = sorted({mask for _, mask in CASES})
    dirs = {mask: ROOT / "build" / "plane_ablation" / str(mask) for mask in masks}
    with ThreadPoolExecutor(len(masks)) as pool:     # each build is one nvcc
        list(pool.map(lambda mask: cuda_build.build_kernels(
            ["plane_fwd"], defines={"PLANE_ABLATE": mask}, build_dir=dirs[mask]), masks))
    st, ld, n = view.stack, view.stack.ld, view.lsten.shape[2]
    packaged = cuda_build.load("plane_fwd")
    try:
        for r in (1, 2):
            b4 = torch.randn((L, 2 * r, ld), generator=g, device=dev)
            row = {}
            for name, mask in CASES:
                # the wrapper launches whatever the loader returns for plane_fwd
                cuda_build._functions["plane_fwd"] = cuda_build.load("plane_fwd", dirs[mask])
                row[name] = 1e3 * time_ms(lambda: pk.plane_forward(st, b4, view.lrows, n), 10) / L
            print(json.dumps(dict(ablation_us_per_plane=row, storage=st.storage, r=r, mn=st.mn)),
                  flush=True)
    finally:
        cuda_build._functions["plane_fwd"] = packaged


# plane widths per storage, and the one whose step is split by ablation
WIDTHS = {"bf16": ((2112, 2304, 2640), 2304), "int8": ((2816, 3072, 3328), 3072)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--storage", choices=sorted(WIDTHS), default="bf16")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(card_name_and_power_limit())
    cuda_build.build_kernels()
    g = torch.Generator(device=dev).manual_seed(0)
    widths, split = WIDTHS[args.storage]
    for mn in widths:
        view = random_view(g, mn, dev, args.storage)
        passes(view, g, dev)
        if mn == split:
            ablation(view, g, dev)
        del view
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
