"""Time the plane kernels of the 3D solves alone, on random planes, for one
checkout of the package: the fused passes on the flag-handoff plane step
and the plane apply, at r = 1, 2 (the narrow step) and 4, 8 (the wide one).

    python3 benchmarks_torch/plane_probe.py                    # bf16 and int8 planes
    python3 benchmarks_torch/plane_probe.py --storage int8     # one storage
    python3 benchmarks_torch/plane_probe.py --r 4,8 [--tree DIR] [--tag NAME]
                                                               # wide launches

``--tree`` is the root of the checkout whose package is timed (default: the
one that holds this script); its kernels are built under its own
``build/``.  To compare a change with its parent on one card, unpack the
parent into a git-ignored directory and run this script once per tree, in
turns (parent, change, change, parent), in one call: the inputs come from
one seed, so each run sees the same planes and right-hand sides.

Needs one CUDA card and nvcc.  Besides the package's build it builds
``plane_fwd.cu`` and ``plane_apply.cu`` once per ablation mask into
``build/plane_probe/ablate<mask>/`` with ``-DPLANE_ABLATE=<mask>``, all at
once.  Prints one JSON line per measurement, with ``--tree`` and ``--tag``:

* the forward and backward passes at l = 48 planes, for each r of ``--r``
  (default 1 and 2), timed twice, and the plane apply (twice more):
  microseconds a plane step and the share of the byte bound (two planes,
  and int8 scales, over 3.35 TB/s); the plane apply's device time from CUDA
  graphs of 200 calls.
  bf16: plane widths mn = 2112, 2304 (the 48^3 solve) and
  2640: 264, 288 and 330 tiles of 8 output lanes on the 132 SMs (at most
  two, three and three tiles a CTA).  int8: mn = 2816, 3072 (the y-planes of
  the 96^3 sweep) and 3328, 352, 384 and 416 tiles (at most three, three and
  four a CTA), each step half the bytes of a bf16 step of the same width;
* where a plane step of the new forward pass, and a plane apply, spend
  their time at each r, by ablation (at 2304 in bf16, 3072 in int8; the
  apply has no handoff, so only the masks without flag waits or stencil
  apply to it): each mask leaves phases out (see
  ``csrc/plane_pass.cuh``: no flag waits, no stencil, no pivot stream, no y
  staging, no products); the results are then wrong, only the time is read.
"""

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ARGS = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ARGS.add_argument("--storage", choices=("bf16", "int8"), default=None,
                  help="one plane storage (default: both)")
ARGS.add_argument("--r", default="1,2",
                  help="right-hand sides a launch, comma-separated, of 1, 2, 4 and 8")
ARGS.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                  help="root of the checkout whose package is timed")
ARGS.add_argument("--tag", default="")
OPTS = ARGS.parse_args()
ROOT = Path(OPTS.tree).resolve()
sys.path.insert(0, str(ROOT))

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
    cuda_time_ms as time_ms,
)

L = 48
PEAK_BYTES_PER_S = 3.35e12
SOURCES = ("plane_fwd", "plane_bwd", "plane_apply")
NO_WAIT, NO_STENCIL, NO_STREAM, NO_STAGE, NO_PRODUCTS = 1, 2, 4, 8, 16
CASES = [
    ("all phases", 0),
    ("no flag waits", NO_WAIT),
    ("no stencil", NO_STENCIL),
    ("no pivot stream", NO_STREAM),
    ("no y staging", NO_STAGE),
    ("no products", NO_PRODUCTS),
    ("no stream, no products", NO_STREAM | NO_PRODUCTS),
    ("only the stream", NO_WAIT | NO_STENCIL | NO_STAGE | NO_PRODUCTS),
    ("only the products", NO_WAIT | NO_STENCIL | NO_STAGE | NO_STREAM),
    ("only the handoff", NO_STREAM | NO_PRODUCTS),
    ("none of them", NO_WAIT | NO_STENCIL | NO_STREAM | NO_STAGE | NO_PRODUCTS),
]
# plane widths per storage, and the one whose step is taken apart by ablation
WIDTHS = {"bf16": ((2112, 2304, 2640), 2304), "int8": ((2816, 3072, 3328), 3072)}


def build_steps() -> dict:
    """name -> {source: launcher}: the package's build ("new") and the
    ablation masks of its forward pass and plane apply, all built at once."""
    cuda_build.build_kernels(list(SOURCES))
    variants = {f"ablate{mask}": ({"PLANE_ABLATE": mask}, ("plane_fwd", "plane_apply"))
                for _, mask in CASES if mask}
    dirs = {name: ROOT / "build" / "plane_probe" / name for name in variants}
    with ThreadPoolExecutor(len(variants)) as pool:     # each build is one nvcc
        list(pool.map(lambda name: cuda_build.build_kernels(
            list(variants[name][1]), defines=variants[name][0], build_dir=dirs[name]),
            variants))
    new = {src: cuda_build.load(src) for src in SOURCES}
    steps = {"new": new, "ablate0": new}
    for name, (_, sources) in variants.items():
        steps[name] = dict(new, **{src: cuda_build.load(src, build_dir=dirs[name])
                                   for src in sources})
    return steps


def use(steps, name):
    """Route the package's wrappers to the launchers of build ``name``."""
    cuda_build._functions.update(steps[name])


def in_turns(steps, fn, order, repeats):
    """Mean ms of ``fn`` under each build of ``order`` in turn, and each
    build's output (clones)."""
    times, outs = {}, {}
    for name in order:
        use(steps, name)
        got = fn()
        outs[name] = tuple(t.clone() for t in (got if isinstance(got, tuple) else (got,)))
        times.setdefault(name, []).append(time_ms(fn, repeats))
    torch.cuda.synchronize()
    use(steps, "new")
    return {name: sum(t) / len(t) for name, t in times.items()}, times, outs


def graph_turns(steps, fn, order, launches=200, replays=5):
    """Device milliseconds of one ``fn()`` under each build of ``order`` in
    turn: ``launches`` calls captured into a CUDA graph per turn and replayed
    (a plane apply takes less time on the card than its wrapper on the host,
    so back-to-back calls would time the host)."""
    times = {}
    for name in order:
        use(steps, name)
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(start.elapsed_time(end) / (replays * launches))
        del graph
    use(steps, "new")
    return {name: sum(t) / len(t) for name, t in times.items()}, times


def random_view(g, mn: int, dev, storage: str) -> pk.PlaneSlabView:
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


def emit(rec: dict):
    print(json.dumps(dict(rec, tree=str(ROOT), tag=OPTS.tag)), flush=True)


def passes(steps, view, g, dev, rs):
    st, ld, n = view.stack, view.stack.ld, view.lsten.shape[2]
    bound_us = 1e6 * (st.nbytes // st.n_planes) / PEAK_BYTES_PER_S    # one plane's bytes
    for r in rs:
        order = ("new", "new")
        b4 = torch.randn((L, 2 * r, ld), generator=g, device=dev)
        b4[..., st.mn:] = 0
        y4 = pk.plane_forward(st, b4, view.lrows, n)[0]
        runs = dict(
            forward=(lambda: pk.plane_forward(st, b4, view.lrows, n), L),
            backward=(lambda: pk.plane_backward(st, y4, view.urows, n), L),
            apply=(lambda: pk.plane_apply_rows(st, 0, b4[0]), 1),
        )
        for kernel, (fn, planes) in runs.items():
            ms, turns, _ = in_turns(steps, fn, order, 10)
            if planes == 1:
                # the plane apply: device time from CUDA graphs, twice more
                ms, turns = graph_turns(steps, fn, order * 2)
            us = {name: 1e3 * v / planes for name, v in ms.items()}
            rec = dict(kernel=kernel, storage=st.storage, mn=st.mn, tiles=ld // 8, r=r,
                       planes=planes, new_us_per_plane=us["new"], bound_us_per_plane=bound_us,
                       share_of_bound={name: bound_us / v for name, v in us.items()},
                       turns_ms={name: t for name, t in turns.items()})
            emit(rec)


def ablation(steps, view, g, dev, rs):
    st, ld, n = view.stack, view.stack.ld, view.lsten.shape[2]
    for r in rs:
        b4 = torch.randn((L, 2 * r, ld), generator=g, device=dev)
        row, apply_row = {}, {}
        for name, mask in CASES:
            use(steps, f"ablate{mask}")
            row[name] = 1e3 * time_ms(lambda: pk.plane_forward(st, b4, view.lrows, n), 10) / L
            if not mask & (NO_WAIT | NO_STENCIL):       # the apply has no handoff
                apply_row[name] = 1e3 * graph_turns(
                    steps, lambda: pk.plane_apply_rows(st, 0, b4[0]), (f"ablate{mask}",))[0][
                        f"ablate{mask}"]
        use(steps, "new")
        emit(dict(ablation_us_per_plane=row, kernel="forward", storage=st.storage, r=r,
                  mn=st.mn))
        emit(dict(ablation_us_per_plane=apply_row, kernel="apply", storage=st.storage, r=r,
                  mn=st.mn))


def main():
    rs = [int(v) for v in OPTS.r.split(",")]
    if any(r not in tk.LAUNCH_WIDTHS for r in rs):
        ARGS.error(f"--r takes {tk.LAUNCH_WIDTHS}")
    dev = torch.device("cuda", 0)
    print(card_name_and_power_limit(), flush=True)
    steps = build_steps()
    g = torch.Generator(device=dev).manual_seed(0)
    for storage in [OPTS.storage] if OPTS.storage else sorted(WIDTHS):
        widths, ablated = WIDTHS[storage]
        for mn in widths:
            view = random_view(g, mn, dev, storage)
            passes(steps, view, g, dev, rs)
            if mn == ablated:
                ablation(steps, view, g, dev, rs)
            del view
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
