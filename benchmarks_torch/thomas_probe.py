"""Time the dense forward and backward passes on the flag-handoff step against
the grid-barrier step they replace, in turns in one process, at every shape
of rows 1, 2, 4, 1i, 2i and 4i of PERF.md: one slab of 801 lines (the
one-slab solve, r = 1 and 2), 16 batch rows of 70 lines (``jacobi_sweep``),
one slab picked among 16 of 70 lines in full and over its last 22 lines (the
multi-slab sweeps), on random bf16 and int8 factors.  Then the cost of a
launch: a one-line backward pass through the bare launcher.

    python3 benchmarks_torch/thomas_probe.py

Needs one CUDA card and nvcc.  Besides the package's build it builds
``csrc/thomas_fwd.cu`` and ``csrc/thomas_bwd.cu`` three times more, into
``build/probe/``: with ``-DTHOMAS_OLD_STEP=1`` (the grid-barrier step, the
parent's kernels), and with ``-DTHOMAS_SPLIT=1`` and ``2`` (the flag-handoff
step with one and with two CTAs a tile, where the package's build picks one
per launch).  Each case is timed old, new, one CTA, two CTAs, two, one, new,
old, and each step's output is held against the grid-barrier step's.
Prints one JSON line per case.
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
    cuda_time_ms as time_ms,
)

N = 801
M1_MAX, TRACE_TAIL = 70, 22   # of the 16-slab system at npml = 10
SOURCES = ("thomas_fwd", "thomas_bwd")
VARIANTS = {"old": {"THOMAS_OLD_STEP": 1}, "split1": {"THOMAS_SPLIT": 1},
            "split2": {"THOMAS_SPLIT": 2}}


def build_steps() -> dict:
    """step -> {source: launcher}: the package's build ("new") and the
    variants of :data:`VARIANTS`, all built at once."""
    cuda_build.build_kernels(list(SOURCES))
    dirs = {name: ROOT / "build" / "probe" / name for name in VARIANTS}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(lambda name: cuda_build.build_kernels(
            list(SOURCES), defines=VARIANTS[name], build_dir=dirs[name]), VARIANTS))
    steps = {"new": {src: cuda_build.load(src) for src in SOURCES}}
    for name in VARIANTS:
        steps[name] = {src: cuda_build.load(src, build_dir=dirs[name]) for src in SOURCES}
    return steps


_EXCHANGES = {}


def use(steps, name):
    """Route the package's wrappers to the launchers of step ``name``, each
    step with exchange buffers of its own (the grid-barrier forward pass keeps
    its float carry where the flag-handoff step keeps its flags)."""
    cuda_build._functions.update(steps[name])
    tk._EXCHANGES = _EXCHANGES.setdefault(name, {})


def random_factors(g, S, m, storage, dev):
    ld = tk._round_up(N, tk.LEAD_MULTIPLE)

    def plane(diag):
        p = (0.1 / N ** 0.5) * torch.randn((S * m, N, N), generator=g, device=dev)
        idx = torch.arange(N, device=dev)
        p[:, idx, idx] += diag
        if storage == "int8":
            q, sc = tk.quantize_planes(p, ld)
            return q.reshape((S, m) + q.shape[1:]), sc.reshape((S, m) + sc.shape[1:])
        dense = torch.zeros((S * m, ld, ld), dtype=torch.bfloat16, device=dev)
        dense[:, :N, :N] = p.to(torch.bfloat16)
        return tk.tile_planes(dense).reshape((S, m, ld // 8, ld, 8)), None

    def bands():
        b = torch.zeros((S, m, 2, 3, ld), device=dev)
        b[..., :N] = 0.4 * torch.rand((S, m, 2, 3, N), generator=g, device=dev) - 0.2
        return b

    (cre, sre), (cim, sim) = plane(0.2), plane(0.0)
    scale = None if storage == "bf16" else tk.tile_scales(sre, sim)
    return tk.ThomasFactorization(cre, cim, bands(), bands(), N, scale=scale)


def rows(g, batch, m, r, dev):
    b4 = torch.zeros((batch, m, 2 * r, tk._round_up(N, tk.LEAD_MULTIPLE)), device=dev)
    b4[..., :N] = torch.randn((batch, m, 2 * r, N), generator=g, device=dev)
    return b4


def err(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def probe(steps, row, storage, fac, s_idx, b4, tail=0, repeats=10):
    """One shape: the forward pass (not at a tail) and the backward pass."""
    lines = fac.m if not tail else tail
    y4 = tk.forward_substitution(fac, s_idx, b4)
    runs = {"bwd": lambda: tk.backward_substitution(fac, s_idx, y4, tail=tail)}
    if not tail:
        runs = {"fwd": lambda: tk.forward_substitution(fac, s_idx, b4), **runs}
    for name, fn in runs.items():
        times, outs = {}, {}
        for step in ("old", "new", "split1", "split2", "split2", "split1", "new", "old"):
            use(steps, step)
            outs[step] = fn()
            times.setdefault(step, []).append(time_ms(fn, repeats))
        torch.cuda.synchronize()
        ms = {step: sum(t) / len(t) for step, t in times.items()}
        print(json.dumps(dict(
            row=row, pass_=name, storage=storage, B=b4.shape[0], S=fac.n_slabs, m=fac.m,
            lines=lines, n=N, r=b4.shape[2] // 2, tail=tail,
            old_ms=ms["old"], new_ms=ms["new"], split1_ms=ms["split1"], split2_ms=ms["split2"],
            ms_turns=times,
            us_per_line={step: 1e3 * v / lines for step, v in ms.items()},
            new_vs_old_err=err(outs["new"], outs["old"]),
            split_vs_old_err=max(err(outs[k], outs["old"]) for k in ("split1", "split2")),
        )), flush=True)
    use(steps, "new")


def probe_launch_cost(fac, dev):
    """The cost of one launch: a one-line backward pass through the bare
    launcher (no Python wrapper), host microseconds per enqueued launch (the
    stream is kept short by synchronising every 50 launches) and device
    microseconds per launch back to back."""
    fn = cuda_build.load("thomas_bwd")
    m, ld = fac.m, fac.ld
    y4 = torch.randn((1, m, 2, ld), device=dev)
    x4 = torch.empty((1, 1, 2, ld), device=dev)
    ex = tk.exchange_for(y4)
    xchg, _ = ex.take(1, 1, ld, 1)

    def launch():
        # dense planes: no head windows, tail_start = half = 0
        _, epoch = ex.take(1, 1, ld, 1)
        if fn(y4.data_ptr(), fac.uband.data_ptr(), 0, 0, fac.cinv_t_re.data_ptr(),
              fac.cinv_t_im.data_ptr(), 0, fac.slab_ids.data_ptr(), x4.data_ptr(), 1, m, N,
              ld, 1, 1, 0, 0, xchg.data_ptr(), epoch, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("thomas_backward failed")

    launch()
    torch.cuda.synchronize()
    host = 0.0
    for _ in range(20):
        t0 = time.perf_counter()
        for _ in range(50):
            launch()
        host += time.perf_counter() - t0
        torch.cuda.synchronize()
    print(json.dumps(dict(launch_cost_one_line_backward=dict(
        host_us_per_launch=1e6 * host / 1000,
        device_us_per_launch=1e3 * time_ms(launch, 50),
    ))), flush=True)


def main():
    dev = torch.device("cuda", 0)
    print(card_name_and_power_limit(), flush=True)
    steps = build_steps()
    g = torch.Generator(device=dev).manual_seed(0)
    for storage in ("bf16", "int8"):
        i8 = "i" if storage == "int8" else ""
        # rows 1-2 (1i-2i): one slab of 801 lines, r = 1 and 2
        fac = random_factors(g, 1, N, storage, dev)
        for r in (1, 2):
            probe(steps, f"1{i8}-2{i8}", storage, fac, fac.slab_ids, rows(g, 1, N, r, dev),
                  repeats=5)
        del fac
        torch.cuda.empty_cache()
        # 16 slabs of 70 lines: all of them at once (jacobi_sweep, rows 1-2 and
        # 1i-2i), and one inner slab in full and over its last 22 lines (rows
        # 2 and 2i at r = 2, rows 4 and 4i at r = 1)
        fac = random_factors(g, 16, M1_MAX, storage, dev)
        for r in (1, 2):
            probe(steps, f"1{i8}-2{i8}", storage, fac, fac.slab_ids, rows(g, 16, M1_MAX, r, dev))
        s = fac.slab_ids[8:9]
        for r, row in ((1, f"4{i8}"), (2, f"2{i8}")):
            b4 = rows(g, 1, M1_MAX, r, dev)
            probe(steps, row, storage, fac, s, b4)
            probe(steps, row, storage, fac, s, b4, tail=TRACE_TAIL)
        if storage == "bf16":
            probe_launch_cost(fac, dev)
        del fac
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
