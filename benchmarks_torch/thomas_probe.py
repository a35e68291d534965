"""Time the line kernels alone on random factors, the dense passes against
the variants of their step, in turns in one process:

- the dense forward and backward passes at every shape of rows 1, 2, 4, 1i,
  2i and 4i of PERF.md: one slab of 801 lines (the one-slab solve, r = 1 and
  2), 16 batch rows of 70 lines (``jacobi_sweep``), one slab picked among 16
  of 70 lines in full and over its last 22 lines (the multi-slab sweeps), on
  bf16 and int8 planes; each case new, map, one CTA, two CTAs, two, one, map,
  new;
- the cached forward pass at every shape of rows 3, 5, 3i and 5i (one slab
  among 16, 70 lines in full and resumed at line 48, r = 1 and 2) and of row
  6 (banded+tail pivots of the 801^2 solve: width 201, 44 head and 26 tail
  lines; one slab in full and resumed, and 16 batch rows), the backward pass
  on the same pivots (row 7: one slab in full and over its last 22 lines, and
  16 batch rows, r = 1 and 2), and the fused sweep kernels of rows 8-9 (16
  slabs, trace tail 22, r = 1 and 2); each case alone, against its plain
  version.

Then the cost of a launch: a one-line backward pass through the bare launcher.

    python3 benchmarks_torch/thomas_probe.py [--banded] [--r 1,2,4,8,16]
                                             [--tree DIR] [--tag NAME] [--step-only]

``--banded`` runs the banded+tail cases only (rows 6-9).  ``--r`` gives the
right-hand sides of a launch (default 1 and 2): at r = 4, 8 and 16 (the
wide step) the dense passes run at the shapes of rows 1-2 and 1i-2i, the backward
pass on an inner slab in full and over its tail and the cached forward pass
in full and resumed (rows 2, 3, 2i, 3i); the banded+tail rows 6-9 run at
every r given (on a tree whose banded+tail launches take at most two
right-hand sides, as its groups of two).  ``--tree`` is the root of the checkout whose package is timed
(default: the one that holds this script), built under its own ``build/``;
``--step-only`` times that package's build alone (no variants, no launch
cost: what runs across trees).  To compare a change with its parent on one
card, unpack the parent into a git-ignored directory and run this script
once per tree, in turns (parent, change, change, parent), in one call: the
inputs come from one seed, so each run sees the same factors.

Needs one CUDA card and nvcc.  Besides the package's build it builds
``csrc/thomas_fwd.cu`` and ``csrc/thomas_bwd.cu`` again into
``build/probe/`` with ``-DTHOMAS_MAP_STEP=1`` (the dense passes through the
step-map body, ``run_flow``, instead of ``flow_kernel``; at r = 4 and 8 the
same wide step) and with ``-DTHOMAS_SPLIT=1`` and ``2`` (the flag-handoff
step with one and with two CTAs a tile, where the package's build picks one
per launch), all at once.  Each variant's output is held against the
package's.  Prints one JSON line per case, with ``--tree`` and ``--tag``.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ARGS = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ARGS.add_argument("--banded", action="store_true", help="the banded+tail rows 6-9 only")
ARGS.add_argument("--r", default="1,2",
                  help="right-hand sides a launch, comma-separated, of 1, 2, 4, 8 and 16")
ARGS.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                  help="root of the checkout whose package is timed")
ARGS.add_argument("--tag", default="")
ARGS.add_argument("--step-only", action="store_true",
                  help="the package's build alone: no variants, no launch cost")
OPTS = ARGS.parse_args()
ROOT = Path(OPTS.tree).resolve()
sys.path.insert(0, str(ROOT))

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import sweep_kernels as sk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk  # noqa: E402
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import (  # noqa: E402
    card_name_and_power_limit,
    cuda_time_ms as time_ms,
)

N = 801
M1_MAX, TRACE_TAIL = 70, 22   # of the 16-slab system at npml = 10
HALF, TAIL_LINES = 100, 26    # banded+tail pivots of the 801^2 solve (width 201 by the rule)
TRACES = dict(l0=10, l1=11, ln=58, lnp=59)    # trace lines of an inner slab
SOURCES = ("thomas_fwd", "thomas_bwd", "thomas_fwd_cached", "sweep_fused")
# variant -> (defines, sources): the dense passes through the step-map body,
# and with one and two CTAs a tile
VARIANTS = {"map": ({"THOMAS_MAP_STEP": 1}, SOURCES[:2]),
            "split1": ({"THOMAS_SPLIT": 1}, SOURCES[:2]),
            "split2": ({"THOMAS_SPLIT": 2}, SOURCES[:2])}
STEPS = ("new",) if OPTS.step_only else ("new",) + tuple(VARIANTS)


def build_steps() -> dict:
    """step -> {source: launcher}: the package's build ("new") and the
    variants of :data:`VARIANTS` (none with ``--step-only``), all built at
    once."""
    cuda_build.build_kernels(list(SOURCES))
    variants = {} if OPTS.step_only else VARIANTS
    dirs = {name: ROOT / "build" / "probe" / name for name in variants}
    with ThreadPoolExecutor(max(len(variants), 1)) as pool:
        list(pool.map(lambda name: cuda_build.build_kernels(
            list(variants[name][1]), defines=variants[name][0], build_dir=dirs[name]),
            variants))
    new = {src: cuda_build.load(src) for src in SOURCES}
    steps = {"new": new}
    for name, (_, sources) in variants.items():
        steps[name] = dict(new, **{src: cuda_build.load(src, build_dir=dirs[name])
                                   for src in sources})
    return steps


_EXCHANGES = {}


class SlotPerLine(tk.Exchange):
    """The exchange of the dense passes through the step-map body: one slot
    per line step, where ``flow_kernel`` reuses a ring of four."""

    def take(self, batch, r, ld, lines, slots=tk.EXCHANGE_LINES):
        return super().take(batch, r, ld, lines, max(slots, lines))


def use(steps, name):
    """Route the package's wrappers to the launchers of step ``name``, each
    step with exchange buffers of its own (the step-map variant takes one
    slot per line step)."""
    cuda_build._functions.update(steps[name])
    if name not in _EXCHANGES:
        dev = torch.device("cuda", 0)
        key = (dev, torch.cuda.current_stream(dev).cuda_stream)
        _EXCHANGES[name] = {key: SlotPerLine(dev)} if name == "map" else {}
    tk._EXCHANGES = _EXCHANGES[name]


def in_turns(steps, fn, order, repeats):
    """Time ``fn`` under each step of ``order`` in turn: mean ms by step, the
    times of each turn, and each step's output (a tuple of clones)."""
    times, outs = {}, {}
    for step in order:
        use(steps, step)
        got = fn()
        outs[step] = tuple(t.clone() for t in (got if isinstance(got, tuple) else (got,)))
        times.setdefault(step, []).append(time_ms(fn, repeats))
    torch.cuda.synchronize()
    use(steps, "new")
    return {step: sum(t) / len(t) for step, t in times.items()}, times, outs


def err_of(outs, step):
    return max(err(a, b) for a, b in zip(outs[step], outs["new"]))


def emit(rec: dict):
    print(json.dumps(dict(rec, tree=str(ROOT), tag=OPTS.tag)), flush=True)


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
    others = STEPS[1:]
    order = ("new",) + others + others[::-1] + ("new",)
    for name, fn in runs.items():
        ms, turns, outs = in_turns(steps, fn, order, repeats)
        emit(dict(
            row=row, pass_=name, storage=storage, B=b4.shape[0], S=fac.n_slabs, m=fac.m,
            lines=lines, n=N, r=b4.shape[2] // 2, tail=tail,
            **{f"{step}_ms": v for step, v in ms.items()}, ms_turns=turns,
            us_per_line={step: 1e3 * v / lines for step, v in ms.items()},
            variants_vs_new_err=max((err_of(outs, k) for k in others), default=0.0),
        ))


def probe_alone(fn, plain, lines, repeats=10, pick=lambda out: out, **fields):
    """One kernel at one shape, alone: its time, microseconds a line step and
    the part of its output that ``pick`` takes against its plain version's
    (taken outside the timed calls: the shortest passes are not far above
    their wrapper's host time)."""
    got, want = pick(fn()), pick(plain())
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    ms = time_ms(fn, repeats)
    emit(dict(**fields, lines=lines, n=N, new_ms=ms, us_per_line=1e3 * ms / lines,
              vs_plain_err=max(err(a, b) for a, b in zip(got, want))))


def probe_cached(row, fac, s_idx, b4, start=0):
    """The cached forward pass (rows 3, 5, 6, 3i, 5i) at one shape, in full
    or resumed at ``start`` from a carry."""
    t_init = b4[:, start].contiguous() if start else torch.zeros_like(b4[:, 0])
    out = (torch.zeros_like(b4), torch.zeros_like(b4))
    probe_alone(lambda: tk.forward_substitution_cached(fac, s_idx, b4, t_init, start=start,
                                                       out=out),
                lambda: tk.forward_substitution_cached_plain(fac, s_idx, b4, t_init, start),
                fac.m - start, pick=lambda stacks: tuple(t[:, start:] for t in stacks),
                row=row, pass_="fwd_cached", layout=tk.layout(fac), B=b4.shape[0],
                S=fac.n_slabs, m=fac.m, r=b4.shape[2] // 2, start=start)


def probe_backward_banded(fac, s_idx, y4, tail=0):
    """The backward pass on banded+tail pivots (row 7) at one shape, in full
    or over the last ``tail`` lines."""
    probe_alone(lambda: tk.backward_substitution(fac, s_idx, y4, tail=tail),
                lambda: tk.backward_substitution_ht_plain(fac, s_idx, y4, tail),
                tail or fac.m, row="7", pass_="bwd", layout=tk.layout(fac), B=y4.shape[0],
                S=fac.n_slabs, m=fac.m, r=y4.shape[2] // 2, tail=tail)


def random_banded(g, S, m, dev):
    """Random banded+tail factors at the 801^2 solve's width: head windows
    and tail planes scaled so that the recurrences contract, output lanes
    past n zero."""
    ld = tk._round_up(N, tk.LEAD_MULTIPLE)
    tiles, wt, ts = ld // tk.LEAD_MULTIPLE, 8 + 2 * HALF, m - TAIL_LINES

    def planes(shape, rows):
        p = (0.2 / rows ** 0.5) * torch.randn(shape, generator=g, device=dev)
        p[..., tiles - 1, :, N - (tiles - 1) * 8:] = 0
        return p.to(torch.bfloat16)

    bands = []
    for _ in range(2):
        b = torch.zeros((S, m, 2, 3, ld), device=dev)
        b[..., :N] = 0.4 * torch.rand((S, m, 2, 3, N), generator=g, device=dev) - 0.2
        bands.append(b)
    head = [planes((S, ts, tiles, wt, 8), wt) for _ in range(2)]
    tail = [planes((S, m - ts, tiles, ld, 8), N) for _ in range(2)]
    return tk.BandedTailFactorization(*head, *tail, *bands, N, HALF)


def sweep_operands(fac, r, g, dev):
    """Trace metadata of inner slabs (:data:`TRACES`), random source rows and
    coupling rows for the fused sweeps on ``fac``."""
    S, m, ld = fac.n_slabs, fac.m, fac.ld
    tr = TRACES
    meta = torch.tensor([[0] + [tr["l0"]] * (S - 1), [0] + [tr["l1"]] * (S - 1),
                         [tr["ln"]] * (S - 1) + [0], [tr["lnp"]] * (S - 1) + [0],
                         [0] + [1] * (S - 1), [1] * (S - 1) + [0]],
                        dtype=torch.int32, device=dev)
    cpl = []
    for _ in range(4):
        c = torch.zeros((S, 2, 3, ld), device=dev)
        c[..., :N] = 0.2 * torch.rand((S, 2, 3, N), generator=g, device=dev) - 0.1
        cpl.append(c)
    return meta, rows(g, S, m, r, dev), cpl


def sweep_runs(fac, meta, b4, cpl):
    """The down and the up launch (the up one on the down one's outputs), each
    with its plain version."""
    down = sk.sweep_down(fac, meta, b4, cpl[0], cpl[1], TRACE_TAIL)
    return {"down": (lambda: sk.sweep_down(fac, meta, b4, cpl[0], cpl[1], TRACE_TAIL),
                     lambda: sk.sweep_down_plain(fac, meta, b4, cpl[0], cpl[1], TRACE_TAIL)),
            "up": (lambda: sk.sweep_up(fac, meta, b4, cpl[2], cpl[3], *down, TRACE_TAIL),
                   lambda: sk.sweep_up_plain(fac, meta, b4, cpl[2], cpl[3], *down, TRACE_TAIL))}


def probe_sweeps(fac, r, g, dev):
    """The fused sweep kernels (rows 8-9) over all slabs."""
    S, m = fac.n_slabs, fac.m
    for name, (fn, plain) in sweep_runs(fac, *sweep_operands(fac, r, g, dev)).items():
        probe_alone(fn, plain, S * (m + TRACE_TAIL), row=8 if name == "down" else 9,
                    pass_="sweep_" + name, S=S, m=m, trace_tail=TRACE_TAIL, r=r)


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
              ld, 1, 1, 0, 0, xchg.data_ptr(), 0, epoch,
              torch.cuda.current_stream().cuda_stream):
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
    emit(dict(launch_cost_one_line_backward=dict(
        host_us_per_launch=1e6 * host / 1000,
        device_us_per_launch=1e3 * time_ms(launch, 50),
    )))


def main():
    rs = [int(v) for v in OPTS.r.split(",")]
    if any(r not in tk.LAUNCH_WIDTHS for r in rs):
        ARGS.error(f"--r takes {tk.LAUNCH_WIDTHS}")
    dev = torch.device("cuda", 0)
    print(card_name_and_power_limit(), flush=True)
    steps = None if OPTS.banded else build_steps()
    g = torch.Generator(device=dev).manual_seed(0)
    for storage in () if OPTS.banded else ("bf16", "int8"):
        i8 = "i" if storage == "int8" else ""
        # rows 1-2 (1i-2i): one slab of 801 lines
        fac = random_factors(g, 1, N, storage, dev)
        for r in rs:
            probe(steps, f"1{i8}-2{i8}", storage, fac, fac.slab_ids, rows(g, 1, N, r, dev),
                  repeats=5)
        del fac
        torch.cuda.empty_cache()
        # 16 slabs of 70 lines: all of them at once (jacobi_sweep, rows 1-2 and
        # 1i-2i), and one inner slab in full and over its last 22 lines (rows
        # 2 and 2i at r = 2 and wider, rows 4 and 4i at r = 1)
        fac = random_factors(g, 16, M1_MAX, storage, dev)
        for r in rs:
            probe(steps, f"1{i8}-2{i8}", storage, fac, fac.slab_ids, rows(g, 16, M1_MAX, r, dev))
        s = fac.slab_ids[8:9]
        for r in rs:
            row = f"4{i8}" if r == 1 else f"2{i8}"
            b4 = rows(g, 1, M1_MAX, r, dev)
            probe(steps, row, storage, fac, s, b4)
            probe(steps, row, storage, fac, s, b4, tail=TRACE_TAIL)
        # the cached forward pass at one inner slab: rows 3 and 5 (3i, 5i; row
        # 3 at r = 4 and 8)
        for r in rs:
            row = f"5{i8}" if r == 2 else f"3{i8}"
            b4 = rows(g, 1, M1_MAX, r, dev)
            probe_cached(row, fac, s, b4)
            probe_cached(row, fac, s, b4, start=M1_MAX - TRACE_TAIL)
        if storage == "bf16" and not OPTS.step_only:
            probe_launch_cost(fac, dev)
        del fac
        torch.cuda.empty_cache()
    # banded+tail pivots: rows 6 and 7 at one inner slab and at 16 batch rows,
    # and the fused sweeps of rows 8-9
    fac = random_banded(g, 16, M1_MAX, dev)
    s = fac.slab_ids[8:9]
    for r in rs:
        b4 = rows(g, 1, M1_MAX, r, dev)
        probe_cached("6", fac, s, b4)
        probe_cached("6", fac, s, b4, start=M1_MAX - TRACE_TAIL)
        y4 = tk.forward_substitution_cached(fac, s, b4)[0]
        probe_backward_banded(fac, s, y4)
        probe_backward_banded(fac, s, y4, tail=TRACE_TAIL)
        b4 = rows(g, 16, M1_MAX, r, dev)
        probe_cached("6", fac, fac.slab_ids, b4)
        probe_backward_banded(fac, fac.slab_ids, tk.forward_substitution_cached(
            fac, fac.slab_ids, b4)[0])
    for r in rs:
        probe_sweeps(fac, r, g, dev)


if __name__ == "__main__":
    main()
