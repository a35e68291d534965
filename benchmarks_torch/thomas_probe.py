"""Time the substitution kernels alone, on random factors, at the shapes of
the two main paths: one slab of 801 lines (the one-slab solve), and one slab
picked among 16 of 70 lines (the multi-slab sweeps: full, truncated and
resumed passes).  Then the cost of a launch: a one-line pass through the bare
launcher, in host and in device time.

    python3 benchmarks_torch/thomas_probe.py

Needs one CUDA card and nvcc.  Prints one JSON line per measurement.
"""

import json
import sys
import time
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


def random_factors(g, S, m, dev):
    ld = tk._round_up(N, tk.LEAD_MULTIPLE)

    def planes(diag):
        p = torch.zeros((S, m, ld, ld), dtype=torch.bfloat16, device=dev)
        p[:, :, :N, :N] = (0.1 / N ** 0.5) * torch.randn((S, m, N, N), generator=g, device=dev)
        idx = torch.arange(N, device=dev)
        p[:, :, idx, idx] += diag
        return tk.tile_planes(p)

    def bands():
        b = torch.zeros((S, m, 2, 3, ld), device=dev)
        b[..., :N] = 0.4 * torch.rand((S, m, 2, 3, N), generator=g, device=dev) - 0.2
        return b

    return tk.ThomasFactorization(planes(0.2), planes(0.0), bands(), bands(), N)


def err(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def probe_passes(g, S, m, tail, dev):
    fac = random_factors(g, S, m, dev)
    s_idx = fac.slab_ids[S // 2 : S // 2 + 1]
    j0 = m - tail
    for r in (1, 2):
        b4 = torch.zeros((1, m, 2 * r, fac.ld), device=dev)
        b4[..., :N] = torch.randn((1, m, 2 * r, N), generator=g, device=dev)
        zero = torch.zeros_like(b4[:, 0])
        y_ref, t_ref = tk.forward_substitution_cached_plain(fac, s_idx, b4, zero)
        x_ref = tk.backward_substitution_plain(fac, s_idx, y_ref)
        t_init = t_ref[:, j0 - 1].contiguous()
        out = (y_ref.clone(), t_ref.clone())
        y = tk.forward_substitution(fac, s_idx, b4)
        yc, tc = tk.forward_substitution_cached(fac, s_idx, b4)
        x = tk.backward_substitution(fac, s_idx, y_ref)
        torch.cuda.synchronize()
        runs = dict(
            fwd_ms=lambda: tk.forward_substitution(fac, s_idx, b4),
            fwd_cached_ms=lambda: tk.forward_substitution_cached(fac, s_idx, b4),
            fwd_cached_resumed_ms=lambda: tk.forward_substitution_cached(
                fac, s_idx, b4, t_init, start=j0, out=out),
            bwd_ms=lambda: tk.backward_substitution(fac, s_idx, y_ref),
            bwd_tail_ms=lambda: tk.backward_substitution(fac, s_idx, y_ref, tail=tail),
            bwd_one_line_ms=lambda: tk.backward_substitution(fac, s_idx, y_ref, tail=1),
        )
        print(json.dumps(dict(
            S=S, m=m, n=N, tail=tail, r=r,
            fwd_err=err(y, y_ref), fwd_cached_err=max(err(yc, y_ref), err(tc, t_ref)),
            bwd_err=err(x, x_ref), **{k: time_ms(f, 10) for k, f in runs.items()},
        )), flush=True)
    return fac


def probe_launch_cost(fac, dev):
    """The cost of one launch: a one-line backward pass through the bare
    launcher (no Python wrapper), host microseconds per enqueued launch (the
    stream is kept short by synchronising every 50 launches) and device
    microseconds per launch back to back."""
    fn = cuda_build.load("thomas_bwd")
    m, ld = fac.m, fac.ld
    y4 = torch.randn((1, m, 2, ld), device=dev)
    x4 = torch.empty((1, 1, 2, ld), device=dev)
    # dense planes: no head windows, tail_start = half = 0
    args = (y4.data_ptr(), fac.uband.data_ptr(), 0, 0, fac.cinv_t_re.data_ptr(),
            fac.cinv_t_im.data_ptr(), fac.slab_ids.data_ptr(), x4.data_ptr(), 1, m, N, ld, 1, 1,
            0, 0, torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args):
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
    print(card_name_and_power_limit())
    logs = cuda_build.build_kernels(verbose=True)
    for log in logs.values():
        print("\n".join(l for l in log.splitlines() if "registers" in l or "spill" in l))
    g = torch.Generator(device=dev).manual_seed(0)
    probe_passes(g, 1, 801, 32, dev)
    fac = probe_passes(g, 16, M1_MAX, TRACE_TAIL, dev)
    probe_launch_cost(fac, dev)


if __name__ == "__main__":
    main()
