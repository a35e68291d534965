"""The CUDA kernels (2D lines on bf16 and int8 planes and on banded+tail
pivots, the fused 2D sweep kernels, 3D planes, and the stencil matvec)
against their plain PyTorch versions.

These tests need a CUDA card and ``nvcc`` (a CUDA kernel has no CPU mode) and
skip without them.  They import nothing of the JAX package, so they run on a
machine that has only the port's dependencies::

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

import dataclasses

from fast_solver_lippmann_schwinger_tpu_torch.config import move_to
from fast_solver_lippmann_schwinger_tpu_torch.ddm import sweeps
from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d, plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.ops import stencil_kernels
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import sweep_kernels as sk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk

pytestmark = pytest.mark.cuda
TOL = 1e-4      # of the max-norm: f32 summation order is the only difference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the substitution kernels have no CPU mode")
    return torch.device("cuda", 0)


def _random_factors(rng, S, m, n, device):
    """Contracting random factors (||C|| ||band|| < 1) in the kernel layout."""
    ld = tk._round_up(n, tk.LEAD_MULTIPLE)

    def planes(diag):
        p = np.zeros((S, m, ld, ld), np.float32)
        p[:, :, :n, :n] = 0.1 * rng.standard_normal((S, m, n, n)) / np.sqrt(n)
        p[:, :, np.arange(n), np.arange(n)] += diag
        return tk.tile_planes(torch.from_numpy(p).to(torch.bfloat16)).to(device)

    def bands():
        b = np.zeros((S, m, 2, 3, ld), np.float32)
        b[..., :n] = rng.uniform(-0.2, 0.2, (S, m, 2, 3, n))
        return torch.from_numpy(b).to(device)

    return tk.ThomasFactorization(planes(0.2), planes(0.0), bands(), bands(), n)


def _to_cpu(fac):
    return tk.ThomasFactorization(fac.cinv_t_re.cpu(), fac.cinv_t_im.cpu(),
                                  fac.lband.cpu(), fac.uband.cpu(), fac.n)


def _rhs(rng, shape, start=0):
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    b[:, :start] = 0
    return b


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("start,tail", [(0, 0), (2, 3), (0, 4), (5, 0)])
def test_solve_all_matches_plain(cuda_device, r, start, tail):
    """n not a multiple of 8, batch rows picking slabs out of order; each
    wrapper counts one launch per call."""
    rng = np.random.default_rng(r)
    m, n = 9, 45
    fac = _random_factors(rng, 2, m, n, cuda_device)
    b = _rhs(rng, (2, m, n, r), start)
    before = (tk.forward_substitution.launches["bf16"], tk.backward_substitution.launches["bf16"])
    got = tk.solve_all(fac, [1, 0], torch.as_tensor(b, device=cuda_device), start=start, tail=tail)
    assert tk.forward_substitution.launches["bf16"] == before[0] + 1
    assert tk.backward_substitution.launches["bf16"] == before[1] + 1
    want = tk.solve_all(_to_cpu(fac), [1, 0], torch.as_tensor(b), start=start, tail=tail)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))


@pytest.mark.parametrize("r", [1, 2])
def test_more_tiles_than_resident_blocks(cuda_device, r):
    """At the main path's width a block's shared memory lets two blocks share
    an SM, so four batch rows (404 tiles) make blocks take several tiles per
    line."""
    rng = np.random.default_rng(r)
    m, n, batch = 4, 801, 4
    fac = _random_factors(rng, 2, m, n, cuda_device)
    b = _rhs(rng, (batch, m, n, r))
    s_idx = [i % 2 for i in range(batch)]
    got = tk.solve_all(fac, s_idx, torch.as_tensor(b, device=cuda_device))
    want = tk.solve_all(_to_cpu(fac), s_idx, torch.as_tensor(b))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))


def test_cuda_tensors_never_reach_the_plain_version(cuda_device, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(tk, "forward_substitution_plain", boom)
    monkeypatch.setattr(tk, "forward_substitution_cached_plain", boom)
    monkeypatch.setattr(tk, "backward_substitution_plain", boom)
    rng = np.random.default_rng(0)
    fac = _random_factors(rng, 1, 4, 24, cuda_device)
    b = torch.as_tensor(_rhs(rng, (1, 4, 24)), device=cuda_device)
    x = tk.solve_all(fac, [0], b)
    assert x.is_cuda and bool(torch.isfinite(torch.view_as_real(x)).all())
    x, y_c, t_c = tk.solve_cached(fac, 0, b[0], tail=2)
    x = tk.solve_resume(fac, 0, b[0], y_c, t_c, 2)
    assert x.is_cuda and bool(torch.isfinite(torch.view_as_real(x)).all())


@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("start,carry", [(0, False), (0, True), (48, True)])
@pytest.mark.parametrize("batch", [1, 16])
def test_cached_forward_matches_plain(cuda_device, storage, r, start, carry, batch):
    """The cached forward pass on the flag-handoff step, dense bf16 and int8
    planes (the banded+tail layout: test_hybrid_passes_match_plain): y and t
    stacks of a slab's 70 lines, a carry in (also at start = 0), lines above
    the start left alone; one CTA a tile, several tiles a CTA at 16 batch rows
    picking slabs out of order; one launch per call (r = 3 padded to four, 12
    to sixteen)."""
    rng = np.random.default_rng(1000 * batch + 10 * r + start + (storage == "int8"))
    m, n = 70, 300
    fac = (_random_factors if storage == "bf16" else _random_int8_factors)(rng, 2, m, n,
                                                                          cuda_device)
    cpu = move_to(fac, "cpu")
    b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (batch, m, n, r)), device=cuda_device))
    s_idx = torch.as_tensor((np.arange(batch) + 1) % 2, dtype=torch.int32, device=cuda_device)
    t_init = None
    if carry:
        t_init = torch.zeros((batch, 2 * r, fac.ld), device=cuda_device)
        t_init[..., :n] = torch.as_tensor(rng.standard_normal((batch, 2 * r, n)).astype(np.float32))
    out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
    before = tk.forward_substitution_cached.launches[storage]
    y4, t4 = tk.forward_substitution_cached(fac, s_idx, b4, t_init, start=start, out=out)
    torch.cuda.synchronize()
    assert tk.forward_substitution_cached.launches[storage] == before + 1
    y_p, t_p = tk.forward_substitution_cached(
        cpu, s_idx.cpu(), b4.cpu(), None if t_init is None else t_init.cpu(), start=start)
    for got, want in ((y4, y_p), (t4, t_p)):
        torch.testing.assert_close(got[:, start:].cpu(), want[:, start:], rtol=0,
                                   atol=TOL * float(want.abs().max()))
    assert bool((y4[:, :start] == 7.0).all()) and bool((t4[:, :start] == -7.0).all())


@pytest.mark.parametrize("r", [None, 2])
def test_one_slab_solves_match_plain(cuda_device, r):
    """``solve``, ``solve_support``, ``solve_cached`` and ``solve_resume`` on
    the card against the same calls on the CPU (plain versions); a resumed
    solve equals the full solve of the same right-hand side."""
    rng = np.random.default_rng(3)
    m, n, tail = 12, 45, 5
    fac = _random_factors(rng, 3, m, n, cuda_device)
    cpu = _to_cpu(fac)
    shape = (m, n) if r is None else (m, n, r)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    b_up = b.copy()
    b_up[m - tail:] += 1.0
    bs = b.copy()
    bs[:3] = 0
    d = lambda a: torch.as_tensor(a, device=cuda_device)      # noqa: E731
    c = torch.as_tensor

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))

    close(tk.solve(fac, 2, d(b), tail=tail), tk.solve(cpu, 2, c(b), tail=tail))
    close(tk.solve_support(fac, 1, d(bs), start=3), tk.solve_support(cpu, 1, c(bs), start=3))
    x, y_c, t_c = tk.solve_cached(fac, 1, d(b), tail)
    xp, y_p, t_p = tk.solve_cached(cpu, 1, c(b), tail)
    close(x, xp), close(y_c, y_p), close(t_c, t_p)
    got = tk.solve_resume(fac, 1, d(b_up), y_c, t_c, tail)
    close(got, tk.solve_resume(cpu, 1, c(b_up), y_p, t_p, tail))
    full = tk.solve(fac, 1, d(b_up))
    torch.testing.assert_close(got, full, rtol=0, atol=TOL * float(full.abs().max()))


@pytest.mark.parametrize("r", [None, 2])
def test_solve_support_head_start_and_tail_match_plain(cuda_device, r):
    """``solve_support`` as the polarized traces' recursions run it, on a
    401-wide random factor (ld = 408): the down recursion's head start and
    tail together, and the up recursion's head start alone, against the
    plain versions on the CPU; zeros above the tail."""
    rng = np.random.default_rng(17)
    m, n, start, tail = 71, 401, 9, 22
    fac = _random_factors(rng, 2, m, n, cuda_device)
    cpu = _to_cpu(fac)
    shape = (m, n) if r is None else (m, n, r)
    for first, last in ((start, tail), (m - tail, 0)):
        b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
        b[:first] = 0
        got = tk.solve_support(fac, 1, torch.as_tensor(b, device=cuda_device), start=first,
                               tail=last)
        want = tk.solve_support(cpu, 1, torch.as_tensor(b), start=first, tail=last)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))
        if last:
            assert not bool(got[: m - last].any())


@pytest.mark.parametrize("entry", ["forward", "forward_cached", "backward", "solve_all"])
def test_too_many_right_hand_sides_raise(cuda_device, entry, monkeypatch):
    """More right-hand sides than one launch takes (r = 3 > MAX_RHS) run as
    groups of the same kernels, one launch each, and agree with the plain
    versions; nothing falls back to them."""
    rng = np.random.default_rng(0)
    fac = _random_factors(rng, 2, 6, 24, cuda_device)
    cpu = _to_cpu(fac)
    r = tk.MAX_RHS + 1
    s_idx = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    rows = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (2, 6, 24, r)), device=cuda_device))
    t0 = rows[:, 0].contiguous()
    calls = {"forward": lambda f, s, b: tk.forward_substitution(f, s, b, start=1),
             "forward_cached": lambda f, s, b: tk.forward_substitution_cached(
                 f, s, b, t0.to(b.device), start=2),
             "backward": lambda f, s, b: tk.backward_substitution(f, s, b, tail=4),
             "solve_all": lambda f, s, b: tk.solve_all(
                 f, s, tk._from_rows_b(b, 24, torch.complex64, 6))}
    want = calls[entry](cpu, s_idx.cpu(), rows.cpu())
    for name in ("forward_substitution_plain", "forward_substitution_cached_plain",
                 "backward_substitution_plain"):
        monkeypatch.setattr(tk, name, None)      # a call would raise TypeError
    fn = {"forward": tk.forward_substitution, "forward_cached": tk.forward_substitution_cached,
          "backward": tk.backward_substitution, "solve_all": tk.backward_substitution}[entry]
    before = fn.launches["bf16"]
    got = calls[entry](fac, s_idx, rows)
    torch.cuda.synchronize()
    assert fn.launches["bf16"] == before + len(tk.rhs_groups(r)) == before + 2
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=TOL * float(w.abs().max()))


@pytest.mark.parametrize("entry", ["forward", "forward_cached", "backward"])
def test_line_too_long_raises(cuda_device, entry):
    """A line whose plane buffers do not fit in a block's shared memory is
    refused before any launch."""
    n = 4000
    planes = torch.zeros((1, 1, n // 8, n, 8), dtype=torch.bfloat16, device=cuda_device)
    bands = torch.zeros((1, 1, 2, 3, n), device=cuda_device)
    fac = tk.ThomasFactorization(planes, planes, bands, bands, n)
    s_idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    rows = torch.zeros((1, 1, 2, n), device=cuda_device)
    fn = {"forward": tk.forward_substitution, "forward_cached": tk.forward_substitution_cached,
          "backward": tk.backward_substitution}[entry]
    before = dict(fn.launches)
    with pytest.raises(ValueError, match="too long"):
        fn(fac, s_idx, rows)
    assert fn.launches == before


# ---------------------------------------------------------------------------
# The plane kernels of the 3D solves
# ---------------------------------------------------------------------------


def _random_view(rng, l, m, n, device, slabs=1):
    """Contracting random plane factors (||P|| ||S|| < 1) in the kernels'
    layout: ``slabs`` slabs of ``l`` planes, the view of the last one."""
    mn = m * n
    ld = tk._round_up(mn, tk.LEAD_MULTIPLE)

    def planes(diag):
        p = torch.zeros((slabs * l, ld, ld), dtype=torch.bfloat16, device=device)
        g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
        p[:, :mn, :mn] = (0.1 / mn ** 0.5) * torch.randn((slabs * l, mn, mn), generator=g,
                                                         device=device)
        idx = torch.arange(mn, device=device)
        p[:, idx, idx] += diag
        return tk.tile_planes(p)

    def sten():
        s = rng.uniform(-0.05, 0.05, (l, m, n, 3, 3)) + 1j * rng.uniform(-0.05, 0.05, (l, m, n, 3, 3))
        return torch.as_tensor(s.astype(np.complex64), device=device)

    stack = pk.PlaneStack(p_re=planes(0.2), p_im=planes(0.0), mn=mn, l1=l)
    return pk.PlaneSlabView(stack=stack, lsten=sten(), usten=sten(), base=(slabs - 1) * l)


def _view_to_cpu(view):
    st = view.stack
    return pk.PlaneSlabView(stack=pk.PlaneStack(st.p_re.cpu(), st.p_im.cpu(), st.mn, st.l1),
                            lsten=view.lsten.cpu(), usten=view.usten.cpu(), base=view.base)


def _close(got, want):
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))


# the widest plane each launch width of the fused passes takes (the module
# note of csrc/plane_pass.cuh, Limits)
WIDEST_PLANE = {"bf16": ((3104, 8), (6352, 4), (12448, 2), (24928, 1)),
                "int8": ((3072, 8), (6272, 4), (12288, 2), (24704, 1))}


def _fused_launches(storage, ld, r):
    """Fused launches a pass of r right-hand sides takes on planes of ld lanes:
    one of the widest width that fits, per group of that many columns."""
    width = next(w for limit, w in WIDEST_PLANE[storage] if ld <= limit)
    return -(-r // min(r, width))


@pytest.mark.parametrize("shape", [(5, 5, 7), (3, 48, 48), (3, 32, 96), (3, 1, 12448)])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("start,carry,tail,collect", [(0, False, 0, True), (0, True, 2, False),
                                                      (2, True, 0, True), (2, False, 1, False)])
def test_plane_passes_match_plain(cuda_device, shape, r, start, carry, tail, collect):
    """Both fused passes at a small width (mn = 35: five tiles, one CTA
    each), the 48^3 plane width (mn = 2304: 288 tiles, two or three a CTA),
    the 96^3 width (mn = 3072: two or three tiles a CTA) and the widest plane
    they take at r = 2
    (mn = 12448: twelve tiles a CTA, a ring of four chunks), from a slab that
    is not the first of its stack, with and without the t stack; planes
    above ``start`` of caller-given stacks are left alone; one launch per
    call, r = 4 and 8 on tensor cores (at mn = 12448, wider than they take,
    in launches of two: plane_kernels.fused_width)."""
    rng = np.random.default_rng(r + 10 * start)
    l, m, n = shape
    view = _random_view(rng, l, m, n, cuda_device, slabs=2)
    cpu = _view_to_cpu(view)
    st, ld = view.stack, view.stack.ld
    b = (rng.standard_normal((l, m * n, r)) + 1j * rng.standard_normal((l, m * n, r)))
    b4 = pk._rows_of(torch.as_tensor(b.astype(np.complex64), device=cuda_device), ld)
    t0 = None
    if carry:
        t0 = torch.zeros((2 * r, ld), device=cuda_device)
        t0[:, : m * n] = torch.as_tensor(rng.standard_normal((2 * r, m * n)).astype(np.float32))
    out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0) if collect else None)
    before = (pk.plane_forward.launches["bf16"], pk.plane_backward.launches["bf16"])
    y4, t4 = pk.plane_forward(st, b4, view.lrows, n, view.base, start, t0, out=out)
    x4 = pk.plane_backward(st, y4, view.urows, n, view.base, start=tail and l - tail)
    torch.cuda.synchronize()
    groups = len(tk.rhs_groups(r, pk.fused_width(st, r)))
    assert groups == _fused_launches("bf16", ld, r)
    assert (pk.plane_forward.launches["bf16"], pk.plane_backward.launches["bf16"]) == (
        before[0] + groups, before[1] + groups)
    y_p, t_p = pk.plane_forward(cpu.stack, b4.cpu(), cpu.lrows, n, cpu.base, start,
                                None if t0 is None else t0.cpu())
    x_p = pk.plane_backward(cpu.stack, y4.cpu(), cpu.urows, n, cpu.base, start=tail and l - tail)
    _close(y4[start:], y_p[start:])
    _close(x4, x_p)
    assert bool((y4[:start] == 7.0).all())
    if collect:
        _close(t4[start:], t_p[start:])
        assert bool((t4[:start] == -7.0).all())
    else:
        assert t4 is None


@pytest.mark.parametrize("r", [None, 2])
def test_polarized_head_and_tail_passes_match_plain(cuda_device, r):
    """The shapes of the 3D polarized traces at 48^3 with 4 z-slabs: the
    forward pass of the down recursion from ``trace_head`` = 5 with no carry
    and its backward pass over the last ``trace_tail`` = 14 planes, on a
    random stack of 24 planes of 2304, through the scans' entry points."""
    rng = np.random.default_rng(24 + (r or 1))
    l, m, n, head, tail = 24, 48, 48, 5, 14
    view = _random_view(rng, l, m, n, cuda_device, slabs=2)
    cpu = _view_to_cpu(view)
    shape = (l, m * n) + (() if r is None else (r,))
    bg = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    bg[:head] = 0
    bg = torch.as_tensor(bg, device=cuda_device)
    before = (pk.plane_forward.launches["bf16"], pk.plane_backward.launches["bf16"])
    y, t = pk.fwd_scan_fused(view, bg, start=head)
    y = torch.cat([y.new_zeros((head,) + tuple(y.shape[1:])), y])
    x = pk.bwd_scan_fused(view, y, tail=tail)
    torch.cuda.synchronize()
    assert t is None
    assert (pk.plane_forward.launches["bf16"], pk.plane_backward.launches["bf16"]) == (
        before[0] + 1, before[1] + 1)
    y_p, _ = pk.fwd_scan_fused(cpu, bg.cpu(), start=head)
    _close(y[head:], y_p)
    x_p = pk.bwd_scan_fused(cpu, y.cpu(), tail=tail)
    _close(x[l - tail:], x_p[l - tail:])
    assert bool((x[: l - tail] == 0).all())


def test_wide_batches_run_grouped_fused_passes(cuda_device):
    """A solve of nine right-hand sides, more than a launch takes, on a stack
    the fused passes take runs two fused launches a pass (columns 0-7, then
    8 alone), no plane apply, and agrees with the plain versions."""
    rng = np.random.default_rng(7)
    l, m, n = 4, 6, 8
    r = pk.MAX_RHS + 1
    view = _random_view(rng, l, m, n, cuda_device)
    b = torch.as_tensor((rng.standard_normal((l * m * n, r))
                         + 1j * rng.standard_normal((l * m * n, r))).astype(np.complex64),
                        device=cuda_device)
    fns = (pk.plane_forward, pk.plane_backward, pk.plane_apply_rows)
    before = tuple(f.launches["bf16"] for f in fns)
    x = direct.block_thomas_solve_3d(view, b)
    torch.cuda.synchronize()
    assert tuple(f.launches["bf16"] - b_ for f, b_ in zip(fns, before)) == (2, 2, 0)
    _close(x, direct.block_thomas_solve_3d(_view_to_cpu(view), b.cpu()))


@pytest.mark.parametrize("r", [1, 2, 3, 8])
@pytest.mark.parametrize("mn", [35, 2304, 12456])
def test_plane_apply_matches_plain(cuda_device, r, mn):
    """One plane apply, also at a width the fused passes refuse at r = 2; r = 3
    (padded to four) and 8 in one launch on tensor cores."""
    rng = np.random.default_rng(mn + r)
    view = _random_view(rng, 1, 1, mn, cuda_device)
    rows = torch.as_tensor(rng.standard_normal((2 * r, view.stack.ld)).astype(np.float32),
                           device=cuda_device)
    rows[:, mn:] = 0
    before = pk.plane_apply_rows.launches["bf16"]
    got = pk.plane_apply_rows(view.stack, 0, rows)
    torch.cuda.synchronize()
    assert pk.plane_apply_rows.launches["bf16"] == before + 1
    _close(got, pk.plane_apply_rows_plain(view.stack, 0, rows).cpu())
    assert pk.fused_fits(view.stack, r) == (mn < 12456 or r == 1)


def test_plane_solve_branches_agree(cuda_device):
    """``block_thomas_solve_3d`` on a view: the fused branch (two launches)
    and the per-plane branch (2 l launches of ``plane_apply``) agree, and
    against the plain versions on the CPU."""
    rng = np.random.default_rng(4)
    l, m, n = 4, 6, 8
    view = _random_view(rng, l, m, n, cuda_device)
    b = torch.as_tensor((rng.standard_normal(l * m * n) + 1j * rng.standard_normal(l * m * n))
                        .astype(np.complex64), device=cuda_device)
    fns = (pk.plane_forward, pk.plane_backward, pk.plane_apply_rows)
    before = tuple(f.launches["bf16"] for f in fns)
    x_fused = direct.block_thomas_solve_3d(view, b)
    x_plane = direct.block_thomas_solve_3d(dataclasses.replace(view, fused=False), b)
    after = tuple(f.launches["bf16"] for f in fns)
    assert tuple(a - b_ for a, b_ in zip(after, before)) == (1, 1, 2 * l)
    torch.testing.assert_close(x_plane, x_fused, rtol=0, atol=TOL * float(x_fused.abs().max()))
    _close(x_fused, direct.block_thomas_solve_3d(_view_to_cpu(view), b.cpu()))


def test_plane_kernels_never_call_plain_versions(cuda_device, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("plane_forward_plain", "plane_backward_plain", "plane_apply_rows_plain"):
        monkeypatch.setattr(pk, name, boom)
    rng = np.random.default_rng(0)
    view = _random_view(rng, 3, 4, 5, cuda_device)
    b = torch.as_tensor(np.ones((60, 2), np.complex64), device=cuda_device)
    for v in (view, dataclasses.replace(view, fused=False)):
        x = direct.block_thomas_solve_3d(v, b)
        assert x.is_cuda and bool(torch.isfinite(torch.view_as_real(x)).all())


@pytest.mark.parametrize("entry", ["forward", "backward", "apply"])
def test_plane_kernels_refuse_three_right_hand_sides(cuda_device, entry):
    """Nine right-hand sides, more than one launch takes (eight), run as two
    launches (eight columns, then one) that agree with the plain version."""
    rng = np.random.default_rng(0)
    view = _random_view(rng, 2, 4, 5, cuda_device)
    cpu = _view_to_cpu(view)
    r = pk.MAX_RHS + 1
    b = rng.standard_normal((2, r, 20)) + 1j * rng.standard_normal((2, r, 20))
    rows = pk._rows_of(torch.as_tensor(b.astype(np.complex64).transpose(0, 2, 1),
                                       device=cuda_device), view.stack.ld)
    runs = {"forward": lambda v, x: pk.plane_forward(v.stack, x, v.lrows, 5, start=1)[0],
            "backward": lambda v, x: pk.plane_backward(v.stack, x, v.urows, 5),
            "apply": lambda v, x: pk.plane_apply_rows(v.stack, 1, x[0].contiguous())}
    fn = {"forward": pk.plane_forward, "backward": pk.plane_backward,
          "apply": pk.plane_apply_rows}[entry]
    before = fn.launches["bf16"]
    got = runs[entry](view, rows)
    torch.cuda.synchronize()
    assert fn.launches["bf16"] == before + 2
    _close(got, runs[entry](cpu, rows.cpu()))


# ---------------------------------------------------------------------------
# The int8 mode of the plane kernels (int8 planes with per-block f32 scales)
# ---------------------------------------------------------------------------


def _random_int8_view(rng, l, m, n, device, slabs=1):
    """Contracting random plane factors quantized by the port's own
    ``direct._quantize_t_int8`` and packed into an int8 stack: ``slabs``
    slabs of ``l`` planes, the view of the last one."""
    mn = m * n
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))

    def plane():
        p = (0.1 / mn ** 0.5) * torch.randn((mn, mn), generator=g, device=device)
        p += 0.2 * torch.eye(mn, device=device)
        return direct._quantize_t_int8(p)

    def sten():
        s = rng.uniform(-0.05, 0.05, (slabs, l, m, n, 3, 3, 2)).astype(np.float32)
        return torch.view_as_complex(torch.as_tensor(s, device=device))

    parts = [[plane() for _ in range(slabs * l)] for _ in range(2)]
    q = [torch.stack([p[0] for p in ps]).reshape((slabs, l) + ps[0][0].shape) for ps in parts]
    s = [torch.stack([p[1] for p in ps]).reshape((slabs, l) + ps[0][1].shape) for ps in parts]
    fac = direct.BlockTridiagFactorization3DInt8(q_re=q[0], q_im=q[1], s_re=s[0], s_im=s[1],
                                                 lsten=sten(), usten=sten())
    stack = pk.build_plane_stack(fac)
    return pk.PlaneSlabView(stack=stack, lsten=fac.lsten[-1], usten=fac.usten[-1],
                            base=(slabs - 1) * l)


def _int8_view_to_cpu(view):
    return pk.PlaneSlabView(stack=dataclasses.replace(
        view.stack, p_re=view.stack.p_re.cpu(), p_im=view.stack.p_im.cpu(),
        scale=view.stack.scale.cpu()), lsten=view.lsten.cpu(), usten=view.usten.cpu(),
        base=view.base)


@pytest.mark.parametrize("shape", [(5, 5, 7), (3, 10, 30), (3, 32, 96), (3, 26, 128),
                                   (3, 1, 12288)])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("start,carry,tail,collect", [(0, False, 0, True), (0, True, 2, False),
                                                      (2, True, 0, True), (2, False, 1, False)])
def test_int8_plane_passes_match_plain(cuda_device, shape, r, start, carry, tail, collect):
    """Both fused passes on int8 planes: padded widths (mn = 35 and 300 in
    one and three 128-row scale blocks; one tile a CTA), the 96^3 y-plane
    width (mn = 3072 = 24 blocks, two or three tiles a CTA), mn = 3328 (416
    tiles: three or four a CTA) and the widest plane they take at r = 2
    (ld = 12288: eleven or twelve tiles a CTA), from the second slab of the
    stack, with and without the t stack; one launch per call, counted as
    int8 (r = 4 and 8 on tensor cores; at ld = 12288 in launches of two)."""
    rng = np.random.default_rng(r + 10 * start + shape[1])
    l, m, n = shape
    view = _random_int8_view(rng, l, m, n, cuda_device, slabs=2)
    cpu = _int8_view_to_cpu(view)
    st, ld = view.stack, view.stack.ld
    assert st.storage == "int8" and ld % 128 == 0
    b = (rng.standard_normal((l, m * n, r)) + 1j * rng.standard_normal((l, m * n, r)))
    b4 = pk._rows_of(torch.as_tensor(b.astype(np.complex64), device=cuda_device), ld)
    t0 = None
    if carry:
        t0 = torch.zeros((2 * r, ld), device=cuda_device)
        t0[:, : m * n] = torch.as_tensor(rng.standard_normal((2 * r, m * n)).astype(np.float32))
    out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0) if collect else None)
    before = (pk.plane_forward.launches["int8"], pk.plane_backward.launches["int8"])
    y4, t4 = pk.plane_forward(st, b4, view.lrows, n, view.base, start, t0, out=out)
    x4 = pk.plane_backward(st, y4, view.urows, n, view.base, start=tail and l - tail)
    torch.cuda.synchronize()
    groups = len(tk.rhs_groups(r, pk.fused_width(st, r)))
    assert groups == _fused_launches("int8", ld, r)
    assert (pk.plane_forward.launches["int8"], pk.plane_backward.launches["int8"]) == (
        before[0] + groups, before[1] + groups)
    y_p, t_p = pk.plane_forward(cpu.stack, b4.cpu(), cpu.lrows, n, cpu.base, start,
                                None if t0 is None else t0.cpu())
    x_p = pk.plane_backward(cpu.stack, y4.cpu(), cpu.urows, n, cpu.base, start=tail and l - tail)
    _close(y4[start:], y_p[start:])
    _close(x4, x_p)
    assert bool((y4[:start] == 7.0).all())
    if collect:
        _close(t4[start:], t_p[start:])
        assert bool((t4[:start] == -7.0).all())
    else:
        assert t4 is None


@pytest.mark.parametrize("storage,m,n", [("bf16", 32, 96), ("bf16", 48, 48), ("int8", 32, 96),
                                         ("int8", 26, 128)])
@pytest.mark.parametrize("r", [1, 2])
def test_plane_passes_are_bit_identical_across_repeats(cuda_device, storage, m, n, r):
    """The fused passes hand their t tiles and y lanes from CTA to CTA by
    flagged words: 100 launches of each (forward resumed at plane 1 from a
    carry into a t stack, and a backward tail) give the same bits as the
    first, so no sum depends on timing; at the 96^3 width, the 48^3 width
    and mn = 3328 (two to four tiles a CTA)."""
    rng = np.random.default_rng(r)
    l = 6
    make = _random_int8_view if storage == "int8" else _random_view
    view = make(rng, l, m, n, cuda_device, slabs=2)
    st, ld = view.stack, view.stack.ld
    b4 = torch.zeros((l, 2 * r, ld), device=cuda_device)
    b4[..., : m * n] = torch.as_tensor(rng.standard_normal((l, 2 * r, m * n)).astype(np.float32))
    t0 = torch.zeros((2 * r, ld), device=cuda_device)
    t0[:, : m * n] = torch.as_tensor(rng.standard_normal((2 * r, m * n)).astype(np.float32))

    def forward():
        return pk.plane_forward(st, b4, view.lrows, n, view.base, 1, t0)

    def backward():
        return (pk.plane_backward(st, b4, view.urows, n, view.base, start=2),)

    for run in (forward, backward):
        first = tuple(t.clone() for t in run())
        for _ in range(99):
            got = run()
            assert all(torch.equal(a, b) for a, b in zip(got, first))


# (m, n) planes of the wide step's cases: 2, 3 and 4 tiles a CTA on 132 SMs at
# the widths of benchmarks_torch/plane_probe.py (bf16 mn = 2112, 2304, 2640:
# at most 2, 3, 3 tiles; int8 2816, 3072, 3328: 3, 3, 4), and the widest
# plane the fused passes take at each wide launch width (WIDEST_PLANE)
WIDE_PLANES = {"bf16": ((32, 66), (48, 48), (40, 66)), "int8": ((32, 88), (32, 96), (26, 128))}
WIDEST_WIDE = {("bf16", 8): (32, 97), ("bf16", 4): (16, 397), ("int8", 8): (32, 96),
               ("int8", 4): (64, 98)}


@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("case", [0, 1, 2, "widest"])
def test_wide_plane_step_matches_plain(cuda_device, storage, r, case):
    """The tensor-core step of the fused passes and the plane apply at r = 4
    and 8 (csrc/plane_pass.cuh, note 4) on bf16 and int8 planes: a forward
    pass resumed at plane 1 from a given carry into a t stack, a backward tail
    of two planes and a whole backward pass, and a plane apply, each against
    its plain version; a second run gives the same bits (the flags and the
    warps' sums leave nothing to timing)."""
    m, n = WIDEST_WIDE[storage, r] if case == "widest" else WIDE_PLANES[storage][case]
    mn, l, start, tail = m * n, 4, 1, 2
    rng = np.random.default_rng(mn + r)
    make, to_cpu = ((_random_int8_view, _int8_view_to_cpu) if storage == "int8"
                    else (_random_view, _view_to_cpu))
    view = make(rng, l, m, n, cuda_device, slabs=2)
    cpu = to_cpu(view)
    st, ld = view.stack, view.stack.ld
    if case == "widest":
        assert pk.fused_width(st, r) == r
    b4 = torch.zeros((l, 2 * r, ld), device=cuda_device)
    b4[..., :mn] = torch.as_tensor(rng.standard_normal((l, 2 * r, mn)).astype(np.float32))
    t0 = torch.zeros((2 * r, ld), device=cuda_device)
    t0[:, :mn] = torch.as_tensor(rng.standard_normal((2 * r, mn)).astype(np.float32))

    def run():
        y4, t4 = pk.plane_forward(st, b4, view.lrows, n, view.base, start, t0)
        return (y4, t4, pk.plane_backward(st, y4, view.urows, n, view.base, start=l - tail),
                pk.plane_backward(st, y4, view.urows, n, view.base),
                pk.plane_apply_rows(st, view.base + 1, b4[1]))

    first = tuple(t.clone() for t in run())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(run(), first))
    y4, t4, x_tail, x4, applied = first
    y_p, t_p = pk.plane_forward(cpu.stack, b4.cpu(), cpu.lrows, n, cpu.base, start, t0.cpu())
    _close(y4[start:], y_p[start:])
    _close(t4[start:], t_p[start:])
    x_p = pk.plane_backward(cpu.stack, y4.cpu(), cpu.urows, n, cpu.base, start=l - tail)
    _close(x_tail[l - tail:], x_p[l - tail:])
    _close(x4, pk.plane_backward(cpu.stack, y4.cpu(), cpu.urows, n, cpu.base))
    _close(applied, pk.plane_apply_rows_plain(cpu.stack, cpu.base + 1, b4[1].cpu()))


@pytest.mark.parametrize("r", [1, 2, 3, 8])
@pytest.mark.parametrize("mn", [35, 3072, 12300])
def test_int8_plane_apply_matches_plain(cuda_device, r, mn):
    """One int8 plane apply, also at a width the fused int8 passes refuse at
    r = 2 (ld = 12416 > 12288); r = 3 (padded to four) and 8 in one launch."""
    rng = np.random.default_rng(mn + r)
    view = _random_int8_view(rng, 1, 1, mn, cuda_device)
    rows = torch.as_tensor(rng.standard_normal((2 * r, view.stack.ld)).astype(np.float32),
                           device=cuda_device)
    rows[:, mn:] = 0
    before = pk.plane_apply_rows.launches["int8"]
    got = pk.plane_apply_rows(view.stack, 0, rows)
    torch.cuda.synchronize()
    assert pk.plane_apply_rows.launches["int8"] == before + 1
    _close(got, pk.plane_apply_rows_plain(view.stack, 0, rows).cpu())
    assert pk.fused_fits(view.stack, r) == (mn < 12300 or r == 1)


def test_int8_solve_branches_agree(cuda_device):
    """``block_thomas_solve_3d`` on an int8 view: the fused branch and the
    per-plane branch agree with each other and with the plain versions on
    the CPU; no plain version is called for a CUDA tensor."""
    rng = np.random.default_rng(5)
    l, m, n = 4, 6, 30
    view = _random_int8_view(rng, l, m, n, cuda_device)
    b = torch.as_tensor((rng.standard_normal((l * m * n, 2))
                         + 1j * rng.standard_normal((l * m * n, 2))).astype(np.complex64),
                        device=cuda_device)
    want = direct.block_thomas_solve_3d(_int8_view_to_cpu(view), b.cpu())
    plain = {name: getattr(pk, name) for name in
             ("plane_forward_plain", "plane_backward_plain", "plane_apply_rows_plain")}
    try:
        for name in plain:
            setattr(pk, name, None)      # a call would raise TypeError
        fns = (pk.plane_forward, pk.plane_backward, pk.plane_apply_rows)
        before = tuple(f.launches["int8"] for f in fns)
        x_fused = direct.block_thomas_solve_3d(view, b)
        x_plane = direct.block_thomas_solve_3d(dataclasses.replace(view, fused=False), b)
        after = tuple(f.launches["int8"] for f in fns)
    finally:
        for name, fn in plain.items():
            setattr(pk, name, fn)
    assert tuple(a - b_ for a, b_ in zip(after, before)) == (1, 1, 2 * l)
    torch.testing.assert_close(x_plane, x_fused, rtol=0, atol=TOL * float(x_fused.abs().max()))
    _close(x_fused, want)


@pytest.mark.parametrize("entry", ["forward", "backward", "apply"])
@pytest.mark.parametrize("fault", ["width", "scales", "rhs"])
def test_int8_wrappers_raise_instead_of_falling_back(cuda_device, entry, fault):
    """int8 planes the kernels cannot take raise before any launch: a width
    that is not a multiple of the 128-row scale blocks, scales of the wrong
    shape; more right-hand sides than a launch takes (nine) run as two
    launches and reach no plain version."""
    rng = np.random.default_rng(0)
    view = _random_int8_view(rng, 2, 4, 40, cuda_device)
    st, r = view.stack, 1
    if fault == "width":
        ld = 168
        st = dataclasses.replace(
            st, p_re=torch.zeros((2, ld // 8, ld, 8), dtype=torch.int8, device=cuda_device),
            p_im=torch.zeros((2, ld // 8, ld, 8), dtype=torch.int8, device=cuda_device),
            scale=torch.ones((2, ld // 8, 1, 2, 8), device=cuda_device))
    elif fault == "scales":
        st = dataclasses.replace(st, scale=st.scale[:, :, :, :1].contiguous())
    else:
        r = pk.MAX_RHS + 1
    rows = torch.zeros((2, 2 * r, st.ld), device=cuda_device)
    w = torch.zeros((2, 2, 9, st.ld), device=cuda_device)
    fn = {"forward": pk.plane_forward, "backward": pk.plane_backward,
          "apply": pk.plane_apply_rows}[entry]
    before = dict(fn.launches)
    call = (lambda: fn(st, 0, rows[0])) if entry == "apply" else (lambda: fn(st, rows, w, 40))
    if fault == "rhs":
        plain = {name: getattr(pk, name) for name in
                 ("plane_forward_plain", "plane_backward_plain", "plane_apply_rows_plain")}
        try:
            for name in plain:
                setattr(pk, name, None)      # a call would raise TypeError
            call()
            torch.cuda.synchronize()
        finally:
            for name, f in plain.items():
                setattr(pk, name, f)
        assert fn.launches == dict(before, int8=before["int8"] + 2)
        return
    with pytest.raises(ValueError):
        call()
    assert fn.launches == before


@pytest.mark.parametrize("mode", ["bf16_pallas", "yblock_int8_pallas"])
def test_gs_sweep_on_card_matches_cpu(cuda_device, mode):
    """The 3D z-slab sweep preconditioner of a small bump problem, built on
    the CPU and moved to the card: one apply (two right-hand sides) through
    the kernels against the same apply through the plain versions, two
    launches of each fused pass per slab solve."""
    problem = bump3d.build_problem(h=1 / 16, dtype=torch.complex64, precond="gs",
                                   n_subdomains=2, npml=5, pivot_dtype=mode, device="cpu")
    pc_cpu = problem.precond
    pc = move_to(pc_cpu, cuda_device)
    rng = np.random.default_rng(1)
    b = (rng.standard_normal((2, problem.grid.size))
         + 1j * rng.standard_normal((2, problem.grid.size))).astype(np.complex64)
    before = (sum(pk.plane_forward.launches.values()), sum(pk.plane_backward.launches.values()))
    got = pc.apply_batch(torch.as_tensor(b, device=cuda_device))
    torch.cuda.synchronize()
    slab_solves = 2 * pc.slabs.n_subs
    after = (sum(pk.plane_forward.launches.values()), sum(pk.plane_backward.launches.values()))
    assert (after[0] - before[0], after[1] - before[1]) == (slab_solves, slab_solves)
    _close(got, pc_cpu.apply_batch(torch.as_tensor(b)))


# ---------------------------------------------------------------------------
# The banded+tail layout: the hybrid passes and the fused sweep kernels
# ---------------------------------------------------------------------------


def _random_hybrid(rng, S, m, n, width, tail_lines):
    """Contracting random factors (||C|| ||band|| < 1) in the hybrid layout,
    on the CPU."""
    cinv = (0.1 / np.sqrt(n)) * (rng.standard_normal((S, m, n, n))
                                 + 1j * rng.standard_normal((S, m, n, n))) + 0.2 * np.eye(n)
    bands = [rng.uniform(-0.2, 0.2, (S, m, n, 3)) + 1j * rng.uniform(-0.2, 0.2, (S, m, n, 3))
             for _ in range(2)]
    fac = direct.BlockTridiagFactorization(*(torch.as_tensor(a.astype(np.complex64))
                                             for a in (cinv, *bands)))
    return tk.build_banded_tail_factorization(fac, width=width, tail_lines=tail_lines)


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("start,carry,tail", [(0, False, 0), (0, True, 3), (5, True, 30),
                                              (48, True, 0)])
@pytest.mark.parametrize("batch", [1, 16])
def test_hybrid_passes_match_plain(cuda_device, r, start, carry, tail, batch):
    """Forward (the flag-handoff step, head windows) from a zero carry or
    t_init, starting in the head and in the tail; backward full, inside the
    tail lines or across into the head; n not a multiple of 8, batch rows
    picking slabs out of order (at 16, several tiles a CTA); one launch per
    call at every r (r = 3 padded to four, 5 to eight, 12 to sixteen; 4, 8
    and 16 the wide step), lines above the start left alone."""
    rng = np.random.default_rng(100 + 10 * r + start + batch)
    m, n = 56, 45
    fac = _random_hybrid(rng, 2, m, n, width=9, tail_lines=20)
    card = move_to(fac, cuda_device)
    b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (batch, m, n, r))))
    s_idx = torch.as_tensor((np.arange(batch) + 1) % 2, dtype=torch.int32)
    t_init = torch.zeros((batch, 2 * r, fac.ld))
    if carry:
        t_init[..., :n] = torch.as_tensor(rng.standard_normal((batch, 2 * r, n)).astype(np.float32))
    out = tuple(torch.full(b4.shape, v, device=cuda_device) for v in (7.0, -7.0))
    fwd, bwd = tk.forward_substitution_cached, tk.backward_substitution
    before = (dict(fwd.launches), dict(bwd.launches))
    y4, t4 = fwd(card, s_idx.to(cuda_device), b4.to(cuda_device), t_init.to(cuda_device),
                 start=start, out=out)
    y_p, t_p = tk.forward_substitution_cached(fac, s_idx, b4, t_init, start=start)
    x4 = tk.backward_substitution(card, s_idx.to(cuda_device), y_p.to(cuda_device), tail=tail)
    torch.cuda.synchronize()
    # one launch each, counted as the hybrid layout's
    groups = len(tk.rhs_groups(r, tk.line_width(fac, r)))
    assert groups == 1
    assert (fwd.launches, bwd.launches) == tuple(dict(b, ht=b["ht"] + groups) for b in before)
    for got, want in ((y4[:, start:], y_p[:, start:]), (t4[:, start:], t_p[:, start:]),
                      (x4, tk.backward_substitution(fac, s_idx, y_p, tail=tail))):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))
    assert bool((y4[:, :start] == 7.0).all()) and bool((t4[:, :start] == -7.0).all())


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 8, 12, 16])
def test_fused_sweep_matches_plain(cuda_device, r):
    """The 3-slab double-sweep preconditioner on banded+tail pivots, built on
    the CPU and moved to the card: one ``gs_sweep`` is one launch of each
    fused kernel at every r (r = 3 padded to four, 5 to eight, 12 to
    sixteen) and agrees
    with the plain fused sweep on the CPU and with the per-slab sweep (the
    hybrid passes) on the card."""
    problem = plasma2d.build_problem(h=1 / 40, n_subdomains=3, double_sweep=True,
                                     pivot_dtype="pallas_banded_tail", pivot_band=21,
                                     dtype=torch.complex64, device="cpu")
    slabs_cpu = problem.precond.slabs
    slabs = move_to(slabs_cpu, cuda_device)
    rng = np.random.default_rng(r)
    shape = (problem.grid.size,) if r == 1 else (problem.grid.size, r)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    fwd = tk.forward_substitution_cached
    before = (sk.sweep_down.launches, sk.sweep_up.launches, fwd.launches["ht"])
    got = sweeps.gs_sweep(slabs, torch.as_tensor(b, device=cuda_device))
    torch.cuda.synchronize()
    groups = len(tk.rhs_groups(r, tk.line_width(slabs.pfac, r, inject=True)))
    assert groups == 1
    assert (sk.sweep_down.launches, sk.sweep_up.launches, fwd.launches["ht"]) == (
        before[0] + groups, before[1] + groups, before[2])
    want = sweeps.gs_sweep(slabs_cpu, torch.as_tensor(b))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))
    per_slab = sweeps._gs_sweep_per_slab(slabs, torch.as_tensor(b, device=cuda_device))
    torch.testing.assert_close(got, per_slab, rtol=0, atol=TOL * float(per_slab.abs().max()))


@pytest.mark.parametrize("r", [2, 4, 8, 16])
def test_fused_sweep_injects_at_a_carry_free_line(cuda_device, r):
    """Injections at lines whose step takes no carry from the step before:
    the down sweep's top trace line at line 0 of each slab (l0 = 0), and the
    up sweep's second bottom injection at the first line of its resumed
    forward pass (trace tail m - ln, so ln = m - tt); the wide step forms
    such a line's w itself, from trace rows that other CTAs stored.  The
    other two injections of each direction follow a carried step.  801 lanes
    (one CTA a tile), windows of width 41, a backward tail that reaches into
    the head; against the plain sweeps, one launch each."""
    rng = np.random.default_rng(40 + r)
    S, m, n = 3, 20, 801
    fac = _hybrid_on_card(rng, S, m, n, 41, 6, cuda_device)
    ln = 13
    tt = m - ln
    meta = torch.tensor([[0, 0, 0], [0, 1, 1], [ln, ln, 0], [ln + 1, ln + 1, 0],
                         [0, 1, 1], [1, 1, 0]], dtype=torch.int32, device=cuda_device)
    b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (S, m, n, r)), device=cuda_device))
    cpl = [torch.zeros((S, 2, 3, fac.ld), device=cuda_device) for _ in range(4)]
    for c in cpl:
        c[..., :n] = torch.as_tensor(rng.uniform(-0.2, 0.2, (S, 2, 3, n)).astype(np.float32))
    before = (sk.sweep_down.launches, sk.sweep_up.launches)
    down = sk.sweep_down(fac, meta, b4, cpl[0], cpl[1], tt)
    u4 = sk.sweep_up(fac, meta, b4, cpl[2], cpl[3], *down, tt)
    torch.cuda.synchronize()
    assert (sk.sweep_down.launches, sk.sweep_up.launches) == (before[0] + 1, before[1] + 1)
    want = sk.sweep_down_plain(fac, meta, b4, cpl[0], cpl[1], tt)
    for got, ref in zip(down, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=TOL * float(ref.abs().max()))
    want = sk.sweep_up_plain(fac, meta, b4, cpl[2], cpl[3], *down, tt)
    torch.testing.assert_close(u4, want, rtol=0, atol=TOL * float(want.abs().max()))


@pytest.mark.parametrize("entry", ["forward", "backward", "down", "up"])
def test_hybrid_wrappers_raise_instead_of_falling_back(cuda_device, entry, monkeypatch):
    """A CUDA tensor never reaches a plain version (each raises here):
    seventeen right-hand sides run as two launches of the kernel (sixteen,
    and one)."""
    def boom(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("forward_substitution_cached_plain", "backward_substitution_plain"):
        monkeypatch.setattr(tk, name, boom)
    monkeypatch.setattr(sk, "sweep_down_plain", boom)
    monkeypatch.setattr(sk, "sweep_up_plain", boom)
    rng = np.random.default_rng(4)
    fac = move_to(_random_hybrid(rng, 3, 8, 24, width=5, tail_lines=3), cuda_device)
    rows = torch.zeros((3, 8, 2 * (tk.MAX_RHS + 1), fac.ld), device=cuda_device)
    s_idx = fac.slab_ids
    meta = torch.tensor([[0, 1, 1], [0, 2, 2], [5, 5, 0], [6, 6, 0], [0, 1, 1], [1, 1, 0]],
                        dtype=torch.int32, device=cuda_device)
    cpl = torch.zeros((3, 2, 3, fac.ld), device=cuda_device)
    calls = {"forward": lambda: tk.forward_substitution_cached(fac, s_idx, rows),
             "backward": lambda: tk.backward_substitution(fac, s_idx, rows),
             "down": lambda: sk.sweep_down(fac, meta, rows, cpl, cpl, 4),
             "up": lambda: sk.sweep_up(fac, meta, rows, cpl, cpl, rows, rows,
                                       rows[:, 0].contiguous(), 4)}
    count = {"forward": lambda: tk.forward_substitution_cached.launches["ht"],
             "backward": lambda: tk.backward_substitution.launches["ht"],
             "down": lambda: sk.sweep_down.launches, "up": lambda: sk.sweep_up.launches}[entry]
    before = count()
    out = calls[entry]()
    torch.cuda.synchronize()
    assert count() == before + 2
    for t in out if isinstance(out, tuple) else (out,):
        assert t.shape[-2:] == (2 * (tk.MAX_RHS + 1), fac.ld) and bool(torch.isfinite(t).all())


BANDED_TAIL = 22                 # the sweeps' trace tail: it reaches into the head


@pytest.fixture(scope="module")
def banded():
    """Banded+tail factors at the 801^2 solve's width for the backward pass
    (row 7): w = 201 (half = 100), 16 slabs, fewer lines than the solve's 70
    (10 of them dense), built on the card once for the tests below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the substitution kernels have no CPU mode")
    return _hybrid_on_card(np.random.default_rng(70), 16, 30, 801, 201, 10,
                           torch.device("cuda", 0))


def _banded_rows(fac, batch, r, seed):
    rng = np.random.default_rng(seed)
    y4 = torch.zeros((batch, fac.m, 2 * r, fac.ld), device=fac.lband.device)
    y4[..., :fac.n] = torch.as_tensor(rng.standard_normal((batch, fac.m, 2 * r, fac.n))
                                      .astype(np.float32), device=y4.device)
    return y4


def _banded_batch(fac, batch):
    """One inner slab (B = 1) or every slab in order (B = 16, ``jacobi_sweep``)."""
    return fac.slab_ids[8:9] if batch == 1 else fac.slab_ids


@pytest.mark.parametrize("r", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("tail", [0, BANDED_TAIL])
@pytest.mark.parametrize("batch", [1, 16])
def test_banded_backward_matches_plain(banded, r, tail, batch):
    """The backward pass on banded+tail pivots at the 801^2 solve's width,
    full and over the last 22 lines (across into the head windows), one inner
    slab and all 16 (several tiles a CTA), against its plain version; one
    launch each (r = 3 padded to four, 12 to sixteen), counted as the hybrid
    layout's."""
    fac = banded
    s_idx = _banded_batch(fac, batch)
    y4 = _banded_rows(fac, batch, r, 10 * r + tail + batch)
    before = tk.backward_substitution.launches["ht"]
    x4 = tk.backward_substitution(fac, s_idx, y4, tail=tail)
    torch.cuda.synchronize()
    assert tk.backward_substitution.launches["ht"] == before + 1
    want = tk.backward_substitution_ht_plain(fac, s_idx, y4, tail)
    assert x4.shape == want.shape == (batch, tail or fac.m, 2 * r, fac.ld)
    torch.testing.assert_close(x4, want, rtol=0, atol=TOL * float(want.abs().max()))


@pytest.mark.parametrize("batch,r,tail", [(1, 1, 0), (1, 2, BANDED_TAIL), (16, 2, 0),
                                         (1, 8, BANDED_TAIL), (16, 8, 0), (16, 4, 0),
                                         (1, 16, BANDED_TAIL), (16, 16, 0)])
def test_banded_backward_is_bit_identical_across_repeats(banded, batch, r, tail):
    """No race in the handoff of the banded backward pass: 20 launches give
    the same bits (no sum depends on timing; there is no atomic)."""
    fac = banded
    s_idx = _banded_batch(fac, batch)
    y4 = _banded_rows(fac, batch, r, 3)
    first = tk.backward_substitution(fac, s_idx, y4, tail=tail)
    for i in range(19):
        assert torch.equal(tk.backward_substitution(fac, s_idx, y4, tail=tail), first), i


def test_banded_backward_after_the_flags_wrap(banded):
    """A launch whose flags would pass the 32-bit limit: the wrapper zeroes the
    exchange buffer (which holds the words of the launches before, flags and
    all) and starts again at flag 1; the pass is right."""
    fac = banded
    s_idx = _banded_batch(fac, 1)
    y4 = _banded_rows(fac, 1, 2, 5)
    want = tk.backward_substitution_ht_plain(fac, s_idx, y4)
    tk.backward_substitution(fac, s_idx, y4)
    ex = tk.exchange_for(y4)
    ex.next = tk.FLAG_LIMIT - 3                  # fewer flags left than lines
    x4 = tk.backward_substitution(fac, s_idx, y4)
    torch.cuda.synchronize()
    assert ex.next == 1 + fac.m
    torch.testing.assert_close(x4, want, rtol=0, atol=TOL * float(want.abs().max()))


@pytest.mark.parametrize("fault", ["int8_scales", "tail_start_at_m", "epoch_zero",
                                   "epoch_wraps"])
def test_banded_backward_refuses_bad_arguments(banded, fault):
    """The launcher refuses banded arguments it cannot run before a launch
    (cudaErrorInvalidValue = 1): int8 scales beside head windows, a tail that
    starts at or past the last line, and a first flag that is 0 or whose
    lines would wrap."""
    from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build

    fac = banded
    s_idx = _banded_batch(fac, 1)
    y4 = _banded_rows(fac, 1, 1, 6)
    x4 = torch.empty_like(y4)
    xchg, epoch = tk.exchange_for(y4).take(1, 1, fac.ld, fac.m, slots=fac.m)
    scale = torch.ones(16, device=y4.device)
    tail_start = fac.m if fault == "tail_start_at_m" else fac.tail_start
    epoch = {"epoch_zero": 0, "epoch_wraps": tk.FLAG_LIMIT - 2}.get(fault, epoch)
    err = cuda_build.load("thomas_bwd")(
        y4.data_ptr(), fac.uband.data_ptr(), fac.head_re.data_ptr(), fac.head_im.data_ptr(),
        fac.tail_re.data_ptr(), fac.tail_im.data_ptr(),
        scale.data_ptr() if fault == "int8_scales" else 0, s_idx.data_ptr(), x4.data_ptr(),
        1, fac.m, fac.n, fac.ld, 1, fac.m, tail_start, fac.half, xchg.data_ptr(), 0, epoch,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1


# ---------------------------------------------------------------------------
# The int8 mode of the line kernels, and the stencil matvec
# ---------------------------------------------------------------------------


def _random_int8_factors(rng, S, m, n, device):
    """Contracting random factors (||C|| ||band|| < 1), quantized on the card
    by the port's own packing into the int8 line layout."""
    ld = tk._round_up(n, tk.LEAD_MULTIPLE)
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))

    def plane(diag):
        p = (0.1 / n ** 0.5) * torch.randn((S * m, n, n), generator=g, device=device)
        p += diag * torch.eye(n, device=device)
        q, sc = tk.quantize_planes(p, ld)
        return q.reshape((S, m) + q.shape[1:]), sc.reshape((S, m) + sc.shape[1:])

    (qre, sre), (qim, sim) = plane(0.2), plane(0.0)
    bands = [torch.zeros((S, m, 2, 3, ld), device=device) for _ in range(2)]
    for b in bands:
        b[..., :n] = torch.as_tensor(rng.uniform(-0.2, 0.2, (S, m, 2, 3, n)).astype(np.float32))
    return tk.ThomasFactorization(qre, qim, *bands, n, scale=tk.tile_scales(sre, sim))


@pytest.mark.parametrize("n", [45, 300])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_int8_line_passes_match_plain(cuda_device, n, r):
    """The three passes on int8 planes (one scale block at n = 45; two full
    blocks and a partial one at n = 300): forward from a start, cached forward
    from a carry with its stacks written in place, backward full and
    truncated; counted as int8 launches (r = 3: one launch each, padded to
    four)."""
    rng = np.random.default_rng(n + r)
    m = 9
    fac = _random_int8_factors(rng, 2, m, n, cuda_device)
    cpu = move_to(fac, "cpu")
    s_idx = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (2, m, n, r)), device=cuda_device))
    t0 = b4[:, 3].contiguous()
    fns = (tk.forward_substitution, tk.forward_substitution_cached, tk.backward_substitution)
    before = [dict(f.launches) for f in fns]
    y4 = tk.forward_substitution(fac, s_idx, b4, start=2)
    out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
    yc, tc = tk.forward_substitution_cached(fac, s_idx, b4, t0, start=4, out=out)
    x4 = tk.backward_substitution(fac, s_idx, y4)
    x4t = tk.backward_substitution(fac, s_idx, y4, tail=3)
    torch.cuda.synchronize()
    groups = len(tk.rhs_groups(r, tk.line_width(fac, r)))
    assert [f.launches for f in fns] == [
        dict(b, int8=b["int8"] + k * groups) for b, k in zip(before, (1, 1, 2))]
    s_cpu = s_idx.cpu()
    y_p = tk.forward_substitution(cpu, s_cpu, b4.cpu(), start=2)
    yc_p, tc_p = tk.forward_substitution_cached(cpu, s_cpu, b4.cpu(), t0.cpu(), start=4)
    for got, want in ((y4, y_p), (yc[:, 4:], yc_p[:, 4:]), (tc[:, 4:], tc_p[:, 4:]),
                      (x4, tk.backward_substitution(cpu, s_cpu, y4.cpu())),
                      (x4t, tk.backward_substitution(cpu, s_cpu, y4.cpu(), tail=3))):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))
    assert bool((yc[:, :4] == 7.0).all()) and bool((tc[:, :4] == -7.0).all())


# the longest lines whose stage buffers fit one CTA's shared memory on an H100,
# by storage and right-hand sides of a launch, with two CTAs a tile: the
# flag-handoff passes, the cached forward pass among them (half a line's rows
# in each of three stage buffers, with the band and 2r right-hand rows at
# r <= 2, the plane runs only at r = 4 and 8, two of them, which keep w of
# the slice and its A fragments once; the grid-barrier step took 1704 and
# 2200 at r = 2;
# a slice holds at most 1280 rows), and the fused sweeps, which keep the trace
# rows beside the carry at r = 2 (the grid-barrier step took about 1300) and
# at r = 4 and 8 run the wide step with nothing added to its shared memory;
# thomas_kernels.line_fits mirrors them
LONGEST_LINE = {("bf16", 1): 2304, ("bf16", 2): 1968, ("bf16", 4): 2560, ("bf16", 8): 1904,
                ("bf16", 16): 2032, ("int8", 1): 2560, ("int8", 2): 2448, ("int8", 4): 2560,
                ("int8", 8): 2192, ("int8", 16): 2032}
LONGEST_SWEEP_LINE = {2: 1840, 4: 2560, 8: 1904, 16: 2032}


def _zero_hybrid(length, device):
    """Zero banded+tail factors of 2 slabs of 3 lines, the last 2 dense."""
    tiles = length // 8
    head = torch.zeros((2, 1, tiles, 8, 8), dtype=torch.bfloat16, device=device)
    tail = torch.zeros((2, 2, tiles, length, 8), dtype=torch.bfloat16, device=device)
    bands = torch.zeros((2, 3, 2, 3, length), device=device)
    return tk.BandedTailFactorization(head, head, tail, tail, bands, bands, length, 0)


@pytest.mark.parametrize("entry,storage,r", [
    ("backward", "bf16", 2), ("backward", "int8", 2), ("forward_cached", "bf16", 2),
    ("forward_cached", "int8", 2), ("sweep", "bf16", 2), ("backward_ht", "bf16", 2)] + [
    (entry, storage, r) for entry in ("backward", "forward_cached")
    for storage in ("bf16", "int8") for r in (1, 4, 8, 16)] + [
    (entry, "bf16", r) for entry in ("sweep", "backward_ht") for r in (4, 8, 16)])
def test_longest_line_fits(cuda_device, entry, storage, r, monkeypatch):
    """The line-length limits of the module notes, for each launch width: the
    longest line launches once at r, one lane group more is refused before a
    launch (the flag-handoff step on two CTAs a tile: 64 + the warps' sums +
    the carry rows [+ w at r > 2] + three stage buffers, of 232448 bytes; the
    fused sweeps with the trace rows beside the carry; the backward pass on
    banded+tail pivots, a step map without the trace rows, as the cached
    forward pass; at r = 4, 8 and 16 every one of them runs the wide step,
    the same shared memory).  The Python mirror (thomas_kernels.line_fits) says
    the same; a longer line would run in narrower launches, so the wrapper
    is held to width r there: the kernel refuses it and the wrapper raises,
    with no launch of another width."""
    n = LONGEST_SWEEP_LINE[r] if entry == "sweep" else LONGEST_LINE[storage, r]
    for length, fits in ((n, True), (n + tk.LEAD_MULTIPLE, False)):
        assert tk.line_fits(length, r, storage, inject=entry == "sweep") == fits
        s_idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        if entry == "sweep":
            fac = _zero_hybrid(length, cuda_device)
            rows = torch.ones((2, 3, 2 * r, length), device=cuda_device)
            meta = torch.zeros((6, 2), dtype=torch.int32, device=cuda_device)
            cpl = torch.zeros((2, 2, 3, length), device=cuda_device)
            call = lambda: sk.sweep_down(fac, meta, rows, cpl, cpl, 1)[1]   # noqa: E731
            fn, key = sk.sweep_down, None
        elif entry == "backward_ht":
            fac = _zero_hybrid(length, cuda_device)
            rows = torch.ones((1, 3, 2 * r, length), device=cuda_device)
            call = lambda: tk.backward_substitution(fac, s_idx, rows)        # noqa: E731
            fn, key = tk.backward_substitution, "ht"
        else:
            dtype = torch.bfloat16 if storage == "bf16" else torch.int8
            planes = torch.zeros((1, 1, length // 8, length, 8), dtype=dtype, device=cuda_device)
            bands = torch.zeros((1, 1, 2, 3, length), device=cuda_device)
            scale = (None if storage == "bf16" else torch.ones(
                (1, 1, length // 8, tk.n_scale_blocks(length), 2, 8), device=cuda_device))
            fac = tk.ThomasFactorization(planes, planes, bands, bands, length, scale=scale)
            rows = torch.ones((1, 1, 2 * r, length), device=cuda_device)
            call = ((lambda: tk.backward_substitution(fac, s_idx, rows)) if entry == "backward"
                    else (lambda: tk.forward_substitution_cached(fac, s_idx, rows)[1]))
            fn = (tk.backward_substitution if entry == "backward"
                  else tk.forward_substitution_cached)
            key = storage
        before = fn.launches if key is None else fn.launches[key]
        if fits:
            x = call()
            torch.cuda.synchronize()
            assert not x.any()
            assert (fn.launches if key is None else fn.launches[key]) == before + 1
        else:
            monkeypatch.setattr(tk, "line_width", lambda fac, r, inject=False: r)
            with pytest.raises(ValueError, match="too long"):
                call()
            monkeypatch.undo()
            assert (fn.launches if key is None else fn.launches[key]) == before


# ---------------------------------------------------------------------------
# The flag-handoff step of the dense forward and backward passes
# ---------------------------------------------------------------------------


def _factors_of(storage, rng, S, m, n, device):
    return (_random_factors if storage == "bf16" else _random_int8_factors)(rng, S, m, n, device)


@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("n", [801, 1700])
def test_flow_passes_match_plain(cuda_device, storage, r, batch, n):
    """The forward pass from a start and the backward pass, full and
    truncated, at the main path's width (n = 801: one CTA a tile, its rows in
    two groups; at 16 batch rows 1616 tiles, several a CTA, which share their
    carry and w) and on a line too long for one CTA (n = 1700: two CTAs a
    tile, the halves added by the consumer), batch rows picking slabs out of
    order; r = 3 (padded to four), 4, 8, 12 (padded to sixteen) and 16 in one
    launch each (at n = 801 one CTA a tile, at 1700 two)."""
    rng = np.random.default_rng(100 * batch + 10 * r + (storage == "int8") + n)
    S, m = 3, 6
    fac = _factors_of(storage, rng, S, m, n, cuda_device)
    cpu = move_to(fac, "cpu")
    s_idx = torch.as_tensor((np.arange(batch) * 2 + 1) % S, dtype=torch.int32, device=cuda_device)
    b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (batch, m, n, r), start=2),
                                            device=cuda_device))
    fns = (tk.forward_substitution, tk.backward_substitution)
    before = [f.launches[storage] for f in fns]
    y4 = tk.forward_substitution(fac, s_idx, b4, start=2)
    x4 = tk.backward_substitution(fac, s_idx, y4)
    x4t = tk.backward_substitution(fac, s_idx, y4, tail=3)
    torch.cuda.synchronize()
    groups = len(tk.rhs_groups(r, tk.line_width(fac, r)))
    assert groups == 1
    assert [f.launches[storage] for f in fns] == [before[0] + groups, before[1] + 2 * groups]
    s_cpu, y_cpu = s_idx.cpu(), y4.cpu()
    assert not y_cpu[:, :2].any()
    for got, want in ((y4, tk.forward_substitution(cpu, s_cpu, b4.cpu(), start=2)),
                      (x4, tk.backward_substitution(cpu, s_cpu, y_cpu)),
                      (x4t, tk.backward_substitution(cpu, s_cpu, y_cpu, tail=3))):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))


def test_flow_passes_are_bit_identical_across_repeats(cuda_device):
    """No race in the carry's handoff: 100 back-to-back pass pairs, the shape
    (one and two CTAs a tile), the storage and r changing from one to the next
    and a cached forward pass (the step-map body) between them, each the
    same bits as the first run at its shape (no sum depends on timing: there
    is no atomic in any)."""
    rng = np.random.default_rng(7)
    cases = []
    # the narrow step (r = 1, 2), then the wide one (r = 4, 8, 16) on one and
    # on two CTAs a tile
    for storage, batch, n, r in (("bf16", 1, 801, 1), ("int8", 16, 300, 2), ("bf16", 4, 801, 2),
                                 ("int8", 1, 801, 1), ("bf16", 16, 120, 1), ("bf16", 2, 1700, 2),
                                 ("int8", 1, 1700, 1), ("bf16", 1, 801, 8), ("int8", 16, 300, 4),
                                 ("bf16", 2, 1700, 4), ("int8", 1, 1700, 8), ("bf16", 1, 801, 16),
                                 ("int8", 2, 1700, 16)):
        fac = _factors_of(storage, rng, 2, 9, n, cuda_device)
        s_idx = torch.as_tensor(np.arange(batch) % 2, dtype=torch.int32, device=cuda_device)
        b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (batch, 9, n, r)), device=cuda_device))
        cases.append((fac, s_idx, b4))
    other = cases[2]
    first = {}
    for i in range(170):
        k = i % len(cases)
        fac, s_idx, b4 = cases[k]
        y4 = tk.forward_substitution(fac, s_idx, b4, start=i % 3)
        x4 = tk.backward_substitution(fac, s_idx, y4, tail=0 if i % 2 else 5)
        tk.forward_substitution_cached(other[0], other[1], other[2])
        key = (k, i % 3, i % 2)
        if key not in first:
            first[key] = (y4, x4)
        else:
            assert torch.equal(y4, first[key][0]) and torch.equal(x4, first[key][1]), (i, key)
    torch.cuda.synchronize()
    assert len(first) == 78      # each of 78 shapes and modes held twice or more


def _longest_line(storage, r, split):
    """The longest line the line kernels take at width r with ``split`` CTAs
    a tile (thomas_kernels.line_smem_bytes, the mirror of the kernels'
    sizing; test_longest_line_fits holds the two-CTA ones to the card)."""
    rows = 3 * 512 if split == 1 else 5 * 256
    return max(ld for ld in range(8, 4096, 8)
               if tk.line_smem_bytes(ld, r, storage, split) <= tk.SMEM_PER_BLOCK
               and tk._slice_rows(ld, split) <= rows)


@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("r", [4, 8, 16])
@pytest.mark.parametrize("n,batch", [(401, 1), (401, 16), (801, 1), (801, 16), ("one", 1),
                                     ("two", 1)])
def test_wide_line_step_matches_plain(cuda_device, storage, r, n, batch):
    """The wide step (r = 4, 8, 16) of the dense line kernels against the plain
    versions, to 1e-4 of the max-norm: the forward pass from a start, the
    backward pass whole and over its last lines, and the cached forward pass
    from a carry at line 48, one launch each, on bf16 and int8 planes, at one
    and sixteen batch rows (several tiles a CTA, slabs out of order) of 401
    and 801 lanes, and at the longest lines of one CTA a tile and of two."""
    if n in ("one", "two"):
        n = _longest_line(storage, r, 1 if n == "one" else 2)
    rng = np.random.default_rng(1000 * r + 10 * batch + (storage == "int8") + n)
    S, m, start = 2, 52, 48
    fac = _factors_of(storage, rng, S, m, n, cuda_device)
    cpu = move_to(fac, "cpu")
    assert tk.line_width(fac, r) == r
    s_idx = torch.as_tensor((np.arange(batch) + 1) % S, dtype=torch.int32, device=cuda_device)
    b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (batch, m, n, r), start=2),
                                            device=cuda_device))
    t_init = torch.zeros((batch, 2 * r, fac.ld), device=cuda_device)
    t_init[..., :n] = torch.as_tensor(rng.standard_normal((batch, 2 * r, n)).astype(np.float32))
    fns = (tk.forward_substitution, tk.backward_substitution, tk.forward_substitution_cached)
    before = [f.launches[storage] for f in fns]
    y4 = tk.forward_substitution(fac, s_idx, b4, start=2)
    x4 = tk.backward_substitution(fac, s_idx, y4)
    x4t = tk.backward_substitution(fac, s_idx, y4, tail=3)
    out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
    yc, tc = tk.forward_substitution_cached(fac, s_idx, b4, t_init, start=start, out=out)
    torch.cuda.synchronize()
    assert [f.launches[storage] for f in fns] == [before[0] + 1, before[1] + 2, before[2] + 1]
    s_cpu, y_cpu, b_cpu = s_idx.cpu(), y4.cpu(), b4.cpu()
    assert not y_cpu[:, :2].any()
    yc_p, tc_p = tk.forward_substitution_cached(cpu, s_cpu, b_cpu, t_init.cpu(), start=start)
    for got, want in ((y4, tk.forward_substitution(cpu, s_cpu, b_cpu, start=2)),
                      (x4, tk.backward_substitution(cpu, s_cpu, y_cpu)),
                      (x4t, tk.backward_substitution(cpu, s_cpu, y_cpu, tail=3)),
                      (yc[:, start:], yc_p[:, start:]), (tc[:, start:], tc_p[:, start:])):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))
    assert bool((yc[:, :start] == 7.0).all()) and bool((tc[:, :start] == -7.0).all())


def _hybrid_on_card(rng, S, m, n, width, tail_lines, device):
    """Contracting random banded+tail factors, built on the card."""
    def cplx(shape, scale):
        return scale * torch.complex(*(torch.as_tensor(
            rng.standard_normal(shape).astype(np.float32), device=device) for _ in range(2)))

    cinv = cplx((S, m, n, n), 0.1 / np.sqrt(n)) + 0.2 * torch.eye(n, device=device)
    bands = [cplx((S, m, n, 3), 0.1) for _ in range(2)]
    fac = direct.BlockTridiagFactorization(cinv=cinv, lband=bands[0], uband=bands[1])
    return tk.build_banded_tail_factorization(fac, width=width, tail_lines=tail_lines)


def test_map_kernels_are_bit_identical_across_repeats(cuda_device):
    """No race in the step-map kernels (the cached forward pass and the fused
    sweeps on the flag-handoff step): 100 rounds of a down/up fused pair and
    cached forward launches on bf16, int8 and banded+tail pivots, the shape
    changing from one round to the next, among them a narrow window on a wide
    line (width 9 at n = 801: a head tile reads 3 tiles' carry, so CTAs at the
    two ends of a line run far apart), the wide step of the sweeps at r = 4,
    8 and 16 and of the hybrid forward pass at r = 8 and 16; every output the
    same bits as the first run at its shape."""
    rng = np.random.default_rng(8)
    sweeps_ = []
    for S, m, n, width, tail_lines, r in ((3, 20, 801, 9, 6, 1), (4, 16, 301, 41, 5, 2),
                                          (3, 12, 45, 9, 4, 1), (4, 16, 801, 41, 5, 8),
                                          (3, 12, 801, 9, 4, 4), (3, 12, 801, 41, 4, 16)):
        fac = _hybrid_on_card(rng, S, m, n, width, tail_lines, cuda_device)
        tt = tail_lines + 2              # the backward tail reaches into the head
        ln = m - tt + 1
        meta = torch.tensor([[0] + [2] * (S - 1), [0] + [3] * (S - 1),
                             [ln] * (S - 1) + [0], [ln + 1] * (S - 1) + [0],
                             [0] + [1] * (S - 1), [1] * (S - 1) + [0]],
                            dtype=torch.int32, device=cuda_device)
        b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (S, m, n, r)), device=cuda_device))
        cpl = [torch.zeros((S, 2, 3, fac.ld), device=cuda_device) for _ in range(4)]
        for c in cpl:
            c[..., :n] = torch.as_tensor(rng.uniform(-0.1, 0.1, (S, 2, 3, n)).astype(np.float32))
        sweeps_.append((fac, meta, b4, cpl, tt))
    passes = []
    for storage, batch, n, r in (("bf16", 1, 801, 1), ("int8", 16, 300, 2), ("bf16", 2, 1700, 2)):
        fac = _factors_of(storage, rng, 2, 70, n, cuda_device)
        s_idx = torch.as_tensor(np.arange(batch) % 2, dtype=torch.int32, device=cuda_device)
        b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (batch, 70, n, r)), device=cuda_device))
        passes.append((fac, s_idx, b4))
    hybrid = sweeps_[0][0]
    hb4 = sweeps_[0][2]
    hybrid8, hb8 = sweeps_[3][0], sweeps_[3][2]
    hybrid16, hb16 = sweeps_[5][0], sweeps_[5][2]
    first = {}
    for i in range(100):
        k = i % len(sweeps_)
        fac, meta, b4, cpl, tt = sweeps_[k]
        down = sk.sweep_down(fac, meta, b4, cpl[0], cpl[1], tt)
        u4 = sk.sweep_up(fac, meta, b4, cpl[2], cpl[3], *down, tt)
        p = i % len(passes)
        pf, ps, pb = passes[p]
        start = 48 if i % 2 else 0
        y_c, t_c = tk.forward_substitution_cached(pf, ps, pb, pb[:, 3].contiguous(), start=start)
        y_h, t_h = tk.forward_substitution_cached(hybrid, hybrid.slab_ids, hb4)
        y_8, t_8 = tk.forward_substitution_cached(hybrid8, hybrid8.slab_ids, hb8)
        y_16, t_16 = tk.forward_substitution_cached(hybrid16, hybrid16.slab_ids, hb16)
        outs = {("sweep", k): down + (u4,), ("cached", p, start): (y_c, t_c), ("ht",): (y_h, t_h),
                ("ht8",): (y_8, t_8), ("ht16",): (y_16, t_16)}
        for key, got in outs.items():
            if key not in first:
                first[key] = got
            else:
                assert all(torch.equal(a, b) for a, b in zip(got, first[key])), (i, key)
    torch.cuda.synchronize()
    assert len(first) == 6 + 6 + 3


@pytest.mark.parametrize("shape", [(41, 41), (31, 45), (801, 801)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_stencil_matvec_matches_plain(cuda_device, shape, dtype, monkeypatch):
    """The stencil kernel against its plain version on random fields, flat
    and gridded u, one launch a call; a complex128 field comes back in
    complex128 at complex64 accuracy; no plain version runs for a CUDA
    tensor."""
    m, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(m * n)
    values = torch.randn((m, n, 3, 3), dtype=dtype, generator=g, device=cuda_device)
    u = torch.randn((m * n,), dtype=dtype, generator=g, device=cuda_device)
    want = stencil_kernels.stencil_matvec_2d_plain(values.cpu(), u.cpu())
    monkeypatch.setattr(stencil_kernels, "stencil_matvec_2d_plain", None)
    before = stencil_kernels.stencil_matvec_2d.launches
    got = stencil_kernels.stencil_matvec_2d(values, u)
    got2 = stencil_kernels.stencil_matvec_2d(values, u.reshape(m, n))
    torch.cuda.synchronize()
    assert stencil_kernels.stencil_matvec_2d.launches == before + 2
    assert got.dtype == dtype and tuple(got.shape) == (m * n,) and tuple(got2.shape) == (m, n)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=TOL * float(want.abs().max()))
    assert torch.equal(got2.reshape(-1), got)
