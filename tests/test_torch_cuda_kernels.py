"""The CUDA substitution kernels against their plain PyTorch versions.

These tests need a CUDA card and ``nvcc`` (a CUDA kernel has no CPU mode) and
skip without them.  They import nothing of the JAX package, so they run on a
machine that has only the port's dependencies::

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

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
    before = (tk.forward_substitution.launches, tk.backward_substitution.launches)
    got = tk.solve_all(fac, [1, 0], torch.as_tensor(b, device=cuda_device), start=start, tail=tail)
    assert tk.forward_substitution.launches == before[0] + 1
    assert tk.backward_substitution.launches == before[1] + 1
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


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("start,carry", [(0, False), (0, True), (4, True)])
def test_cached_forward_matches_plain(cuda_device, r, start, carry):
    """y and t stacks, a carry in (also at start = 0), lines above the start
    left alone; one launch per call."""
    rng = np.random.default_rng(10 * r + start)
    m, n, batch = 9, 45, 2
    fac = _random_factors(rng, 2, m, n, cuda_device)
    b4 = tk._to_rows_b(fac, torch.as_tensor(_rhs(rng, (batch, m, n, r)), device=cuda_device))
    s_idx = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    t_init = None
    if carry:
        t_init = torch.zeros((batch, 2 * r, fac.ld), device=cuda_device)
        t_init[..., :n] = torch.as_tensor(rng.standard_normal((batch, 2 * r, n)).astype(np.float32))
    out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
    before = tk.forward_substitution_cached.launches
    y4, t4 = tk.forward_substitution_cached(fac, s_idx, b4, t_init, start=start, out=out)
    torch.cuda.synchronize()
    assert tk.forward_substitution_cached.launches == before + 1
    y_p, t_p = tk.forward_substitution_cached(
        _to_cpu(fac), s_idx.cpu(), b4.cpu(), None if t_init is None else t_init.cpu(), start=start)
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


@pytest.mark.parametrize("entry", ["forward", "forward_cached", "backward", "solve_all"])
def test_too_many_right_hand_sides_raise(cuda_device, entry):
    """What the kernels do not take raises instead of falling back."""
    rng = np.random.default_rng(0)
    fac = _random_factors(rng, 1, 4, 24, cuda_device)
    r = tk.MAX_RHS + 1
    s_idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    rows = torch.zeros((1, 4, 2 * r, fac.ld), device=cuda_device)
    with pytest.raises(ValueError, match="right-hand sides"):
        if entry == "forward":
            tk.forward_substitution(fac, s_idx, rows)
        elif entry == "forward_cached":
            tk.forward_substitution_cached(fac, s_idx, rows)
        elif entry == "backward":
            tk.backward_substitution(fac, s_idx, rows)
        else:
            tk.solve_all(fac, [0], torch.as_tensor(_rhs(rng, (1, 4, 24, r)), device=cuda_device))


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
    before = fn.launches
    with pytest.raises(ValueError, match="too long"):
        fn(fac, s_idx, rows)
    assert fn.launches == before
