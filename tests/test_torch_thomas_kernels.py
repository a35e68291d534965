"""The port's bf16 substitution module against the JAX package's Pallas
kernels (run in interpret mode) on the SAME carried-over factors.

On the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``).
"""


import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
from fast_solver_lippmann_schwinger_tpu.sparse import pallas_thomas as jpt
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix2D as JStencilMatrix2D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

M, N = 6, 13      # N is not a multiple of 8: the ragged edge is exercised


def _bits(x):
    """A JAX bfloat16 array as numpy uint16 bit patterns."""
    return np.asarray(x).view(np.uint16)


def _carry_over(jpf, device="cpu"):
    return convert.thomas_factorization(
        _bits(jpf.cinv_t_re), _bits(jpf.cinv_t_im), np.asarray(jpf.lband),
        np.asarray(jpf.uband), np.asarray(jpf.scale), jpf.n, device=device,
    )


@pytest.fixture(scope="module", params=[1, 2], ids=["S1", "S2"])
def factors(request):
    S = request.param
    rng = np.random.default_rng(S)
    v = rng.standard_normal((S, M, N, 3, 3)) + 1j * rng.standard_normal((S, M, N, 3, 3))
    v[..., 1, 1] += 8.0
    jf = jax.vmap(lambda w: jdirect.factor_stencil_2d(JStencilMatrix2D(values=w)))(jnp.asarray(v))
    jpf = jpt.build_pallas_factorization(jf)
    tf = direct.factor_stencil_values(torch.as_tensor(v))
    return S, jf, jpf, tf


def test_layout_is_bit_equal(factors):
    """Same rounding chain complex -> f32 -> bf16: the planes built by the
    port equal the carried-over ones bit for bit, at the port's own leading
    dimension with zero padding."""
    S, _, jpf, tf = factors
    built = tk.build_thomas_factorization(tf)
    carried = _carry_over(jpf)
    assert built.ld == carried.ld == 16 and built.n == N
    assert (built.n_slabs, built.m) == (S, M)
    jplanes = {"cinv_t_re": _bits(jpf.cinv_t_re), "cinv_t_im": _bits(jpf.cinv_t_im)}
    for name in ("cinv_t_re", "cinv_t_im"):
        a, b = getattr(built, name), getattr(carried, name)
        # tile-major: [s, j, t, i_in, l] holds Cinv^T[i_in, 8 t + l]
        assert a.dtype == torch.bfloat16 and a.shape == (S, M, 2, 16, 8)
        assert a.is_contiguous() and b.is_contiguous()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        dense = tk.dense_planes(a)
        assert dense.shape == (S, M, 16, 16)
        assert torch.equal(tk.tile_planes(dense).view(torch.int16), a.view(torch.int16))
        assert not dense[:, :, N:].any() and not dense[:, :, :, N:].any()
        # the very bits of the JAX package's planes, away from its padding
        np.testing.assert_array_equal(
            dense[:, :, :N, :N].contiguous().view(torch.int16).numpy().view(np.uint16),
            jplanes[name][:, :, :N, :N])
    assert torch.equal(built.lband, carried.lband)
    assert torch.equal(built.uband, carried.uband)
    unbatched = tk.build_thomas_factorization(tf.slab(0), batched=False)
    assert torch.equal(unbatched.cinv_t_re[0].view(torch.int16),
                       built.cinv_t_re[0].view(torch.int16))


@pytest.mark.parametrize("r", [None, 1, 2, 5, 8])
@pytest.mark.parametrize("start,tail", [(0, 0), (2, 0), (0, 3), (2, 2)])
def test_solve_all_matches_interpret_kernels(factors, r, start, tail):
    """Same factors, same f32 arithmetic; only the summation order differs:
    1e-4 of the max-norm (measured about 1e-7)."""
    S, _, jpf, _ = factors
    pf = _carry_over(jpf)
    rng = np.random.default_rng(10 * start + tail)
    shape = (2, M, N) if r is None else (2, M, N, r)
    b = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    b[:, :start] = 0
    s_idx = [S - 1, 0]       # batch rows pick slabs out of order
    want = np.asarray(jpt.solve_all(jpf, jnp.asarray(s_idx), jnp.asarray(b),
                                    start=start, tail=tail, interpret=True))
    got = tk.solve_all(pf, s_idx, torch.as_tensor(b), start=start, tail=tail)
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("r", [1, 2, 8])
def test_passes_match_interpret_kernels(factors, r):
    """The forward and the backward wrapper separately, on the row layout."""
    S, _, jpf, _ = factors
    pf = _carry_over(jpf)
    rng = np.random.default_rng(r)
    b = (rng.standard_normal((S, M, N, r)) + 1j * rng.standard_normal((S, M, N, r))).astype(np.complex64)
    s_idx = np.arange(S, dtype=np.int32)
    jb4 = jpt._to_rows_b(jpf, jnp.asarray(b))
    b4 = tk._to_rows_b(pf, torch.as_tensor(b))
    np.testing.assert_array_equal(b4.numpy()[..., :N], np.asarray(jb4)[..., :N])
    jy4 = jpt._fwd_b(jpf, jnp.asarray(s_idx), jb4, start=1, interpret=True)
    y4 = tk.forward_substitution(pf, torch.as_tensor(s_idx), b4, start=1)
    assert not y4[:, :1].any()
    np.testing.assert_allclose(y4.numpy()[:, 1:, :, :N], np.asarray(jy4)[..., :N], rtol=0, atol=1e-5)
    jy_full = jnp.concatenate([jnp.zeros_like(jy4[:, :1]), jy4], axis=1)
    jx4 = jpt._bwd_b(jpf, jnp.asarray(s_idx), jy_full, tail=4, interpret=True)
    x4 = tk.backward_substitution(pf, torch.as_tensor(s_idx), y4, tail=4)
    assert tuple(x4.shape) == (S, 4, 2 * r, pf.ld)
    np.testing.assert_allclose(x4.numpy()[..., :N], np.asarray(jx4)[..., :N], rtol=0, atol=1e-5)
    back = tk._from_rows_b(x4, N, torch.complex64, M, offset=M - 4)
    jback = jpt._from_rows_b(jx4, N, jnp.complex64, M, M - 4)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=0, atol=1e-5)


def test_solve_all_close_to_dense_solve(factors):
    """bf16 pivots carry 8 mantissa bits: within 2e-2 of the full-precision
    ``block_thomas_solve`` on these well-conditioned systems."""
    S, _, _, tf = factors
    pf = tk.build_thomas_factorization(tf)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((S, M, N, 2)) + 1j * rng.standard_normal((S, M, N, 2))
    got = tk.solve_all(pf, list(range(S)), torch.as_tensor(b))
    for s in range(S):
        want = direct.block_thomas_solve(tf.slab(s), torch.as_tensor(b[s]))
        err = (got[s] - want).abs().max() / want.abs().max()
        assert err < 2e-2


def test_wrappers_validate_and_count():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((1, M, N, 3, 3)) + 0j
    v[..., 1, 1] += 8.0
    pf = tk.build_thomas_factorization(direct.factor_stencil_values(torch.as_tensor(v)))
    s_idx = torch.zeros(1, dtype=torch.int32)
    rows = torch.zeros((1, M, 2, pf.ld))
    before = (dict(tk.forward_substitution.launches), dict(tk.backward_substitution.launches))
    tk.backward_substitution(pf, s_idx, tk.forward_substitution(pf, s_idx, rows))
    # the plain path launches no kernel, so it counts nothing
    assert (tk.forward_substitution.launches, tk.backward_substitution.launches) == before
    with pytest.raises(ValueError):
        tk.forward_substitution(pf, s_idx, rows.double())
    with pytest.raises(ValueError):
        tk.forward_substitution(pf, s_idx.long(), rows)
    with pytest.raises(ValueError):
        tk.forward_substitution(pf, s_idx, rows, start=M)
    with pytest.raises(ValueError):
        tk.backward_substitution(pf, s_idx, rows[..., :-1].contiguous())
    with pytest.raises(ValueError, match="storage"):
        tk.build_thomas_factorization(direct.factor_stencil_values(torch.as_tensor(v)), storage="int4")
    # int8 planes need their scales, of the layout's shape
    p8 = tk.build_thomas_factorization(direct.factor_stencil_values(torch.as_tensor(v)),
                                       storage="int8")
    for bad in (None, p8.scale[..., :1, :].contiguous()):
        with pytest.raises(ValueError):
            tk.forward_substitution(dataclasses.replace(p8, scale=bad), s_idx, rows)


def test_exchange_hands_out_fresh_flags():
    """The exchange of the flag-handoff passes (``tk.Exchange``): a ring of
    four lines of (B, ld, 2r, 2 halves) 8-byte words, zero when made; each
    launch gets ``lines`` flags that no earlier launch on the buffer used,
    never 0; a launch that needs more words gets a new zeroed buffer and the
    counter starts again at 1, and so it does, after zeroing, where the flags
    would pass 32 bits."""
    ex = tk.Exchange("cpu")
    words, epoch = ex.take(1, 1, 808, 801)
    assert epoch == 1 and words.dtype == torch.int32
    assert words.numel() == 2 * tk.Exchange.values(1, 1, 808) == 2 * (4 * 1 * 808 * 2 * 2)
    assert not words.any()
    assert ex.take(1, 1, 808, 801) == (words, 802)
    words[:] = 7                                     # as launches leave it
    same, epoch = ex.take(1, 1, 400, 5)              # fewer words: the same buffer
    assert same is words and epoch == 1603
    bigger, epoch = ex.take(16, 2, 808, 70)          # more words: a new one
    assert bigger.numel() == 2 * (4 * 16 * 808 * 2 * 4) and not bigger.any() and epoch == 1
    ex.next = tk.FLAG_LIMIT - 10                     # the last flags of 32 bits
    bigger[:] = 7
    assert ex.take(16, 2, 808, 10)[1] == tk.FLAG_LIMIT - 10 and bigger.all()
    assert ex.take(16, 2, 808, 1) == (bigger, 1) and not bigger.any()
    assert ex.next == 2


def _slice_rows(ld, split):
    """Rows of the largest slice of a tile's input rows with ``split`` CTAs a
    tile (``csrc/thomas_flow.cuh``, ``slice_rows``)."""
    return 8 * -(-(ld // 8) // split)


@pytest.mark.parametrize("n,r,tt", [(801, 1, 22), (801, 2, 22), (1300, 2, 8), (45, 1, 5),
                                    (801, 8, 22)])
def test_step_maps_get_a_slot_per_step_and_private_lines(n, r, tt):
    """The cached forward pass and the fused sweeps at r = 1, 2 (``run_flow``)
    take one exchange slot per line step, so that no slot is written twice in
    a launch: the launch's flags are fresh and its words fit the buffer; the
    dense passes' ring of four slots then fits the same buffer.  The fused
    sweeps at r = 4, 8 (the wide step, every step waiting on the one before)
    take that ring too, and its rows buffer of four slots.  The fused sweeps'
    scratch holds every CTA's private y lines, ``tt`` lines of its slice's
    rows, with one CTA a tile and with two."""
    from fast_solver_lippmann_schwinger_tpu_torch.sparse import sweep_kernels as sk

    ld = tk._round_up(n, tk.LEAD_MULTIPLE)
    fac = types.SimpleNamespace(n=n, ld=ld, m=70, n_slabs=16)    # the shapes they read
    steps = sk.steps(fac, tt)
    assert steps == 16 * (70 + tt)
    slots = sk.exchange_slots(fac, tt, r)
    assert slots == (steps if r <= 2 else tk.EXCHANGE_LINES)
    ex = tk.Exchange("cpu")
    words, epoch = ex.take(1, r, ld, steps, slots=slots)
    assert epoch == 1 and not words.any()
    assert words.numel() == 2 * slots * ld * tk.LINE_HALVES * 2 * r
    rows = ex.wide_rows(1, r, ld, slots=slots)
    assert (rows is None) == (r <= 2)
    if rows is not None:
        assert rows.numel() == slots * tk.WIDE_SLOT_BYTES * r * ld // 4
    ring, epoch = ex.take(1, r, ld, 70)             # a dense pass after it: same buffer
    assert ring is words and epoch == steps + 1
    tiles = ld // tk.LEAD_MULTIPLE
    floats = sk.private_floats(fac, tt, r)
    for split in (1, 2):
        assert floats >= split * tiles * tt * 2 * r * _slice_rows(ld, split)


@pytest.mark.parametrize("batch,tail", [(1, 0), (1, 22), (2, 0), (2, 22)])
def test_banded_backward_takes_a_slot_per_line_step(batch, tail):
    """The backward pass on banded+tail pivots is a step map (``run_flow``),
    which never writes a slot twice in a launch: at r = 1, 2 it takes one
    exchange slot per line step, in full (70 lines) and over the last
    ``tail`` lines, with fresh flags and words that fit the buffer (at r = 4,
    8, the wide step, the ring of four); a dense backward pass after it takes
    the ring of four slots from the same buffer, and the next banded pass
    fresh flags again.  The 801^2 solve's shapes: 44 head lines of width 201
    and 26 dense ones (expanded zeros: only the shapes are read)."""
    S, m, n, half, head_lines, r = 16, 70, 801, 100, 44, 2
    ld = tk._round_up(n, tk.LEAD_MULTIPLE)
    tiles = ld // tk.LEAD_MULTIPLE

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((), dtype=dtype).expand(shape)

    head = zeros(S, head_lines, tiles, 8 + 2 * half, 8, dtype=torch.bfloat16)
    planes = zeros(S, m - head_lines, tiles, ld, 8, dtype=torch.bfloat16)
    bands = zeros(S, m, 2, 3, ld)
    fac = tk.BandedTailFactorization(head, head, planes, planes, bands, bands, n, half)
    dense = types.SimpleNamespace(n=n, ld=ld, m=m)
    m_eff = tail or m
    assert tk.backward_slots(fac, m_eff) == tk.backward_slots(fac, m_eff, r) == m_eff
    assert tk.backward_slots(fac, m_eff, 4) == tk.backward_slots(fac, m_eff, 8) == tk.EXCHANGE_LINES
    assert tk.backward_slots(dense, m) == tk.backward_slots(dense, m, 8) == tk.EXCHANGE_LINES
    ex = tk.Exchange("cpu")
    words, epoch = ex.take(batch, r, ld, m_eff, slots=tk.backward_slots(fac, m_eff))
    assert epoch == 1 and not words.any()
    assert words.numel() == 2 * m_eff * batch * ld * tk.LINE_HALVES * 2 * r
    ring, epoch = ex.take(batch, r, ld, m, slots=tk.backward_slots(dense, m))
    assert ring is words and epoch == 1 + m_eff
    again, epoch = ex.take(batch, r, ld, m_eff, slots=tk.backward_slots(fac, m_eff))
    assert again is words and epoch == 1 + m_eff + m


@pytest.mark.parametrize("r,width", [(5, 2), (5, 8), (8, 8), (11, 8), (8, 4)])
@pytest.mark.parametrize("case", ["rows", "tuple", "out", "one_stack"])
def test_rhs_groups_give_what_one_call_gives(factors, case, r, width):
    """``in_rhs_groups``, which runs a batch on the card as one launch a
    group of at most ``width`` columns, each padded with zero columns to a
    launch width (r = 5 as one launch of eight, r = 11 as eight and three
    padded to four), here with the CPU passes as launches: the groups' rows
    joined (``rows``), a tuple of stacks joined with a ``None`` operand
    passed through (``tuple``), stacks written back in place with the lines
    before ``start`` kept (``out``), and one stack written back
    (``one_stack``), each equal to one call on all columns; every launch
    sees a launch width of rows."""
    S, _, _, tf = factors
    pf = tk.build_thomas_factorization(tf)
    rng = np.random.default_rng(r)
    s = torch.arange(S, dtype=torch.int32)
    b4 = torch.zeros((S, M, 2 * r, pf.ld))
    b4[..., :N] = torch.as_tensor(rng.standard_normal((S, M, 2 * r, N)).astype(np.float32))
    t0 = b4[:, 1].contiguous()

    def stacks():
        return torch.full_like(b4, 7.0), torch.full_like(b4, -7.0)

    widths = []

    def seen(b):
        widths.append(b.shape[-2] // 2)
        return b

    if case == "rows":
        got = tk.in_rhs_groups(lambda b: tk.forward_substitution(pf, s, seen(b), 1), r, (b4,),
                               width=width)
        want = (tk.forward_substitution(pf, s, b4, 1),)
        got = (got,)
    elif case == "tuple":
        got = tk.in_rhs_groups(
            lambda b, t: tk.forward_substitution_cached(pf, s, seen(b), t, 2), r, (b4, None),
            width=width)
        want = tk.forward_substitution_cached(pf, s, b4, None, 2)
    elif case == "out":
        out = stacks()
        got = tk.in_rhs_groups(
            lambda b, t, out: tk.forward_substitution_cached(pf, s, seen(b), t, 2, out),
            r, (b4, t0), out, width=width)
        assert got is out
        want = tk.forward_substitution_cached(pf, s, b4, t0, 2, stacks())
        assert bool((got[0][:, :2] == 7.0).all()) and bool((got[1][:, :2] == -7.0).all())
    else:
        out = torch.empty_like(b4)
        got = tk.in_rhs_groups(
            lambda y, out: out.copy_(tk.backward_substitution(pf, s, seen(y))), r, (b4,), out,
            width=width)
        assert got is out
        got, want = (got,), (tk.backward_substitution(pf, s, b4),)
    groups = tk.rhs_groups(r, width)
    assert widths == [tk.launch_width(c1 - c0) for c0, c1 in groups]
    assert all(w in tk.LAUNCH_WIDTHS for w in widths)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))


def test_convert_rejects_int8_scales_and_dirty_padding(factors):
    _, _, jpf, _ = factors
    args = [_bits(jpf.cinv_t_re), _bits(jpf.cinv_t_im), np.asarray(jpf.lband),
            np.asarray(jpf.uband), np.asarray(jpf.scale), jpf.n]
    # bf16 planes carry all-ones scales; int8 planes arrive as int8 arrays
    # (tests/test_torch_int8_thomas.py)
    with pytest.raises(ValueError, match="all-ones"):
        convert.thomas_factorization(*args[:4], 0.5 * args[4], args[5], device="cpu")
    dirty = args[0].copy()
    dirty[..., -1, -1] = 1
    with pytest.raises(ValueError):
        convert.thomas_factorization(dirty, *args[1:], device="cpu")
    with pytest.raises(TypeError):
        convert.thomas_factorization(args[0].astype(np.float32), *args[1:], device="cpu")


# ---------------------------------------------------------------------------
# The one-slab entry points of the multi-slab sweeps: ``solve``,
# ``solve_cached``, ``solve_resume`` and ``solve_support`` against the JAX
# package's in interpret mode, on the same carried-over planes.  A 2-D ``b``
# runs the single-RHS kernels there (``_fwd``/``_bwd``), (m, n, 2) the
# multi-RHS ones (``_fwd_bt``/``_bwd_b``).  Tolerance 1e-5 of the max-norm:
# f32 summation order is the only difference.
# ---------------------------------------------------------------------------

S3, M3, N3 = 3, 12, 20


@pytest.fixture(scope="module")
def slab_factors():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((S3, M3, N3, 3, 3)) + 1j * rng.standard_normal((S3, M3, N3, 3, 3))
    v[..., 1, 1] += 8.0
    jf = jax.vmap(lambda w: jdirect.factor_stencil_2d(JStencilMatrix2D(values=w)))(jnp.asarray(v))
    jpf = jpt.build_pallas_factorization(jf)
    return jpf, _carry_over(jpf)


def _one_rhs(seed, r):
    rng = np.random.default_rng(seed)
    shape = (M3, N3) if r is None else (M3, N3, r)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _near(got, want, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("r", [None, 2, 8])
@pytest.mark.parametrize("tail", [0, 5, M3])
def test_solve_matches_interpret_kernels(slab_factors, r, tail):
    jpf, pf = slab_factors
    b = _one_rhs(tail, r)
    want = jpt.solve(jpf, 2, jnp.asarray(b), tail=tail, interpret=True)
    got = tk.solve(pf, 2, torch.as_tensor(b), tail=tail)
    assert got.dtype == torch.complex64
    _near(got, want)
    # the slab may also arrive as a tensor
    _near(tk.solve(pf, torch.tensor(2), torch.as_tensor(b), tail=tail), want)


@pytest.mark.parametrize("r", [None, 2, 8])
@pytest.mark.parametrize("start,tail", [(0, 0), (3, 0), (3, 5), (M3 - 1, 0), (M3, 4)])
def test_solve_support_matches_interpret_kernels(slab_factors, r, start, tail):
    jpf, pf = slab_factors
    b = _one_rhs(start, r)
    if start < M3:
        b[:start] = 0
    want = jpt.solve_support(jpf, 1, jnp.asarray(b), start=start, tail=tail, interpret=True)
    _near(tk.solve_support(pf, 1, torch.as_tensor(b), start=start, tail=tail), want)


@pytest.mark.parametrize("r", [None, 2, 8])
@pytest.mark.parametrize("tail", [0, 5])
def test_solve_cached_matches_interpret_kernels(slab_factors, r, tail):
    """x and both caches; the caches are compared on the true lanes."""
    jpf, pf = slab_factors
    b = _one_rhs(20 + tail, r)
    jx, jy, jt = jpt.solve_cached(jpf, 0, jnp.asarray(b), tail=tail, interpret=True)
    x, y, t = tk.solve_cached(pf, 0, torch.as_tensor(b), tail=tail)
    _near(x, jx, "x")
    rows = 2 if r is None else 2 * r
    assert tuple(y.shape) == tuple(t.shape) == (M3, rows, pf.ld)
    _near(y[..., :N3], np.asarray(jy)[..., :N3], "y cache")
    _near(t[..., :N3], np.asarray(jt)[..., :N3], "t cache")
    assert not y[..., N3:].any() and not t[..., N3:].any()


@pytest.mark.parametrize("r", [None, 2, 8])
@pytest.mark.parametrize("resume", [0, 1, 4, M3 - 1, M3])
def test_solve_resume_matches_interpret_kernels(slab_factors, r, resume):
    """The resumed solve against the JAX package's, and against a full solve
    of the same right-hand side: the plain versions run the same operations
    in the same order wherever the pass starts, so those two agree bit for
    bit.  The caches are left as they were."""
    jpf, pf = slab_factors
    b = _one_rhs(30, r)
    b2 = b.copy()
    if resume > 0:
        b2[M3 - resume:] += _one_rhs(31, r)[M3 - resume:]
    _, jy, jt = jpt.solve_cached(jpf, 1, jnp.asarray(b), tail=3, interpret=True)
    _, y, t = tk.solve_cached(pf, 1, torch.as_tensor(b), tail=3)
    y0, t0 = y.clone(), t.clone()
    want = jpt.solve_resume(jpf, 1, jnp.asarray(b2), jy, jt, resume, interpret=True)
    got = tk.solve_resume(pf, 1, torch.as_tensor(b2), y, t, resume)
    _near(got, want)
    assert torch.equal(got, tk.solve(pf, 1, torch.as_tensor(b2)))
    assert torch.equal(y, y0) and torch.equal(t, t0)


@pytest.mark.parametrize("r", [1, 2, 8])
def test_cached_forward_pass_starts_from_a_carry_and_owns_its_lines_only(slab_factors, r):
    """``start = 0`` with a non-zero ``t_init``, and a later start writing in
    place into the caller's stacks: against the JAX package's ``_fwd_bt``."""
    jpf, pf = slab_factors
    rng = np.random.default_rng(r)
    b = (rng.standard_normal((2, M3, N3, r)) + 1j * rng.standard_normal((2, M3, N3, r))).astype(np.complex64)
    s_idx = np.array([2, 0], np.int32)
    jb4 = jpt._to_rows_b(jpf, jnp.asarray(b))
    b4 = tk._to_rows_b(pf, torch.as_tensor(b))
    t_init = np.zeros((2, 2 * r, jpf.np_), np.float32)
    t_init[..., :N3] = rng.standard_normal((2, 2 * r, N3))
    for start in (0, 4):
        jy, jt = jpt._fwd_bt(jpf, jnp.asarray(s_idx), jb4, jnp.asarray(t_init), start=start, interpret=True)
        out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
        y4, t4 = tk.forward_substitution_cached(
            pf, torch.as_tensor(s_idx), b4, torch.as_tensor(t_init[..., : pf.ld].copy()), start=start, out=out)
        assert y4 is out[0] and t4 is out[1]
        _near(y4[:, start:, :, :N3], np.asarray(jy)[..., :N3], "y")
        _near(t4[:, start:, :, :N3], np.asarray(jt)[..., :N3], "t")
        assert bool((y4[:, :start] == 7.0).all()) and bool((t4[:, :start] == -7.0).all())
    # without buffers the stacks are new and zero above the start; no t_init
    # means a zero carry, which is what the plain forward pass starts from
    y4, t4 = tk.forward_substitution_cached(pf, torch.as_tensor(s_idx), b4, start=4)
    assert not y4[:, :4].any() and not t4[:, :4].any()
    assert torch.equal(y4, tk.forward_substitution(pf, torch.as_tensor(s_idx), b4, start=4))


def test_cached_wrapper_validates_and_counts(slab_factors):
    _, pf = slab_factors
    s_idx = torch.zeros(1, dtype=torch.int32)
    rows = torch.zeros((1, M3, 2, pf.ld))
    before = dict(tk.forward_substitution_cached.launches)
    tk.forward_substitution_cached(pf, s_idx, rows)
    assert tk.forward_substitution_cached.launches == before   # plain path: no launch
    with pytest.raises(ValueError, match="t_init"):
        tk.forward_substitution_cached(pf, s_idx, rows, torch.zeros((1, 4, pf.ld)))
    with pytest.raises(ValueError, match="t_init"):
        tk.forward_substitution_cached(pf, s_idx, rows, torch.zeros((1, 2, pf.ld)).double())
    with pytest.raises(ValueError, match="out"):
        tk.forward_substitution_cached(pf, s_idx, rows, out=(rows, rows[:, 1:]))
    with pytest.raises(ValueError, match="start"):
        tk.forward_substitution_cached(pf, s_idx, rows, start=M3)
    assert pf.slab_ids.dtype == torch.int32 and pf.slab_ids.tolist() == [0, 1, 2]


@pytest.fixture(scope="module")
def full_width_pair():
    """One factorization in the dense bf16 layout and in the banded+tail
    layout at full width (every entry kept): the same bf16 entries, four tail
    lines."""
    rng = np.random.default_rng(6)
    v = rng.standard_normal((S3, M3, N3, 3, 3)) + 1j * rng.standard_normal((S3, M3, N3, 3, 3))
    v[..., 1, 1] += 8.0
    tf = direct.factor_stencil_values(torch.as_tensor(v.astype(np.complex64)))
    hybrid = tk.build_banded_tail_factorization(tf, width=2 * N3 - 1, tail_lines=4)
    assert hybrid.tail_start == M3 - 4 and hybrid.half == N3 - 1
    return tk.build_thomas_factorization(tf), hybrid


@pytest.mark.parametrize("entry", ["solve", "solve_cached", "solve_resume", "solve_support", "solve_all"])
def test_banded_tail_entry_points(full_width_pair, entry):
    """Every entry point takes the hybrid layout (the JAX package's
    ``PallasFactorizationBandedTail``) and, at full width, gives the dense bf16
    layout's answer (``test_ht_full_width_matches_bf16``): 1e-5 of the
    max-norm, the summation order of the head windows differing."""
    dense, hybrid = full_width_pair
    b = torch.as_tensor(_one_rhs(40, None))
    b2 = torch.as_tensor(_one_rhs(41, 2))
    b2[:3] = 0
    runs = {
        "solve": lambda f: tk.solve(f, 2, b, tail=5),
        "solve_cached": lambda f: torch.cat([t.reshape(-1) for t in tk.solve_cached(f, 1, b2, 4)]),
        "solve_resume": lambda f: tk.solve_resume(f, 0, b, *tk.solve_cached(f, 0, b2[..., 0], 3)[1:], 3),
        "solve_support": lambda f: tk.solve_support(f, 1, b2, start=3, tail=6),
        "solve_all": lambda f: tk.solve_all(f, [2, 0], torch.stack([b, b.flip(0)])),
    }
    want = runs[entry](dense)
    _near(runs[entry](hybrid), want.numpy())
