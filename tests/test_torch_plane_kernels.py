"""The plain versions of the plane kernels (one plane apply, the fused
forward and backward passes) against the JAX package's Pallas kernels in
interpret mode, on plane stacks carried across from the JAX package, and the
3D scans through a plane view (support, cached, resumed; fused and per-plane
branches).  The random stencil is ``tests/test_pallas_plane.py``'s
(L, M, N = 6, 5, 7).

Tolerances: the planes are the same bf16 numbers on both sides and every sum
is f32, so the packages differ in summation order only: 1e-5 of the
max-norm for one apply or pass, 2e-5 for a solve."""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
from fast_solver_lippmann_schwinger_tpu.sparse import pallas_plane as pp
from fast_solver_lippmann_schwinger_tpu.sparse.stencil_matrix import (
    StencilMatrix3D as JStencilMatrix3D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

L, M, N = 6, 5, 7
MN = M * N
TOL = 1e-5


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _rand(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def views():
    """The JAX bf16 plane view and the port's view of the same planes."""
    rng = np.random.default_rng(9)
    vals = (rng.standard_normal((L, M, N, 3, 3, 3))
            + 1j * rng.standard_normal((L, M, N, 3, 3, 3))).astype(np.complex64)
    vals[:, :, :, 1, 1, 1] += 30.0
    jfac = jdirect.factor_stencil_3d(JStencilMatrix3D(values=jnp.asarray(vals)), pivot_dtype="bf16")
    stack = pp.build_plane_stack(jfac, batched=False)
    jview = pp.PlaneSlabView(stack=stack, lsten=jfac.lsten, usten=jfac.usten,
                             base=jnp.zeros((), jnp.int32))
    tview = convert.plane_slab_view(
        dict(p_re=np.asarray(stack.p_re).view(np.uint16), p_im=np.asarray(stack.p_im).view(np.uint16),
             scale=np.asarray(stack.scale), mn=stack.mn, l1=stack.l1),
        np.asarray(jfac.lsten), np.asarray(jfac.usten), device="cpu")
    return jfac, jview, tview


def test_stack_layout(views):
    """The port's packing of the carried bf16 factorization equals the
    carried JAX stack bit for bit; weight rows equal the JAX package's
    packing with its 128-lane padding cut off."""
    jfac, jview, tview = views
    fac = convert.factorization_3d(
        np.asarray(jfac.lsten), np.asarray(jfac.usten),
        cinv_re=np.asarray(jfac.cinv_re).view(np.uint16),
        cinv_im=np.asarray(jfac.cinv_im).view(np.uint16), device="cpu")
    stack = pk.build_plane_stack(fac, batched=False)
    assert (stack.mn, stack.l1, stack.ld, stack.n_planes) == (MN, L, 40, L)
    assert tuple(stack.p_re.shape) == (L, 5, 40, 8)
    for got, want in ((stack.p_re, tview.stack.p_re), (stack.p_im, tview.stack.p_im)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    want = np.asarray(pp._pack_sten_rows(jfac.lsten, 128))
    assert tuple(tview.lrows.shape) == (L, 2, 9, 40)
    np.testing.assert_array_equal(tview.lrows.numpy(), want[..., :40])
    assert not want[..., 40:].any()
    # full pivots are rounded complex -> f32 -> bf16 as in the JAX package:
    # complex pivots holding bf16 values pack to the same bits
    def dense(p):
        return pk.dense_planes(p[:2]).float()[:, :MN, :MN].mT

    full = direct.BlockTridiagFactorization3D(
        cinv=torch.complex(dense(tview.stack.p_re), dense(tview.stack.p_im)),
        lsten=fac.lsten[:2], usten=fac.usten[:2])
    packed = pk.build_plane_stack(full, batched=False)
    assert torch.equal(packed.p_re.view(torch.int16), tview.stack.p_re[:2].view(torch.int16))
    assert torch.equal(packed.p_im.view(torch.int16), tview.stack.p_im[:2].view(torch.int16))


@pytest.mark.parametrize("r", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [0, L - 1])
def test_plane_apply_matches(views, r, k):
    """Row 10: one plane apply, multi- and single-RHS."""
    _, jview, tview = views
    shape = (MN,) if r == 1 else (MN, r)
    y = _rand(np.random.default_rng(2 + r), shape)
    want = pp.plane_apply(jview, k, jnp.asarray(y))
    got = pk.plane_apply(tview, k, torch.as_tensor(y))
    assert got.shape == y.shape and _relerr(got, want) < TOL


@pytest.mark.parametrize("r", [1, 2, 3, 8])
@pytest.mark.parametrize("start,with_t0", [(0, False), (0, True), (2, False), (3, True)])
def test_forward_pass_matches(views, r, start, with_t0):
    """Row 11: the fused forward pass, from ``start`` with and without a
    carry, collecting the t stack."""
    _, jview, tview = views
    rng = np.random.default_rng(10 * r + start)
    bg = _rand(rng, (L, MN) if r == 1 else (L, MN, r))
    t0 = _rand(rng, bg.shape[1:]) if with_t0 else None
    jy, jt = pp.fwd_scan_fused(jview, jnp.asarray(bg), start=start,
                               t_start=None if t0 is None else jnp.asarray(t0), collect_t=True)
    ty, tt = pk.fwd_scan_fused(tview, torch.as_tensor(bg), start=start,
                               t_start=None if t0 is None else torch.as_tensor(t0), collect_t=True)
    assert ty.shape == tuple(jy.shape) == (L - start,) + bg.shape[1:]
    assert _relerr(ty, jy) < TOL and _relerr(tt, jt) < TOL
    y_only, none = pk.fwd_scan_fused(tview, torch.as_tensor(bg), start=start,
                                     t_start=None if t0 is None else torch.as_tensor(t0))
    assert none is None and torch.equal(y_only, ty)


@pytest.mark.parametrize("r", [1, 2, 3, 8])
@pytest.mark.parametrize("tail", [0, 2, L])
def test_backward_pass_matches(views, r, tail):
    """Row 12: the fused backward pass, full and truncated to ``tail``."""
    _, jview, tview = views
    y = _rand(np.random.default_rng(20 + r), (L, MN) if r == 1 else (L, MN, r))
    want = pp.bwd_scan_fused(jview, jnp.asarray(y), tail=tail)
    got = pk.bwd_scan_fused(tview, torch.as_tensor(y), tail=tail)
    assert got.shape == tuple(want.shape) and _relerr(got, want) < TOL
    if 0 < tail < L:
        assert not got[: L - tail].any()


def test_kernel_wrappers_in_place(views):
    """The raw wrappers: planes above ``start`` of caller-given stacks are
    left alone, and the padding lanes of a carry count as zero."""
    _, _, tview = views
    st, ld = tview.stack, tview.stack.ld
    rng = np.random.default_rng(7)
    b4 = pk._rows_of(torch.as_tensor(_rand(rng, (L, MN, 2))), ld)
    t0 = torch.as_tensor(rng.standard_normal((4, ld)).astype(np.float32))
    out = (torch.full_like(b4, 7.0), torch.full_like(b4, -7.0))
    y4, t4 = pk.plane_forward(st, b4, tview.lrows, N, start=2, t_init=t0, out=out)
    assert (y4[:2] == 7).all() and (t4[:2] == -7).all()
    t0_clean = t0.clone()
    t0_clean[:, MN:] = 0
    y4b, t4b = pk.plane_forward(st, b4, tview.lrows, N, start=2, t_init=t0_clean)
    assert torch.equal(y4[2:], y4b[2:]) and torch.equal(t4[2:], t4b[2:])
    assert not y4b[2:, :, MN:].any() and not t4b[2:, :, MN:].any()
    y4c, none = pk.plane_forward(st, b4, tview.lrows, N, start=2, t_init=t0, collect_t=False)
    assert none is None and torch.equal(y4c[2:], y4[2:])
    x4 = pk.plane_backward(st, y4b, tview.urows, N, start=3)
    assert not x4[:3].any() and x4[3:].abs().max() > 0
    # the launch counts move only where a kernel was launched
    assert pk.plane_forward.launches == pk.plane_backward.launches == {"bf16": 0, "int8": 0}
    with pytest.raises(ValueError):
        pk.plane_forward(st, b4[:, :, :8], tview.lrows, N)
    with pytest.raises(ValueError):
        pk.plane_apply_rows(st, L, b4[0])


def test_base_indexes_a_slab_of_a_batched_stack(views):
    """A two-slab stack: the view of slab 1 (``base = l1``) solves with slab
    1's planes."""
    jfac, _, tview = views
    fac = convert.factorization_3d(
        np.asarray(jfac.lsten), np.asarray(jfac.usten),
        cinv_re=np.asarray(jfac.cinv_re).view(np.uint16),
        cinv_im=np.asarray(jfac.cinv_im).view(np.uint16), device="cpu")
    two = dataclasses.replace(fac, cinv_re=torch.stack([2 * fac.cinv_re, fac.cinv_re]),
                              cinv_im=torch.stack([2 * fac.cinv_im, fac.cinv_im]))
    stack = pk.build_plane_stack(two, batched=True)
    assert stack.n_planes == 2 * L and stack.l1 == L
    view1 = pk.PlaneSlabView(stack=stack, lsten=fac.lsten, usten=fac.usten, base=L)
    b = torch.as_tensor(_rand(np.random.default_rng(8), (L * MN,)))
    want = direct.block_thomas_solve_3d(tview, b)
    for v in (view1, dataclasses.replace(view1, fused=False)):
        assert _relerr(direct.block_thomas_solve_3d(v, b), want) < TOL


@pytest.mark.parametrize("r", [1, 2, 3, 8])
@pytest.mark.parametrize("fused", [True, False])
def test_scan_variants_match(views, r, fused):
    """Every entry point the sweeps use, through the port's view (fused or
    per-plane branch), against the JAX view: support (start/tail), cached +
    resume, multi-RHS.  The fused branch takes every r here in one launch
    (r = 3 padded to four: ``fused_width``)."""
    _, jview, tview = views
    view = dataclasses.replace(tview, fused=fused)
    assert pk.fused_fits(tview.stack, r) and pk.fused_width(tview.stack, r) == tk.launch_width(r)
    rng = np.random.default_rng(11 + r)
    shape = (L * MN,) if r == 1 else (L * MN, r)
    b = _rand(rng, shape)
    bz = b.copy()
    bz[: 2 * MN] = 0
    tol = 2e-5
    got = direct.block_thomas_solve_support_3d(view, torch.as_tensor(bz), start=2, tail=3)
    want = jdirect.block_thomas_solve_support_3d(jview, jnp.asarray(bz), start=2, tail=3)
    assert _relerr(got, want) < tol
    tx, ty, tt = direct.block_thomas_solve_cached_3d(view, torch.as_tensor(b), 3)
    jx, jy, jt = jdirect.block_thomas_solve_cached_3d(jview, jnp.asarray(b), 3)
    for g, w in ((tx, jx), (ty, jy), (tt, jt)):
        assert g.shape == tuple(w.shape) and _relerr(g, w) < tol
    got = direct.block_thomas_solve_resume_3d(view, torch.as_tensor(b), ty, tt, 3)
    want = jdirect.block_thomas_solve_resume_3d(jview, jnp.asarray(b), jy, jt, 3)
    assert _relerr(got, want) < tol


def test_fused_limits():
    """The fused passes take r <= 8 (a launch width of 1, 2, 4 or 8) and the
    widths whose staged y_p fits one block's shared memory on an H100 beside
    a ring of four slots; 48^3 (mn = 2304) and the 96^3 y-planes (3072) take
    eight right-hand sides in bf16 and int8; a batch the stack does not take
    at its width runs in launches of the widest that fits (``fused_width``)."""
    def stack(ld, int8=False):
        return pk.PlaneStack(p_re=torch.empty((1, ld // 8, ld, 8)), p_im=None, mn=ld, l1=1,
                             scale=torch.ones(1) if int8 else None)

    assert pk.fused_fits(stack(2304), 1) and pk.fused_fits(stack(2304), 2)
    assert pk.fused_fits(stack(12448), 2) and not pk.fused_fits(stack(12456), 2)
    assert pk.fused_fits(stack(24928), 1) and not pk.fused_fits(stack(24936), 1)
    assert pk.fused_fits(stack(64), 3) and not pk.fused_fits(stack(64), 9)
    for ld in (2304, 3072):
        assert pk.fused_fits(stack(ld), 8) and pk.fused_fits(stack(ld, int8=True), 8)
    assert pk.fused_fits(stack(3104), 8) and not pk.fused_fits(stack(3112), 8)
    assert pk.fused_fits(stack(6352), 4) and not pk.fused_fits(stack(6360), 4)
    assert not pk.fused_fits(stack(3200, int8=True), 8)
    assert pk.fused_fits(stack(6272, int8=True), 4) and not pk.fused_fits(stack(6400, int8=True), 4)
    assert [pk.fused_width(stack(12448), r) for r in (1, 2, 3, 8, 20)] == [1, 2, 2, 2, 2]
    assert [pk.fused_width(stack(3072), r) for r in (1, 3, 5, 8, 20)] == [1, 4, 8, 8, 8]
    assert pk.fused_width(stack(24936), 1) == 0


def _csrc_ints(pattern: str, name: str = "plane_pass.cuh") -> list:
    src = (Path(pk.__file__).resolve().parents[1] / "csrc" / name).read_text()
    return [int(v) for v in re.search(pattern, src).groups()]


H100_SMS, H100_SMEM = 132, 232_448


@pytest.mark.parametrize("storage", ["bf16", "int8"])
@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("ld", [128, 2304, 3072, "widest"])
def test_wide_launcher_takes_what_fused_fits_takes(storage, r, ld):
    """Every plane ``fused_fits`` sends to a wide launch (r = 4, 8) is one
    the wide launcher admits on an H100 (132 SMs, 232,448 bytes of shared
    memory a block): at most ``max_tiles`` tiles a CTA, whose lanes' y the
    consumer threads form (a thread per lane and pair of right-hand sides),
    and a ring of at least two slots of the smallest chunk beside the warps'
    sums and staged y (csrc/plane_pass.cuh: ``flow_wide``, ``wide_ring``,
    ``wide_smem_bytes``), the constants read from the sources."""
    if ld == "widest":
        ld = pk._WIDE_WIDEST[storage][r]
    st = pk.PlaneStack(p_re=torch.empty((1, ld // 8, ld, 8)), p_im=None, mn=ld, l1=1,
                       scale=torch.ones(1) if storage == "int8" else None)
    assert pk.fused_fits(st, r)
    lanes, = _csrc_ints(r"constexpr int kLanes = (\d+);")
    warps, = _csrc_ints(r"constexpr int kFlowWarps = (\d+);")
    depth, = _csrc_ints(r"constexpr int kYDepth = (\d+);")
    pitch, = _csrc_ints(r"constexpr int kYPitch = (\d+);", "wide_mma.cuh")
    tiles8, tiles4 = _csrc_ints(r"max_tiles\(\) \{ return R == 8 \? (\d+) : (\d+); \}")
    max_tiles = tiles8 if r == 8 else tiles4
    tiles = ld // lanes
    grid = min(tiles, H100_SMS)
    nt = -(-tiles // grid)
    assert nt <= max_tiles and nt * lanes * (r // 2) <= warps * 32 and grid <= 160
    # the smallest chunk: 16 rows of 16-byte (bf16) tile rows, 128 of 8-byte
    # int8 rows with their block's 2 x 8 f32 scales
    slot = 2 * 16 * 16 if storage == "bf16" else 2 * 128 * 8 + 2 * lanes * 4
    slots = 2
    smem = (-(-16 * slots // 128) * 128 + 4 * 2 * nt * 2 * r * lanes * warps
            + 4 * warps * depth * 2 * r * pitch + slots * nt * slot)
    assert smem <= H100_SMEM


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("ld", [40, 3072, 12448])
def test_fused_passes_take_fresh_flags_and_double_buffered_words(r, ld):
    """A fused pass on the card hands t tiles and y lanes over as flagged
    exchange words: two slots of each kind, (ld, 2r) words each, in the
    stream's exchange buffer, which is zeroed once; each launch takes one
    fresh flag per plane step from the counter that the line kernels draw
    from too, so no word of an earlier launch carries a flag that a later one
    waits for."""
    ex = tk.Exchange("cpu")
    words, first = pk.take_words(ex, ld, r, 96)
    assert first == 1 and not words.any()
    # y and t words, WORD_SLOTS = 2 slots each of (ld, 2r) words, two int32
    # a word
    assert (pk.WORD_KINDS, pk.WORD_SLOTS) == (2, 2)
    assert words.numel() >= 2 * (2 * 2 * ld * 2 * r)
    again, second = pk.take_words(ex, ld, r, 10)               # the next launch
    assert again is words and second == first + 96
    line, third = ex.take(1, r, ld, 70)                        # a line kernel after it
    assert line is words and third == second + 10


def test_int8_storage_raises(views):
    """int8 plane storage is ported (``tests/test_torch_int8_planes.py``), as
    are the int8 line pivots of the 2D kernels (``test_torch_int8_thomas.py``).
    What raises: a storage that is neither, bf16 planes handed the scales of
    int8 storage, and int8 planes that are not transposed and padded to the
    128-row scale blocks."""
    jfac, jview, _ = views
    with pytest.raises(ValueError, match="storage"):
        tk.build_thomas_factorization(None, storage="int4")
    st = jview.stack
    with pytest.raises(ValueError, match="all-ones"):
        convert.plane_stack(np.asarray(st.p_re).view(np.uint16), np.asarray(st.p_im).view(np.uint16),
                            np.full((L, 2, 2, 128), 0.5, np.float32), MN, L, device="cpu")
    q = torch.zeros((1, MN, MN), dtype=torch.int8)
    s = torch.ones((1, 1, MN))
    fac = direct.BlockTridiagFactorization3DInt8(q_re=q, q_im=q, s_re=s, s_im=s,
                                                 lsten=None, usten=None)
    with pytest.raises(ValueError, match="must be"):
        pk.build_plane_stack(fac, batched=False)
