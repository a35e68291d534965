"""int8 plane pivots: the quantization, the int8 factorization, the non-Pallas
int8 pivot apply and the plain versions of the int8 plane kernels against the
JAX package (its Pallas kernels in interpret mode), on numpy-seeded inputs.
The random stencil is ``tests/test_pallas_plane.py``'s (L, M, N = 6, 5, 7):
mn = 35 pads to one 128-row scale block.

Tolerances: the quantization is bit-equal (the same f32 divisions and
round-half-even on both sides).  On the same int8 planes and scales the
packages differ in f32 summation order only: 1e-5 of the max-norm for one
apply or pass, 2e-5 for a solve.  The factorizations invert the same complex128
planes with two LAPACKs, so a quantized entry may land one step apart where
its value sits on a rounding boundary."""

import dataclasses

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
from fast_solver_lippmann_schwinger_tpu_torch.sparse.stencil_matrix import StencilMatrix3D
from torch_threads import few_threads  # noqa: F401

L, M, N = 6, 5, 7
MN = M * N
TOL = 1e-5


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _rand(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _planes_cases():
    rng = np.random.default_rng(0)
    plain = rng.standard_normal((35, 35)).astype(np.float32)
    # 300 inputs: three scale blocks, the last one padded; block 1 all zero
    # (scale 1), a decaying row scale, and entries exactly half a quantum
    # off a step (round half to even) in a block whose scale is 1
    wide = (rng.standard_normal((130, 300)) * np.logspace(0, -6, 130)[:, None]).astype(np.float32)
    wide[:, 128:256] = 0.0
    halves = np.zeros((4, 200), np.float32)
    halves[:, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -127.0]
    halves[:, 128:] = rng.uniform(-1e-30, 1e-30, (4, 72))
    return {"35x35": plain, "130x300": wide, "halves": halves}


@pytest.mark.parametrize("case", ["35x35", "130x300", "halves"])
def test_quantization_is_bit_equal(case):
    """q and scales bit for bit on the same f32 planes: padding rows, an
    all-zero block (scale 1), half-way values and the +-127 ends."""
    a = _planes_cases()[case]
    jq, js = jdirect._quantize_t_int8(jnp.asarray(a))
    tq, ts = direct._quantize_t_int8(torch.as_tensor(a))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    if case == "halves":
        assert tq[:8, 0].tolist() == [127, 2, -4, 0, 0, 2, 126, -127]
        assert ts[0, 0] == 1.0 and tq.abs().max() == 127


def _stencil(seed=9):
    rng = np.random.default_rng(seed)
    vals = _rand(rng, (L, M, N, 3, 3, 3), np.complex128)
    vals[:, :, :, 1, 1, 1] += 30.0
    return vals


@pytest.fixture(scope="module")
def int8():
    """The JAX int8 factorization and plane view, and the port's carried
    copies: the non-Pallas factorization and the view of the plane stack."""
    vals = _stencil().astype(np.complex64)
    jfac = jdirect.factor_stencil_3d(JStencilMatrix3D(values=jnp.asarray(vals)), pivot_dtype="int8")
    stack = pp.build_plane_stack(jfac, batched=False)
    jview = pp.PlaneSlabView(stack=stack, lsten=jfac.lsten, usten=jfac.usten,
                             base=jnp.zeros((), jnp.int32))
    fields = {name: np.asarray(getattr(jfac, name))
              for name in ("q_re", "q_im", "s_re", "s_im", "lsten", "usten")}
    tfac = convert.factorization_3d(**fields, device="cpu")
    tview = convert.plane_slab_view(
        dict(p_re=np.asarray(stack.p_re), p_im=np.asarray(stack.p_im),
             scale=np.asarray(stack.scale), mn=stack.mn, l1=stack.l1),
        fields["lsten"], fields["usten"], device="cpu")
    return jfac, jview, tfac, tview


def test_int8_factorization_matches():
    """``factor_stencil_3d(pivot_dtype="int8")`` of the same complex128
    stencil: couplings exact, scales to one f32 step (each is an f32 absmax
    of complex128 inverses from two LAPACKs), quantized entries equal but
    where an inverse sits within rounding of a step (then one step apart)."""
    vals = _stencil()
    jfac = jdirect.factor_stencil_3d(JStencilMatrix3D(values=jnp.asarray(vals)), pivot_dtype="int8")
    tfac = direct.factor_stencil_3d(StencilMatrix3D(values=torch.as_tensor(vals)),
                                    pivot_dtype="int8")
    assert isinstance(tfac, direct.BlockTridiagFactorization3DInt8)
    assert tuple(tfac.q_re.shape) == (L, 128, MN) and tuple(tfac.s_re.shape) == (L, 1, MN)
    np.testing.assert_array_equal(tfac.lsten.numpy(), np.asarray(jfac.lsten))
    np.testing.assert_array_equal(tfac.usten.numpy(), np.asarray(jfac.usten))
    for part in ("re", "im"):
        q, jq = getattr(tfac, f"q_{part}").numpy(), np.asarray(getattr(jfac, f"q_{part}"))
        diff = np.abs(q.astype(np.int32) - jq)
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size
        assert not q[:, MN:].any()
        np.testing.assert_allclose(getattr(tfac, f"s_{part}").numpy(),
                                   np.asarray(getattr(jfac, f"s_{part}")), rtol=2.5e-7)


def test_int8_plane_is_the_quantized_inverse():
    """Each dequantized plane is the pivot inverse of the full factorization
    to within half a quantum of its block."""
    st = StencilMatrix3D(values=torch.as_tensor(_stencil()))
    full = direct.factor_stencil_3d(st, pivot_dtype="full")
    q8 = direct.factor_stencil_3d(st, pivot_dtype="int8")
    for k in range(L):
        for q, sc, part in ((q8.q_re[k], q8.s_re[k], full.cinv[k].real),
                            (q8.q_im[k], q8.s_im[k], full.cinv[k].imag)):
            deq = (q[:MN].double() * sc.double().repeat_interleave(128, 0)[:MN]).T
            step = sc.double().repeat_interleave(128, 0)[:MN].T
            assert bool(((deq - part).abs() <= 0.5 * step * (1 + 1e-5) + 1e-12).all())


def test_stack_layout(int8):
    """The port's packing of the carried int8 factorization equals the
    carried JAX stack bit for bit: planes, and scales (ones on the padding
    lanes, where the JAX package keeps zeros)."""
    jfac, jview, tfac, tview = int8
    stack = pk.build_plane_stack(tfac, batched=False)
    assert stack.storage == "int8" and (stack.mn, stack.ld, stack.n_planes) == (MN, 128, L)
    assert tuple(stack.p_re.shape) == (L, 16, 128, 8) and stack.p_re.dtype == torch.int8
    assert tuple(stack.scale.shape) == (L, 16, 1, 2, 8)
    for got, want in ((stack.p_re, tview.stack.p_re), (stack.p_im, tview.stack.p_im),
                      (stack.scale, tview.stack.scale)):
        assert torch.equal(got, want)
    assert bool((stack.scale[:, MN // 8 + 1 :] == 1.0).all())
    dense = pk.dense_planes(stack.p_re[2]).numpy()
    np.testing.assert_array_equal(dense, np.asarray(jview.stack.p_re[2]))
    assert stack.nbytes == 2 * L * 128 * 128 + 4 * L * 2 * 128


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("k", [0, L - 1])
def test_plane_apply_matches(int8, r, k):
    """Row 10, int8 mode: one plane apply; the JAX kernel scales each 128-row
    partial product, the port dequantizes first (f32 rounding only)."""
    _, jview, _, tview = int8
    y = _rand(np.random.default_rng(2 + r), (MN,) if r == 1 else (MN, r))
    want = pp.plane_apply(jview, k, jnp.asarray(y))
    got = pk.plane_apply(tview, k, torch.as_tensor(y))
    assert got.shape == y.shape and _relerr(got, want) < TOL


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("start,with_t0", [(0, False), (0, True), (3, True)])
def test_forward_pass_matches(int8, r, start, with_t0):
    """Row 11, int8 mode: the fused forward pass from ``start`` with and
    without a carry, collecting the t stack."""
    _, jview, _, tview = int8
    rng = np.random.default_rng(10 * r + start)
    bg = _rand(rng, (L, MN) if r == 1 else (L, MN, r))
    t0 = _rand(rng, bg.shape[1:]) if with_t0 else None
    jy, jt = pp.fwd_scan_fused(jview, jnp.asarray(bg), start=start,
                               t_start=None if t0 is None else jnp.asarray(t0), collect_t=True)
    ty, tt = pk.fwd_scan_fused(tview, torch.as_tensor(bg), start=start,
                               t_start=None if t0 is None else torch.as_tensor(t0),
                               collect_t=True)
    assert ty.shape == tuple(jy.shape) == (L - start,) + bg.shape[1:]
    assert _relerr(ty, jy) < TOL and _relerr(tt, jt) < TOL


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("tail", [0, 2])
def test_backward_pass_matches(int8, r, tail):
    """Row 12, int8 mode: the fused backward pass, full and truncated."""
    _, jview, _, tview = int8
    y = _rand(np.random.default_rng(20 + r), (L, MN) if r == 1 else (L, MN, r))
    want = pp.bwd_scan_fused(jview, jnp.asarray(y), tail=tail)
    got = pk.bwd_scan_fused(tview, torch.as_tensor(y), tail=tail)
    assert got.shape == tuple(want.shape) and _relerr(got, want) < TOL


@pytest.mark.parametrize("shape", [(L * MN,), (L * MN, 2)])
def test_xla_int8_pivot_apply_matches(int8, shape):
    """The non-Pallas int8 mode (``_pivot_apply_3d`` on the carried
    factorization: per-block products scaled after them) against the JAX
    package's, one plane and a whole solve."""
    jfac, _, tfac, _ = int8
    b = _rand(np.random.default_rng(5), shape)
    y = b[:MN]
    got = direct._pivot_apply_3d(tfac, 3, torch.as_tensor(y))
    want = jdirect._pivot_apply_3d(jfac, 3, jnp.asarray(y))
    assert _relerr(got, want) < TOL
    got = direct.block_thomas_solve_3d(tfac, torch.as_tensor(b))
    want = jdirect.block_thomas_solve_3d(jfac, jnp.asarray(b))
    assert got.dtype == torch.complex64 and _relerr(got, want) < 2e-5


@pytest.mark.parametrize("fused", [True, False])
def test_scan_variants_match(int8, fused):
    """The sweeps' entry points through the port's int8 view, fused or
    per-plane branch, against the JAX view: support, cached + resumed."""
    _, jview, _, tview = int8
    view = dataclasses.replace(tview, fused=fused)
    b = _rand(np.random.default_rng(11), (L * MN, 2))
    tx, ty, tt = direct.block_thomas_solve_cached_3d(view, torch.as_tensor(b), 3)
    jx, jy, jt = jdirect.block_thomas_solve_cached_3d(jview, jnp.asarray(b), 3)
    for g, w in ((tx, jx), (ty, jy), (tt, jt)):
        assert g.shape == tuple(w.shape) and _relerr(g, w) < 2e-5
    got = direct.block_thomas_solve_resume_3d(view, torch.as_tensor(b), ty, tt, 3)
    want = jdirect.block_thomas_solve_resume_3d(jview, jnp.asarray(b), jy, jt, 3)
    assert _relerr(got, want) < 2e-5


def test_int8_wrappers_check_their_stack(int8):
    """The raw wrappers refuse a stack whose planes, width or scales do not
    fit its storage, and count no launch on the CPU."""
    _, _, _, tview = int8
    st = tview.stack
    rows = torch.zeros((2, st.ld))
    before = dict(pk.plane_apply_rows.launches)
    pk.plane_apply_rows(st, 0, rows)
    assert pk.plane_apply_rows.launches == before
    for bad in (dataclasses.replace(st, scale=st.scale[:, :, :, :1].contiguous()),
                dataclasses.replace(st, p_im=st.p_im.to(torch.bfloat16))):
        with pytest.raises(ValueError):
            pk.plane_apply_rows(bad, 0, rows)
    bf16 = pk.empty_plane_stack(1, MN, 1, "bf16", "cpu")
    with pytest.raises(ValueError, match="cannot be packed"):
        pk.pack_planes(bf16, 0, int8[2])
    assert pk.fused_fits(st, 8) and not pk.fused_fits(st, pk.MAX_RHS + 1)


def test_fused_limits_of_int8_stacks():
    """The int8 ring carries its scales: 1 KB less room for the staged y_p
    than bf16 (ld <= 12288 at r = 2, 24704 at r = 1, 6272 at r = 4 and 3072,
    the 96^3 y-planes, at r = 8, in steps of 128)."""
    def stack(ld):
        return pk.PlaneStack(p_re=torch.empty((1, 1, ld, 8), dtype=torch.int8), p_im=None,
                             mn=ld, l1=1, scale=torch.empty(0))

    assert pk.fused_fits(stack(3072), 1) and pk.fused_fits(stack(3072), 2)
    assert pk.fused_fits(stack(12288), 2) and not pk.fused_fits(stack(12416), 2)
    assert pk.fused_fits(stack(24576), 1) and not pk.fused_fits(stack(24832), 1)
    assert pk.fused_fits(stack(6272), 4) and not pk.fused_fits(stack(6400), 4)
    assert pk.fused_fits(stack(3072), 8) and not pk.fused_fits(stack(3200), 8)
