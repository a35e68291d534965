"""Eight and sixteen right-hand sides through the port's joint solves against
the JAX package, on the CPU, and the shared-memory sizing that lets one
launch on the card take them.

On the card a line kernel's launch takes r = 1, 2, 4, 8 or 16 right-hand
sides (dense, int8 and banded+tail line pivots, the fused sweeps;
``thomas_kernels.LAUNCH_WIDTHS``) and a 3D plane pass r = 1, 2, 4 or 8, each
pivot plane read once for the whole batch, as the TPU kernels do for any r.
Here the wrappers take their plain versions, so these tests hold the batched
paths whole at R = 8 and 16 against the JAX package: the joint eight- and
sixteen-direction solves of the 2D double sweep at h = 1/40 (3 slabs,
complex128, each package building its own dense pivots: the same count per
direction, residual histories to 1e-5), and ``GSPreconditioner3D.apply_batch`` of eight
sources at h = 1/10 on the JAX package's slab systems carried across (bf16
z-planes, the 48^3 route; int8 y-planes, the 96^3 route: the port's plain
plane passes against the JAX Pallas kernels in interpret mode, 1e-4 of the
max-norm).  The Python mirrors of the kernels' shared memory say that R = 8
fits the lines and planes of the solves the card runs (``chip_smoke.py``),
R = 16 their lines, and that the planes stop at eight; the kernels
themselves are held to these at wide r in
``tests/test_torch_cuda_kernels.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.ddm import subdomain3d as jsd
from fast_solver_lippmann_schwinger_tpu.models import media as jmedia
from fast_solver_lippmann_schwinger_tpu.models import plasma2d as jplasma2d
from fast_solver_lippmann_schwinger_tpu.ops.fastconv import build_fast_convolution_3d
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain3d as sd
from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.sparse import plane_kernels as pk
from fast_solver_lippmann_schwinger_tpu_torch.sparse import thomas_kernels as tk
from torch_threads import few_threads  # noqa: F401

R = 8


def _directions(count: int) -> tuple:
    """``count`` plane-wave directions at angles 2 pi k / count
    (examples/example_multisource2d.py)."""
    return tuple((float(np.cos(2 * np.pi * k / count)), float(np.sin(2 * np.pi * k / count)))
                 for k in range(count))


DIRECTIONS = _directions(R)
KW_SWEEP = dict(h=1.0 / 40.0, n_subdomains=3, npml=6, double_sweep=True)
SOLVE = dict(rtol=1e-6, restart=20, maxiter=12)
NN, K = 11, 10.0          # h = 1/10


@pytest.fixture(scope="module")
def double_sweep_problems():
    """Each package's own complex128 3-slab double-sweep problem at h = 1/40
    on dense pivots."""
    jp = jplasma2d.build_problem(dtype=jnp.complex128, pivot_dtype="full", **KW_SWEEP)
    tp = plasma2d.build_problem(dtype=torch.complex128, pivot_dtype="full", device="cpu",
                                **KW_SWEEP)
    return jp, tp


def _joint_solve_matches_jax(problems, directions):
    """``plasma2d.solve_batched`` of ``directions`` at once in each package:
    the same iteration count for every direction, residual histories to 1e-5
    above a floor of 1e-12 of the first residual, solutions to 1e-8 of the
    max-norm."""
    jp, tp = problems
    count = len(directions)
    jX, jinfo = jplasma2d.solve_batched(jp, directions, **SOLVE)
    tX, info = plasma2d.solve_batched(tp, directions, **SOLVE)
    counts = np.asarray(jinfo.n_iterations)
    np.testing.assert_array_equal(info.n_iterations.numpy(), counts)
    assert counts.shape == (count,) and counts.min() > 0
    assert bool(info.converged.all()) and bool(np.asarray(jinfo.converged).all())
    for i in range(count):
        want = np.asarray(jinfo.residuals[i])[: counts[i] + 1]
        np.testing.assert_allclose(info.residuals[i].numpy()[: counts[i] + 1], want, rtol=1e-5,
                                   atol=1e-12 * want[0])
    want = np.asarray(jX)
    assert tuple(tX.shape) == want.shape == (count, tp.grid.size)
    np.testing.assert_allclose(tX.numpy(), want, rtol=0, atol=1e-8 * np.abs(want).max())
    assert float(info.true_residual.max()) < 1e-5


def test_eight_directions_joint_double_sweep_solve(double_sweep_problems):
    """Eight directions in one joint solve (R = 8, one launch of eight a pass
    on the card), against the JAX ``solve_batched``."""
    _joint_solve_matches_jax(double_sweep_problems, DIRECTIONS)


def test_sixteen_directions_joint_double_sweep_solve(double_sweep_problems):
    """Sixteen directions at angles 2 pi k / 16 in one joint solve (R = 16,
    one launch of sixteen a pass on the card), against the JAX
    ``solve_batched`` of the same sixteen."""
    _joint_solve_matches_jax(double_sweep_problems, _directions(16))


@pytest.fixture(scope="module")
def annihilators():
    """The JAX package's complex128 annihilator fields of the bump at
    h = 1/10, carried to the port."""
    h = 1.0 / (NN - 1)
    x = np.linspace(0.0, 1.0, NN)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    nu = jmedia.gaussian_bump_3d(X, Y, Z)
    op = build_fast_convolution_3d(x, x, x, h, K, nu, dtype=jnp.complex128)
    a, ag = jstencils.build_sparse_a_ag_3d(K, op, dtype=jnp.complex128)
    return dict(a=a, ag=ag, nu=nu, x=x, h=h)


def _slab_fields(js) -> dict:
    """A JAX 3D slab system as the numpy fields ``convert.slab_system_3d``
    takes (its kernel plane stack included)."""
    out = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)
           if f.name not in ("fac", "pfac")}
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in out.items()}
    fac = {f.name: np.asarray(getattr(js.fac, f.name)) for f in dataclasses.fields(js.fac)}
    for name in ("cinv_re", "cinv_im"):
        if name in fac:
            fac[name] = fac[name].view(np.uint16)
    out["fac"] = fac
    st = js.pfac
    bits = (lambda p: np.asarray(p).view(np.uint16)) if st.p_re.dtype == jnp.bfloat16 \
        else np.asarray
    out["pfac"] = dict(p_re=bits(st.p_re), p_im=bits(st.p_im), scale=np.asarray(st.scale),
                       mn=st.mn, l1=st.l1)
    return out


@pytest.mark.parametrize("mode,storage", [("bf16_pallas", "bf16"),
                                          ("yblock_int8_pallas", "int8")])
def test_gs_preconditioner_apply_batch_of_eight(annihilators, mode, storage):
    """``GSPreconditioner3D.apply_batch`` of eight sources (R x N, the
    ``gmres_batched`` convention of ``api.solve_problem_batched``) on the JAX
    package's slab system carried across: its plain plane passes at r = 8
    against the JAX Pallas kernels in interpret mode (1e-4 of the max-norm,
    f32 summation order through the sweep's chained slab solves), and each
    source's row the single apply of that source."""
    s = annihilators
    js = jsd.build_slab_system_3d(s["a"], s["ag"], s["nu"], s["x"], s["h"], K, n_subs=2,
                                  npml=5, pivot_dtype=mode)
    ts = convert.slab_system_3d(_slab_fields(js), device="cpu")
    assert ts.pfac is not None and ts.pfac.storage == storage
    assert pk.fused_width(ts.pfac, R) == R
    rng = np.random.default_rng(8)
    b = rng.standard_normal((R, NN ** 3)) + 1j * rng.standard_normal((R, NN ** 3))
    want = np.asarray(jsd.GSPreconditioner3D(slabs=js).apply_batch(jnp.asarray(b)))
    pc = sd.GSPreconditioner3D(slabs=ts)
    got = pc.apply_batch(torch.as_tensor(b))
    assert tuple(got.shape) == want.shape == (R, NN ** 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    single = pc.apply(torch.as_tensor(b[3]))
    torch.testing.assert_close(got[3], single, rtol=0, atol=1e-5 * float(single.abs().max()))


def _stack(ld: int, storage: str) -> pk.PlaneStack:
    """A plane stack of width ``ld`` (only its shapes are read)."""
    return pk.PlaneStack(p_re=torch.empty((1, ld // 8, ld, 8)), p_im=None, mn=ld, l1=1,
                         scale=torch.ones(1) if storage == "int8" else None)


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_eight_right_hand_sides_fit_the_solves_shapes(storage):
    """The Python mirrors of the kernels' shared memory (which pick a launch
    width from shapes alone): R = 8 fits the 401^2 and 801^2 lines (ld 408
    and 808, one CTA a tile) and the 48^3 and 96^3 planes (ld 2304 and 3072)
    in bf16 and int8; one lane group past the longest line or plane of each
    width does not."""
    for ld in (408, 808):
        assert tk.line_fits(ld, R, storage)
        # one CTA a tile holds a whole line of either, at r = 2 and at r = 8
        for r in (2, R):
            assert tk.line_smem_bytes(ld, r, storage, split=1) <= tk.SMEM_PER_BLOCK
    assert tk.line_smem_bytes(920, R, "bf16", split=1) > tk.SMEM_PER_BLOCK
    longest = {"bf16": {1: 2304, 2: 1968, 4: 2560, 8: 1904},
               "int8": {1: 2560, 2: 2448, 4: 2560, 8: 2192}}[storage]
    for r, n in longest.items():
        assert tk.line_fits(n, r, storage) and not tk.line_fits(n + 8, r, storage)
    for ld in (2304, 3072):
        assert pk.fused_fits(_stack(ld, storage), R) and pk.fused_width(_stack(ld, storage), R) == R
    widest = {"bf16": 3104, "int8": 3072}[storage]
    step = 8 if storage == "bf16" else 128
    assert not pk.fused_fits(_stack(widest + step, storage), R)
    assert pk.fused_width(_stack(widest + step, storage), R) == 4


def _dense_fac(n, storage="bf16"):
    """Dense line pivots of length ``n`` (only their shapes are read)."""
    ld = tk._round_up(n, 8)
    planes = torch.zeros((), dtype=torch.bfloat16).expand(1, 1, ld // 8, ld, 8)
    bands = torch.zeros(()).expand(1, 1, 2, 3, ld)
    scale = None if storage == "bf16" else torch.ones(
        (1, 1, ld // 8, tk.n_scale_blocks(ld), 2, 8))
    return tk.ThomasFactorization(planes, planes, bands, bands, n, scale=scale)


def _banded_801():
    """Banded+tail pivots of the 801^2 solve's width (w = 201; shapes only)."""
    half = 100
    head = torch.zeros((), dtype=torch.bfloat16).expand(1, 1, 101, 8 + 2 * half, 8)
    tail = torch.zeros((), dtype=torch.bfloat16).expand(1, 1, 101, 808, 8)
    bands = torch.zeros(()).expand(1, 2, 2, 3, 808)
    return tk.BandedTailFactorization(head, head, tail, tail, bands, bands, 801, half)


def test_line_widths_follow_the_line():
    """A batch runs in launches of the widest width the line takes: the dense
    layout up to sixteen (padded: three as four, five as eight, twelve as
    sixteen), halved on lines too long for a width, the banded+tail layout
    likewise."""
    fac = _dense_fac
    assert [tk.line_width(fac(801), r) for r in (1, 2, 3, 5, 8, 12, 20)] == [1, 2, 4, 8, 8, 16,
                                                                             16]
    assert [tk.line_width(fac(1700), r) for r in (3, 8, 16)] == [4, 8, 16]
    assert [tk.line_width(fac(2000), r) for r in (2, 3, 8, 16)] == [1, 4, 4, 16]
    assert [tk.line_width(fac(2200, "int8"), r) for r in (2, 8, 16)] == [2, 4, 4]
    banded = _banded_801()
    assert [tk.line_width(banded, r) for r in (1, 2, 3, 8, 16)] == [1, 2, 4, 8, 16]
    assert [tk.launch_width(r) for r in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert tk.rhs_groups(11) == [(0, 11)] and tk.rhs_groups(5, 2) == [(0, 2), (2, 4), (4, 5)]


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_sixteen_right_hand_sides_take_one_line_launch(storage):
    """The mirrors at r = 16: r = 9..16 launch as sixteen, more run in groups
    of sixteen; the 801^2 lines (ld 808) and the banded+tail layout of the
    solve take sixteen in one launch, on one CTA a tile (the launcher's
    pick), in the passes and the fused sweeps; an exchange sized for a wide
    launch of sixteen holds its rows and flags; the plane kernels still stop
    at eight."""
    assert [tk.launch_width(r) for r in range(9, 17)] == [16] * 8
    assert tk.MAX_RHS == 16 and tk.LAUNCH_WIDTHS[-1] == 16
    assert tk.rhs_groups(40) == [(0, 16), (16, 32), (32, 40)]
    assert tk.line_fits(808, 16, storage)
    assert tk.line_smem_bytes(808, 16, storage, split=1) <= tk.SMEM_PER_BLOCK
    fac = _dense_fac(801, storage)
    assert tk.line_width(fac, 16) == tk.line_width(fac, 12) == 16
    if storage == "bf16":
        assert tk.line_width(_banded_801(), 16) == 16
        assert tk.line_width(_banded_801(), 16, inject=True) == 16
    ex = tk.Exchange("cpu")
    for batch, slots in ((1, tk.EXCHANGE_LINES), (16, tk.EXCHANGE_LINES), (1, 70)):
        words, _ = ex.take(batch, 16, 808, 70, slots=slots)
        rows = ex.wide_rows(batch, 16, 808, slots=slots)
        assert rows.numel() * 4 >= slots * batch * tk.WIDE_SLOT_BYTES * 16 * 808
        assert words.numel() // 2 >= slots * batch * 2 * 101 * 4       # flag words
    for ld in (2304, 3072):
        stack = _stack(ld, storage)
        assert pk.MAX_RHS == 8 and not pk.fused_fits(stack, 16)
        assert pk.fused_width(stack, 16) == 8
