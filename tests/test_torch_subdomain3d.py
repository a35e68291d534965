"""The 3D z-slab domain decomposition (``ddm/subdomain3d.py``) against the
JAX package: the slab system's fields, the source partition, and the
Gauss-Seidel sweep in every pivot layout and storage, on the setup of
``tests/test_ddm3d.py`` (NN = 17, K = 8, two slabs, npml = 5).

Tolerances: with full pivots both packages build the same complex128 system
and the sweeps agree to 1e-10 of the max-norm (LAPACK rounding).  On slab
systems carried across from the JAX package (the same bf16 or int8 planes)
the sweeps differ in f32 summation order only, amplified a little by the
recursion: 1e-4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.ddm import subdomain3d as jsd
from fast_solver_lippmann_schwinger_tpu.models import media
from fast_solver_lippmann_schwinger_tpu.ops.fastconv import build_fast_convolution_3d
from fast_solver_lippmann_schwinger_tpu.sparse import pallas_plane as pp
from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
from fast_solver_lippmann_schwinger_tpu.sparse.direct import (
    BlockTridiagFactorization3D as JFac3D,
)
from fast_solver_lippmann_schwinger_tpu_torch import convert
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain3d as sd
from fast_solver_lippmann_schwinger_tpu_torch.ddm.polarized3d import (
    PolarizedTracesPreconditioner3D,
)
from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d
from fast_solver_lippmann_schwinger_tpu_torch.sparse.plane_kernels import PlaneSlabView
from torch_threads import few_threads  # noqa: F401

NN = 17
K = 8.0


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _rhs(seed, r=None):
    rng = np.random.default_rng(seed)
    shape = (NN ** 3,) if r is None else (NN ** 3, r)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def setup():
    """The JAX operator's annihilator fields (complex128), carried to the
    port, and a cache of slab systems built by both packages."""
    h = 1.0 / (NN - 1)
    x = np.linspace(0.0, 1.0, NN)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    nu = media.gaussian_bump_3d(X, Y, Z)
    op = build_fast_convolution_3d(x, x, x, h, K, nu, dtype=jnp.complex128)
    a, ag = jstencils.build_sparse_a_ag_3d(K, op, dtype=jnp.complex128)
    ta = convert.stencil_matrix_3d(np.asarray(a.values), device="cpu")
    tag = convert.stencil_matrix_3d(np.asarray(ag.values), device="cpu")
    return dict(a=a, ag=ag, ta=ta, tag=tag, nu=nu, x=x, h=h, cache={})


def _jax_system(setup, mode):
    """The JAX package's slab system; a ``_pallas`` mode is the plain mode's
    system with its plane stack attached, as ``build_slab_system_3d`` makes
    it."""
    key = ("jax", mode)
    if key not in setup["cache"]:
        if mode.endswith("_pallas"):
            js = _jax_system(setup, mode[: -len("_pallas")])
            fac = js.fac
            setup["cache"][key] = js.replace(
                fac=JFac3D(cinv=jnp.zeros(fac.lsten.shape[:2] + (0, 0), fac.lsten.dtype),
                           lsten=fac.lsten, usten=fac.usten),
                pfac=pp.build_plane_stack(fac))
        else:
            s = setup
            setup["cache"][key] = jsd.build_slab_system_3d(
                s["a"], s["ag"], s["nu"], s["x"], s["h"], K, n_subs=2, npml=5, pivot_dtype=mode)
    return setup["cache"][key]


def _port_system(setup, mode):
    key = ("port", mode)
    if key not in setup["cache"]:
        s = setup
        setup["cache"][key] = sd.build_slab_system_3d(
            s["ta"], s["tag"], s["nu"], s["x"], s["h"], K, n_subs=2, npml=5, pivot_dtype=mode)
    return setup["cache"][key]


def _fields(js) -> dict:
    """A JAX slab system's fields as numpy arrays, for ``convert``."""
    out = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)
           if f.name not in ("fac", "pfac")}
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in out.items()}
    fac = {f.name: np.asarray(getattr(js.fac, f.name)) for f in dataclasses.fields(js.fac)}
    for name in ("cinv_re", "cinv_im"):
        if name in fac:
            fac[name] = fac[name].view(np.uint16)
    out["fac"] = fac
    out["pfac"] = None
    if js.pfac is not None:
        st = js.pfac
        bits = (lambda p: np.asarray(p).view(np.uint16)) if st.p_re.dtype == jnp.bfloat16 \
            else np.asarray
        out["pfac"] = dict(p_re=bits(st.p_re), p_im=bits(st.p_im), scale=np.asarray(st.scale),
                           mn=st.mn, l1=st.l1)
    return out


def _carried(setup, mode):
    key = ("carried", mode)
    if key not in setup["cache"]:
        setup["cache"][key] = convert.slab_system_3d(_fields(_jax_system(setup, mode)),
                                                     device="cpu")
    return setup["cache"][key]


@pytest.mark.parametrize("mode", ["full", "yblock"])
def test_slab_system_fields_match(setup, mode):
    """complex128, each package building its own system: trace planes,
    flags, partition indices, couplings and the stencil field as the
    factorization sees it (couplings exactly, pivots to LAPACK rounding)."""
    js, ts = _jax_system(setup, mode), _port_system(setup, mode)
    assert ts.pivot_layout == js.pivot_layout == ("y" if mode == "yblock" else "z")
    for name in ("n", "m", "l", "n_subs", "l1_max", "trace_tail", "trace_head"):
        assert getattr(ts, name) == getattr(js, name), name
    assert (ts.l1_max, ts.trace_tail, ts.trace_head) == (14, 8, 4)
    for name in ("l0", "l1", "ln", "lnp", "has_top", "has_bot", "src_plane", "src_valid",
                 "owner", "owner_plane"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("cpl_01", "cpl_10", "cpl_n_np", "cpl_np_n", "lsten", "usten"):
        src_t = ts if name.startswith("cpl") else ts.fac
        src_j = js if name.startswith("cpl") else js.fac
        np.testing.assert_array_equal(getattr(src_t, name).numpy(),
                                      np.asarray(getattr(src_j, name)), err_msg=name)
    want = np.asarray(js.fac.cinv)
    assert tuple(ts.fac.cinv.shape) == want.shape
    assert _relerr(ts.fac.cinv, want) < 1e-10


def test_host_stencils_give_the_same_slabs(setup):
    """``a_host``/``ag_host`` (with ``pivot_band``, which is accepted and
    ignored) in the JAX package's order: the host copies are read instead of
    the device fields, here zeroed to show it, and the slabs are those of the
    call without them, bit for bit."""
    s = setup
    want = _port_system(setup, "full")
    blank = lambda st: dataclasses.replace(st, values=torch.zeros_like(st.values))  # noqa: E731
    got = sd.build_slab_system_3d(
        blank(s["ta"]), blank(s["tag"]), s["nu"], s["x"], s["h"], K, 2, 5, 2.0,
        s["ta"].values.numpy(), s["tag"].values.numpy(), "full", 33)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "fac":
            for g in dataclasses.fields(b):
                assert torch.equal(getattr(a, g.name), getattr(b, g.name)), g.name
        elif isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_partition_gather_roundtrip(setup):
    ts = _port_system(setup, "full")
    for r in (None, 2):
        b = torch.as_tensor(_rhs(3, r))
        fields = sd.partition_source_3d(ts, b)
        assert tuple(fields.shape) == (2, 14, NN * NN) + (() if r is None else (r,))
        np.testing.assert_array_equal(
            fields.numpy(), np.asarray(jsd.partition_source_3d(_jax_system(setup, "full"),
                                                               jnp.asarray(b.numpy()))))
        assert torch.equal(sd.gather_interior_3d(ts, fields), b)


@pytest.mark.parametrize("mode", ["full", "yblock"])
def test_gs_sweep_matches_own_build(setup, mode):
    """complex128 dense pivots, z layout (cached/resumed local solves) and
    y layout (plain local solves), two right-hand sides (one column is the
    same computation: ``test_multi_rhs_is_per_column``)."""
    js, ts = _jax_system(setup, mode), _port_system(setup, mode)
    b = _rhs(4, 2)
    got = sd.gs_sweep_3d(ts, torch.as_tensor(b))
    want = jsd.gs_sweep_3d(js, jnp.asarray(b))
    assert got.shape == tuple(want.shape) and _relerr(got, want) < 1e-10


@pytest.mark.parametrize("mode", ["bf16", "bf16_pallas", "yblock_bf16", "yblock_bf16_pallas",
                                  "yblock_int8", "yblock_int8_pallas"])
def test_gs_sweep_matches_on_carried_system(setup, mode):
    """The same bf16 or int8 planes on both sides (the JAX package's slab
    system carried across): the plain bf16/int8 pivot applies, and the plane
    kernels' plain versions against the JAX Pallas kernels in interpret
    mode."""
    js, ts = _jax_system(setup, mode), _carried(setup, mode)
    if mode.endswith("_pallas"):
        assert ts.pfac is not None and isinstance(ts.slab_facs[1], PlaneSlabView)
        assert ts.pfac.storage == ("int8" if "int8" in mode else "bf16")
        assert ts.slab_facs[1].base == ts.pfac.l1 == (NN if mode.startswith("yblock") else 14)
    b = _rhs(5, 2)
    got = sd.gs_sweep_3d(ts, torch.as_tensor(b))
    want = jsd.gs_sweep_3d(js, jnp.asarray(b))
    assert got.shape == tuple(want.shape) and _relerr(got, want) < 1e-4


@pytest.mark.parametrize("mode", ["yblock_int8_pallas"])
def test_own_compressed_build_matches(setup, mode):
    """The port's own compressed build of the 96^3 path's mode: the same
    plane stack as the JAX package's but for planes whose inverse sits on a
    rounding boundary, so its sweep agrees to the pivots' own precision (the
    z layout's own bf16 build: ``tests/test_torch_bump3d.py``)."""
    js, ts = _jax_system(setup, mode), _port_system(setup, mode)
    want_stack = _carried(setup, mode).pfac
    assert ts.pfac.storage == want_stack.storage and ts.pfac.ld == want_stack.ld
    b = _rhs(6)
    got = sd.gs_sweep_3d(ts, torch.as_tensor(b))
    want = jsd.gs_sweep_3d(js, jnp.asarray(b))
    assert _relerr(got, want) < 1e-4


@pytest.mark.parametrize("mode", ["full", "yblock_int8_pallas"])
def test_multi_rhs_is_per_column(setup, mode):
    ts = _port_system(setup, mode)
    b = torch.as_tensor(_rhs(7, 2))
    got = sd.gs_sweep_3d(ts, b)
    for j in range(2):
        want = sd.gs_sweep_3d(ts, b[:, j].contiguous())
        assert _relerr(got[:, j], want) < 1e-12
    pc = sd.SingleSweepPreconditioner3D(slabs=ts, a_s=setup["ta"])
    batch = b.T.contiguous()
    out = pc.apply_batch(batch)
    for j in range(2):
        assert _relerr(out[j], pc.apply(batch[j])) < 1e-12


def test_one_slab_is_the_exact_solve(setup):
    """With one slab the sweep is one local solve of the whole domain."""
    s = setup
    js = jsd.build_slab_system_3d(s["a"], s["ag"], s["nu"], s["x"], s["h"], K, n_subs=1, npml=5,
                                  pivot_dtype="yblock")
    ts = sd.build_slab_system_3d(s["ta"], s["tag"], s["nu"], s["x"], s["h"], K, n_subs=1,
                                 npml=5, pivot_dtype="yblock")
    assert ts.n_subs == 1 and ts.trace_tail == 0 and ts.l1_max == NN
    b = _rhs(8)
    assert _relerr(sd.gs_sweep_3d(ts, torch.as_tensor(b)),
                   jsd.gs_sweep_3d(js, jnp.asarray(b))) < 1e-10


def test_unported_and_invalid_options_raise(setup, tmp_path):
    """``cache_dir``, once unported, checkpoints the slab factorization (a
    second build loads it bit-identically, also through ``bump3d``);
    ``fac_provider``, once unported, supplies the factorization: a provider
    that factors slab by slab with the ``factor_one`` it is given gives the
    built system's sweep to 1e-12; bad modes and too thin absorbing layers
    are refused as in the JAX package.  Polarized traces build on the z
    layout."""
    s = setup
    args = (s["ta"], s["tag"], s["nu"], s["x"], s["h"], K, 2)
    built = [sd.build_slab_system_3d(*args, cache_dir=str(tmp_path / "slabs"))
             for _ in range(2)]
    for f in dataclasses.fields(built[0].fac):
        assert torch.equal(getattr(built[0].fac, f.name), getattr(built[1].fac, f.name))
    def provider(h_sten, dtype, factor_one):
        assert h_sten.shape[0] == 2 and h_sten.dtype == np.complex128
        facs = [factor_one(torch.as_tensor(h_sten[i]).to(dtype)) for i in range(2)]
        return type(facs[0])(**{f.name: torch.stack([getattr(x, f.name) for x in facs])
                                for f in dataclasses.fields(facs[0])}), None

    provided = sd.build_slab_system_3d(*args, fac_provider=provider)
    b = torch.as_tensor(_rhs(9))
    assert _relerr(sd.gs_sweep_3d(provided, b), sd.gs_sweep_3d(built[0], b)) < 1e-12
    with pytest.raises(ValueError, match="pivot_dtype"):
        sd.build_slab_system_3d(*args, pivot_dtype="yblock_fp8")
    with pytest.raises(ValueError, match="npml"):
        sd.build_slab_system_3d(*args, npml=4)
    pc = bump3d.build_problem(h=1 / 10, precond="polarized_traces", n_subdomains=2,
                              device="cpu").precond
    assert isinstance(pc, PolarizedTracesPreconditioner3D)
    assert pc.slabs.pivot_layout == "z" and pc.slabs.n_subs == 2
    p1, p2 = (bump3d.build_problem(h=1 / 10, precond="gs", cache_dir=str(tmp_path / "bump"),
                                   device="cpu") for _ in range(2))
    assert p2.setup_seconds["factorization"] == 0.0
    assert torch.equal(p1.precond.slabs.fac.cinv, p2.precond.slabs.fac.cinv)
