"""Checkpoints of the port's setup artifacts (``utils/checkpoint.py``): the
cases of ``tests/test_checkpoint.py`` on the port, and more.

A second build from the same ``cache_dir`` must load bit-identical tensors
(dtypes included: bf16 and int8 planes, f32 bands) in every pivot mode whose
layout differs, and solve bit-identically; pivot modes and quadratures key
apart; a truncated, foreign or misshapen file is recomputed and overwritten.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.utils import checkpoint as jcheckpoint
from fast_solver_lippmann_schwinger_tpu_torch.core.grids import Grid2D, Grid3D
from fast_solver_lippmann_schwinger_tpu_torch.ddm import subdomain3d, sweeps
from fast_solver_lippmann_schwinger_tpu_torch.models import bump3d, media, plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.ops import fastconv
from fast_solver_lippmann_schwinger_tpu_torch.sparse import stencils
from fast_solver_lippmann_schwinger_tpu_torch.utils import checkpoint
from torch_threads import few_threads  # noqa: F401

H = 1.0 / 40.0


def tensors(obj, prefix="") -> dict:
    """Every tensor of a tree of the port's dataclasses, by field path."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            out.update(tensors(v, f"{prefix}[{i}]"))
    return out


def assert_bit_identical(a, b):
    ta, tb = tensors(a), tensors(b)
    assert ta.keys() == tb.keys() and ta
    for name in ta:
        assert ta[name].dtype == tb[name].dtype, name
        assert ta[name].shape == tb[name].shape, name
        assert torch.equal(ta[name], tb[name]), name


def _build(pivot, cache_dir):
    return plasma2d.build_problem(
        h=H, n_subdomains=3, npml=5, dtype=torch.complex64, double_sweep=False,
        pivot_dtype=pivot, cache_dir=cache_dir, device="cpu",
    )


def _files(cache_dir, prefix):
    return sorted(f for f in os.listdir(cache_dir) if f.startswith(prefix + "_"))


@pytest.mark.parametrize("pivot", ["full", "bf16", "banded_tail", "pallas", "pallas_int8",
                                   "pallas_banded_tail"])
def test_slab_factorization_roundtrip(tmp_path, pivot):
    """The second build loads the first's slab system: every tensor of the
    factorization and of the kernel layout bit-identical, the non-tensor
    fields equal, and the loaded system solves bit-identically."""
    cache = str(tmp_path / "cache")
    p1 = _build(pivot, cache)
    p2 = _build(pivot, cache)
    assert len(_files(cache, "slabfac")) == 1
    assert p1.setup_seconds["checkpoint"] > 0 and p2.setup_seconds["checkpoint"] > 0
    s1, s2 = p1.precond.slabs, p2.precond.slabs
    assert_bit_identical(s1.fac, s2.fac)
    if pivot.startswith("pallas"):
        assert_bit_identical(s1.pfac, s2.pfac)
        assert (s1.pfac.n, s1.pfac.storage) == (s2.pfac.n, s2.pfac.storage)
        assert torch.equal(s1.pfac.slab_ids, s2.pfac.slab_ids)
    else:
        assert s1.pfac is None and s2.pfac is None
    if pivot == "pallas_int8":
        assert s2.pfac.cinv_t_re.dtype == torch.int8 and s2.pfac.scale is not None
    x1, i1 = plasma2d.solve(p1, rtol=1e-5, maxiter=30)
    x2, i2 = plasma2d.solve(p2, rtol=1e-5, maxiter=30)
    assert int(i1.n_iterations) == int(i2.n_iterations) > 0
    assert torch.equal(x1, x2)


def test_pivot_mode_cache_isolation(tmp_path):
    """Pivot modes key apart on the same configuration: each keeps its own
    file and class."""
    cache = str(tmp_path / "cache")
    modes = ("full", "bf16", "pallas")
    facs = [_build(mode, cache).precond.slabs for mode in modes]
    assert len(_files(cache, "slabfac")) == len(modes)
    assert facs[0].fac.cinv.shape[-1] == facs[0].n and facs[0].pfac is None
    assert hasattr(facs[1].fac, "cinv_re") and facs[1].pfac is None
    assert facs[2].fac.cinv.shape[-1] == 0 and facs[2].pfac is not None
    again = _build("bf16", cache).precond.slabs
    assert_bit_identical(again.fac, facs[1].fac)


@pytest.mark.parametrize("dim", [2, 3])
def test_symbol_roundtrip(tmp_path, dim):
    """The spectral symbol loads bit-identically; another quadrature or size
    class keys apart."""
    cache = str(tmp_path / "cache")
    if dim == 2:
        grid = Grid2D(a=1.0, h=1.0 / 24.0)
        nu = media.gaussian_bump_2d(*grid.mesh())

        def build(**kw):
            return fastconv.build_fast_convolution_2d(
                grid.x, grid.y, grid.h, 24.0, nu, dtype=torch.complex128, cache_dir=cache,
                device="cpu", **{"quad_rule": "greengard_vico", **kw})
    else:
        grid = Grid3D(a=1.0, h=1.0 / 10.0)
        nu = media.gaussian_bump_3d(*grid.mesh())

        def build(**kw):
            return fastconv.build_fast_convolution_3d(
                grid.x, grid.x, grid.x, grid.h, 10.0, nu, dtype=torch.complex128,
                cache_dir=cache, device="cpu", **kw)
    op1, op2 = build(), build()
    assert len(_files(cache, "symbol")) == 1
    assert torch.equal(op1.symbol, op2.symbol)
    other = build(quad_rule="trapezoidal") if dim == 2 else build(prefer_pow2=True)
    assert len(_files(cache, "symbol")) == 2
    assert other.symbol.shape != op1.symbol.shape or not torch.equal(other.symbol, op1.symbol)


@pytest.mark.parametrize("dim", [2, 3])
def test_stencil_fields_roundtrip(tmp_path, dim):
    """The host stencil fields load bit-identically, on the device in the
    working dtype and (2D) as the host arrays the slab systems are built from."""
    cache = str(tmp_path / "cache")
    if dim == 2:
        grid = Grid2D(a=1.0, h=H)
        k = 1.0 / H

        def build():
            return stencils.build_sparse_a_ag_2d(k, grid.x, grid.y, H, dtype=torch.complex64,
                                                 return_host=True, cache_dir=cache,
                                                 device="cpu")
    else:
        grid = Grid3D(a=1.0, h=0.1)
        op = fastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, 0.1, 10.0,
                                                media.gaussian_bump_3d, device="cpu")

        def build():
            return stencils.build_sparse_a_ag_3d(10.0, op, cache_dir=cache)
    first, second = build(), build()
    assert len(_files(cache, "stencils")) == 1
    for a, b in zip(first, second):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a.values.dtype == b.values.dtype and torch.equal(a.values, b.values)


@pytest.mark.parametrize("pivot_dtype", ["full", "bf16_pallas", "yblock_int8_pallas"])
def test_slab_system_3d_roundtrip(tmp_path, pivot_dtype):
    """``build_slab_system_3d`` loads its factorization and plane stack
    bit-identically, and the loaded slabs sweep bit-identically."""
    cache = str(tmp_path / "cache")
    grid = Grid3D(a=1.0, h=0.1)
    k = 10.0
    nu = media.gaussian_bump_3d(*grid.mesh())
    op = fastconv.build_fast_convolution_3d(grid.x, grid.x, grid.x, 0.1, k, nu, device="cpu")
    a_st, ag_st = stencils.build_sparse_a_ag_3d(k, op)
    runs = []
    for _ in range(2):
        parts = {}
        runs.append(subdomain3d.build_slab_system_3d(
            a_st, ag_st, nu, grid.x, 0.1, k, 2, npml=5, pivot_dtype=pivot_dtype,
            cache_dir=cache, timings=parts))
        assert set(parts) == {"slab_fields", "factorization", "packing", "checkpoint"}
    assert parts["factorization"] == 0.0       # the second build loaded
    s1, s2 = runs
    assert len(_files(cache, "slabfac3d")) == 1
    assert_bit_identical(s1.fac, s2.fac)
    assert (s1.pfac is None) == (s2.pfac is None) == (not pivot_dtype.endswith("_pallas"))
    if s1.pfac is not None:
        assert_bit_identical(s1.pfac, s2.pfac)
        assert (s1.pfac.mn, s1.pfac.l1, s1.pfac.storage) == (s2.pfac.mn, s2.pfac.l1,
                                                             s2.pfac.storage)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(grid.size), dtype=torch.complex64)
    assert torch.equal(subdomain3d.gs_sweep_3d(s1, b), subdomain3d.gs_sweep_3d(s2, b))


@pytest.mark.parametrize("damage", ["truncated", "foreign", "misshapen"])
def test_unreadable_file_is_recomputed(tmp_path, damage):
    """A truncated file, a JAX ``.npz`` under the port's name, or a file of
    the wrong shapes loads as ``None``: the build recomputes the same
    system and overwrites the file, which the next build loads."""
    cache = str(tmp_path / "cache")
    p1 = _build("pallas", cache)
    (name,) = _files(cache, "slabfac")
    path = os.path.join(cache, name)
    if damage == "truncated":
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[: len(blob) // 2])
    elif damage == "foreign":
        with open(path, "wb") as fh:
            np.savez_compressed(fh, leaf_0=np.ones(3))
    else:
        checkpoint.save(path, (p1.precond.slabs.fac, None))     # no kernel layout
    assert checkpoint.load(path, "cpu", check=lambda facs: facs[1] is not None) is None
    p2 = _build("pallas", cache)
    assert_bit_identical(p1.precond.slabs.pfac, p2.precond.slabs.pfac)
    loaded = checkpoint.load(path, "cpu")
    assert_bit_identical(loaded[1], p1.precond.slabs.pfac)


@pytest.mark.parametrize("dim", [2, 3])
def test_whole_slab_systems_roundtrip(tmp_path, dim):
    """``save`` / ``load`` of a whole ``SlabSystem`` (kernel layout included)
    or ``SlabSystem3D`` (plane stack included): every tensor and plain field
    back, ``slab_ids`` rebuilt, and the loaded system sweeps bit-identically."""
    path = str(tmp_path / "slabs.pt")
    rng = np.random.default_rng(1)
    if dim == 2:
        slabs = _build("pallas", None).precond.slabs
        sweep = sweeps.gs_sweep
    else:
        slabs = bump3d.build_problem(h=0.1, precond="gs", n_subdomains=2,
                                     pivot_dtype="bf16_pallas", device="cpu").precond.slabs
        sweep = subdomain3d.gs_sweep_3d
    checkpoint.save(path, slabs)
    loaded = checkpoint.load(path, "cpu")
    assert type(loaded) is type(slabs)
    assert_bit_identical(loaded, slabs)
    for f in dataclasses.fields(slabs):
        if not isinstance(getattr(slabs, f.name), (torch.Tensor, type(None))) \
                and not dataclasses.is_dataclass(getattr(slabs, f.name)):
            assert getattr(loaded, f.name) == getattr(slabs, f.name), f.name
    size = slabs.m * slabs.n * (slabs.l if dim == 3 else 1)
    b = torch.as_tensor(rng.standard_normal(size) + 1j * rng.standard_normal(size),
                        dtype=torch.complex64)
    assert torch.equal(sweep(loaded, b), sweep(slabs, b))


def test_views_are_saved_compact(tmp_path):
    """A view is written without the rest of its base storage."""
    base = torch.zeros(1 << 20)
    path = str(tmp_path / "view.pt")
    checkpoint.save(path, (base[10:20], base.view(1024, 1024)[:, 3]))
    assert os.path.getsize(path) < 64 * 1024
    a, b = checkpoint.load(path, "cpu")
    assert a.shape == (10,) and b.shape == (1024,)


def test_config_key_is_the_jax_packages():
    kw = dict(h_digest="ab", shape=[3, 70, 801, 3, 3], pivot_dtype="pallas", pivot_band=None,
              pivot_rank=None, dtype="complex64")
    assert checkpoint.config_key(**kw) == jcheckpoint.config_key(**kw)
