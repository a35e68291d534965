"""The port's sharded 2D sweeps (``parallel/sharded.py``) on 2 and 4 gloo
ranks against the JAX package's single-device ``gs_sweep`` and
``DoubleSweepPreconditioner``, on the setup of ``tests/test_sharded.py`` and
``tests/test_pipelined.py`` (h = 1/36, Gaussian bump, 4 slabs, npml 6,
complex128) with their seeds and (D, R, rhs_block) cases.

The JAX slab systems are carried across with ``convert.slab_system``; one
spawn per world size runs every case (``torch_dist.run_ranks``), and every
rank must return the same bits.  Tolerance: the JAX tests' 1e-10 (rtol) and
1e-12 (atol).  A slab system whose only pivots are the kernel layout is
refused with ``ValueError`` by every sharded entry point; the JAX sweeps
raise on it too (a ``TypeError`` from inside the local solve).

JAX is imported inside the fixtures only: the ranks import this module.
"""

import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu_torch.parallel import sharded
from torch_dist import run_ranks, same_on_every_rank, slab_fields
from torch_threads import few_threads  # noqa: F401

H, N_SUBS, NPML = 1.0 / 36.0, 4, 6
# (D, seed) of tests/test_sharded.py
MASKED = {"masked_d4": (4, 0), "masked_d2": (2, 1)}
# (D, R, rhs_block) of tests/test_pipelined.py, seeded as there
PIPELINED = {f"pipe_d{d}_r{r}": (d, r, 1, d * 10 + r) for d, r in [(4, 3), (2, 3), (2, 1), (4, 6)]}
PIPELINED.update({f"block_d{d}_r{r}_b{b}": (d, r, b, d * 100 + r + b)
                  for d, r, b in [(2, 4, 2), (2, 5, 2), (4, 6, 3), (2, 4, 8)]})
ENTRY_POINTS = ("sharded_gs_sweep", "sharded_gs_sweep_pipelined", "make_sharded_double_sweep",
                "make_sharded_double_sweep_pipelined", "shard_slab_system")


def _rhs(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def rank_cases(mesh, inp):
    """Every case of one world size, on one rank."""
    out = {}
    shard = sharded.shard_slab_system(inp["slabs"], mesh)
    for name, b in inp["masked"].items():
        out[name] = sharded.sharded_gs_sweep(shard, b, mesh)
    for name, (B, block) in inp["pipelined"].items():
        out[name] = sharded.sharded_gs_sweep_pipelined(shard, B, mesh, rhs_block=block)
    pc = sharded.make_sharded_double_sweep(inp["slabs"], inp["slabs_t"], inp["msp"],
                                           inp["a_s"], mesh)
    out["double"] = pc(inp["double_b"])
    if "kernel_only" in inp:
        ko, b = inp["kernel_only"], inp["double_b"]
        calls = {
            "sharded_gs_sweep": lambda: sharded.sharded_gs_sweep(ko, b, mesh),
            "sharded_gs_sweep_pipelined": lambda: sharded.sharded_gs_sweep_pipelined(
                ko, b[None], mesh),
            "make_sharded_double_sweep": lambda: sharded.make_sharded_double_sweep(
                ko, ko, inp["msp"], inp["a_s"], mesh),
            "make_sharded_double_sweep_pipelined":
                lambda: sharded.make_sharded_double_sweep_pipelined(
                    ko, ko, inp["msp"], inp["a_s"], mesh),
            "shard_slab_system": lambda: sharded.shard_slab_system(ko, mesh),
        }
        for name, call in calls.items():
            try:
                call()
                out[f"refused_{name}"] = ""
            except ValueError as e:
                out[f"refused_{name}"] = str(e)
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.core.grids import Grid2D
    from fast_solver_lippmann_schwinger_tpu.ddm import subdomain as jsub
    from fast_solver_lippmann_schwinger_tpu.ddm import sweeps as jsweeps
    from fast_solver_lippmann_schwinger_tpu.models import media
    from fast_solver_lippmann_schwinger_tpu.sparse import direct as jdirect
    from fast_solver_lippmann_schwinger_tpu.sparse import pallas_thomas as pt
    from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
    from fast_solver_lippmann_schwinger_tpu_torch import convert

    grid = Grid2D(a=1.0, h=H)
    k = 1.0 / H
    X, Y = grid.mesh()
    nu = media.gaussian_bump_2d(X, Y)
    a, ag = jstencils.build_sparse_a_ag_2d(k, grid.x, grid.y, H, dtype=jnp.complex128)
    msp = jstencils.build_msp_2d(a, ag, nu, k)
    js = jsub.build_slab_system(a, ag, nu, grid.x, grid.y, H, k, N_SUBS, npml=NPML)
    js_t = jsub.build_slab_system(a.transpose(), ag.transpose(), nu.T, grid.y, grid.x, H, k,
                                  N_SUBS, npml=NPML)
    # the kernel layout alone: an empty placeholder beside the bf16 planes
    jko = js.replace(
        pfac=pt.build_pallas_factorization(js.fac),
        fac=jdirect.BlockTridiagFactorization(
            cinv=jnp.zeros(js.fac.cinv.shape[:2] + (0, 0), js.fac.cinv.dtype),
            lband=js.fac.lband, uband=js.fac.uband))

    cases = {name: _rhs(seed, grid.size) for name, (_, seed) in MASKED.items()}
    cases.update({name: _rhs(seed, (r, grid.size))
                  for name, (_, r, _, seed) in PIPELINED.items()})
    cases["double"] = _rhs(7, grid.size)
    flat = np.concatenate([np.atleast_2d(v) for v in cases.values()])
    swept = np.asarray(jax.jit(jax.vmap(jsweeps.gs_sweep, in_axes=(None, 0)))(
        js, jnp.asarray(flat)))
    refs, i = {}, 0
    for name, v in cases.items():
        rows = np.atleast_2d(v).shape[0]
        refs[name] = swept[i:i + rows] if v.ndim == 2 else swept[i]
        i += rows
    pc = jsweeps.DoubleSweepPreconditioner(slabs=js, slabs_t=js_t, msp=msp, a_s=a)
    refs["double"] = np.asarray(jax.jit(pc.apply)(jnp.asarray(cases["double"])))

    port = dict(
        slabs=convert.slab_system(slab_fields(js), device="cpu"),
        slabs_t=convert.slab_system(slab_fields(js_t), device="cpu"),
        msp=convert.stencil_matrix_2d(np.asarray(msp.values), device="cpu"),
        a_s=convert.stencil_matrix_2d(np.asarray(a.values), device="cpu"),
        kernel_only=convert.slab_system(slab_fields(jko), device="cpu"),
    )
    return dict(grid=grid, cases=cases, refs=refs, port=port, jko=jko)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """World size -> the cases' results (every rank's the same)."""
    done = {}

    def get(D):
        if D not in done:
            c = setup["cases"]
            inp = dict(setup["port"])
            if D != 2:
                inp.pop("kernel_only")
            inp["masked"] = {n: torch.as_tensor(c[n]) for n, (d, _) in MASKED.items() if d == D}
            inp["pipelined"] = {n: (torch.as_tensor(c[n]), b)
                                for n, (d, _, b, _) in PIPELINED.items() if d == D}
            inp["double_b"] = torch.as_tensor(c["double"])
            done[D] = same_on_every_rank(run_ranks(
                D, __name__, "rank_cases", inp, tmp_path_factory.mktemp(f"sharded_d{D}")))
        return done[D]

    return get


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", list(MASKED))
def test_masked_sweep_matches_single_device(setup, ranks, case):
    _close(ranks(MASKED[case][0])[case], setup["refs"][case])


@pytest.mark.parametrize("case", list(PIPELINED))
def test_pipelined_sweep_matches_single_device(setup, ranks, case):
    """Including k = 2 slabs a rank, R < D, ragged blocks and B > R."""
    got = ranks(PIPELINED[case][0])[case]
    assert tuple(got.shape) == setup["cases"][case].shape
    _close(got, setup["refs"][case])


@pytest.mark.parametrize("D", [2, 4])
def test_double_sweep_matches_single_device(setup, ranks, D):
    _close(ranks(D)["double"], setup["refs"]["double"])


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_kernel_layout_alone_is_refused(setup, ranks, entry):
    """The port refuses the pallas-only system up front, naming its mode;
    the JAX sweeps accept it and fail inside (ROADMAP.md, Queue 3)."""
    message = ranks(2)[f"refused_{entry}"]
    assert "pivot_dtype='pallas'" in message
    if entry.startswith("sharded_gs_sweep"):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        from fast_solver_lippmann_schwinger_tpu.parallel import sharded as jsharded

        mesh = Mesh(np.array(jax.devices()[:2]), ("slab",))
        b = jnp.asarray(setup["cases"]["double"])
        with pytest.raises(Exception):
            if entry == "sharded_gs_sweep":
                jsharded.sharded_gs_sweep(setup["jko"], b, mesh)
            else:
                jsharded.sharded_gs_sweep_pipelined(setup["jko"], b[None], mesh)


def test_sharding_specs_split_the_slab_fields(setup):
    """Slab-leading fields go over the mesh axis; the reconstruction maps and
    the kernel layout do not."""
    specs = sharded.slab_sharding_specs(setup["port"]["slabs"])
    assert specs["owner"] is None and specs["owner_line"] is None and specs["pfac"] is None
    assert specs["n_subs"] is None and specs["trace_tail"] is None
    for name in ("h_stencils", "l0", "has_bot", "src_line", "cpl_np_n"):
        assert specs[name] == "slab"
    assert specs["fac"] == {"cinv": "slab", "lband": "slab", "uband": "slab"}
