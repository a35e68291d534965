"""The port's sharded 3D z-slab sweeps (``parallel/sharded3d.py``) on gloo
ranks against the JAX package's single-device ``gs_sweep_3d``, on the setup
of ``tests/test_sharded3d.py`` (NN = 17, K = 8, npml 5, complex128): the
masked sweep on the z-plane and y-blocked layouts with 2 slabs on 2 ranks
(and 4 slabs on 4), the pipelined sweep's (R, rhs_block, slabs) cases on 2
ranks, and the masked sweep preconditioner ``GS(As b)``.

JAX slab systems are carried across with ``convert.slab_system_3d``; one
spawn per world size runs every case and every rank must return the same
bits.  Tolerance 1e-10 (rtol), 1e-12 (atol), as the JAX test.  JAX is
imported inside the fixtures only: the ranks import this module.
"""

import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu_torch.parallel import sharded3d
from torch_dist import run_ranks, same_on_every_rank, slab_fields_3d
from torch_threads import few_threads  # noqa: F401

NN, K = 17, 8.0
# name -> (D, system, seed); systems: (pivot_dtype, slabs)
MASKED = {"masked_full_d2": (2, ("full", 2), 0), "masked_yblock_d2": (2, ("yblock", 2), 0),
          "masked_full_d4": (4, ("full", 4), 3)}
# (D, R, rhs_block, slabs) of tests/test_sharded3d.py, seeded as there
PIPELINED = {f"pipe_r{r}_b{b}_s{s}": (2, r, b, s, r * 10 + b)
             for r, b, s in [(3, 1, 2), (4, 2, 2), (5, 2, 4)]}
SYSTEMS = [("full", 2), ("yblock", 2), ("full", 4)]


def rank_cases(mesh, inp):
    out = {}
    for name, (key, b) in inp["masked"].items():
        out[name] = sharded3d.sharded_gs_sweep_3d(inp["systems"][key], b, mesh)
    for name, (key, B, block) in inp["pipelined"].items():
        out[name] = sharded3d.sharded_gs_sweep_3d_pipelined(inp["systems"][key], B, mesh,
                                                            rhs_block=block)
    if "precond_b" in inp:
        pc = sharded3d.make_sharded_sweep_preconditioner_3d(inp["systems"][("full", 2)],
                                                            inp["a_s"], mesh)
        out["precond"] = pc(inp["precond_b"])
        refusals = {
            "y_pipelined": lambda: sharded3d.sharded_gs_sweep_3d_pipelined(
                inp["systems"][("yblock", 2)], inp["precond_b"][None], mesh),
            "kernel_only": lambda: sharded3d.sharded_gs_sweep_3d(
                inp["kernel_only"], inp["precond_b"], mesh),
            "kernel_only_pipelined": lambda: sharded3d.sharded_gs_sweep_3d_pipelined(
                inp["kernel_only"], inp["precond_b"][None], mesh),
            "kernel_only_precond": lambda: sharded3d.make_sharded_sweep_preconditioner_3d(
                inp["kernel_only"], inp["a_s"], mesh),
        }
        for name, call in refusals.items():
            try:
                call()
                out[f"refused_{name}"] = ""
            except ValueError as e:
                out[f"refused_{name}"] = str(e)
    return out


def _rhs(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from fast_solver_lippmann_schwinger_tpu.ddm import subdomain3d as jsd
    from fast_solver_lippmann_schwinger_tpu.models import media
    from fast_solver_lippmann_schwinger_tpu.ops.fastconv import build_fast_convolution_3d
    from fast_solver_lippmann_schwinger_tpu.sparse import pallas_plane as pp
    from fast_solver_lippmann_schwinger_tpu.sparse import stencils as jstencils
    from fast_solver_lippmann_schwinger_tpu.sparse.direct import BlockTridiagFactorization3D
    from fast_solver_lippmann_schwinger_tpu_torch import convert

    h = 1.0 / (NN - 1)
    x = np.linspace(0.0, 1.0, NN)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    nu = media.gaussian_bump_3d(X, Y, Z)
    op = build_fast_convolution_3d(x, x, x, h, K, nu, dtype=jnp.complex128)
    a, ag = jstencils.build_sparse_a_ag_3d(K, op, dtype=jnp.complex128)
    jsys = {(mode, s): jsd.build_slab_system_3d(a, ag, nu, x, h, K, n_subs=s, npml=5,
                                                pivot_dtype=mode)
            for mode, s in SYSTEMS}
    full = jsys[("full", 2)]
    jko = full.replace(
        fac=BlockTridiagFactorization3D(
            cinv=jnp.zeros(full.fac.lsten.shape[:2] + (0, 0), full.fac.lsten.dtype),
            lsten=full.fac.lsten, usten=full.fac.usten),
        pfac=pp.build_plane_stack(full.fac))

    sweep = jax.jit(jax.vmap(jsd.gs_sweep_3d, in_axes=(None, 0)))
    cases, refs = {}, {}
    for name, (_, key, seed) in MASKED.items():
        cases[name] = (key, _rhs(seed, NN ** 3))
    for name, (_, r, _, s, seed) in PIPELINED.items():
        cases[name] = (("full", s), _rhs(seed, (r, NN ** 3)))
    for key in SYSTEMS:
        mine = [n for n, (k, _) in cases.items() if k == key]
        flat = np.concatenate([np.atleast_2d(cases[n][1]) for n in mine])
        out, i = np.asarray(sweep(jsys[key], jnp.asarray(flat))), 0
        for n in mine:
            v = cases[n][1]
            rows = np.atleast_2d(v).shape[0]
            refs[n] = out[i:i + rows] if v.ndim == 2 else out[i]
            i += rows
    b = _rhs(11, NN ** 3)
    refs["precond"] = np.asarray(jax.jit(lambda s, v: jsd.gs_sweep_3d(s, a.matvec(v)))(
        full, jnp.asarray(b)))
    port = dict(
        systems={key: convert.slab_system_3d(slab_fields_3d(js), device="cpu")
                 for key, js in jsys.items()},
        a_s=convert.stencil_matrix_3d(np.asarray(a.values), device="cpu"),
        kernel_only=convert.slab_system_3d(slab_fields_3d(jko), device="cpu"),
    )
    return dict(cases=cases, refs=refs, port=port, precond_b=b, jko=jko)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    done = {}

    def get(D):
        if D not in done:
            c = setup["cases"]
            inp = dict(systems=setup["port"]["systems"])
            inp["masked"] = {n: (key, torch.as_tensor(c[n][1]))
                             for n, (d, key, _) in MASKED.items() if d == D}
            inp["pipelined"] = {n: (("full", s), torch.as_tensor(c[n][1]), b)
                                for n, (d, _, b, s, _) in PIPELINED.items() if d == D}
            if D == 2:
                inp.update(a_s=setup["port"]["a_s"], kernel_only=setup["port"]["kernel_only"],
                           precond_b=torch.as_tensor(setup["precond_b"]))
            done[D] = same_on_every_rank(run_ranks(
                D, __name__, "rank_cases", inp, tmp_path_factory.mktemp(f"sharded3d_d{D}")))
        return done[D]

    return get


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", list(MASKED))
def test_masked_3d_sweep_matches_single_device(setup, ranks, case):
    _close(ranks(MASKED[case][0])[case], setup["refs"][case])


@pytest.mark.parametrize("case", list(PIPELINED))
def test_pipelined_3d_sweep_matches_single_device(setup, ranks, case):
    got = ranks(PIPELINED[case][0])[case]
    assert tuple(got.shape) == setup["cases"][case][1].shape
    _close(got, setup["refs"][case])


def test_sweep_preconditioner_3d(setup, ranks):
    _close(ranks(2)["precond"], setup["refs"]["precond"])


@pytest.mark.parametrize("what", ["y_pipelined", "kernel_only", "kernel_only_pipelined",
                                  "kernel_only_precond"])
def test_refusals(setup, ranks, what):
    """The pipelined sweep needs the z layout, as in the JAX package; a
    system whose only pivots are the plane kernels' stack is refused with its
    mode named, where the JAX sweep fails inside its local solve."""
    message = ranks(2)[f"refused_{what}"]
    if what == "y_pipelined":
        assert "z-plane pivot layout" in message
        return
    assert "pivot_dtype='bf16_pallas'" in message
    if what == "kernel_only":
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        from fast_solver_lippmann_schwinger_tpu.parallel import sharded3d as jsharded3d

        mesh = Mesh(np.array(jax.devices()[:2]), ("slab",))
        with pytest.raises(Exception):
            jsharded3d.sharded_gs_sweep_3d(setup["jko"], jnp.asarray(setup["precond_b"]), mesh)
