"""The port's slices as a whole against the JAX package at h = 1/40: the
one-slab plasma solve, the 3-slab bi-directional sweep solve, and the
package's device and import rules."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu.models import plasma2d as jplasma2d
from fast_solver_lippmann_schwinger_tpu_torch import convert, resolve_device
from fast_solver_lippmann_schwinger_tpu_torch.models import plasma2d
from fast_solver_lippmann_schwinger_tpu_torch.sparse import direct
from torch_threads import few_threads  # noqa: F401

KW = dict(h=1.0 / 40.0, n_subdomains=1, npml=6, double_sweep=False)
SOLVE = dict(rtol=1e-6, restart=20, maxiter=12)
DIRS = ((1.0, 0.0), (0.0, 1.0))


@pytest.fixture(scope="module", params=["full", "pallas"])
def problems(request):
    mode = request.param
    jdt, tdt = ((jnp.complex128, torch.complex128) if mode == "full"
                else (jnp.complex64, torch.complex64))
    jp = jplasma2d.build_problem(dtype=jdt, pivot_dtype=mode, **KW)
    tp = plasma2d.build_problem(dtype=tdt, pivot_dtype=mode, device="cpu", **KW)
    # complex128 with dense pivots agrees to rounding.  complex64 with bf16
    # planes (the JAX side runs its Pallas kernels in interpret mode): the two
    # complex64 factorizations round differently, a few bf16 plane entries
    # flip, and below f32 epsilon times the initial norm the residual history
    # is rounding noise: history rtol 1e-3 with that floor, solution 1e-4.
    tol = (dict(hist=1e-6, floor=1e-12, sol=1e-7) if mode == "full"
           else dict(hist=1e-3, floor=1e-6, sol=1e-4))
    return mode, jp, tp, tol


def _check_history(info_res, jinfo_res, n_it, tol):
    want = np.asarray(jinfo_res)
    got = np.asarray(info_res)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[: n_it + 1], want[: n_it + 1],
                               rtol=tol["hist"], atol=tol["floor"] * want[0])


def test_problem_setup_matches(problems):
    mode, jp, tp, _ = problems
    assert tp.grid.shape == jp.grid.shape == (41, 41) and tp.k == jp.k
    np.testing.assert_array_equal(tp.nu, jp.nu)
    assert tp.op.symbol.shape == jp.op.symbol.shape
    assert (tp.precond.slabs.pfac is not None) == (mode == "pallas")
    assert set(tp.setup_seconds) == {"symbol", "stencils", "factorization", "packing"}


@pytest.mark.parametrize("direction", DIRS)
def test_solve_matches(problems, direction):
    _, jp, tp, tol = problems
    jx, jinfo = jplasma2d.solve(jp, direction, **SOLVE)
    tx, info = plasma2d.solve(tp, direction, **SOLVE)
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and n_it > 0
    assert bool(info.converged) and bool(jinfo.converged)
    _check_history(info.residuals, jinfo.residuals, n_it, tol)
    want = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), want, rtol=0, atol=tol["sol"] * np.abs(want).max())
    assert float(info.true_residual) < 1e-5


def test_solve_batched_three_directions(problems):
    """Three directions, which a substitution launch on the card takes padded
    to four (the launch widths are 1, 2, 4 and 8): the joint solve of three
    against the JAX package's ``gmres_batched``."""
    _, jp, tp, tol = problems
    dirs = DIRS + ((0.6, 0.8),)
    jX, jinfo = jplasma2d.solve_batched(jp, dirs, **SOLVE)
    tX, info = plasma2d.solve_batched(tp, dirs, **SOLVE)
    np.testing.assert_array_equal(info.n_iterations.numpy(), np.asarray(jinfo.n_iterations))
    for i in range(len(dirs)):
        _check_history(info.residuals[i], jinfo.residuals[i], int(info.n_iterations[i]), tol)
    want = np.asarray(jX)
    assert tuple(tX.shape) == want.shape == (3, tp.grid.size)
    np.testing.assert_allclose(tX.numpy(), want, rtol=0, atol=tol["sol"] * np.abs(want).max())


def test_solve_batched_matches(problems):
    _, jp, tp, tol = problems
    jX, jinfo = jplasma2d.solve_batched(jp, DIRS, **SOLVE)
    tX, info = plasma2d.solve_batched(tp, DIRS, **SOLVE)
    np.testing.assert_array_equal(info.n_iterations.numpy(), np.asarray(jinfo.n_iterations))
    assert bool(info.converged.all())
    for i in range(len(DIRS)):
        _check_history(info.residuals[i], jinfo.residuals[i], int(info.n_iterations[i]), tol)
    want = np.asarray(jX)
    assert tuple(tX.shape) == want.shape == (2, tp.grid.size)
    np.testing.assert_allclose(tX.numpy(), want, rtol=0, atol=tol["sol"] * np.abs(want).max())
    assert float(info.true_residual.max()) < 1e-5


# ---------------------------------------------------------------------------
# The multi-slab slice: 3 slabs, alternating bi-directional sweep.  Each
# package builds its own stencils and factorizations here, so complex128 with
# dense pivots agrees to LAPACK rounding (1e-8), and complex64 with bf16
# planes to the bf16 roundings that flip between the two factorizations:
# equal iteration counts, solution within 1e-3.  The complex64 solves stop at
# rtol 1e-5: at 1e-6 they reach the float32 rounding floor of an apply, and
# the last iteration is decided by rounding noise (5 iterations in the JAX
# package; the port's residual sits at 1.0001e-6 of its start after 5 and
# passes after 6).
# ---------------------------------------------------------------------------

KW_SWEEP = dict(h=1.0 / 40.0, n_subdomains=3, npml=6, double_sweep=True)


@pytest.fixture(scope="module", params=["full", "pallas"])
def sweep_problems(request):
    mode = request.param
    jdt, tdt = ((jnp.complex128, torch.complex128) if mode == "full"
                else (jnp.complex64, torch.complex64))
    jp = jplasma2d.build_problem(dtype=jdt, pivot_dtype=mode, **KW_SWEEP)
    tp = plasma2d.build_problem(dtype=tdt, pivot_dtype=mode, device="cpu", **KW_SWEEP)
    tol = (dict(hist=1e-8, floor=1e-12, sol=1e-8, solve=SOLVE) if mode == "full"
           else dict(hist=None, floor=None, sol=1e-3, solve=dict(SOLVE, rtol=1e-5)))
    return mode, jp, tp, tol


def test_double_sweep_problem_setup(sweep_problems):
    mode, jp, tp, _ = sweep_problems
    pc = tp.precond
    assert type(pc).__name__ == "DoubleSweepPreconditioner"
    for slabs in (pc.slabs, pc.slabs_t):
        assert slabs.n_subs == 3 and (slabs.pfac is not None) == (mode == "pallas")
    assert (pc.slabs.trace_tail, pc.slabs_t.trace_tail) == (
        jp.precond.slabs.trace_tail, jp.precond.slabs_t.trace_tail)
    want = np.asarray(jp.precond.msp.values)
    got = pc.msp.values.numpy()
    # the annihilator rows are fixed up to a phase each; |Msp| is not
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0, atol=1e-4 * np.abs(want).max())
    assert set(tp.setup_seconds) == {"symbol", "stencils", "factorization", "packing",
                                     "factorization_t", "packing_t"}


def test_defaults_are_the_reference_configuration():
    """16 slabs and the double sweep, as the JAX package's ``build_problem``."""
    import inspect

    ours = inspect.signature(plasma2d.build_problem).parameters
    theirs = inspect.signature(jplasma2d.build_problem).parameters
    for name in ("h", "n_subdomains", "npml", "double_sweep", "pivot_dtype_t"):
        assert ours[name].default == theirs[name].default, name


@pytest.mark.parametrize("direction", DIRS[:1])     # the batched test runs both
def test_double_sweep_solve_matches(sweep_problems, direction):
    _, jp, tp, tol = sweep_problems
    jx, jinfo = jplasma2d.solve(jp, direction, **tol["solve"])
    tx, info = plasma2d.solve(tp, direction, **tol["solve"])
    n_it = int(jinfo.n_iterations)
    assert int(info.n_iterations) == n_it and n_it > 0
    assert bool(info.converged) and bool(jinfo.converged)
    if tol["hist"] is not None:
        _check_history(info.residuals, jinfo.residuals, n_it, tol)
    want = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), want, rtol=0, atol=tol["sol"] * np.abs(want).max())
    assert float(info.true_residual) < 1e-4


def test_double_sweep_solve_batched_matches(sweep_problems):
    _, jp, tp, tol = sweep_problems
    jX, jinfo = jplasma2d.solve_batched(jp, DIRS, **tol["solve"])
    tX, info = plasma2d.solve_batched(tp, DIRS, **tol["solve"])
    np.testing.assert_array_equal(info.n_iterations.numpy(), np.asarray(jinfo.n_iterations))
    assert bool(info.converged.all())
    if tol["hist"] is not None:
        for i in range(len(DIRS)):
            _check_history(info.residuals[i], jinfo.residuals[i], int(info.n_iterations[i]), tol)
    want = np.asarray(jX)
    np.testing.assert_allclose(tX.numpy(), want, rtol=0, atol=tol["sol"] * np.abs(want).max())
    assert float(info.true_residual.max()) < 1e-4


# the eight build functions that take ``cache_dir`` (module, function)
CACHE_FUNCTIONS = {
    "fastconv.2d": ("ops.fastconv", "build_fast_convolution_2d"),
    "fastconv.3d": ("ops.fastconv", "build_fast_convolution_3d"),
    "stencils.2d": ("sparse.stencils", "build_sparse_a_ag_2d"),
    "stencils.3d": ("sparse.stencils", "build_sparse_a_ag_3d"),
    "subdomain": ("ddm.subdomain", "build_slab_system"),
    "subdomain3d": ("ddm.subdomain3d", "build_slab_system_3d"),
    "plasma2d": ("models.plasma2d", "build_problem"),
    "bump3d": ("models.bump3d", "build_problem"),
}


# the functions, builders and operators of parallel/, by module
PARALLEL_FUNCTIONS = [
    ("sharded", f) for f in ("slab_sharding_specs", "shard_slab_system", "sharded_gs_sweep",
                             "sharded_gs_sweep_pipelined", "make_sharded_double_sweep",
                             "make_sharded_double_sweep_pipelined")
] + [
    ("sharded3d", f) for f in ("sharded_gs_sweep_3d", "sharded_gs_sweep_3d_pipelined",
                               "make_sharded_sweep_preconditioner_3d",
                               "make_sharded_sweep_preconditioner_3d_pipelined")
] + [("polarized", "make_sharded_polarized_preconditioner"),
     ("polarized3d", "make_sharded_polarized_preconditioner_3d")] + [
    ("fft", f) for f in ("DistributedLS2D", "DistributedLS3D",
                         "build_distributed_fast_convolution_2d",
                         "build_distributed_fast_convolution_3d")
]


@pytest.mark.parametrize("name", ["build_problem", "build_slab_system",
                                  "build_fast_convolution_2d", "build_slab_system_3d",
                                  "plasma_integral2d.build_problem",
                                  "PolarizedTracesPreconditioner3D",
                                  "bump2d.build_problem", "bump2d.solve",
                                  "differentiable_solve", "compress_factorization_banded",
                                  "compress_factorization_banded_lr",
                                  "compress_factorization_banded_tail",
                                  "SolverConfig", "DDMConfig", "ProblemConfig",
                                  "api.build_problem", "api.solve_problem",
                                  "api.solve_problem_batched", "save_field", "config_key",
                                  "build_sparse_a_2d", "factor_stencil_2d_batched",
                                  "block_thomas_solve_batched", "PhaseTimer.phase"]
                         + [f"cache_dir:{b}" for b in CACHE_FUNCTIONS]
                         + [f"parallel:{m}.{f}" for m, f in PARALLEL_FUNCTIONS])
def test_signatures_match_the_jax_package(name):
    """The port's build functions (and the 3D polarized preconditioner's
    fields, and the fields of the three config dataclasses) take the JAX
    package's parameters, in its order and with its defaults; the port adds
    only trailing parameters of its own (``device``; ``timings`` where the
    setup is split by part).  Two ground rules differ: the working ``dtype``
    is a torch dtype (``torch.complex64`` for ``jnp.complex64``), and
    ``prefer_pow2`` never sniffs a TPU backend: a build function's ``False`` stands
    for the JAX package's ``None``, and the config's ``None`` means the
    5-smooth sizes.  Each of the eight build functions with a ``cache_dir`` takes it
    (``None`` by default) and no longer refuses it.  The functions, builders
    and operators of ``parallel/`` take the JAX parameters in the JAX order
    and add none; there ``mesh`` is a ``torch.distributed`` ``DeviceMesh``
    (a ground rule, as the dtype is)."""
    import dataclasses
    import importlib
    import inspect

    def pair(module, function):
        return tuple(getattr(importlib.import_module(f"{pkg}.{module}"), function)
                     for pkg in ("fast_solver_lippmann_schwinger_tpu_torch",
                                 "fast_solver_lippmann_schwinger_tpu"))

    if name.startswith("cache_dir:"):
        module, function = CACHE_FUNCTIONS[name.split(":", 1)[1]]
        ours, _ = pair(module, function)
        assert inspect.signature(ours).parameters["cache_dir"].default is None
        assert "cache_dir checkpointing is not ported" not in inspect.getsource(ours)
        return
    if name.endswith("Config"):
        ours, theirs = pair("config", name)
        fo, ft = dataclasses.fields(ours), dataclasses.fields(theirs)
        assert [f.name for f in fo] == [f.name for f in ft]
        for f, g in zip(fo, ft):
            if f.name == "dtype":
                assert (f.type, g.type) == ("torch.dtype", "jnp.dtype")
                assert (f.default, g.default) == (torch.complex64, jnp.complex64)
            elif f.default_factory is not dataclasses.MISSING:
                assert type(f.default_factory()).__name__ == type(g.default_factory()).__name__
            else:
                # prefer_pow2: None in both, the port's None the 5-smooth sizes
                assert (f.type, f.default) == (g.type, g.default), f.name
        return

    if name.startswith("parallel:"):
        module, function = name.split(":", 1)[1].split(".")
        pairs, extras = pair(f"parallel.{module}", function), []
    else:
        pairs, extras = None, None
    (ours, theirs), extras = (pairs, extras) if pairs else {
        "build_problem": (pair("models.plasma2d", "build_problem"), ["device"]),
        "build_slab_system": (pair("ddm.subdomain", "build_slab_system"), ["device", "timings"]),
        "build_fast_convolution_2d": (pair("ops.fastconv", "build_fast_convolution_2d"),
                                      ["device"]),
        "build_slab_system_3d": (pair("ddm.subdomain3d", "build_slab_system_3d"), ["timings"]),
        "plasma_integral2d.build_problem": (pair("models.plasma_integral2d", "build_problem"),
                                            ["device"]),
        "PolarizedTracesPreconditioner3D": (pair("ddm.polarized3d",
                                                 "PolarizedTracesPreconditioner3D"), []),
        "bump2d.build_problem": (pair("models.bump2d", "build_problem"), ["device"]),
        "bump2d.solve": (pair("models.bump2d", "solve"), []),
        "differentiable_solve": (pair("solver.adjoint", "differentiable_solve"), []),
        "compress_factorization_banded": (pair("sparse.direct", "compress_factorization_banded"),
                                          []),
        "compress_factorization_banded_lr": (pair("sparse.direct",
                                                  "compress_factorization_banded_lr"), []),
        "compress_factorization_banded_tail": (pair("sparse.direct",
                                                    "compress_factorization_banded_tail"), []),
        "api.build_problem": (pair("api", "build_problem"), ["device"]),
        "api.solve_problem": (pair("api", "solve_problem"), []),
        "api.solve_problem_batched": (pair("api", "solve_problem_batched"), []),
        "save_field": (pair("utils.fields", "save_field"), []),
        "config_key": (pair("utils.checkpoint", "config_key"), []),
        "build_sparse_a_2d": (pair("sparse.stencils", "build_sparse_a_2d"), ["device"]),
        "factor_stencil_2d_batched": (pair("sparse.direct", "factor_stencil_2d_batched"), []),
        "block_thomas_solve_batched": (pair("sparse.direct", "block_thomas_solve_batched"), []),
        "PhaseTimer.phase": (tuple(c.phase for c in pair("utils.timing", "PhaseTimer")), []),
    }[name]
    ours = list(inspect.signature(ours).parameters.values())
    theirs = list(inspect.signature(theirs).parameters.values())
    assert [p.name for p in ours] == [p.name for p in theirs] + extras
    assert all(p.default is None for p in ours[len(theirs):])
    for p, q in zip(ours, theirs):
        assert p.kind == q.kind, p.name
        if p.name == "dtype":
            assert (p.default, q.default) == (torch.complex64, jnp.complex64)
        elif p.name == "prefer_pow2":
            assert (p.default, q.default) == (False, None)
        else:
            assert p.default == q.default, p.name


def test_pivot_dtype_t_sets_the_transposed_sweep():
    tp = plasma2d.build_problem(dtype=torch.complex64, pivot_dtype="pallas", pivot_dtype_t="full",
                                device="cpu", **{**KW_SWEEP, "n_subdomains": 2})
    assert tp.precond.slabs.pfac is not None and tp.precond.slabs_t.pfac is None
    _, info = plasma2d.solve(tp, **SOLVE)
    assert bool(info.converged)


def test_device_rule():
    """Entry points default to the CUDA card and raise without one; only an
    explicit ``device="cpu"`` runs on the host."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        plasma2d.build_problem(**KW)


@pytest.mark.parametrize("function,args", [
    ("lippmann_schwinger_2d", (np.ones((4, 4), np.complex64), np.ones(4), 1.0, 2, 2, "greengard_vico")),
    ("stencil_matrix_2d", (np.ones((2, 2, 3, 3), np.complex64),)),
    ("block_tridiag_factorization", (np.ones((2, 2, 2), np.complex64),) + (np.ones((2, 2, 3), np.complex64),) * 2),
    ("thomas_factorization", (np.zeros((1, 2, 128, 128), np.uint16),) * 2
     + (np.zeros((1, 2, 2, 3, 128), np.float32),) * 2 + (np.ones((1, 2, 1, 1, 128), np.float32), 2)),
    ("slab_system", ({}, None)),
    ("double_sweep_preconditioner", ({}, {}, np.ones((2, 2, 3, 3), np.complex64),
                                     np.ones((2, 2, 3, 3), np.complex64))),
    ("polarized_traces_preconditioner", ({}, np.ones((2, 2, 3, 3), np.complex64), 2, 1e-2,
                                         40, "GS")),
])
def test_convert_defaults_to_the_card(function, args):
    """The functions that carry JAX objects across follow the device rule too:
    no ``device`` means the card, and an error where there is none."""
    if torch.cuda.is_available():
        pytest.skip("the default device exists here; the rule is tested where it does not")
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(convert, function)(*args)


@pytest.mark.parametrize("kw", [dict(pivot_dtype="banded"), dict(pivot_rank=24),
                                dict(cache_dir="slab_cache"),
                                dict(double_sweep=True, pivot_dtype_t="banded_lr")])
def test_unported_options_raise(tmp_path, kw):
    """The options the port once lacked: the banded pivot modes and
    ``pivot_rank`` now build and solve (``tests/test_torch_banded_pivots.py``
    holds them against the JAX package); ``cache_dir`` (ROADMAP.md, Queue 1
    slice 9) checkpoints the symbol, the stencil fields and the slab
    factorization, which a second build loads bit-identically and solves
    with bit-identically (``tests/test_torch_checkpoint.py`` has the rest)."""
    if "cache_dir" in kw:
        cache = str(tmp_path / kw["cache_dir"])
        p1, p2 = (plasma2d.build_problem(device="cpu", **{**KW, "cache_dir": cache})
                  for _ in range(2))
        assert sorted(f.split("_")[0] for f in os.listdir(cache)) == ["slabfac", "stencils",
                                                                      "symbol"]
        assert torch.equal(p1.op.symbol, p2.op.symbol)
        f1, f2 = p1.precond.slabs.fac, p2.precond.slabs.fac
        assert all(torch.equal(getattr(f1, n), getattr(f2, n)) for n in ("cinv", "lband", "uband"))
        (x1, _), (x2, _) = plasma2d.solve(p1, **SOLVE), plasma2d.solve(p2, **SOLVE)
        assert torch.equal(x1, x2)
        return
    tp = plasma2d.build_problem(dtype=torch.complex128, device="cpu", **{**KW, **kw})
    if kw.get("pivot_dtype_t") == "banded_lr":
        assert isinstance(tp.precond.slabs_t.fac, direct.BlockTridiagFactorizationBandedLR)
        assert isinstance(tp.precond.slabs.fac, direct.BlockTridiagFactorization)
    elif "pivot_dtype" in kw:
        assert isinstance(tp.precond.slabs.fac, direct.BlockTridiagFactorizationBanded)
    _, info = plasma2d.solve(tp, **SOLVE)
    assert bool(info.converged) and float(info.true_residual) < 1e-5


def test_package_imports_no_jax():
    """Every module of the port imports, in a fresh interpreter, without
    pulling in jax, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fast_solver_lippmann_schwinger_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 15, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'fast_solver_lippmann_schwinger_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 15
