"""The port's CLI, ``python -m fast_solver_lippmann_schwinger_tpu_torch``,
and its field output, against the JAX package's ``api`` and ``save_field``.

``main`` runs in this process with ``--cpu --x64``, from flags and from a
JSON config file (with a ``cache_dir``, so the second run loads the first's
checkpoints): its iteration count is the JAX ``api``'s on the same fields.
The ``.npz`` that ``--save-field`` writes holds the JAX package's keys and
values.  A subprocess runs the module as a user does and shows that JAX
never entered the interpreter.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_solver_lippmann_schwinger_tpu import api as japi
from fast_solver_lippmann_schwinger_tpu import config as jconfig
from fast_solver_lippmann_schwinger_tpu.utils.fields import save_field as jsave_field
from fast_solver_lippmann_schwinger_tpu_torch import __main__ as cli
from fast_solver_lippmann_schwinger_tpu_torch.utils.fields import save_field
from fast_solver_lippmann_schwinger_tpu_torch.utils.timing import PhaseTimer, profiled
from torch_threads import few_threads  # noqa: F401

FLAGS = ["--dim", "2", "--medium", "plasma", "--h", "0.025", "--precond", "double_sweep",
         "--subs", "3"]
ROOT = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module")
def jax_iterations():
    """The JAX ``api``'s count for the fields of :data:`FLAGS`."""
    cfg = jconfig.ProblemConfig(
        dim=2, medium="plasma", h=0.025, precond="double_sweep",
        solver=jconfig.SolverConfig(dtype=jnp.complex128),
        ddm=jconfig.DDMConfig(n_subdomains=3),
    )
    _, info = japi.solve_problem(japi.build_problem(cfg))
    return int(info.n_iterations)


def run_main(argv, capsys):
    """``main(argv)``; returns its stdout lines and its phase-timer record."""
    cli.main(argv)
    out, err = capsys.readouterr()
    timer = json.loads(err.strip().splitlines()[-1])
    return out.splitlines(), timer


def iterations(lines) -> int:
    (line,) = [ln for ln in lines if ln.startswith("iterations to convergence:")]
    return int(line.split(":")[1])


def test_main_with_flags(jax_iterations, capsys, tmp_path):
    base = str(tmp_path / "u")
    lines, timer = run_main(FLAGS + ["--cpu", "--x64", "--save-field", base], capsys)
    assert iterations(lines) == jax_iterations
    assert any(ln.startswith("residual history:") for ln in lines)
    assert any(ln.startswith("field artifacts:") and base + ".npz" in ln for ln in lines)
    assert set(timer["phases_s"]) == {"setup", "solve"}
    assert timer["grid"] == [41, 41] and timer["precond"] == "double_sweep"
    data = np.load(base + ".npz")
    assert data["u"].shape == (41, 41) and data["u"].dtype == np.complex128
    assert len(data["residuals"]) == jax_iterations + 1


def test_main_with_a_config_file(jax_iterations, capsys, tmp_path):
    """The same fields from a config file, whose ``dtype`` string maps to the
    torch dtype, twice on one ``cache_dir``: the second run loads the
    checkpoints and solves the same."""
    cfg = dict(dim=2, medium="plasma", h=0.025, precond="double_sweep",
               cache_dir=str(tmp_path / "cache"), ddm=dict(n_subdomains=3),
               solver=dict(dtype="complex128"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    runs = []
    for i in range(2):
        base = str(tmp_path / f"u{i}")
        lines, _ = run_main(["--config", str(path), "--cpu", "--save-field", base], capsys)
        assert iterations(lines) == jax_iterations
        runs.append(np.load(base + ".npz")["u"])
    np.testing.assert_array_equal(runs[0], runs[1])
    files = os.listdir(cfg["cache_dir"])
    assert sorted(f.split("_")[0] for f in files) == ["slabfac", "slabfac", "stencils", "symbol"]


@pytest.mark.parametrize("shape", [(30, 40), (4, 5, 6)])
def test_save_field_npz_is_the_jax_packages(tmp_path, shape):
    """The same array and residuals give the same ``.npz`` keys and values as
    the JAX package's ``save_field``, for a 2D field and a 3D one (whose
    picture is its middle slice); a CPU tensor is taken as it is."""
    rng = np.random.default_rng(0)
    size = int(np.prod(shape))
    u = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    res = np.array([1.0, 0.3, 0.01, 0.0, 0.0])
    ours = save_field(str(tmp_path / "port.npz"), torch.as_tensor(u), shape,
                      residuals=torch.as_tensor(res), title="t")
    theirs = jsave_field(str(tmp_path / "jax"), u, shape, residuals=res, title="t")
    assert [os.path.splitext(f)[1] for f in ours] == [os.path.splitext(f)[1] for f in theirs]
    a, b = np.load(ours[0]), np.load(theirs[0])
    assert sorted(a.files) == sorted(b.files) == ["residuals", "shape", "u"]
    for key in a.files:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key])


def test_module_run_imports_no_jax(tmp_path):
    """``python -m fast_solver_lippmann_schwinger_tpu_torch --cpu ...`` as a
    user runs it: it solves and writes its field, and neither jax nor the
    JAX package entered the interpreter."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['fast_solver_lippmann_schwinger_tpu_torch'] + {FLAGS!r} + "
        f"['--cpu', '--save-field', {str(tmp_path / 'u')!r}]\n"
        "runpy.run_module('fast_solver_lippmann_schwinger_tpu_torch', run_name='__main__',\n"
        "                 alter_sys=True)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'fast_solver_lippmann_schwinger_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "iterations to convergence:" in out.stdout
    assert os.path.exists(tmp_path / "u.npz")


def test_main_without_cpu_needs_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("the default device exists here; the rule is tested where it does not")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(FLAGS)


def test_phase_timer_blocks_on_what_the_jax_method_takes():
    """``PhaseTimer.phase(name, block_on=...)`` takes the JAX method's
    argument: a tensor, or a tuple (list, dict) of them, nested, with other
    leaves ignored; host tensors need no wait, and each phase is recorded,
    repeats added up."""
    timer = PhaseTimer(device="cpu")
    x = torch.ones(8)
    with timer.phase("one", block_on=x):
        x = x * 2
    with timer.phase("many", block_on=(x, [x, None], {"y": x, "n": 3})):
        x = x + 1
    with timer.phase("one", block_on=x):
        pass
    assert list(timer.durations) == ["one", "many"]
    assert all(seconds >= 0.0 for seconds in timer.durations.values())


def test_phase_timer_and_profiled(tmp_path, capsys):
    """``PhaseTimer`` adds up repeated phases and prints one JSON line on
    stderr; ``profiled`` writes a Chrome trace of its region, and without a
    directory traces nothing."""
    timer = PhaseTimer(device="cpu")
    for _ in range(2):
        with timer.phase("work"):
            torch.ones(8).sum()
    timer.log(tag="x")
    record = json.loads(capsys.readouterr().err.strip())
    assert list(record["phases_s"]) == ["work"] and record["tag"] == "x"
    with profiled(str(tmp_path / "trace")) as prof:
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    assert prof is not None and os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with profiled(None) as prof:
        pass
    assert prof is None
