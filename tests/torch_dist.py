"""Multi-rank harness for the port's ``parallel/`` tests on the CPU.

:func:`run_ranks` spawns D processes (``torch.multiprocessing``, spawn),
each a rank of a gloo process group on a ``FileStore`` under the test's
temporary directory (no TCP port, so test workers side by side never
collide), with a 60 s collective timeout, one PyTorch thread, and a 1-D
``DeviceMesh`` ``("slab",)`` on the CPU.  Every rank calls
``module.function(mesh, inputs)`` and saves what it returns; the parent
returns the list of the ranks' results.  The ranks run under a hard
deadline: past it they are killed and the test fails, so a hung collective
never holds the test run.

The rank function lives in the test module and is found by name; a test
module that defines one imports JAX only inside its tests and fixtures, so
the ranks never import it.  Inputs and results travel as ``torch.save``
files.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

DEADLINE_S = 150.0
COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def _rank_main(rank: int, world: int, module: str, function: str, workdir: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("slab",))
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        out = getattr(importlib.import_module(module), function)(mesh, inputs)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, module: str, function: str, inputs, workdir,
              deadline: float = DEADLINE_S) -> list:
    """Run ``module.function(mesh, inputs)`` on ``world`` ranks; returns each
    rank's result, in rank order."""
    import torch.multiprocessing as mp

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    ctx = mp.start_processes(_rank_main, args=(world, module, function, workdir),
                             nprocs=world, join=False, start_method="spawn")
    stop = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > stop:
                pytest.fail(f"{module}.{function} on {world} ranks passed its "
                            f"{deadline:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def same_on_every_rank(results: list):
    """Assert that every rank returned the same bits; return rank 0's."""
    first = results[0]
    for r, other in enumerate(results[1:], start=1):
        assert first.keys() == other.keys()
        for key, value in first.items():
            got = other[key]
            if isinstance(value, torch.Tensor):
                assert torch.equal(value, got), f"rank {r} differs from rank 0 in {key!r}"
            else:
                assert value == got, f"rank {r} differs from rank 0 in {key!r}"
    return first


def slab_fields(js) -> dict:
    """A JAX 2D slab system (full or plain compressed pivots, with its
    kernel layout if any) as the dict of numpy arrays ``convert.slab_system``
    takes."""
    d = {f.name: (np.asarray(getattr(js, f.name)) if hasattr(getattr(js, f.name), "shape")
                  else getattr(js, f.name))
         for f in dataclasses.fields(js) if f.name not in ("fac", "pfac")}
    fac = {f.name: getattr(js.fac, f.name) for f in dataclasses.fields(js.fac)}
    d["fac"] = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in fac.items()}
    p = js.pfac
    d["pfac"] = None if p is None else dict(
        cinv_t_re=np.asarray(p.cinv_t_re).view(np.uint16),
        cinv_t_im=np.asarray(p.cinv_t_im).view(np.uint16),
        lband=np.asarray(p.lband), uband=np.asarray(p.uband),
        scale=np.asarray(p.scale), n=p.n,
    )
    return d


def slab_fields_3d(js) -> dict:
    """A JAX 3D slab system as the dict ``convert.slab_system_3d`` takes."""
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
        bits = ((lambda p: np.asarray(p).view(np.uint16)) if str(st.p_re.dtype) == "bfloat16"
                else np.asarray)
        out["pfac"] = dict(p_re=bits(st.p_re), p_im=bits(st.p_im), scale=np.asarray(st.scale),
                           mn=st.mn, l1=st.l1)
    return out
