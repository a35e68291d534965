"""Phase timing, profiling and timing on the card with CUDA events.

Counterpart of the JAX package's ``utils/timing.py``, which replaces the
reference's ad-hoc ``@time`` / ``tic()``/``toc()`` / ``println`` progress
markers (SURVEY.md section 5) with a structured per-phase timing registry.
Device work is asynchronous, so wall-clock time around a call measures only
its launch: :class:`PhaseTimer` synchronises a CUDA device at the end of each
phase, and events recorded on the stream measure what the card did.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from collections import OrderedDict

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree``: a tensor, or a tuple,
    list or dict of them, nested (the JAX package's pytrees)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return set()
    return set().union(*(_cuda_devices(t) for t in tree))


class PhaseTimer:
    """Collects wall-clock seconds per named phase and prints them as one
    JSON line to ``stream`` (``sys.stderr`` as it is when :meth:`log` runs,
    where ``None``); on a CUDA ``device`` each phase ends with a
    ``torch.cuda.synchronize``, so its time includes the device work it
    enqueued."""

    def __init__(self, stream=None, device=None):
        self.durations = OrderedDict()
        self.stream = stream
        self.device = None if device is None else torch.device(device)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block as phase ``name``.  Before the clock stops it waits
        for the devices of ``block_on`` (a tensor, or a tuple, list or dict of
        them, as the JAX package's ``block_until_ready``): each CUDA device a
        tensor lies on is synchronised, host tensors need no wait."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for device in _cuda_devices(block_on):
                torch.cuda.synchronize(device)
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.durations[name] = self.durations.get(name, 0.0) + time.perf_counter() - t0

    def log(self, **extra) -> None:
        print(json.dumps({"phases_s": dict(self.durations), **extra}),
              file=self.stream or sys.stderr)


@contextlib.contextmanager
def profiled(logdir: str | None = None):
    """Trace a region with ``torch.profiler`` (the host and, where there is a
    card, its kernels) when ``logdir`` is given, and write the Chrome trace
    to ``<logdir>/trace.json``; yields the profiler, or ``None``."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def cuda_time_ms(fn, repeats: int) -> float:
    """Mean milliseconds of ``fn()`` over ``repeats`` back-to-back calls, by
    CUDA events on the current stream, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def card_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them; a card
    set below its maximum runs slower, so every time is kept beside this."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
