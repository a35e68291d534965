"""Multi-device FFT convolution with all-to-all transposes.

Counterpart of the JAX package's ``parallel/fft.py``: the extended grid of
the Lippmann-Schwinger apply (4x the field in 2D, 8x in 3D) is split over
the ranks of a 1-D ``torch.distributed`` mesh, and the FFT is decomposed the
slab-pencil way:

    rows local -> FFT over the local axes -> ``all_to_all`` transpose ->
    FFT over the remaining axis -> spectral multiply against the symbol
    block this rank holds (split the transposed way) -> the inverse in
    reverse order.

Two ``all_to_all_single`` calls a convolve; the symbol never moves.  The
user-facing field stays replicated: every rank passes the same (m, n) field
and gets the same result, its row blocks gathered with one
``all_gather_into_tensor``.  The FFTs are ``torch.fft`` (cuFFT on the card);
no hand-written kernel runs here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from fast_solver_lippmann_schwinger_tpu_torch.config import QuadRule, real_dtype_of, to_tensor
from fast_solver_lippmann_schwinger_tpu_torch.ops import greens
from fast_solver_lippmann_schwinger_tpu_torch.parallel.sharded import (
    _real,
    all_gather_rows,
    shard_device,
)


def _all_to_all(group, chunks: torch.Tensor) -> torch.Tensor:
    """(D, ...) chunks, chunk j to rank j -> (D, ...), chunk j from rank j."""
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(_real(out), _real(chunks), group=group)
    return out


class _Distributed:
    """What the two operators share: the mesh axis, and this rank's place."""

    @functools.cached_property
    def group(self):
        return self.mesh.get_group(self.axis)

    @functools.cached_property
    def n_ranks(self) -> int:
        return dist.get_world_size(self.group)

    @functools.cached_property
    def rank(self) -> int:
        return self.mesh.get_local_rank(self.axis)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """``M u = u + omega^2 (G conv (nu u))`` for one field, flat or gridded."""
        scaled = (self.nu.reshape(u.shape) * u).to(self.symbol.dtype)
        return u + (self.omega ** 2) * self.convolve(scaled)

    def apply_batch(self, u: torch.Tensor) -> torch.Tensor:
        """(R, N) batched operator apply."""
        scaled = (self.nu.reshape(1, -1) * u.reshape(u.shape[0], -1)).to(self.symbol.dtype)
        return u + (self.omega ** 2) * self.convolve_batch(scaled).reshape(u.shape)

    def convolve(self, b: torch.Tensor) -> torch.Tensor:
        """``G conv b`` for one replicated field, flat or gridded."""
        return self.convolve_batch(b.reshape(1, -1)).reshape(b.shape)

    def __call__(self, u):
        return self.apply(u)


@dataclasses.dataclass(frozen=True, eq=False)
class DistributedLS2D(_Distributed):
    """2D Lippmann-Schwinger operator whose extended grid is split over a
    mesh axis: this rank holds the column block ``symbol`` (me, ne/D) of the
    spectral symbol and transforms the row block me/D of the extended grid.
    The (m, n) field stays replicated (grid sizes need not divide over the
    mesh)."""

    symbol: torch.Tensor       # (me, ne/D) complex: this rank's columns
    nu: torch.Tensor           # (m, n) real, replicated
    omega: float
    n: int
    m: int
    axis: str
    mesh: object

    def convolve_batch(self, b: torch.Tensor) -> torch.Tensor:
        """(R, m*n) batch convolution: the batch rides along every local FFT
        (feeds ``gmres_batched`` with the pipelined sharded sweep
        preconditioner, the composed multi-device solve)."""
        D, me_rank = self.n_ranks, self.rank
        me_, cols = self.symbol.shape
        ne, rows = cols * D, me_ // D
        R = b.shape[0]
        bg = b.reshape(R, self.m, self.n).to(self.symbol.dtype)
        x = torch.zeros((R, rows, ne), dtype=self.symbol.dtype, device=self.symbol.device)
        lo, hi = me_rank * rows, min((me_rank + 1) * rows, self.m)
        if hi > lo:
            x[:, : hi - lo, : self.n] = bg[:, lo:hi]
        x = torch.fft.fft(x, dim=2)
        # columns to their owners: (D, R, rows, cols) -> (R, me, cols)
        x = _all_to_all(self.group, x.reshape(R, rows, D, cols).permute(2, 0, 1, 3))
        x = x.permute(1, 0, 2, 3).reshape(R, me_, cols)
        x = torch.fft.ifft(self.symbol * torch.fft.fft(x, dim=1), dim=1)
        # rows back: (D, R, rows, cols) -> (R, rows, ne)
        x = _all_to_all(self.group, x.reshape(R, D, rows, cols).permute(1, 0, 2, 3))
        x = x.permute(1, 2, 0, 3).reshape(R, rows, ne)
        out = torch.fft.ifft(x, dim=2)[:, :, : self.n]
        whole = all_gather_rows(self.group, out.transpose(0, 1))       # (me, R, n)
        return whole[: self.m].transpose(0, 1).reshape(b.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class DistributedLS3D(_Distributed):
    """3D counterpart: the extended grid split into z-slabs over the mesh
    axis, the symbol held in y-pencils (le, me/D, ne)."""

    symbol: torch.Tensor       # (le, me/D, ne) complex: this rank's y block
    nu: torch.Tensor           # (l, m, n) real, replicated
    omega: float
    n: int
    m: int
    l: int                     # noqa: E741
    axis: str
    mesh: object

    def convolve_batch(self, b: torch.Tensor) -> torch.Tensor:
        """(R, l*m*n) batch convolution in one sharded pass (composes with
        ``make_sharded_sweep_preconditioner_3d_pipelined`` and
        ``gmres_batched`` into the 3D multi-device solve)."""
        D, me_rank = self.n_ranks, self.rank
        le, ys, ne = self.symbol.shape
        me_, zs = ys * D, le // D
        R = b.shape[0]
        bg = b.reshape(R, self.l, self.m, self.n).to(self.symbol.dtype)
        x = torch.zeros((R, zs, me_, ne), dtype=self.symbol.dtype, device=self.symbol.device)
        lo, hi = me_rank * zs, min((me_rank + 1) * zs, self.l)
        if hi > lo:
            x[:, : hi - lo, : self.m, : self.n] = bg[:, lo:hi]
        x = torch.fft.fftn(x, dim=(2, 3))
        # y blocks to their owners: (D, R, zs, ys, ne) -> (R, le, ys, ne)
        x = _all_to_all(self.group, x.reshape(R, zs, D, ys, ne).permute(2, 0, 1, 3, 4))
        x = x.permute(1, 0, 2, 3, 4).reshape(R, le, ys, ne)
        x = torch.fft.ifft(self.symbol * torch.fft.fft(x, dim=1), dim=1)
        # z blocks back: (D, R, zs, ys, ne) -> (R, zs, me, ne)
        x = _all_to_all(self.group, x.reshape(R, D, zs, ys, ne).permute(1, 0, 2, 3, 4))
        x = x.permute(1, 2, 0, 3, 4).reshape(R, zs, me_, ne)
        out = torch.fft.ifftn(x, dim=(2, 3))[:, :, : self.m, : self.n]
        whole = all_gather_rows(self.group, out.transpose(0, 1))       # (le, R, m, n)
        return whole[: self.l].transpose(0, 1).reshape(b.shape)


def build_distributed_fast_convolution_2d(
    x, y, h, k, nu, mesh, axis: str = "slab",
    quad_rule: QuadRule | str = QuadRule.GREENGARD_VICO,
    dtype=torch.complex64,
) -> DistributedLS2D:
    """Distributed counterpart of ``build_fast_convolution_2d`` (Greengard-
    Vico by default, as the JAX function): the extended sizes are 5-smooth
    multiples of the mesh-axis size, and this rank keeps the symbol's column
    block on its device, so the spectral multiply is local."""
    quad_rule = QuadRule(quad_rule)
    n, m = len(x), len(y)
    group = mesh.get_group(axis)
    D, rank = dist.get_world_size(group), mesh.get_local_rank(axis)
    device = shard_device(mesh, axis)
    X, Y = np.meshgrid(np.asarray(x), np.asarray(y), indexing="xy")
    nu_arr = nu(X, Y) if callable(nu) else np.asarray(nu).reshape(m, n)
    ne = greens.good_fft_size(2 * n - 1, multiple_of=D)
    me = greens.good_fft_size(2 * m - 1, multiple_of=D)
    if quad_rule == QuadRule.TRAPEZOIDAL:
        sym, ne, me = greens.trapezoidal_kernel_2d(n, m, h, k, ne=ne, me=me)
    else:
        sym, ne, me = greens.gv_compact_kernel_2d(n, m, h, k, ne=ne, me=me)
    cols = ne // D
    return DistributedLS2D(
        symbol=to_tensor(sym[:, rank * cols:(rank + 1) * cols], dtype, device),
        nu=to_tensor(nu_arr, real_dtype_of(dtype), device),
        omega=float(k), n=n, m=m, axis=axis, mesh=mesh,
    )


def build_distributed_fast_convolution_3d(
    x, y, z, h, k, nu, mesh, axis: str = "slab",
    dtype=torch.complex64,
) -> DistributedLS3D:
    """3D distributed builder (the compact Greengard-Vico symbol; reference
    ``buildFastConvolution3D``, ``src/FastConvolution3D.jl:68-132``): z and y
    extents are multiples of the mesh-axis size; this rank keeps its y block
    of the symbol."""
    n, m, l = len(x), len(y), len(z)
    group = mesh.get_group(axis)
    D, rank = dist.get_world_size(group), mesh.get_local_rank(axis)
    device = shard_device(mesh, axis)
    X = np.asarray(x)[None, None, :]
    Y = np.asarray(y)[None, :, None]
    Z = np.asarray(z)[:, None, None]
    nu_arr = nu(X, Y, Z) if callable(nu) else np.asarray(nu).reshape(l, m, n)
    nu_arr = np.broadcast_to(nu_arr, (l, m, n))
    ne = greens.good_fft_size(2 * n - 1)
    me = greens.good_fft_size(2 * m - 1, multiple_of=D)
    le = greens.good_fft_size(2 * l - 1, multiple_of=D)
    sym, ne, me, le = greens.gv_compact_kernel_3d(n, m, l, h, k, ne=ne, me=me, le=le)
    ys = me // D
    return DistributedLS3D(
        symbol=to_tensor(sym[:, rank * ys:(rank + 1) * ys], dtype, device),
        nu=to_tensor(nu_arr, real_dtype_of(dtype), device),
        omega=float(k), n=n, m=m, l=l, axis=axis, mesh=mesh,
    )
