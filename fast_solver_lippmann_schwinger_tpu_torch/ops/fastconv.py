"""Fast O(N log N) application of the Lippmann-Schwinger operator.

``M u = u + omega^2 * (G conv (nu .* u))`` applied via zero-padding, FFT,
spectral multiply, inverse FFT, crop: the counterpart of the JAX package's
``ops/fastconv.py`` (reference ``FastM`` and its ``fastconvolution`` /
``FFTconvolution`` applies, ``src/FastConvolution.jl:11-154``, and
``FastM3D``, ``src/FastConvolution3D.jl:7-63``).

Design notes:

* The spectral symbol is stored in standard (unshifted) FFT order; the
  reference's ``fftshift``/``ifftshift`` pair around the Greengard-Vico
  multiply (``src/FastConvolution.jl:94-98``) is folded into the symbol at
  build time, saving two full passes over the extended grid per apply.
* The kernel is embedded in wrap-around (circulant) order so the output
  lands at slice ``[0:m, 0:n]`` and the extended size can be rounded up to
  an FFT-friendly composite (the reference's exact ``2n-1`` is frequently
  prime).
* The FFTs are ``torch.fft`` (cuFFT on the card), as the JAX package leaves
  them to its compiler; no hand-written kernel stands behind this module.
  A leading batch axis rides through every stage, so ``apply`` on an
  ``(R, m*n)`` batch is one set of batched FFTs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fast_solver_lippmann_schwinger_tpu_torch.config import (
    QuadRule,
    real_dtype_of,
    resolve_device,
    to_tensor,
)
from fast_solver_lippmann_schwinger_tpu_torch.ops import greens
from fast_solver_lippmann_schwinger_tpu_torch.utils import checkpoint


@dataclasses.dataclass(frozen=True)
class LippmannSchwinger2D:
    """``M = I + omega^2 G diag(nu)`` on a 2D grid.

    Fields mirror the reference ``FastM`` struct
    (``src/FastConvolution.jl:11-27``) with the symbol pre-folded as
    described in the module docstring.  A frozen dataclass of tensors: there
    is nothing trainable to register.
    """

    symbol: torch.Tensor       # (me, ne) complex: spectral multiplier
    nu: torch.Tensor           # (m, n) real: medium perturbation
    omega: float
    n: int
    m: int
    quad_rule: str

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def size(self):
        return self.m * self.n

    def convolve(self, b: torch.Tensor) -> torch.Tensor:
        """Pure discrete convolution ``G conv b`` (no identity, no nu).

        ``b`` is one field, flat ``(m*n,)`` or gridded ``(m, n)``, or a
        batch of fields with leading axes, ``(R, m*n)`` / ``(R, m, n)``.
        Counterpart of ``FFTconvolution`` (``src/FastConvolution.jl:110-154``).
        """
        m, n = self.m, self.n
        me, ne = self.symbol.shape
        cdtype = self.symbol.dtype
        b3 = b.reshape(-1, m, n)
        batch = b3.shape[0]
        # pruned padding: rows m..me of the extended grid are zero, so the
        # forward row-FFT runs on the m live rows only and the inverse
        # row-FFT on the m output rows only (exact; ~30% fewer FFT points)
        rows = torch.zeros((batch, m, ne), dtype=cdtype, device=b.device)
        rows[:, :, :n] = b3.to(cdtype)
        rows = torch.fft.fft(rows, dim=2)
        ext = torch.zeros((batch, me, ne), dtype=cdtype, device=b.device)
        ext[:, :m] = rows
        spec = self.symbol * torch.fft.fft(ext, dim=1)
        out = torch.fft.ifft(spec, dim=1)[:, :m]
        out = torch.fft.ifft(out, dim=2)[:, :, :n]
        return out.reshape(b.shape)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """``M u = u + omega^2 (G conv (nu u))``: the GMRES hot loop.

        Counterpart of ``fastconvolution`` (``src/FastConvolution.jl:58-107``).
        Takes the same single or batched layouts as :meth:`convolve`.
        """
        nu = self.nu.reshape(-1) if u.shape[-1] == self.size else self.nu
        scaled = (nu * u).to(self.symbol.dtype)
        return u + (self.omega ** 2) * self.convolve(scaled)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.apply(u)


def _cached_symbol(compute, cache_dir, **key_fields) -> np.ndarray:
    """The host spectral symbol (``GFFT``) from ``compute()``, which returns
    ``(sym, *extents)``, or from its checkpoint in ``cache_dir`` keyed on the
    quadrature configuration (the JAX package's ``_cached_symbol``; the size
    class ``pow2`` is resolved before it enters the key)."""
    if cache_dir is None:
        return compute()[0]

    def computed():
        sym, *extents = compute()
        return (sym, *map(int, extents))

    def fits(out):
        sym, *extents = out
        return (sym.dtype == np.complex128 and sym.ndim == key_fields["dim"]
                and sym.shape == tuple(reversed(extents)))

    return checkpoint.cached(checkpoint.path_for(cache_dir, "symbol", **key_fields),
                             computed, fits)[0]


def build_fast_convolution_2d(
    x: np.ndarray,
    y: np.ndarray,
    h: float,
    k: float,
    nu,
    quad_rule: QuadRule | str = QuadRule.TRAPEZOIDAL,
    dtype: torch.dtype = torch.complex64,
    pad_to_friendly: bool = True,
    prefer_pow2: bool = False,
    cache_dir: str | None = None,
    device=None,
) -> LippmannSchwinger2D:
    """Build the 2D fast operator (reference ``buildFastConvolution``,
    ``src/FastConvolution.jl:170-236``): the Duan-Rokhlin corrected
    trapezoidal rule by default, as in the JAX package, or the
    Greengard-Vico truncated kernel.

    ``nu`` is either a callable ``nu(X, Y)`` over coordinate meshes or an
    ``(m, n)`` array.  ``pad_to_friendly=False`` keeps the reference's exact
    extended sizes (``2n-1`` trapezoidal, ``4n`` Greengard-Vico);
    ``prefer_pow2`` picks the size class of the friendly ones (power of two
    instead of 5-smooth).  The symbol is computed on the host in float64 and
    moved to ``device`` in ``dtype``; ``cache_dir`` checkpoints it
    (``utils/checkpoint.py``), keyed on the quadrature configuration.
    """
    device = resolve_device(device)
    quad_rule = QuadRule(quad_rule)
    n, m = len(x), len(y)
    X, Y = np.meshgrid(np.asarray(x), np.asarray(y), indexing="xy")
    nu_arr = nu(X, Y) if callable(nu) else np.asarray(nu).reshape(m, n)

    def _symbol():
        if quad_rule == QuadRule.TRAPEZOIDAL:
            return greens.trapezoidal_kernel_2d(
                n, m, h, k,
                ne=None if pad_to_friendly else 2 * n - 1,
                me=None if pad_to_friendly else 2 * m - 1,
                prefer_pow2=prefer_pow2,
            )
        if pad_to_friendly:
            # exact compact re-embedding of the GV quadrature: ~2n extended
            # grid instead of 4n (see greens.gv_compact_kernel_2d)
            return greens.gv_compact_kernel_2d(n, m, h, k, prefer_pow2=prefer_pow2)
        return greens.gv_symbol_2d(n, m, h, k, ne=4 * n, me=4 * m)

    sym = _cached_symbol(
        _symbol, cache_dir, dim=2, quad=quad_rule.value, n=n, m=m, h=h, k=k,
        pad=pad_to_friendly, pow2=bool(prefer_pow2) if pad_to_friendly else None,
    )

    return LippmannSchwinger2D(
        symbol=to_tensor(sym, dtype, device),
        nu=to_tensor(nu_arr, real_dtype_of(dtype), device),
        omega=float(k),
        n=n,
        m=m,
        quad_rule=quad_rule.value,
    )


@dataclasses.dataclass(frozen=True)
class LippmannSchwinger3D:
    """3D analog (reference ``FastM3D``, ``src/FastConvolution3D.jl:7-63``)."""

    symbol: torch.Tensor       # (le, me, ne) complex
    nu: torch.Tensor           # (l, m, n) real
    omega: float
    n: int
    m: int
    l: int
    quad_rule: str

    @property
    def shape(self):
        return (self.l, self.m, self.n)

    @property
    def size(self):
        return self.l * self.m * self.n

    def convolve(self, b: torch.Tensor) -> torch.Tensor:
        """``G conv b`` for one field, flat ``(l*m*n,)`` or ``(l, m, n)``, or
        a batch with a leading axis, ``(R, l*m*n)`` / ``(R, l, m, n)``."""
        l, m, n = self.l, self.m, self.n
        le, me, ne = self.symbol.shape
        cdtype = self.symbol.dtype
        b4 = b.reshape(-1, l, m, n)
        batch = b4.shape[0]
        # pruned padding (see the 2D convolve), staged per axis: each FFT
        # pass runs only over the slices that are live on its batch axes
        x = torch.zeros((batch, l, m, ne), dtype=cdtype, device=b.device)
        x[..., :n] = b4.to(cdtype)
        x = torch.fft.fft(x, dim=3)
        y = torch.zeros((batch, l, me, ne), dtype=cdtype, device=b.device)
        y[:, :, :m] = x
        y = torch.fft.fft(y, dim=2)
        ext = torch.zeros((batch, le, me, ne), dtype=cdtype, device=b.device)
        ext[:, :l] = y
        spec = self.symbol * torch.fft.fft(ext, dim=1)
        out = torch.fft.ifft(spec, dim=1)[:, :l]
        out = torch.fft.ifft(out, dim=2)[:, :, :m]
        out = torch.fft.ifft(out, dim=3)[..., :n]
        return out.reshape(b.shape)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """``M u = u + omega^2 (G conv (nu u))``; layouts as :meth:`convolve`."""
        nu = self.nu.reshape(-1) if u.shape[-1] == self.size else self.nu
        scaled = (nu * u).to(self.symbol.dtype)
        return u + (self.omega ** 2) * self.convolve(scaled)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.apply(u)


def build_fast_convolution_3d(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    h: float,
    k: float,
    nu,
    quad_rule: QuadRule | str = QuadRule.GREENGARD_VICO,
    dtype: torch.dtype = torch.complex64,
    pad_to_friendly: bool = True,
    prefer_pow2: bool = False,
    cache_dir: str | None = None,
    device=None,
) -> LippmannSchwinger3D:
    """3D fast operator (reference ``buildFastConvolution3D``,
    ``src/FastConvolution3D.jl:68-132``; Greengard-Vico only, as in the
    reference's working path).  ``nu`` is a callable ``nu(X, Y, Z)`` or an
    (l, m, n) array; ``prefer_pow2`` picks the extended-grid size class;
    ``cache_dir`` checkpoints the symbol."""
    device = resolve_device(device)
    quad_rule = QuadRule(quad_rule)
    if quad_rule != QuadRule.GREENGARD_VICO:
        raise NotImplementedError("3D supports the Greengard-Vico rule")
    n, m, l = len(x), len(y), len(z)
    Z, Y, X = np.meshgrid(np.asarray(z), np.asarray(y), np.asarray(x), indexing="ij")
    nu_arr = nu(X, Y, Z) if callable(nu) else np.asarray(nu).reshape(l, m, n)

    def _symbol():
        if pad_to_friendly:
            return greens.gv_compact_kernel_3d(n, m, l, h, k, prefer_pow2=prefer_pow2)
        return greens.gv_symbol_3d(n, m, l, h, k, ne=4 * n, me=4 * m, le=4 * l)

    sym = _cached_symbol(
        _symbol, cache_dir, dim=3, quad=quad_rule.value, n=n, m=m, l=l, h=h, k=k,
        pad=pad_to_friendly, pow2=bool(prefer_pow2) if pad_to_friendly else None,
    )
    return LippmannSchwinger3D(
        symbol=to_tensor(sym, dtype, device),
        nu=to_tensor(nu_arr, real_dtype_of(dtype), device),
        omega=float(k), n=n, m=m, l=l, quad_rule=quad_rule.value,
    )


def sample_g_columns(op, indices: np.ndarray, chunk: int = 64) -> torch.Tensor:
    """Green's-matrix rows via unit-impulse convolutions, on the operator's
    device.

    ``G`` is symmetric, so row j == column j == ``G conv e_j``.  Counterpart
    of ``sampleGConv`` / ``sampleG3D`` (``src/FastConvolution.jl:278-306``,
    ``src/FastConvolution3D.jl:136-160``).  Impulses go through the batched
    ``convolve`` in chunks, and a chunk is cut so that its extended-grid
    intermediates (about 3 live copies per impulse) stay under 8 GB.

    Returns (len(indices), op.size).
    """
    indices = np.asarray(indices, dtype=np.int64)
    ext_bytes = op.symbol.numel() * op.symbol.element_size()
    chunk = max(1, min(chunk, int(8e9 // max(3 * ext_bytes, 1))))
    device = op.symbol.device
    rows = torch.empty((indices.shape[0], op.size), dtype=op.symbol.dtype, device=device)
    for c0 in range(0, indices.shape[0], chunk):
        idx = torch.as_tensor(indices[c0 : c0 + chunk], device=device)
        eye = torch.zeros((idx.shape[0], op.size), dtype=op.symbol.dtype, device=device)
        eye[torch.arange(idx.shape[0], device=device), idx] = 1.0
        rows[c0 : c0 + idx.shape[0]] = op.convolve(eye)
    return rows
