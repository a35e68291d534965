"""Setup-time Green's-function kernel tables and Fourier symbols.

All artifacts here are computed once per problem on the host in float64
(the Hankel tables by the native sampler, ``native/sampler.py``; the other
special functions via SciPy), then moved to the device in the working
complex dtype.  The hot loop (``ops/fastconv.py``) never
evaluates a Bessel function.

Reference counterparts:

* Duan-Rokhlin diagonal-correction table — ``src/FastConvolution.jl:407-415``
* extended trapezoidal kernel table ``buildGConv`` — ``src/FastConvolution.jl:425-469``
* Greengard-Vico truncated-kernel symbol ``Gtruncated2D`` —
  ``src/Functions.jl:40-42``, used at ``src/FastConvolution.jl:185-235``
* dense row sampling ``sampleG`` — ``src/FastConvolution.jl:239-275``
* the dense quadrature matrix ``buildConvMatrix`` (a test oracle) —
  ``src/FastConvolution.jl:497-513``
"""

from __future__ import annotations

import numpy as np
from scipy.special import hankel1, jv

from fast_solver_lippmann_schwinger_tpu_torch.native.sampler import (
    hankel_kernel_table,
)

# -----------------------------------------------------------------------------
# Duan-Rokhlin corrected trapezoidal rule
# -----------------------------------------------------------------------------

# Table of diagonal corrections D0 vs k*h from R. Duan & V. Rokhlin,
# "High-order quadratures for the solution of scattering problems in two
# dimensions" (J. Comput. Phys.).  Same values as the reference's
# ``referenceValsTrapRule`` (``src/FastConvolution.jl:407-415``): entry j
# corresponds to k*h = 2^{-(j-1)} ... in practice the example scripts always use
# k*h = 1 and take the first entry.
_DUAN_ROKHLIN_KH = 2.0 ** (-np.arange(6))
_DUAN_ROKHLIN_D0 = np.array(
    [
        1 - 0.892j,
        1 - 1.35j,
        1 - 1.79j,
        1 - 2.23j,
        1 - 2.67j,
        1 - 3.11j,
    ]
)


def duan_rokhlin_table():
    """(k*h values, D0 corrections) — mirrors ``referenceValsTrapRule()``."""
    return _DUAN_ROKHLIN_KH.copy(), _DUAN_ROKHLIN_D0.copy()


def duan_rokhlin_d0(kh: float) -> complex:
    """Diagonal correction for a given k*h.

    The reference indexes its table as ``D[round(Int, k*h)]`` which resolves
    to the first entry for the k*h = 1 configurations used by every example script;
    we look up the nearest tabulated k*h instead.
    """
    idx = int(np.argmin(np.abs(_DUAN_ROKHLIN_KH - kh)))
    return complex(_DUAN_ROKHLIN_D0[idx])


# -----------------------------------------------------------------------------
# FFT-size helper
# -----------------------------------------------------------------------------

def good_fft_size(minimum: int, multiple_of: int = 1,
                  prefer_pow2: bool = False) -> int:
    """Smallest FFT-fast integer >= minimum (and divisible by
    ``multiple_of``).

    The reference uses exact sizes 2n-1 / 4n which are frequently prime
    (e.g. 1601) and catastrophic for FFT performance; the circulant
    embedding is exact for ANY size >= the minimum, so we round up: to the
    smallest 5-smooth (2^a 3^b 5^c) composite by default, or to the next
    power of two with ``prefer_pow2=True``.  The choice is explicit here
    (the JAX package sniffs its backend and picks 5-smooth on the CPU);
    which class cuFFT runs faster is an open question in ``PERF.md``.
    """
    if minimum <= 1:
        minimum = 1
    if prefer_pow2 and multiple_of & (multiple_of - 1) == 0:
        p = 1
        while p < minimum or p % multiple_of:
            p *= 2
        return p
    best = None
    p2 = 1
    while p2 < 2 * minimum * multiple_of:
        p23 = p2
        while p23 < 2 * minimum * multiple_of:
            p235 = p23
            while p235 < minimum or p235 % multiple_of:
                p235 *= 5
                if p235 > 4 * minimum * multiple_of:
                    break
            if p235 >= minimum and p235 % multiple_of == 0 and (
                best is None or p235 < best
            ):
                best = p235
            p23 *= 3
        p2 *= 2
    if best is None:
        raise ValueError(
            f"no 5-smooth size >= {minimum} divisible by {multiple_of} "
            "(multiple_of must itself be 5-smooth)"
        )
    return best


# -----------------------------------------------------------------------------
# Trapezoidal-rule circulant kernel (2D)
# -----------------------------------------------------------------------------

def trapezoidal_kernel_2d(n: int, m: int, h: float, k: float,
                          d0: complex | None = None,
                          ne: int | None = None, me: int | None = None,
                          prefer_pow2: bool = False):
    """Circulant-embedded Duan-Rokhlin kernel table, in Fourier space.

    Builds the displacement table ``K[dy, dx] = (i/4) h^2 H0^(1)(k r)`` for
    displacements dx in [-(n-1), n-1], dy in [-(m-1), m-1] with the corrected
    diagonal ``(i/4) D0 h^2`` (reference ``buildGConv``,
    ``src/FastConvolution.jl:425-469``), embeds it in a circulant of size
    ``(me, ne)`` in wrap-around order, and returns its 2D FFT.

    The wrap-around layout puts the convolution output at slice ``[0:m, 0:n]``
    and permits any ``ne >= 2n-1``: the default is :func:`good_fft_size` of
    ``2n-1`` (the reference's exact size, frequently prime, is
    ``ne=2n-1``).

    Returns (symbol (me, ne) complex128, ne, me).
    """
    if d0 is None:
        d0 = duan_rokhlin_d0(k * h)
    ne = good_fft_size(2 * n - 1, prefer_pow2=prefer_pow2) if ne is None else ne
    me = good_fft_size(2 * m - 1, prefer_pow2=prefer_pow2) if me is None else me
    if ne < 2 * n - 1 or me < 2 * m - 1:
        raise ValueError(
            f"circulant embedding needs ne >= {2 * n - 1}, me >= {2 * m - 1}; "
            f"got ({ne}, {me})"
        )

    dx = h * np.arange(-(n - 1), n)          # (2n-1,)
    dy = h * np.arange(-(m - 1), m)          # (2m-1,)
    r = np.sqrt(dx[None, :] ** 2 + dy[:, None] ** 2)
    r[m - 1, n - 1] = 1.0                    # dodge the singularity
    tab = hankel_kernel_table(k, r, h)       # (i/4) h^2 H0(k r)
    tab[m - 1, n - 1] = 0.25j * d0 * h ** 2

    circ = np.zeros((me, ne), dtype=np.complex128)
    # wrap displacement (dyi - (m-1), dxi - (n-1)) to circulant index
    iy = (np.arange(2 * m - 1) - (m - 1)) % me
    ix = (np.arange(2 * n - 1) - (n - 1)) % ne
    circ[np.ix_(iy, ix)] = tab
    return np.fft.fft2(circ), ne, me


# -----------------------------------------------------------------------------
# Greengard-Vico truncated-kernel symbols
# -----------------------------------------------------------------------------

def gtruncated_2d(L: float, k: float, s: np.ndarray) -> np.ndarray:
    """Fourier transform of the radially truncated 2D Helmholtz kernel.

    G_L^(s) = (1 + (i pi/2) L H0^(1)(Lk) s J1(Ls)
                 - (i pi/2) L k H1^(1)(Lk) J0(Ls)) / (s^2 - k^2)

    Matches ``Gtruncated2D`` (``src/Functions.jl:40-42``).  The apparent
    singularity at s = k is removable and never hit on the integer k-grid.
    """
    h0lk = hankel1(0, L * k)
    h1lk = hankel1(1, L * k)
    num = (
        1.0
        + (0.5j * np.pi * L * h0lk) * (s * jv(1, L * s))
        - (0.5j * np.pi * L * k * h1lk) * jv(0, L * s)
    )
    return num / (s ** 2 - k ** 2)


def gv_symbol_2d(n: int, m: int, h: float, k: float,
                 ne: int | None = None, me: int | None = None,
                 truncation_factor: float = 1.5):
    """Greengard-Vico spectral multiplier on the 4x-extended grid.

    The reference samples the analytic symbol at integer wavenumbers
    ``(2 pi / Lp) * j`` with ``Lp = 4 n h`` on a 4n-point grid in fftshift
    order and multiplies shifted spectra (``src/FastConvolution.jl:185-234``,
    ``fastconvolution`` GV branch ``:84-102``).  Equivalently we fold the
    shift into the symbol once and store it in standard FFT order.

    ``ne`` may exceed 4n (FFT-friendly rounding): the truncation radius
    ``L = 1.5 n h`` only requires the extended period ``ne h >= n h + 2 L``,
    i.e. ne >= 4n.  The default keeps the reference's exact ne = 4n.

    Returns (symbol (me, ne) complex128 in unshifted FFT order, ne, me).
    """
    ne = 4 * n if ne is None else ne
    me = 4 * m if me is None else me
    if ne < 4 * n or me < 4 * m:
        raise ValueError(
            f"GV extended grid needs ne >= {4 * n}, me >= {4 * m}; "
            f"got ({ne}, {me})"
        )
    Lp_x = ne * h
    Lp_y = me * h
    L = truncation_factor * n * h   # = 1.5 * (span + h), span = (n-1) h

    kx = (2 * np.pi / Lp_x) * (np.arange(ne) - ne // 2)
    ky = (2 * np.pi / Lp_y) * (np.arange(me) - me // 2)
    s = np.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2)
    sym_shifted = gtruncated_2d(L, k, s)
    return np.fft.ifftshift(sym_shifted), ne, me


def gv_compact_kernel_2d(n: int, m: int, h: float, k: float,
                         ne: int | None = None, me: int | None = None,
                         truncation_factor: float = 1.5,
                         prefer_pow2: bool = False):
    """Greengard-Vico quadrature on a compact (~2n) extended grid.

    The GV spectral apply on the 4n grid (``gv_symbol_2d``) realizes a
    discrete convolution whose real-space taps at grid displacements are the
    inverse FFT of the symbol.  Since every displacement between points of
    the n-grid lies within the (2n-1)^2 table — and the truncated kernel's
    support radius L = 1.5 n h covers the maximal in-grid distance
    sqrt(2) (n-1) h — extracting that table and re-embedding it in a
    circulant of any size >= 2n-1 applies the EXACT same operator with
    ~2.5x fewer FFT points (8x in 3D) and power-of-two-friendly sizes.

    Returns (symbol (me, ne) complex128 in unshifted order, ne, me).
    """
    full, ne4, me4 = gv_symbol_2d(
        n, m, h, k, truncation_factor=truncation_factor
    )
    kern = np.fft.ifft2(full)                 # real-space taps, periodic 4n
    dx = np.arange(-(n - 1), n) % ne4
    dy = np.arange(-(m - 1), m) % me4
    tab = kern[np.ix_(dy, dx)]                # (2m-1, 2n-1) displacement table

    ne = good_fft_size(2 * n - 1, prefer_pow2=prefer_pow2) if ne is None else ne
    me = good_fft_size(2 * m - 1, prefer_pow2=prefer_pow2) if me is None else me
    if ne < 2 * n - 1 or me < 2 * m - 1:
        raise ValueError(
            f"compact embedding needs ne >= {2 * n - 1}, me >= {2 * m - 1}; "
            f"got ({ne}, {me})"
        )
    circ = np.zeros((me, ne), dtype=np.complex128)
    iy = (np.arange(2 * m - 1) - (m - 1)) % me
    ix = (np.arange(2 * n - 1) - (n - 1)) % ne
    circ[np.ix_(iy, ix)] = tab
    return np.fft.fft2(circ), ne, me


def gtruncated_3d(L: float, k: float, s: np.ndarray) -> np.ndarray:
    """3D truncated-kernel symbol (``src/Functions.jl:45-47``)."""
    return (-1.0 + np.exp(1j * L * k) * (np.cos(L * s) - 1j * k * L * np.sinc(L * s / np.pi))) / (
        k ** 2 - s ** 2
    )


def gv_symbol_3d(n: int, m: int, l: int, h: float, k: float,
                 ne: int | None = None, me: int | None = None,
                 le: int | None = None,
                 truncation_factor: float = 1.8):
    """3D Greengard-Vico symbol (``src/FastConvolution3D.jl:68-132``;
    truncation radius factor 1.8 per ``:73``).

    Returns (symbol (le, me, ne) complex128, unshifted order, ne, me, le).
    """
    ne = 4 * n if ne is None else ne
    me = 4 * m if me is None else me
    le = 4 * l if le is None else le
    L = truncation_factor * n * h

    kx = (2 * np.pi / (ne * h)) * (np.arange(ne) - ne // 2)
    ky = (2 * np.pi / (me * h)) * (np.arange(me) - me // 2)
    kz = (2 * np.pi / (le * h)) * (np.arange(le) - le // 2)
    s = np.sqrt(
        kx[None, None, :] ** 2 + ky[None, :, None] ** 2 + kz[:, None, None] ** 2
    )
    sym_shifted = gtruncated_3d(L, k, s)
    return np.fft.ifftshift(sym_shifted), ne, me, le


def gv_compact_kernel_3d(n: int, m: int, l: int, h: float, k: float,
                         ne: int | None = None, me: int | None = None,
                         le: int | None = None,
                         truncation_factor: float = 1.8,
                         prefer_pow2: bool = False):
    """3D compact GV embedding (see :func:`gv_compact_kernel_2d`): the
    support radius 1.8 n h covers sqrt(3) (n-1) h, so the (2n-1)^3 tap table
    is complete and the extended grid shrinks from (4n)^3 to ~(2n)^3.

    Returns (symbol (le, me, ne) complex128 unshifted, ne, me, le).
    """
    full, ne4, me4, le4 = gv_symbol_3d(
        n, m, l, h, k, truncation_factor=truncation_factor
    )
    kern = np.fft.ifftn(full)
    dx = np.arange(-(n - 1), n) % ne4
    dy = np.arange(-(m - 1), m) % me4
    dz = np.arange(-(l - 1), l) % le4
    tab = kern[np.ix_(dz, dy, dx)]

    ne = good_fft_size(2 * n - 1, prefer_pow2=prefer_pow2) if ne is None else ne
    me = good_fft_size(2 * m - 1, prefer_pow2=prefer_pow2) if me is None else me
    le = good_fft_size(2 * l - 1, prefer_pow2=prefer_pow2) if le is None else le
    if ne < 2 * n - 1 or me < 2 * m - 1 or le < 2 * l - 1:
        raise ValueError(
            f"compact embedding needs (ne, me, le) >= "
            f"({2 * n - 1}, {2 * m - 1}, {2 * l - 1}); got ({ne}, {me}, {le})"
        )
    circ = np.zeros((le, me, ne), dtype=np.complex128)
    ix = (np.arange(2 * n - 1) - (n - 1)) % ne
    iy = (np.arange(2 * m - 1) - (m - 1)) % me
    iz = (np.arange(2 * l - 1) - (l - 1)) % le
    circ[np.ix_(iz, iy, ix)] = tab
    return np.fft.fftn(circ), ne, me, le


# -----------------------------------------------------------------------------
# Dense Green's-row sampling (setup / oracles)
# -----------------------------------------------------------------------------

def sample_g_rows_2d(k: float, X: np.ndarray, Y: np.ndarray,
                     ind_s: np.ndarray, d0: complex, h: float) -> np.ndarray:
    """Rows ``G[ind_s, :]`` of the dense quadrature matrix.

    ``G[i, j] = (i/4) h^2 H0^(1)(k |x_i - x_j|)`` with Duan-Rokhlin diagonal
    — mirrors ``sampleG`` (``src/FastConvolution.jl:239-275``).
    X, Y are flat coordinate vectors (x-fastest order).
    """
    ind_s = np.asarray(ind_s)
    r = np.sqrt(
        (X[None, :] - X[ind_s, None]) ** 2 + (Y[None, :] - Y[ind_s, None]) ** 2
    )
    rows = np.arange(ind_s.shape[0])
    r[rows, ind_s] = 1.0
    g = hankel_kernel_table(k, r, h)
    g[rows, ind_s] = 0.25j * d0 * h ** 2
    return g


def dense_conv_matrix_2d(k: float, X: np.ndarray, Y: np.ndarray,
                         d0: complex, h: float) -> np.ndarray:
    """Full dense quadrature matrix G (test oracle).

    Mirrors ``buildConvMatrix`` (``src/FastConvolution.jl:497-513``).
    """
    return sample_g_rows_2d(k, X, Y, np.arange(X.shape[0]), d0, h)
