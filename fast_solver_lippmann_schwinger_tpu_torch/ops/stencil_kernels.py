"""The 9-point stencil matvec kernel: CUDA kernel + plain twin.

Counterpart of the JAX package's ``ops/pallas_stencil.py``: ``y = S u`` for a
(m, n, 3, 3) complex stencil field S (``StencilMatrix2D``: ``values[j, i, dj,
di]`` couples node (j, i) to (j + dj - 1, i + di - 1)) and a complex field u,
flat or (m, n), in float32 arithmetic.  The JAX package runs it for the As b
step of every single-RHS preconditioner apply when ``use_pallas=True``.  The
TPU kernel (``kernel_shifted``) is rewritten by hand for Hopper in CUDA C++,
``csrc/stencil_matvec.cu``, which also holds the design note.

Precision, as in the JAX package: the field and u are taken in complex64 and
the result is cast back to the field's dtype, so a complex128 field gives a
result of complex64 accuracy in both packages.

:func:`stencil_matvec_2d` launches the kernel for a CUDA tensor (or raises);
it takes the plain PyTorch version :func:`stencil_matvec_2d_plain` only for a
tensor that lies on the CPU.  The kernel is compiled with ``nvcc`` for
``sm_90a`` into ``build/`` on first use (``native/cuda_build.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_solver_lippmann_schwinger_tpu_torch.native import cuda_build

cuda_build.register("stencil_matvec", "stencil_matvec",
                    [cuda_build.PTR] * 3 + [cuda_build.INT] * 2 + [cuda_build.PTR])


def stencil_matvec_2d_plain(values: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`stencil_matvec_2d`: the TPU kernel's taps in
    its order, ``(dj, di) = (0, 0), (0, 1), ... (2, 2)``, on float32 real and
    imaginary planes, u padded with a zero halo."""
    m, n = values.shape[0], values.shape[1]
    s9 = values.reshape(m, n, 9)
    s_re, s_im = s9.real.float(), s9.imag.float()
    up = F.pad(u.reshape(m, n), (1, 1, 1, 1))
    u_re, u_im = up.real.float(), up.imag.float()
    acc_re = torch.zeros((m, n), dtype=torch.float32, device=u.device)
    acc_im = torch.zeros_like(acc_re)
    for dj in range(3):
        for di in range(3):
            t = 3 * dj + di
            sre, sim = s_re[:, :, t], s_im[:, :, t]
            ure, uim = u_re[dj : dj + m, di : di + n], u_im[dj : dj + m, di : di + n]
            acc_re = acc_re + (sre * ure - sim * uim)
            acc_im = acc_im + (sre * uim + sim * ure)
    return torch.complex(acc_re, acc_im).to(values.dtype).reshape(u.shape)


def stencil_matvec_2d(values: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``y = S u`` for a (m, n, 3, 3) complex stencil field; ``u`` flat
    (m*n,) or (m, n), complex; the result has u's shape and the field's
    dtype."""
    m, n = values.shape[0], values.shape[1]
    if tuple(values.shape) != (m, n, 3, 3) or not values.is_complex():
        raise ValueError(f"values must be a complex (m, n, 3, 3) field, got {tuple(values.shape)}")
    if u.numel() != m * n or not u.is_complex() or u.device != values.device:
        raise ValueError(f"u must be a complex field of {m} x {n} nodes on {values.device}")
    if not u.is_cuda:
        return stencil_matvec_2d_plain(values, u)
    vals = values.to(torch.complex64).contiguous()
    u64 = u.reshape(m, n).to(torch.complex64).contiguous()
    y = torch.empty((m, n), dtype=torch.complex64, device=u.device)
    err = cuda_build.load("stencil_matvec")(
        vals.data_ptr(), u64.data_ptr(), y.data_ptr(), m, n,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stencil_matvec: CUDA error {err}")
    stencil_matvec_2d.launches += 1
    return y.to(values.dtype).reshape(u.shape)


# launch count: one per wrapper call that launched the kernel
stencil_matvec_2d.launches = 0
