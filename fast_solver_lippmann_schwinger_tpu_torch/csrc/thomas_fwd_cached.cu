// Cached forward block-Thomas substitution on Hopper (sm_90a), on dense or
// banded+tail pivots.
//
// Replaces three TPU kernels of the JAX package, sparse/pallas_thomas.py:
// _fwd_kernel (launched by _fwd: one slab, one right-hand side),
// _fwd_kernel_bt (launched by _fwd_bt: batch rows of r right-hand sides) and
// _fwd_kernel_ht (launched by _fwd_ht: the same on banded+tail pivots).  On
// the TPU the first two are two bodies because their block layouts differ; in
// the row layout here, (B, m, 2r, ld), the first is the second at B = 1,
// r = 1.  For each batch row and each line j = start..m-1,
//
//     y_j = b_j - L_j . t_{j-1},     t_j = C_j^{-1} y_j,     t_{start-1} = t_init,
//
// keeping BOTH stacks: y for the backward pass, t so that a later pass whose
// right-hand side differs only from some line on can resume there from
// t_init = t_{start-1} (the up pass of a Gauss-Seidel sweep resumes the down
// pass at the bottom trace lines).  Lines < start of y and t belong to the
// caller: the kernel neither reads nor writes them.
//
// Pivot layouts.  Dense (tail_start = 0): every line has a dense tile-major
// plane pair (tre, tim); hre and him are unused.  Banded+tail (tail_start >
// 0): lines j < tail_start apply their banded head window (hre, him: only
// |in - out| <= half is kept), lines j >= tail_start their dense plane
// (tre, tim, index j - tail_start); the pass crosses from one layout to the
// other in mid-pass and its carry goes on as it is, and the cp.async
// look-ahead stages whichever layout the next line has.  The two layouts are
// two instantiations, thomas::pass_kernel<R, false, true> and
// pass_kernel<R, false, true, true>, so a trace names them apart.  Dense int8
// planes (scale given: the TPU kernels' nb > 1 branch of _scaled_dots) are
// pass_kernel<R, false, true, false, Storage::kInt8>.  The body
// is in thomas_line.cuh, which describes the design (one cooperative launch
// per pass, grid barrier per line, 8-lane tiles, staged plane columns: a head
// tile stages only the rows of its window that lie in [0, n)), the limits
// (r <= 2) and the bound.  The t stack is itself the carry: line j reads row
// j-1 of the stack it writes row j of, so the two-slot scratch of the plain
// forward kernel is not needed.
//
// Bound: bytes.  Per line two dense planes, 2 x ld^2 x 2 B, or two head
// windows, 2 x ld x (8 + 2 half) x 2 B less the rows outside [0, n), against
// 3.35 TB/s, plus the b, y and t stacks.
//
// thomas_forward_cached launches only; it allocates nothing, does not
// synchronise, and returns the launch's error code (0 on success).
#include "thomas_line.cuh"

extern "C" int thomas_forward_cached(
    const float* b,          // (B, m, 2r, ld) right-hand rows
    const float* lband,      // (S, m, 2, 3, ld)
    const uint16_t* hre,     // (S, tail_start, ld/8, 8 + 2 half, 8) bf16 head windows
    const uint16_t* him,     //   (banded+tail only)
    const void* tre,         // (S, m - tail_start, ld/8, ld, 8) bf16 planes, tile-major,
    const void* tim,         //   or dense int8 planes (S, m, ld/8, ld, 8)
    const float* scale,      // int8: (S, m, ld/8, nb, 2, 8) scales; else null
    const int* s_idx,        // (B,)
    const float* t_init,     // (B, 2r, ld) carry into line `start`
    float* y,                // (B, m, 2r, ld); lines < start are not touched
    float* t,                // (B, m, 2r, ld); lines < start are not touched
    int batch, int m, int n, int ld, int r, int start, int tail_start, int half,
    void* stream) {
  if (t_init == nullptr) return (int)cudaErrorInvalidValue;
  thomas::PassArgs a{};
  a.rhs = b;
  a.band = lband;
  a.cre = tre;
  a.cim = tim;
  a.scale = scale;
  a.hre = hre;
  a.him = him;
  a.s_idx = s_idx;
  a.t_init = t_init;
  a.kept = y;
  a.out = t;
  a.batch = batch;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.first = start;
  a.count = m - start;
  a.tail_start = tail_start;
  a.half = half;
  cudaError_t err = tail_start > 0
                        ? thomas::run_pass<false, true, true>(r, a, (cudaStream_t)stream)
                        : thomas::run_pass<false, true>(r, a, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
