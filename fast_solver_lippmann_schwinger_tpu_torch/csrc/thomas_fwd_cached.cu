// Cached forward block-Thomas substitution on Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, sparse/pallas_thomas.py:
// _fwd_kernel (launched by _fwd: one slab, one right-hand side) and
// _fwd_kernel_bt (launched by _fwd_bt: batch rows of r right-hand sides).
// On the TPU they are two bodies because their block layouts differ; in the
// row layout here, (B, m, 2r, ld), the first is the second at B = 1, r = 1.
// For each batch row and each line j = start..m-1,
//
//     y_j = b_j - L_j . t_{j-1},     t_j = C_j^{-1} y_j,     t_{start-1} = t_init,
//
// keeping BOTH stacks: y for the backward pass, t so that a later pass whose
// right-hand side differs only from some line on can resume there from
// t_init = t_{start-1} (the up pass of a Gauss-Seidel sweep resumes the down
// pass at the bottom trace lines).  Lines < start of y and t belong to the
// caller: the kernel neither reads nor writes them.
//
// The kernel is thomas::pass_kernel<R, false, true>, the cached forward
// instantiation of the body in thomas_line.cuh, which describes the design
// (one cooperative launch per pass, grid barrier per line, 8-lane tiles,
// staged plane columns), the limits (r <= 2) and the bound.  The t stack is
// itself the carry: line j reads row j-1 of the stack it writes row j of, so
// the two-slot scratch of the plain forward kernel is not needed.
//
// Bound: bytes.  (m - start) lines x 2 planes x ld^2 x 2 B against 3.35 TB/s,
// plus the b, y and t stacks.
//
// thomas_forward_cached launches only; it allocates nothing, does not
// synchronise, and returns the launch's error code (0 on success).
#include "thomas_line.cuh"

extern "C" int thomas_forward_cached(
    const float* b,          // (B, m, 2r, ld) right-hand rows
    const float* lband,      // (S, m, 2, 3, ld)
    const uint16_t* cre,     // (S, m, ld/8, ld, 8) bf16, tile-major
    const uint16_t* cim,
    const int* s_idx,        // (B,)
    const float* t_init,     // (B, 2r, ld) carry into line `start`
    float* y,                // (B, m, 2r, ld); lines < start are not touched
    float* t,                // (B, m, 2r, ld); lines < start are not touched
    int batch, int m, int n, int ld, int r, int start, void* stream) {
  if (t_init == nullptr) return (int)cudaErrorInvalidValue;
  thomas::PassArgs a;
  a.rhs = b;
  a.band = lband;
  a.cre = cre;
  a.cim = cim;
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
  cudaError_t err = thomas::run_pass<false, true>(r, a, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
