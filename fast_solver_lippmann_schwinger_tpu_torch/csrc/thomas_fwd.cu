// Forward block-Thomas substitution on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_thomas.py:_fwd_kernel_b (launched by
// _fwd_b) of the JAX package: for each batch row and each line
// j = start..m-1,
//
//     y_j = b_j - L_j . t_{j-1},     t_j = C_j^{-1} y_j,     t_{start-1} = 0,
//
// keeping the y stack.  The kernel is thomas::pass_kernel<R, false, false>, the
// forward instantiation of the body in thomas_line.cuh, which also describes
// the design (one cooperative launch per pass, grid barrier per line, 8-lane
// tiles, staged plane columns), the limits (r <= 2) and the bound.  With
// scales the planes are int8 (the TPU kernel's nb > 1 branch of _scaled_dots)
// and the kernel is pass_kernel<R, false, false, false, Storage::kInt8>.  The carry t lives in a two-slot
// ping-pong buffer in global memory: line j reads slot (j-1)&1 while writing
// slot j&1, and the barrier between lines keeps the two apart.
//
// Bound: bytes.  (m - start) lines x 2 planes x ld^2 x 2 B (int8: 1 B, plus
// the scales) against 3.35 TB/s, plus the b and y stacks.
//
// thomas_forward launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "thomas_line.cuh"

extern "C" int thomas_forward(
    const float* b,          // (B, m, 2r, ld) right-hand rows
    const float* lband,      // (S, m, 2, 3, ld)
    const void* cre,         // (S, m, ld/8, ld, 8) bf16 or int8, tile-major
    const void* cim,
    const float* scale,      // int8: (S, m, ld/8, nb, 2, 8) scales; bf16: null
    const int* s_idx,        // (B,)
    float* y,                // (B, m, 2r, ld); lines < start are not written
    float* carry,            // (2, B, 2r, ld) scratch
    int batch, int m, int n, int ld, int r, int start, void* stream) {
  thomas::PassArgs a{};
  a.rhs = b;
  a.band = lband;
  a.cre = cre;
  a.cim = cim;
  a.scale = scale;
  a.s_idx = s_idx;
  a.t_init = nullptr;
  a.kept = y;
  a.out = carry;
  a.batch = batch;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.first = start;
  a.count = m - start;
  cudaError_t err = thomas::run_pass<false>(r, a, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
