// Backward block-Thomas substitution on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_thomas.py:_bwd_kernel_b (launched by
// _bwd_b) of the JAX package: for each batch row, bottom-up over the lines
// j = m-1 .. m-m_eff,
//
//     x_j = C_j^{-1} (y_j - U_j . x_{j+1}),     x_m = 0,
//
// where m_eff = m for a full pass or `tail` when only the last lines are
// wanted.  The kernel is thomas::pass_kernel<R, true, false>, the backward
// instantiation of the body in thomas_line.cuh, which also describes the
// design (one cooperative launch per pass, grid barrier per line, 8-lane
// tiles, staged plane columns), the limits (r <= 2) and the bound.  The carry needs no scratch here: x_{j+1} is
// read from the output stack's row j+1 while row j is written.
//
// Bound: bytes.  m_eff lines x 2 planes x ld^2 x 2 B against 3.35 TB/s, plus
// the y and x stacks.
//
// thomas_backward launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "thomas_line.cuh"

extern "C" int thomas_backward(
    const float* y,          // (B, m, 2r, ld) forward-pass stack
    const float* uband,      // (S, m, 2, 3, ld)
    const uint16_t* cre,     // (S, m, ld/8, ld, 8) bf16, tile-major
    const uint16_t* cim,
    const int* s_idx,        // (B,)
    float* x,                // (B, m_eff, 2r, ld): lines m-m_eff .. m-1
    int batch, int m, int n, int ld, int r, int m_eff, void* stream) {
  if (m_eff < 1 || m_eff > m) return (int)cudaErrorInvalidValue;
  thomas::PassArgs a;
  a.rhs = y;
  a.band = uband;
  a.cre = cre;
  a.cim = cim;
  a.s_idx = s_idx;
  a.t_init = nullptr;
  a.kept = nullptr;
  a.out = x;
  a.batch = batch;
  a.m = m;
  a.n = n;
  a.ld = ld;
  a.first = m - 1;
  a.count = m_eff;
  cudaError_t err = thomas::run_pass<true>(r, a, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
