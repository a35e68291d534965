// Backward plane substitution of the 3D block-Thomas solve on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_plane.py:_bwd_slab_kernel (launched
// by _bwd_slab_call) of the JAX package: for the planes p = l-1 down to
// start of one slab,
//
//     x_p = (y_p - S'_p(x_{p+1})) . P[base + p],     x_l = 0,
//
// with S'_p the 9-tap in-plane coupling stencil to plane p+1 and P the
// transposed bf16 pivot plane.  start = l - tail computes only the last
// `tail` planes, which is exact: the recursion starts at the true last plane.
// Planes < start of the x stack belong to the caller.
//
// The kernel is plane::pass_kernel<R, true>, the backward instantiation of
// the body in plane_pass.cuh, which describes the design, the limits and the
// bound.  The x stack is the carry (plane p reads row p+1); the stencil
// phase's result lives in a one-plane scratch between the two barriers.
//
// Bound: bytes.  (l - start) planes x 2 x ld^2 x 2 B against 3.35 TB/s
// (0.304 ms for 48 planes at mn = 2304), plus the weight rows and the y and x
// stacks (about 1 %).
//
// plane_backward launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "plane_pass.cuh"

extern "C" int plane_backward(
    const float* y,          // (l, 2r, ld) rows of the forward pass
    const float* w,          // (l, 2, 9, ld) weight rows of the couplings to plane p+1
    const uint16_t* pre,     // (SL, ld/8, ld, 8) bf16, tile-major, transposed
    const uint16_t* pim,
    float* scratch,          // (2r, ld)
    float* x,                // (l, 2r, ld); planes < start are not touched
    int l, int mn, int n, int ld, int r, int base, int start, void* stream) {
  plane::PassArgs a;
  a.rhs = y;
  a.w = w;
  a.pre = pre;
  a.pim = pim;
  a.t_init = nullptr;
  a.kept = scratch;
  a.out = x;
  a.carry = nullptr;
  a.l = l;
  a.mn = mn;
  a.n = n;
  a.ld = ld;
  a.base = base;
  a.start = start;
  cudaError_t err = plane::run_pass<true>(r, a, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
