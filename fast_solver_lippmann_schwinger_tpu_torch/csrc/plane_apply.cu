// One plane-pivot apply on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_plane.py:_plane_kernel (launched by
// _plane_apply_rows) of the JAX package:
//
//     out = [Yr; Yi] @ P[idx]   with complex recombination
//           out_re = Yr.Pre - Yi.Pim,   out_im = Yi.Pre + Yr.Pim,
//
// rows (2r, ld) f32 in and out, P the transposed bf16 pivot plane.  It is the
// per-plane branch of the 3D substitution scans, taken for stacks too wide for
// the fused passes (plane_fwd.cu, plane_bwd.cu); the stencil couplings stay in
// PyTorch there, as in the JAX package.
//
// The kernel is plane::apply_kernel<R> in plane_pass.cuh: one block per tile
// of 8 output lanes (ld / 8 blocks, no barrier), the tile's pivot columns
// streamed through the same cp.async ring as the fused passes, the rows read
// from global memory chunk by chunk, so shared memory does not depend on ld.
// r <= 2 right-hand sides per launch.
//
// Bound: bytes.  2 x ld^2 x 2 B of planes (21.2 MB, 6.3 us at mn = 2304)
// against 3.35 TB/s; the rows are 1 %.
//
// plane_apply launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "plane_pass.cuh"

extern "C" int plane_apply(
    const float* rows,       // (2r, ld)
    const uint16_t* pre,     // (SL, ld/8, ld, 8) bf16, tile-major, transposed
    const uint16_t* pim,
    float* out,              // (2r, ld)
    int mn, int ld, int r, int idx, void* stream) {
  if (!plane::valid(mn, ld, r) || idx < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      r == 1 ? plane::launch_apply<1>(rows, pre, pim, out, ld, idx, (cudaStream_t)stream)
             : plane::launch_apply<2>(rows, pre, pim, out, ld, idx, (cudaStream_t)stream);
  return (int)err;
}
