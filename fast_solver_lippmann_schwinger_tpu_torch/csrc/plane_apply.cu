// One plane-pivot apply on Hopper (sm_90a).
//
// Replaces the TPU kernel sparse/pallas_plane.py:_plane_kernel (launched by
// _plane_apply_rows) of the JAX package:
//
//     out = [Yr; Yi] @ P[idx]   with complex recombination
//           out_re = Yr.Pre - Yi.Pim,   out_im = Yi.Pre + Yr.Pim,
//
// rows (2r, ld) f32 in and out, P the transposed pivot plane: bf16, or int8
// with one f32 scale per (128-input-row block, output lane), the TPU kernel's
// nb > 1 branch (pallas_plane.py:151-164).  It is the
// per-plane branch of the 3D substitution scans, taken for stacks too wide for
// the fused passes (plane_fwd.cu, plane_bwd.cu); the stencil couplings stay in
// PyTorch there, as in the JAX package.
//
// The kernels are plane::apply_kernel<R, S> in plane_pass.cuh, for
// S = Storage::kBf16 and Storage::kInt8.  r = 1, 2: one block per tile of 8
// output lanes (ld / 8 blocks, no barrier), the tile's pivot columns (and
// int8 scales) streamed through a cp.async ring, the rows read from global
// memory chunk by chunk, so shared memory does not depend on ld; the int8
// entries are dequantized before the product, where the TPU kernel scales
// each 128-row partial product: f32 rounding apart, the same numbers.  r = 4
// and 8 (plane_pass.cuh note 4): one wave of blocks of up to max_tiles
// consecutive tiles, a producer warp bulk-copying their chunks, 8 warps
// multiplying each k-step of the rows, split once, into all of them on tensor
// cores; int8 partials scaled per 16-row k-step before they are added.
//
// Bound: bytes.  2 x ld^2 x 2 B of bf16 planes (21.2 MB, 6.3 us at
// mn = 2304), 2 x ld^2 x 1 B plus the scales in int8 (19.5 MB, 5.8 us at
// ld = 3072), against 3.35 TB/s; the rows are 1 %.
//
// plane_apply launches only; it allocates nothing, does not synchronise,
// and returns the launch's error code (0 on success).
#include "plane_pass.cuh"

extern "C" int plane_apply(
    const float* rows,       // (2r, ld)
    const void* pre,         // (SL, ld/8, ld, 8) bf16 or int8, tile-major, transposed
    const void* pim,
    const float* scale,      // int8: (SL, ld/8, ld/128, 2, 8) f32 scales; bf16: null
    float* out,              // (2r, ld)
    int mn, int ld, int r, int idx, void* stream) {
  if (!plane::valid(mn, ld, r, scale) || idx < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      scale != nullptr
          ? plane::launch_apply_r<plane::Storage::kInt8>(r, rows, pre, pim, scale, out, ld, idx, st)
          : plane::launch_apply_r<plane::Storage::kBf16>(r, rows, pre, pim, scale, out, ld, idx, st);
  return (int)err;
}
