// Augmented Gauss-Jordan elimination without pivoting, on one [A | b]
// system held in shared memory by one thread block.
//
// This is the device-side counterpart of the elimination the TPU kernels
// run lock-step across a VMEM tile (predictionio_tpu/ops/solve.py
// _gj_kernel and predictionio_tpu/ops/fused_als.py _gj_solve_writeback):
// R pivot steps, each one normalises the pivot row and removes the pivot
// column from every other row; after R steps column R holds x.  No
// pivoting is safe because ALS only ever solves Gram + reg*I with
// reg > 0 (symmetric positive definite, diagonally loaded).
//
// Included by gj_solve.cu (the solves alone).  The fused gather+Gram
// kernel (fused_als.cu) closes with a blocked Cholesky of its own and
// does not include this file.

#pragma once

#include <cuda_runtime.h>

namespace pio {

// the pivot clamp of the reference elimination (ops/solve.py _EPS)
constexpr float kGjEps = 1e-20f;

// largest rank the kernels accept: the [R, R+1] system of R = 128 takes
// 66 KB of shared memory, and the fused kernel's accumulator tiles are
// sized for 16 x 8 = 128 rows and columns
constexpr int kMaxRank = 128;

// Bytes of shared memory gj_solve_inplace needs for rank R: the
// augmented matrix (leading dimension R + 1) plus the pivot-row and
// pivot-column scratch vectors.
__host__ __device__ inline size_t gj_smem_floats(int R) {
  return (size_t)R * (R + 1) + (R + 1) + R;
}

// Solve in place.  M is [R][R + 1] row-major in shared memory with b in
// column R; prow holds R + 1 floats and pcol R floats of shared scratch.
// Every thread of the block must call it (it synchronises the block),
// and the block must be a whole number of warps.
//
// Columns left of the pivot are already unit vectors, so each step only
// touches columns p..R: the pivot row's entries there are zero and the
// reference's full-width update leaves them unchanged.
__device__ __forceinline__ void gj_solve_inplace(float* M, int R,
                                                 float* prow,
                                                 float* pcol) {
  const int ld = R + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int p = 0; p < R; ++p) {
    float d = M[p * ld + p];
    d = fabsf(d) > kGjEps ? d : kGjEps;
    for (int j = p + threadIdx.x; j < ld; j += blockDim.x) {
      prow[j] = M[p * ld + j] / d;
    }
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      pcol[i] = (i == p) ? 0.0f : M[i * ld + p];
    }
    __syncthreads();
    for (int i = warp; i < R; i += nwarps) {
      float* row = M + i * ld;
      if (i == p) {
        for (int j = p + lane; j < ld; j += 32) row[j] = prow[j];
      } else {
        const float c = pcol[i];
        for (int j = p + lane; j < ld; j += 32) row[j] -= c * prow[j];
      }
    }
    __syncthreads();
  }
}

}  // namespace pio
