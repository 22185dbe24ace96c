// Batched SPD solve A[i] x[i] = b[i] by augmented Gauss-Jordan, for sm_90a.
//
// Replaces: predictionio_tpu/ops/solve.py _gj_kernel (pallas_call at
// ops/solve.py:162, launched by _solve_padded), the kernel behind
// ALSConfig(solver="pallas").
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores),
// counting the least work of the function, not of this kernel: an SPD
// solve needs one triangle of A, R(R+1)/2 * 4 bytes, plus b and x
// (2*R*4), and about R^3/3 + 2R^2 flop (Cholesky and two triangular
// solves).  At the full-width user half (138,493 systems of rank 64)
// that is 1.22 GB, 0.37 ms at the memory rate, against 13.2 GFLOP,
// 0.20 ms at the f32 rate: the function is memory-bound.  This kernel
// reads all of A and does about R^3 flop a system (R steps of an
// R x (R+1-p) update), and the latency of its 2R block barriers is what
// a simple version pays on top: chip_smoke.py measured 10.6 ms for
// 65,536 rank-64 systems against a 0.17 ms bound, about 61x (H100 80GB
// HBM3, 700 W power limit).
//
// Design: one thread block per system, so a ragged batch needs no
// identity padding (the TPU kernel padded B to its VMEM tile).  The
// block loads [A | b] into shared memory with leading dimension R + 1
// (odd for even R, so the column reads of a pivot step are free of bank
// conflicts) and runs gj_solve_inplace (gj.cuh).  Block size grows with
// R: one warp up to R = 16, four up to 64, eight above.  R = 128 needs
// 67 KB of shared memory, which the launcher unlocks with
// cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_runtime.h>

#include "gj.cuh"
#include "launch_args.cuh"

namespace {

__global__ void gj_solve_kernel(const float* __restrict__ A,
                                const float* __restrict__ b,
                                float* __restrict__ x, int R) {
  extern __shared__ float smem[];
  const int ld = R + 1;
  float* M = smem;
  float* prow = M + (size_t)R * ld;
  float* pcol = prow + ld;
  const size_t sys = blockIdx.x;
  const float* As = A + sys * R * R;
  for (int e = threadIdx.x; e < R * R; e += blockDim.x) {
    const int i = e / R;
    M[i * ld + (e - i * R)] = As[e];
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    M[i * ld + R] = b[sys * R + i];
  }
  __syncthreads();
  pio::gj_solve_inplace(M, R, prow, pcol);
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    x[sys * R + i] = M[i * ld + R];
  }
}

}  // namespace

extern "C" {

const char* pio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A [B, R, R], b [B, R], x [B, R]: float32, contiguous, on the device of
// `stream` (GjArgs).  Returns the CUDA error code of the launch (0 on
// success).
int pio_gj_solve(const void* block) {
  const GjArgs a = pio::load_args<GjArgs>(block);
  const int B = a.B, R = a.R;
  if (B < 0 || R < 1 || R > pio::kMaxRank) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = pio::gj_smem_floats(R) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gj_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = R <= 16 ? 32 : (R <= 64 ? 128 : 256);
  gj_solve_kernel<<<B, threads, smem, static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const float*>(a.A), static_cast<const float*>(a.b),
      static_cast<float*>(a.x), R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
