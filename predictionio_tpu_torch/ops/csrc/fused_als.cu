// Fused ALS normal-equation build and solve, one bucket row per block,
// for sm_90a.
//
// Replaces: predictionio_tpu/ops/fused_als.py _fused_kernel_taa
// (pallas_call at ops/fused_als.py:368) and _fused_kernel_dma
// (pallas_call at ops/fused_als.py:500), the kernels behind
// ALSConfig(solver="fused").  The two TPU kernels compute the same
// function and differ only in how table rows reach VMEM, a choice forced
// by Mosaic's gather rules.  On Hopper the opposite factor table of the
// full-width run (26,744 x 64 f32 = 6.8 MB, or 138,493 x 64 = 35 MB)
// sits in the 50 MB L2, so one kernel with plain row loads stands for
// both.
//
// For each row r of the bucket it computes
//   x[r] = (gram0 + sum_k cw[r,k] v_k v_k^T + reg[r] I)^-1 sum_k bw[r,k] v_k,
//   v_k = table[idx[r,k]]
// with every product and sum in f32 (a bf16 table is widened with
// __bfloat162float; no TF32).  Masked entries carry cw = bw = 0.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores),
// counting the least work of the function, not of this kernel: one
// triangle of each Gram, nnz * R(R+1) flop, the right-hand sides,
// 2 * nnz * R, and one SPD solve a row, R^3/3 + 2R^2.  For a full-width
// user half (20,000,263 ratings, 138,493 rows, R = 64) that is 99 GFLOP,
// 1.5 ms at the f32 rate; the bytes it must move are idx/cw/bw of the
// real entries (12 B a rating, 0.24 GB) and one read of the table,
// 0.07 ms.  So it is bound by operations.  This kernel accumulates the
// whole R x R Gram (2 * nnz * R^2) and solves by Gauss-Jordan (about
// R^3 a row).  The gathered rows (nnz * R * 4 = 5.1 GB a half) come
// mostly from L2.  chip_smoke.py measured 8.6 ms for a [32768, 128]
// rank-64 bucket (about 3.16M real entries) against a 0.25 ms bound,
// about 34x (H100 80GB HBM3, 700 W power limit).
//
// Design, simple and right first:
// * One block of 256 threads per bucket row.  The block walks K in
//   chunks of KC: it stages the chunk's idx/cw/bw in shared memory,
//   gathers the chunk's table rows into a [KC, R] f32 tile (skipping
//   entries whose two weights are zero), then accumulates.
// * The R x R accumulator lives in registers: the 256 threads form a
//   16 x 16 grid and thread (ty, tx) owns rows ty + 16a and columns
//   tx + 16c, a, c < TILE = ceil(R / 16).  A warp's reads of the row
//   tile are then broadcasts or 16 consecutive words: no bank conflicts.
// * After the last chunk the block writes gram0 + A + reg I and b into
//   shared memory as [A | b] and solves it in place with gj.cuh.
// * A row with a huge K (the most popular item has ~1.8M ratings in a
//   [1, 2^21] bucket) runs on one block and sets the tail of its half;
//   splitting K across blocks with a second reduction pass is left for a
//   later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "gj.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;  // the accumulator grid is kGrid x kGrid threads

template <typename T>
__device__ __forceinline__ float widen(T v);

template <>
__device__ __forceinline__ float widen<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared-memory floats of the kernel for rank R and chunk KC: the
// Gauss-Jordan system and scratch, the [KC, R] row tile, and the
// chunk's cw, bw and idx.  ops/fused_als.py fused_tile_plan holds the
// same sum; the launcher refuses a plan that disagrees.
inline size_t fused_smem_floats(int R, int KC) {
  return pio::gj_smem_floats(R) + (size_t)KC * R + 3 * (size_t)KC;
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
    fused_als_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ cw,
                     const float* __restrict__ bw,
                     const float* __restrict__ reg,
                     const float* __restrict__ gram0, float* __restrict__ x,
                     int K, int M, int R, int KC) {
  extern __shared__ float smem[];
  const int ld = R + 1;
  float* Msys = smem;
  float* prow = Msys + (size_t)R * ld;
  float* pcol = prow + ld;
  float* V = pcol + R;
  float* wc = V + (size_t)KC * R;
  float* wb = wc + KC;
  int* ix = reinterpret_cast<int*>(wb + KC);

  const int tid = threadIdx.x;
  const int tx = tid % kGrid;
  const int ty = tid / kGrid;
  const size_t row = blockIdx.x;
  const size_t base = row * K;

  float acc[TILE][TILE];
#pragma unroll
  for (int a = 0; a < TILE; ++a)
#pragma unroll
    for (int c = 0; c < TILE; ++c) acc[a][c] = 0.0f;
  float bacc = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int n = min(KC, K - k0);
    for (int t = tid; t < n; t += kThreads) {
      ix[t] = idx[base + k0 + t];
      wc[t] = cw[base + k0 + t];
      wb[t] = bw[base + k0 + t];
    }
    __syncthreads();
    for (int e = tid; e < n * R; e += kThreads) {
      const int kk = e / R;
      const int c = e - kk * R;
      float v = 0.0f;
      if (wc[kk] != 0.0f || wb[kk] != 0.0f) {
        const int id = ix[kk];
        // an id outside the table poisons the row instead of reading
        // out of bounds: the caller sees NaN, never a wrong number
        v = (id >= 0 && id < M) ? widen(table[(size_t)id * R + c]) : NAN;
      }
      V[e] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < n; ++kk) {
      const float* v = V + (size_t)kk * R;
      const float w = wc[kk];
      if (w != 0.0f) {  // uniform across the block
        float vi[TILE], vj[TILE];
#pragma unroll
        for (int a = 0; a < TILE; ++a) {
          const int i = ty + kGrid * a;
          vi[a] = i < R ? w * v[i] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < TILE; ++c) {
          const int j = tx + kGrid * c;
          vj[c] = j < R ? v[j] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < TILE; ++a)
#pragma unroll
          for (int c = 0; c < TILE; ++c)
            acc[a][c] = fmaf(vi[a], vj[c], acc[a][c]);
      }
      if (tid < R) bacc = fmaf(wb[kk], v[tid], bacc);
    }
    __syncthreads();
  }

  const float rg = reg[row];
#pragma unroll
  for (int a = 0; a < TILE; ++a) {
    const int i = ty + kGrid * a;
#pragma unroll
    for (int c = 0; c < TILE; ++c) {
      const int j = tx + kGrid * c;
      if (i < R && j < R) {
        Msys[i * ld + j] =
            gram0[i * R + j] + acc[a][c] + (i == j ? rg : 0.0f);
      }
    }
  }
  if (tid < R) Msys[tid * ld + R] = bacc;
  __syncthreads();
  pio::gj_solve_inplace(Msys, R, prow, pcol);
  if (tid < R) x[row * R + tid] = Msys[tid * ld + R];
}

template <typename T, int TILE>
int launch(const void* table, const void* idx, const void* cw,
           const void* bw, const void* reg, const void* gram0, void* x,
           int B, int K, int M, int R, int KC, size_t smem,
           cudaStream_t stream) {
  auto kernel = fused_als_kernel<T, TILE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(cw), static_cast<const float*>(bw),
      static_cast<const float*>(reg), static_cast<const float*>(gram0),
      static_cast<float*>(x), K, M, R, KC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* table, const void* idx, const void* cw,
             const void* bw, const void* reg, const void* gram0, void* x,
             int B, int K, int M, int R, int KC, int tile, int smem_bytes,
             void* stream) {
  if (B < 0 || K < 0 || M < 1 || R < 1 || R > pio::kMaxRank || KC < 1)
    return cudaErrorInvalidValue;
  const int want_tile = R <= 16 ? 1 : R <= 32 ? 2 : R <= 64 ? 4 : 8;
  const size_t smem = fused_smem_floats(R, KC) * sizeof(float);
  if (tile != want_tile || static_cast<size_t>(smem_bytes) != smem)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 1:
      return launch<T, 1>(table, idx, cw, bw, reg, gram0, x, B, K, M, R, KC,
                          smem, s);
    case 2:
      return launch<T, 2>(table, idx, cw, bw, reg, gram0, x, B, K, M, R, KC,
                          smem, s);
    case 4:
      return launch<T, 4>(table, idx, cw, bw, reg, gram0, x, B, K, M, R, KC,
                          smem, s);
    default:
      return launch<T, 8>(table, idx, cw, bw, reg, gram0, x, B, K, M, R, KC,
                          smem, s);
  }
}

}  // namespace

extern "C" {

// table [M, R] (f32 or bf16), idx [B, K] int32, cw/bw [B, K] f32,
// reg [B] f32, gram0 [R, R] f32 -> x [B, R] f32; all contiguous on the
// device of `stream`.  `kc`, `tile` and `smem_bytes` come from
// fused_tile_plan and must match this file's own accounting.  Returns
// the CUDA error code of the launch (0 on success).
int pio_fused_als_f32(const void* table, const void* idx, const void* cw,
                      const void* bw, const void* reg, const void* gram0,
                      void* x, int B, int K, int M, int R, int kc, int tile,
                      int smem_bytes, void* stream) {
  return dispatch<float>(table, idx, cw, bw, reg, gram0, x, B, K, M, R, kc,
                         tile, smem_bytes, stream);
}

int pio_fused_als_bf16(const void* table, const void* idx, const void* cw,
                       const void* bw, const void* reg, const void* gram0,
                       void* x, int B, int K, int M, int R, int kc, int tile,
                       int smem_bytes, void* stream) {
  return dispatch<__nv_bfloat16>(table, idx, cw, bw, reg, gram0, x, B, K, M,
                                 R, kc, tile, smem_bytes, stream);
}

}  // extern "C"
