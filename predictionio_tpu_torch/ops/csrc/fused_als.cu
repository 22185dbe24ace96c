// Fused ALS normal-equation build and solve, one bucket row per block,
// for sm_90a, in two forms.
//
// Replaces: predictionio_tpu/ops/fused_als.py _fused_kernel_taa
// (pallas_call at ops/fused_als.py:368) and _fused_kernel_dma
// (pallas_call at ops/fused_als.py:500), the kernels behind
// ALSConfig(solver="fused").  The two TPU kernels compute the same
// function and differ only in how table rows reach VMEM: sub-gathers
// (take_along_axis) or a rolling window of asynchronous row copies.  Here
// the two forms differ the same way:
// * "taa": the block loads each chunk's rows from global memory (mostly
//   L2: the opposite table of the full-width run, 26,744 x 64 f32 =
//   6.8 MB or 138,493 x 64 = 35 MB, fits the 50 MB L2) one element per
//   thread, widens them to f32 into a [KC, R] tile, synchronises, then
//   accumulates;
// * "dma": the [KC, R] row tile is double-buffered and filled by cp.async:
//   while chunk c accumulates, chunk c+1's rows are already in flight into
//   the other buffer (cp.async.commit_group / wait_group, then a block
//   barrier).  A masked entry (cw = bw = 0) is zero-filled through
//   cp.async's source-size operand; an id outside the table poisons its
//   row with NaN by a plain store and is never read.  A bf16 table is
//   staged as raw bf16 rows and widened when the accumulation reads them,
//   which needs an even R (a row must be a whole number of 4-byte pieces).
//
// For each row r of the bucket both compute
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
// R^3 a row).  chip_smoke.py measured 8.6 ms for the "taa" form on a
// [32768, 128] rank-64 bucket (about 3.16M real entries) against a
// 0.25 ms bound, about 34x (H100 80GB HBM3, 700 W power limit); the
// "dma" form's time is in PERF.md.
//
// Design, simple and right first:
// * One block of 256 threads per bucket row.  The block walks K in
//   chunks of KC: it stages the chunk's idx/cw/bw in shared memory,
//   brings the chunk's table rows into a [KC, R] tile, then accumulates.
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
#include <cstdint>

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

// Shared-memory bytes of the "taa" form for rank R and chunk KC: the
// Gauss-Jordan system and scratch, the [KC, R] f32 row tile, and the
// chunk's cw, bw and idx.  ops/fused_als.py fused_smem_bytes holds the
// same sums; the launcher refuses a plan that disagrees.
inline size_t taa_smem_bytes(int R, int KC) {
  return 4 * (pio::gj_smem_floats(R) + (size_t)KC * R + 3 * (size_t)KC);
}

// The "dma" form: two [KC, R] tiles in the table's own element width,
// the Gauss-Jordan system and scratch, and two sets of the chunk's cw,
// bw and idx.
inline size_t dma_smem_bytes(int R, int KC, int elem_bytes) {
  return 2 * (size_t)KC * R * elem_bytes + 4 * pio::gj_smem_floats(R) +
         4 * 6 * (size_t)KC;
}

// Accumulate one staged chunk of n rows (tile V of element type S, one
// row every R elements) into the thread's Gram tile and rhs entry.
template <typename S, int TILE>
__device__ __forceinline__ void accumulate(const S* V, const float* wc,
                                           const float* wb, int n, int R,
                                           float (&acc)[TILE][TILE],
                                           float& bacc) {
  const int tid = threadIdx.x;
  const int tx = tid % kGrid;
  const int ty = tid / kGrid;
  for (int kk = 0; kk < n; ++kk) {
    const S* v = V + (size_t)kk * R;
    const float w = wc[kk];
    if (w != 0.0f) {  // uniform across the block
      float vi[TILE], vj[TILE];
#pragma unroll
      for (int a = 0; a < TILE; ++a) {
        const int i = ty + kGrid * a;
        vi[a] = i < R ? w * widen(v[i]) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < TILE; ++c) {
        const int j = tx + kGrid * c;
        vj[c] = j < R ? widen(v[j]) : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < TILE; ++a)
#pragma unroll
        for (int c = 0; c < TILE; ++c)
          acc[a][c] = fmaf(vi[a], vj[c], acc[a][c]);
    }
    if (tid < R) bacc = fmaf(wb[kk], widen(v[tid]), bacc);
  }
}

// Write gram0 + acc + reg I and b into Msys as [A | b], solve, store x.
template <int TILE>
__device__ __forceinline__ void solve_row(float* Msys, float* prow,
                                          float* pcol,
                                          const float (&acc)[TILE][TILE],
                                          float bacc, const float* gram0,
                                          float rg, float* xrow, int R) {
  const int tid = threadIdx.x;
  const int tx = tid % kGrid;
  const int ty = tid / kGrid;
  const int ld = R + 1;
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
  if (tid < R) xrow[tid] = Msys[tid * ld + R];
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
  float* Msys = smem;
  float* prow = Msys + (size_t)R * (R + 1);
  float* pcol = prow + R + 1;
  float* V = pcol + R;
  float* wc = V + (size_t)KC * R;
  float* wb = wc + KC;
  int* ix = reinterpret_cast<int*>(wb + KC);

  const int tid = threadIdx.x;
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
    accumulate<float, TILE>(V, wc, wb, n, R, acc, bacc);
    __syncthreads();
  }
  solve_row<TILE>(Msys, prow, pcol, acc, bacc, gram0, reg[row],
                  x + row * R, R);
}

// ---- "dma" form ---------------------------------------------------------

__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               int vec, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage chunk [k0, k0 + n) of the row: its idx/cw/bw by plain loads (then
// a barrier, so every thread sees the ids), its table rows by cp.async
// into tile Vb.  The copies are committed by the caller.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ cw, const float* __restrict__ bw, size_t base,
    int k0, int n, int M, int R, int vec, T* Vb, int* ix, float* wc,
    float* wb) {
  const int tid = threadIdx.x;
  for (int t = tid; t < n; t += kThreads) {
    ix[t] = idx[base + k0 + t];
    wc[t] = cw[base + k0 + t];
    wb[t] = bw[base + k0 + t];
  }
  __syncthreads();
  const int row_bytes = R * (int)sizeof(T);
  const int pieces = row_bytes / vec;
  unsigned char* dst0 = reinterpret_cast<unsigned char*>(Vb);
  const unsigned char* tab = reinterpret_cast<const unsigned char*>(table);
  for (int e = tid; e < n * pieces; e += kThreads) {
    const int kk = e / pieces;
    const int q = e - kk * pieces;
    unsigned char* dst = dst0 + (size_t)kk * row_bytes + q * vec;
    const bool live = wc[kk] != 0.0f || wb[kk] != 0.0f;
    const int id = ix[kk];
    if (!live) {
      cp_async_zfill(dst, tab, vec, 0);  // reads nothing, writes zeros
    } else if (id >= 0 && id < M) {
      cp_async_zfill(dst, tab + (size_t)id * row_bytes + q * vec, vec, vec);
    } else {
      // an id outside the table poisons the row, as in the "taa" form
      const uint32_t nan4 = sizeof(T) == 4 ? 0x7fc00000u : 0x7fc07fc0u;
      for (int b = 0; b < vec; b += 4)
        *reinterpret_cast<uint32_t*>(dst + b) = nan4;
    }
  }
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
    fused_als_dma_kernel(const T* __restrict__ table,
                         const int* __restrict__ idx,
                         const float* __restrict__ cw,
                         const float* __restrict__ bw,
                         const float* __restrict__ reg,
                         const float* __restrict__ gram0,
                         float* __restrict__ x, int K, int M, int R, int KC,
                         int vec) {
  extern __shared__ __align__(16) unsigned char sm[];
  // buffer b of the tile starts at V0 + b * tile_elems; its cw, bw and idx
  // at meta + 3 * b * KC (pointer arithmetic, not arrays: no stack frame)
  T* V0 = reinterpret_cast<T*>(sm);
  const size_t tile_elems = (size_t)KC * R;
  float* Msys = reinterpret_cast<float*>(V0 + 2 * tile_elems);
  float* prow = Msys + (size_t)R * (R + 1);
  float* pcol = prow + R + 1;
  float* meta = pcol + R;

  const size_t row = blockIdx.x;
  const size_t base = row * K;

  float acc[TILE][TILE];
#pragma unroll
  for (int a = 0; a < TILE; ++a)
#pragma unroll
    for (int c = 0; c < TILE; ++c) acc[a][c] = 0.0f;
  float bacc = 0.0f;

  const int nchunks = (K + KC - 1) / KC;
  if (nchunks > 0) {
    stage_chunk<T>(table, idx, cw, bw, base, 0, min(KC, K), M, R, vec, V0,
                   reinterpret_cast<int*>(meta + 2 * KC), meta, meta + KC);
  }
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    if (c + 1 < nchunks) {
      // buffer b ^ 1 was last read by chunk c - 1, which ended with a
      // barrier: it is free to fill while chunk c accumulates
      const int k1 = (c + 1) * KC;
      float* m1 = meta + 3 * (b ^ 1) * KC;
      stage_chunk<T>(table, idx, cw, bw, base, k1, min(KC, K - k1), M, R,
                     vec, V0 + (b ^ 1) * tile_elems,
                     reinterpret_cast<int*>(m1 + 2 * KC), m1, m1 + KC);
    }
    cp_async_commit();     // one group per step, the last one empty
    cp_async_wait_one();   // this thread's copies of chunk c have landed
    __syncthreads();       // and every other thread's
    const float* m0 = meta + 3 * b * KC;
    accumulate<T, TILE>(V0 + b * tile_elems, m0, m0 + KC,
                        min(KC, K - c * KC), R, acc, bacc);
    __syncthreads();       // buffer b is free for chunk c + 2
  }
  solve_row<TILE>(Msys, prow, pcol, acc, bacc, gram0, reg[row],
                  x + row * R, R);
}

template <typename T, int TILE>
int launch(bool dma, const void* table, const void* idx, const void* cw,
           const void* bw, const void* reg, const void* gram0, void* x,
           int B, int K, int M, int R, int KC, int vec, size_t smem,
           cudaStream_t stream) {
  auto taa = fused_als_kernel<T, TILE>;
  auto dmak = fused_als_dma_kernel<T, TILE>;
  if (smem > 48 * 1024) {
    cudaError_t e = dma ? cudaFuncSetAttribute(
                              dmak, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem))
                        : cudaFuncSetAttribute(
                              taa, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const T* t = static_cast<const T*>(table);
  const int* ix = static_cast<const int*>(idx);
  const float* c = static_cast<const float*>(cw);
  const float* w = static_cast<const float*>(bw);
  const float* rg = static_cast<const float*>(reg);
  const float* g0 = static_cast<const float*>(gram0);
  float* out = static_cast<float*>(x);
  if (dma) {
    dmak<<<B, kThreads, smem, stream>>>(t, ix, c, w, rg, g0, out, K, M, R, KC,
                                        vec);
  } else {
    taa<<<B, kThreads, smem, stream>>>(t, ix, c, w, rg, g0, out, K, M, R, KC);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool dma, const void* table, const void* idx, const void* cw,
             const void* bw, const void* reg, const void* gram0, void* x,
             int B, int K, int M, int R, int KC, int tile, int smem_bytes,
             int vec, void* stream) {
  if (B < 0 || K < 0 || M < 1 || R < 1 || R > pio::kMaxRank || KC < 1)
    return cudaErrorInvalidValue;
  const int want_tile = R <= 16 ? 1 : R <= 32 ? 2 : R <= 64 ? 4 : 8;
  size_t smem;
  if (dma) {
    // a row must be a whole number of vec-byte pieces, and each piece of
    // a tile 16-byte aligned when vec is 16 (KC is a multiple of 8)
    const int row_bytes = R * (int)sizeof(T);
    if ((vec != 16 && vec != 4) || row_bytes % vec != 0 || KC % 8 != 0)
      return cudaErrorInvalidValue;
    smem = dma_smem_bytes(R, KC, (int)sizeof(T));
  } else {
    smem = taa_smem_bytes(R, KC);
  }
  if (tile != want_tile || static_cast<size_t>(smem_bytes) != smem)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 1:
      return launch<T, 1>(dma, table, idx, cw, bw, reg, gram0, x, B, K, M, R,
                          KC, vec, smem, s);
    case 2:
      return launch<T, 2>(dma, table, idx, cw, bw, reg, gram0, x, B, K, M, R,
                          KC, vec, smem, s);
    case 4:
      return launch<T, 4>(dma, table, idx, cw, bw, reg, gram0, x, B, K, M, R,
                          KC, vec, smem, s);
    default:
      return launch<T, 8>(dma, table, idx, cw, bw, reg, gram0, x, B, K, M, R,
                          KC, vec, smem, s);
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
  return dispatch<float>(false, table, idx, cw, bw, reg, gram0, x, B, K, M, R,
                         kc, tile, smem_bytes, 0, stream);
}

int pio_fused_als_bf16(const void* table, const void* idx, const void* cw,
                       const void* bw, const void* reg, const void* gram0,
                       void* x, int B, int K, int M, int R, int kc, int tile,
                       int smem_bytes, void* stream) {
  return dispatch<__nv_bfloat16>(false, table, idx, cw, bw, reg, gram0, x, B,
                                 K, M, R, kc, tile, smem_bytes, 0, stream);
}

// The "dma" form, same arguments plus `vec`: the cp.async piece size in
// bytes, 16 where a row and the table start are 16-byte aligned, else 4.
int pio_fused_als_dma_f32(const void* table, const void* idx, const void* cw,
                          const void* bw, const void* reg, const void* gram0,
                          void* x, int B, int K, int M, int R, int kc,
                          int tile, int smem_bytes, int vec, void* stream) {
  return dispatch<float>(true, table, idx, cw, bw, reg, gram0, x, B, K, M, R,
                         kc, tile, smem_bytes, vec, stream);
}

int pio_fused_als_dma_bf16(const void* table, const void* idx, const void* cw,
                           const void* bw, const void* reg, const void* gram0,
                           void* x, int B, int K, int M, int R, int kc,
                           int tile, int smem_bytes, int vec, void* stream) {
  return dispatch<__nv_bfloat16>(true, table, idx, cw, bw, reg, gram0, x, B,
                                 K, M, R, kc, tile, smem_bytes, vec, stream);
}

}  // extern "C"
