// Fused ALS normal-equation build and solve for sm_90a, in two forms,
// with long rows split across blocks and the Gram built on the tensor
// cores.
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
//   6.8 MB or 138,493 x 64 = 35 MB, fits the 50 MB L2), one warp per row,
//   widens them to f32 into a [KC, R] tile, synchronises, then
//   accumulates;
// * "dma": the row tile is double-buffered in the table's own element
//   width and filled by cp.async: while chunk c accumulates, chunk c+1's
//   rows are already in flight into the other buffer.  The two buffers
//   together take no more shared memory than the "taa" form's one f32
//   tile (half the chunk height for an f32 table), so both forms keep the
//   same blocks per SM.  A masked entry (cw = bw = 0) is zero-filled
//   through cp.async's source-size operand; an id outside the table
//   poisons its row with NaN by a plain store and is never read.  A bf16
//   row must be a whole number of 4-byte pieces (even R).
//
// For each row r of a bucket both compute
//   x[r] = (gram0 + sum_k cw[r,k] v_k v_k^T + reg[r] I)^-1 sum_k bw[r,k] v_k,
//   v_k = table[idx[r,k]]
// Masked entries carry cw = bw = 0 and cost only their 12 bytes of
// idx/cw/bw: no table read, and a chunk with no live entry skips its
// products.
//
// Bound on an H100 (3.35 TB/s; 495 TFLOP/s TF32 on the tensor cores, 67
// TFLOP/s f32 outside them), counting the least work of the function:
// one triangle of each Gram, nnz * R(R+1) flop, and the right-hand
// sides, 2 * nnz * R, on the tensor cores at f32 accuracy (3 TF32
// products for an f32 table, 2 for bf16), and one SPD solve a row,
// R^3/3 + 2R^2, in f32; the bytes are idx/cw/bw of the real entries
// (12 B a rating) and one read of the table.  So it is bound by
// operations (0.129 ms for a [32768, 128] rank-64 bucket of about 3.16M
// ratings against an f32 table; 0.048 ms for the heaviest item's
// 1.86M-rating row).  Measured times are in PERF.md.
//
// Design:
// * Split K across blocks.  A bucket of B rows runs on B * S blocks: block
//   (row, s) covers the row's segment [s * seg, (s + 1) * seg).  With
//   S = 1 the block solves its row itself.  With S > 1 (the planner,
//   ops/fused_als.py fused_tile_plan, splits buckets too short to fill
//   the card) each block writes its segment's partial Gram triangle and
//   rhs, in f32, to a workspace the wrapper allocates, and pass 2 sums a
//   row's S partials, adds gram0 and reg I, and solves.  Pass 2 is bound
//   by the partials' bytes (about 9 MB a split bucket at R = 64), so
//   where the rows are too few to fill the card its first stage
//   (fused_als_group_sum_kernel) sums groups of consecutive segments on
//   at least 2 * SMs blocks, and its second (fused_als_reduce_kernel, a
//   block per row) sums the group sums and solves; where B fills the
//   card the second stage sums the S partials itself.  Fixed orders and
//   no atomics: two calls on the same inputs give the same bits.
// * The Gram on the tensor cores, at f32 accuracy.  A chunk's products
//   are mma.sync m16n8k8 TF32 tiles with f32 accumulation:
//   A[i][k] = v_k[i], B[k][j] = cw_k v_k[j], and one extra n8 column
//   B[k][R'] = bw_k that carries the rhs in the same pass.  Every operand
//   is split into a TF32 high part and a TF32 residual ("3xTF32": hi*hi +
//   hi*lo + lo*hi), which keeps about 22 significant bits, so an f32
//   table is multiplied at f32 accuracy and an implicit weight cw = alpha
//   * r is never rounded to a short operand.  A bf16 value is exact in
//   TF32, so for a bf16 table the row operand has no residual and two
//   products suffice.  Only the lower triangle's tiles and the diagonal
//   tiles are computed; each of the block's 8 warps takes a run of
//   consecutive tiles (sharing their row fragment) over the whole chunk,
//   so no cross-warp reduction is needed.  The staged tile's row stride
//   keeps the fragment loads free of bank conflicts.
// * The solve is a Cholesky factorisation of the SPD system (about a
//   third of Gauss-Jordan's operations), with the forward substitution
//   riding the factorisation, by the whole block in panels of 8 columns:
//   warp 0 factors a panel in registers with shuffles, all 8 warps apply
//   it to the trailing triangle.  That is 2 block barriers per panel, 16
//   at R = 64, where Gauss-Jordan takes 2R.  (A first version solved with
//   one warp and no block barrier at all; with one system a block in
//   flight it set the time of every unsplit bucket.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launch_args.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 128;
// the pivot clamp of the Gauss-Jordan kernels (ops/solve.py _EPS)
constexpr float kEps = 1e-20f;

// ---- layout shared with ops/fused_als.py (the planner holds the same
// sums; the launcher refuses a plan that disagrees) -----------------------

__host__ __device__ inline int pad16(int R) { return (R + 15) & ~15; }

// Row stride, in 32-bit words, of a staged tile of `elem_bytes` elements.
// An m16n8k8 fragment load reads rows k0 + (lane & 3) at columns
// c0 + (lane >> 2): the stride keeps the four rows on disjoint banks
// (f32: 8 words a row, stride = 8 mod 16; bf16: 4 words, stride = 4 mod
// 8).  Columns R .. pad16(R) stay zero.
__host__ __device__ inline int stride_words(int R, int elem_bytes) {
  return elem_bytes == 4 ? pad16(R) + 8 : pad16(R) / 2 + 4;
}

// Output tiles of one chunk's product: for each 16-row block mi of the
// Gram, the n8 tiles 0 .. 2 mi + 1 (the lower triangle and the diagonal
// tiles) and one rhs tile.
__host__ __device__ inline int n_tiles(int R) {
  const int m16 = pad16(R) / 16;
  return m16 * (m16 + 2);
}

// Accumulator tiles per warp the kernels are compiled for.
__host__ __device__ inline int tiles_per_warp(int R) {
  const int need = (n_tiles(R) + kWarps - 1) / kWarps;
  return need <= 1 ? 1 : need <= 3 ? 3 : need <= 6 ? 6 : 10;
}

__host__ __device__ inline size_t sys_bytes(int R) {
  return 4 * (size_t)R * (R + 1);
}

__host__ __device__ inline size_t max_sz(size_t a, size_t b) {
  return a > b ? a : b;
}

// "taa": one [KC, stride] f32 tile, which the [R, R+1] system reuses
// after the last chunk, and the chunk's cw, bw and idx.
inline size_t taa_smem_bytes(int R, int KC) {
  return max_sz((size_t)KC * 4 * stride_words(R, 4), sys_bytes(R)) +
         12 * (size_t)KC;
}

// "dma": two [KC, stride] tiles in the table's element width (the system
// reuses them), and two sets of the chunk's cw, bw and idx.
inline size_t dma_smem_bytes(int R, int KC, int elem_bytes) {
  return max_sz(2 * (size_t)KC * 4 * stride_words(R, elem_bytes),
                sys_bytes(R)) +
         24 * (size_t)KC;
}

// Floats of one row's partial: the packed lower triangle and the rhs.
__host__ __device__ inline size_t partial_floats(int R) {
  return (size_t)R * (R + 1) / 2 + R;
}

// ---- tensor-core pieces --------------------------------------------------

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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x ~ hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b for one m16n8k8 TF32 tile, f32 accumulation.  Fragments
// (g = lane >> 2, q = lane & 3): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
// a3 (g + 8, q + 4); b0 (k = q, n = g), b1 (q + 4, g); c0 (g, 2q),
// c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's share of the output tiles: tiles t = warp * per + s for
// s < count, per = ceil(tiles / kWarps), so a warp's tiles mostly share
// their 16-row block and with it the A fragment.  row0 is the tile's
// first Gram row plus g; col0 its first column plus g, or -1 for the rhs
// tile.
template <int TPW>
struct WarpTiles {
  int count;
  int row0[TPW];
  int col0[TPW];
  int nj[TPW];

  __device__ __forceinline__ void init(int R) {
    const int warp = threadIdx.x >> 5;
    const int g = (threadIdx.x & 31) >> 2;
    const int total = n_tiles(R);
    const int per = (total + kWarps - 1) / kWarps;
    count = 0;
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int t = warp * per + s;
      int m = 0;
      while ((m + 1) * (m + 3) <= t) ++m;  // t lies in 16-row block m
      const int j = t - m * (m + 2);
      nj[s] = j;
      row0[s] = 16 * m + g;
      col0[s] = j == 2 * m + 2 ? -1 : 8 * j + g;
      if (s < per && t < total) count = s + 1;
    }
  }
};

// Accumulate one staged chunk of n8 rows (a multiple of 8; rows past the
// chunk's entries are zero with zero weights) into the warp's tiles.  V
// holds rows of element type S at a stride of SE elements; T is the
// table's type (an f32 table splits the row operand too).  A chunk with
// no live entry adds nothing and is skipped.
template <typename S, typename T, int TPW>
__device__ __forceinline__ void accumulate(const S* V, int SE,
                                           const float* wc, const float* wb,
                                           int n8, const WarpTiles<TPW>& wt,
                                           float (&acc)[TPW][4]) {
  constexpr bool kSplitRows = sizeof(T) == 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  bool live = false;
  for (int k = lane; k < n8; k += 32) live |= wc[k] != 0.0f || wb[k] != 0.0f;
  if (!__any_sync(0xffffffffu, live)) return;
  for (int k0 = 0; k0 < n8; k0 += 8) {
    const S* r0 = V + (size_t)(k0 + q) * SE;
    const S* r1 = r0 + 4 * (size_t)SE;
    const float w0 = wc[k0 + q], w1 = wc[k0 + q + 4];
    const float u0 = wb[k0 + q], u1 = wb[k0 + q + 4];
    uint32_t ah[4], al[4];
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      if (s < wt.count) {
        if (s == 0 || wt.row0[s] != wt.row0[s - 1]) {
          // a new 16-row block: load and split its A fragment
          const int ia = wt.row0[s];
          const float av[4] = {widen(r0[ia]), widen(r0[ia + 8]),
                               widen(r1[ia]), widen(r1[ia + 8])};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kSplitRows) {
              split_tf32(av[e], ah[e], al[e]);
            } else {
              ah[e] = __float_as_uint(av[e]);
            }
          }
        }
        float b0, b1;
        if (wt.col0[s] < 0) {
          b0 = g == 0 ? u0 : 0.0f;
          b1 = g == 0 ? u1 : 0.0f;
        } else {
          const int jb = wt.col0[s];
          b0 = w0 * widen(r0[jb]);
          b1 = w1 * widen(r1[jb]);
        }
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b0, bh0, bl0);
        split_tf32(b1, bh1, bl1);
        if constexpr (kSplitRows) mma_tf32(acc[s], al, bh0, bh1);
        mma_tf32(acc[s], ah, bl0, bl1);
        mma_tf32(acc[s], ah, bh0, bh1);
      }
    }
  }
}

// Rows of a system each lane of the factoring warp holds (R <= 32 RPL),
// for the kernels compiled with TPW accumulator tiles per warp.
template <int TPW>
__host__ __device__ constexpr int rows_per_lane() {
  return TPW == 1 ? 1 : TPW == 3 ? 2 : TPW == 6 ? 3 : 4;
}

constexpr int kPanel = 8;

// v[hp] at compile-time h (a register array read at a runtime index
// would go to local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int hp) {
  float r = 0.0f;
#pragma unroll
  for (int h = 0; h < N; ++h) r = h == hp ? v[h] : r;
  return r;
}

template <int N, int C>
__device__ __forceinline__ float pick_col(const float (&v)[N][C], int hp,
                                          int c) {
  float r = 0.0f;
#pragma unroll
  for (int h = 0; h < N; ++h) r = h == hp ? v[h][c] : r;
  return r;
}

// Cholesky solve of one system by the whole block, in panels of kPanel
// columns.  M is [R][R + 1] in shared memory (leading dimension R + 1)
// with the lower triangle of A and b in column R; only the lower
// triangle is read, and L overwrites it (its diagonal as 1 / L[p][p]).
// For each panel, warp 0 loads the panel's columns into registers (lane
// l holds rows l + 32h, the rhs beside them), factors them with shuffles
// and applies the forward substitution to every row of the rhs; after a
// barrier all 8 warps subtract the panel's product from the trailing
// lower triangle, and a second barrier ends the panel: 2 barriers per 8
// columns (16 at R = 64; wider panels hold more registers and fit fewer
// blocks on an SM, which cost more than the barriers they save).  Warp
// 0 then back-substitutes with L^T, the rhs still in its registers.  A
// pivot at or below kEps is clamped, as the Gauss-Jordan kernels clamp
// theirs; a NaN stays NaN.  Every thread of the block must call it.  Not
// inlined: one copy per RPL serves every kernel (the unrolled panel is
// long to compile), at the cost of one call a row.
template <int RPL>
__device__ __noinline__ void chol_solve_block(float* M, int R,
                                              float* __restrict__ x) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ld = R + 1;
  float yv[RPL];
#pragma unroll
  for (int h = 0; h < RPL; ++h) {
    const int i = lane + 32 * h;
    yv[h] = warp == 0 && i < R ? M[i * ld + R] : 0.0f;
  }
  for (int c0 = 0; c0 < R; c0 += kPanel) {
    const int w = min(kPanel, R - c0);
    if (warp == 0) {
      float pv[RPL][kPanel];
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        const int i = lane + 32 * h;
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          pv[h][c] = i < R && c < w && i >= c0 + c ? M[i * ld + c0 + c]
                                                   : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        if (c >= w) break;
        const int p = c0 + c;
        float d = __shfl_sync(0xffffffffu, pick_col(pv, p >> 5, c), p & 31);
        d = d > kEps ? d : (d != d ? d : kEps);
        const float inv = rsqrtf(d);  // 1 / L[p][p]
        const float yp =
            __shfl_sync(0xffffffffu, pick(yv, p >> 5), p & 31) * inv;
#pragma unroll
        for (int h = 0; h < RPL; ++h) {
          const int i = lane + 32 * h;
          if (i > p) {
            pv[h][c] *= inv;
            yv[h] = fmaf(-pv[h][c], yp, yv[h]);
          } else if (i == p) {
            pv[h][c] = inv;  // the diagonal is kept as its inverse
            yv[h] = yp;
          } else {
            pv[h][c] = 0.0f;
          }
        }
#pragma unroll
        for (int c2 = c + 1; c2 < kPanel; ++c2) {
          if (c2 >= w) break;
          const int q = c0 + c2;
          const float lqp =
              __shfl_sync(0xffffffffu, pick_col(pv, q >> 5, c), q & 31);
#pragma unroll
          for (int h = 0; h < RPL; ++h) {
            if (lane + 32 * h > p) pv[h][c2] = fmaf(-pv[h][c], lqp, pv[h][c2]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        const int i = lane + 32 * h;
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          if (i < R && c < w && i >= c0 + c) M[i * ld + c0 + c] = pv[h][c];
        }
      }
    }
    __syncthreads();
    // trailing update: rows i by warp, columns j <= i by lane
    const int t0 = c0 + w;
    for (int j0 = t0; j0 < R; j0 += 32) {
      const int j = j0 + lane;
      float lj[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        lj[c] = j < R && c < w ? M[j * ld + c0 + c] : 0.0f;
      }
      for (int i = j0 + warp; i < R; i += kWarps) {
        if (j > i) continue;
        const float* li = M + i * ld + c0;
        float a = M[i * ld + j];
#pragma unroll
        for (int c = 0; c < kPanel; ++c) a = fmaf(-li[c], lj[c], a);
        M[i * ld + j] = a;
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    for (int p = R - 1; p >= 0; --p) {
      const float xp =
          __shfl_sync(0xffffffffu, pick(yv, p >> 5), p & 31) * M[p * ld + p];
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        const int i = lane + 32 * h;
        if (i < p) {
          yv[h] = fmaf(-M[p * ld + i], xp, yv[h]);
        } else if (i == p) {
          yv[h] = xp;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      const int i = lane + 32 * h;
      if (i < R) x[i] = yv[h];
    }
  }
}

// The end of pass 1.  S == 1: write gram0 + acc + reg I and the rhs into
// the system M (which reuses the tile region: the caller synchronised
// after the last chunk), then warp 0 solves.  S > 1: write the partial
// triangle and rhs to `part`.
template <int TPW>
__device__ __forceinline__ void finish_row(const WarpTiles<TPW>& wt,
                                           const float (&acc)[TPW][4],
                                           float* M, float* part,
                                           const float* gram0, float rg,
                                           float* xrow, int R) {
  const int q = threadIdx.x & 3;
  const int ld = R + 1;
  const size_t tri = (size_t)R * (R + 1) / 2;
#pragma unroll
  for (int s = 0; s < TPW; ++s) {
    if (s >= wt.count) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = wt.row0[s] + (e >= 2 ? 8 : 0);
      if (i >= R) continue;
      if (wt.col0[s] < 0) {
        if (q != 0 || (e & 1)) continue;  // the rhs is the tile's column 0
        if (part) {
          part[tri + i] = acc[s][e];
        } else {
          M[i * ld + R] = acc[s][e];
        }
      } else {
        const int j = 8 * wt.nj[s] + 2 * q + (e & 1);
        if (j > i) continue;
        if (part) {
          part[(size_t)i * (i + 1) / 2 + j] = acc[s][e];
        } else {
          M[i * ld + j] =
              gram0[i * R + j] + acc[s][e] + (i == j ? rg : 0.0f);
        }
      }
    }
  }
  if (part) return;
  __syncthreads();
  chol_solve_block<rows_per_lane<TPW>()>(M, R, xrow);
}

// ---- "taa" form ----------------------------------------------------------

template <typename T, int TPW>
__global__ void __launch_bounds__(kThreads)
    fused_als_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ cw,
                     const float* __restrict__ bw,
                     const float* __restrict__ reg,
                     const float* __restrict__ gram0, float* __restrict__ x,
                     float* __restrict__ ws, int K, int M, int R, int KC,
                     int S, int seg) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int SE = stride_words(R, 4);
  float* V = reinterpret_cast<float*>(sm);
  const size_t region = max_sz((size_t)KC * SE * 4, sys_bytes(R));
  float* wc = reinterpret_cast<float*>(sm + region);
  float* wb = wc + KC;
  int* ix = reinterpret_cast<int*>(wb + KC);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row = blockIdx.x / S;
  const int sgm = blockIdx.x - (int)row * S;
  const size_t base = row * K;
  const int kbeg = sgm * seg;
  const int kend = min(K, kbeg + seg);

  WarpTiles<TPW> wt;
  wt.init(R);
  float acc[TPW][4];
#pragma unroll
  for (int s = 0; s < TPW; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] = 0.0f;

  for (int e = tid; e < KC * SE; e += kThreads) V[e] = 0.0f;
  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    const int n = min(KC, kend - k0);
    const int n8 = (n + 7) & ~7;
    __syncthreads();  // the previous chunk's reads are done
    bool live = false;
    for (int t = tid; t < n8; t += kThreads) {
      if (t < n) {
        ix[t] = idx[base + k0 + t];
        wc[t] = cw[base + k0 + t];
        wb[t] = bw[base + k0 + t];
        live |= wc[t] != 0.0f || wb[t] != 0.0f;
      } else {
        ix[t] = 0;
        wc[t] = 0.0f;
        wb[t] = 0.0f;
      }
    }
    if (!__syncthreads_or(live)) continue;  // no table read, no products
    // a warp per row, four rows at a time with all their loads in flight
    for (int kk0 = warp; kk0 < n8; kk0 += 4 * kWarps) {
      float v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = kk0 + u * kWarps;
        const bool live = kk < n8 && (wc[kk] != 0.0f || wb[kk] != 0.0f);
        const int id = kk < n8 ? ix[kk] : 0;
        // an id outside the table poisons the row instead of reading out
        // of bounds: the caller sees NaN, never a wrong number
        const bool ok = live && id >= 0 && id < M;
        const T* src = table + (size_t)(ok ? id : 0) * R;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c = lane + 32 * h;
          v[u][h] = ok && c < R ? widen(src[c]) : (live && !ok ? NAN : 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = kk0 + u * kWarps;
        if (kk >= n8) break;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c = lane + 32 * h;
          if (c < R) V[(size_t)kk * SE + c] = v[u][h];
        }
      }
    }
    __syncthreads();
    accumulate<float, T, TPW>(V, SE, wc, wb, n8, wt, acc);
  }
  __syncthreads();  // the tile region becomes the system
  finish_row<TPW>(wt, acc, V,
                  S > 1 ? ws + (row * S + sgm) * partial_floats(R) : nullptr,
                  gram0, reg[row], x + row * R, R);
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

// Stage chunk [k0, k0 + n) of the row: its idx/cw/bw by plain loads (zero
// weights for the rows up to the next multiple of 8; then a barrier, so
// every thread sees the ids), its table rows by cp.async into tile Vb
// (rows SB bytes apart).  The copies are committed by the caller.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ cw, const float* __restrict__ bw, size_t base,
    int k0, int n, int M, int R, int SB, int vec, T* Vb, int* ix, float* wc,
    float* wb) {
  const int tid = threadIdx.x;
  const int n8 = (n + 7) & ~7;
  for (int t = tid; t < n8; t += kThreads) {
    if (t < n) {
      ix[t] = idx[base + k0 + t];
      wc[t] = cw[base + k0 + t];
      wb[t] = bw[base + k0 + t];
    } else {
      ix[t] = 0;
      wc[t] = 0.0f;
      wb[t] = 0.0f;
    }
  }
  __syncthreads();
  const int row_bytes = R * (int)sizeof(T);
  const int pieces = row_bytes / vec;
  unsigned char* dst0 = reinterpret_cast<unsigned char*>(Vb);
  const unsigned char* tab = reinterpret_cast<const unsigned char*>(table);
  for (int e = tid; e < n8 * pieces; e += kThreads) {
    const int kk = e / pieces;
    const int q = e - kk * pieces;
    unsigned char* dst = dst0 + (size_t)kk * SB + q * vec;
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

template <typename T, int TPW>
__global__ void __launch_bounds__(kThreads)
    fused_als_dma_kernel(const T* __restrict__ table,
                         const int* __restrict__ idx,
                         const float* __restrict__ cw,
                         const float* __restrict__ bw,
                         const float* __restrict__ reg,
                         const float* __restrict__ gram0,
                         float* __restrict__ x, float* __restrict__ ws,
                         int K, int M, int R, int KC, int S, int seg,
                         int vec) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int SW = stride_words(R, (int)sizeof(T));
  const int SB = 4 * SW;                        // row stride in bytes
  const int SE = SB / (int)sizeof(T);           // ... in elements
  T* V0 = reinterpret_cast<T*>(sm);
  const size_t tile_elems = (size_t)KC * SE;
  const size_t region = max_sz(2 * (size_t)KC * SB, sys_bytes(R));
  // buffer b's cw, bw and idx start at meta + 3 * b * KC
  float* meta = reinterpret_cast<float*>(sm + region);

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x / S;
  const int sgm = blockIdx.x - (int)row * S;
  const size_t base = row * K;
  const int kbeg = sgm * seg;
  const int kend = min(K, kbeg + seg);

  WarpTiles<TPW> wt;
  wt.init(R);
  float acc[TPW][4];
#pragma unroll
  for (int s = 0; s < TPW; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] = 0.0f;

  // zero both buffers once: the pad columns are never copied into
  uint32_t* z = reinterpret_cast<uint32_t*>(sm);
  for (size_t e = tid; e < 2 * (size_t)KC * SW; e += kThreads) z[e] = 0u;
  __syncthreads();

  const int nchunks = kend > kbeg ? (kend - kbeg + KC - 1) / KC : 0;
  if (nchunks > 0) {
    stage_chunk<T>(table, idx, cw, bw, base, kbeg, min(KC, kend - kbeg), M,
                   R, SB, vec, V0, reinterpret_cast<int*>(meta + 2 * KC),
                   meta, meta + KC);
  }
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    const int k1 = kbeg + (c + 1) * KC;
    if (c + 1 < nchunks) {
      // buffer b ^ 1 was last read by chunk c - 1, which ended with a
      // barrier: it is free to fill while chunk c accumulates
      float* m1 = meta + 3 * (b ^ 1) * KC;
      stage_chunk<T>(table, idx, cw, bw, base, k1, min(KC, kend - k1), M, R,
                     SB, vec, V0 + (b ^ 1) * tile_elems,
                     reinterpret_cast<int*>(m1 + 2 * KC), m1, m1 + KC);
    }
    cp_async_commit();     // one group per step, the last one empty
    cp_async_wait_one();   // this thread's copies of chunk c have landed
    __syncthreads();       // and every other thread's
    const float* m0 = meta + 3 * b * KC;
    const int n = min(KC, kend - (kbeg + c * KC));
    accumulate<T, T, TPW>(V0 + b * tile_elems, SE, m0, m0 + KC,
                          (n + 7) & ~7, wt, acc);
    __syncthreads();       // buffer b is free for chunk c + 2
  }
  __syncthreads();  // the tile region becomes the system
  finish_row<TPW>(wt, acc, reinterpret_cast<float*>(sm),
                  S > 1 ? ws + (row * S + sgm) * partial_floats(R) : nullptr,
                  gram0, reg[row], x + row * R, R);
}

// ---- pass 2: reduce the split partials and solve -------------------------
//
// What bounds it: bytes.  A split bucket's partials are [B, S, P] f32
// (P = R(R+1)/2 + R, 2,144 at R = 64), and the planner gives a split
// bucket about WAVES * SMS partial rows, about 9 MB at R = 64: 2.7 us
// at 3.35 TB/s.  A block per row reading them alone (the first design)
// left all but B SMs idle: at B = 1 one SM read the heavy row's 8.8 MB
// in 0.33 ms.  Two stages now, both in one pass-2 call (one count of
// fused_als_reduce, however many launches):
// * stage 1 (fused_als_group_sum_kernel), where the rows are too few to
//   fill the card and have more segments than two batches of loads: a
//   grid of (tile of the [B * P] entries, group of consecutive
//   segments), G groups of `seg_per_group` segments.  A
//   thread sums its VEC entries over its group's segments in segment
//   order, kUnroll loads in flight (16-byte loads where P % 4 == 0 and
//   the partials are 16-byte aligned, else 4-byte loads), and writes the group sum to the [B, G, P] scratch the wrapper
//   allocates.  The planner (ops/fused_als.py reduce_plan) picks G so
//   that the grid has at least 2 * SMs blocks (G = 1 where the tiles
//   alone fill it), in groups of at least two segments;
// * stage 2 (fused_als_reduce_kernel), a block per row: sums the row's G
//   group sums (or, without stage 1, its S partials: where B alone fills
//   the card, or S <= 2 * kUnroll) in order, the same
//   loads, writes gram0 + sum + reg I and the rhs into the
//   [R, R + 1] system in shared memory and solves it (chol_solve_block,
//   pass 1's).  At B = 1 that one-block solve is the floor: about 0.030
//   ms of the pass's 0.039 ms of device time at [1, 1024, 2144] on an
//   H100 (PERF.md).
// Every sum has a fixed order, and no value is summed by atomics: two
// calls on the same partials give the same bits.

// The two constants of pass 2's plan are defined here; ops/fused_als.py
// SUM_THREADS and REDUCE_UNROLL copy them (tests/test_torch_fused_reduce.py
// holds the copies to these lines).
// a stage-1 block: narrow tiles, so fewer groups reach 2 * SMs blocks
// and stage 2 has fewer group sums to read (128 threads: 0.048 against
// 0.045 ms at [1, 2048, 2144], kernel_variants.py reduce)
constexpr int kSumThreads = 64;
// loads in flight a thread.  Stage 2's block also runs the solve, and its
// registers set how many blocks of a tall bucket share an SM: 16 took
// 102 registers a thread against 64 and 0.129 against 0.070 ms at
// B = 1046.
constexpr int kUnroll = 8;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// acc += src[0], src[stride], ..., src[(n - 1) stride], in that order, in
// batches of kUnroll slices whose loads are all issued before their adds
// (a short last batch predicated, not a loop of single loads)
template <int VEC>
__device__ __forceinline__ void sum_slices(const float* __restrict__ src,
                                           size_t stride, int n,
                                           float (&acc)[VEC]) {
  for (int s = 0; s < n; s += kUnroll) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u < n) load_vec<VEC>(src + (size_t)(s + u) * stride, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u < n) {
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] += v[u][c];
      }
    }
  }
}

// Stage 1: block (tile, group) sums segments [g * spg, min(S, (g + 1) *
// spg)) of the tile's entries of the flattened [B * P] partial rows.
// With VEC = 4, P % 4 == 0: a 16-byte piece never straddles two rows.
template <int VEC>
__global__ void __launch_bounds__(kSumThreads)
    fused_als_group_sum_kernel(const float* __restrict__ ws,
                               float* __restrict__ groups, long long total,
                               int P, int S, int G, int spg) {
  const long long f =
      ((long long)blockIdx.x * kSumThreads + threadIdx.x) * VEC;
  if (f >= total) return;
  const long long b = f / P;
  const int e = static_cast<int>(f - b * P);
  const int g = blockIdx.y;
  const int s0 = g * spg;
  float acc[VEC] = {};
  sum_slices<VEC>(ws + ((size_t)b * S + s0) * P + e, P, min(spg, S - s0),
                  acc);
  float* out = groups + ((size_t)b * G + g) * P + e;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
  } else {
    out[0] = acc[0];
  }
}

// the row i of the packed lower triangle's entry e = i (i + 1) / 2 + j
__device__ __forceinline__ int tri_row(int e) {
  int i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  return i;
}

// Stage 2: block per row of src [B, N, P] (N group sums, or the S
// partials), summed in order, then gram0 and reg I added, and solved.
template <int RPL, int VEC>
__global__ void __launch_bounds__(kThreads)
    fused_als_reduce_kernel(const float* __restrict__ src,
                            const float* __restrict__ reg,
                            const float* __restrict__ gram0,
                            float* __restrict__ x, int R, int N) {
  extern __shared__ float Msys[];
  const int ld = R + 1;
  const size_t row = blockIdx.x;
  const int P = static_cast<int>(partial_floats(R));
  const int tri = R * (R + 1) / 2;
  const float rg = reg[row];
  const float* part = src + row * N * P;
  for (int v = threadIdx.x * VEC; v < P; v += kThreads * VEC) {
    float acc[VEC] = {};
    sum_slices<VEC>(part + v, P, N, acc);
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const int e = v + c;
      if (e < tri) {
        const int i = tri_row(e);
        const int j = e - i * (i + 1) / 2;
        const float g0 = gram0 == nullptr ? 0.0f : gram0[i * R + j];
        Msys[i * ld + j] = g0 + acc[c] + (i == j ? rg : 0.0f);
      } else {
        Msys[(e - tri) * ld + R] = acc[c];
      }
    }
  }
  __syncthreads();
  chol_solve_block<RPL>(Msys, R, x + row * R);
}

template <int RPL, int VEC>
int launch_reduce(const ReduceArgs& a, int groups, cudaStream_t stream) {
  const int P = static_cast<int>(partial_floats(a.R));
  const float* src = static_cast<const float*>(a.ws);
  int n = a.segments;
  if (a.scratch != nullptr) {  // stage 1
    const long long total = (long long)a.B * P;
    const dim3 grid(static_cast<unsigned>(
                        (total + kSumThreads * VEC - 1) / (kSumThreads * VEC)),
                    static_cast<unsigned>(groups));
    fused_als_group_sum_kernel<VEC><<<grid, kSumThreads, 0, stream>>>(
        src, static_cast<float*>(a.scratch), total, P, a.segments, groups,
        a.seg_per_group);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = static_cast<const float*>(a.scratch);
    n = groups;
  }
  const size_t smem = sys_bytes(a.R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_als_reduce_kernel<RPL, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_als_reduce_kernel<RPL, VEC><<<a.B, kThreads, smem, stream>>>(
      src, static_cast<const float*>(a.reg),
      static_cast<const float*>(a.gram0), static_cast<float*>(a.x), a.R, n);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch_reduce(const ReduceArgs& a, int groups, cudaStream_t stream) {
  switch ((a.R + 31) / 32) {
    case 1:
      return launch_reduce<1, VEC>(a, groups, stream);
    case 2:
      return launch_reduce<2, VEC>(a, groups, stream);
    case 3:
      return launch_reduce<3, VEC>(a, groups, stream);
    default:
      return launch_reduce<4, VEC>(a, groups, stream);
  }
}

// ---- launch --------------------------------------------------------------

template <typename T, int TPW>
int launch(bool dma, const void* table, const void* idx, const void* cw,
           const void* bw, const void* reg, const void* gram0, void* x,
           void* ws, int B, int K, int M, int R, int KC, int S, int seg,
           int vec, size_t smem, cudaStream_t stream) {
  auto taa = fused_als_kernel<T, TPW>;
  auto dmak = fused_als_dma_kernel<T, TPW>;
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
  float* part = static_cast<float*>(ws);
  const unsigned blocks = static_cast<unsigned>((size_t)B * S);
  if (dma) {
    dmak<<<blocks, kThreads, smem, stream>>>(t, ix, c, w, rg, g0, out, part,
                                             K, M, R, KC, S, seg, vec);
  } else {
    taa<<<blocks, kThreads, smem, stream>>>(t, ix, c, w, rg, g0, out, part, K,
                                            M, R, KC, S, seg);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool dma, const void* table, const void* idx, const void* cw,
             const void* bw, const void* reg, const void* gram0, void* x,
             void* ws, int B, int K, int M, int R, int KC, int tile,
             int smem_bytes, int S, int seg, long long ws_bytes, int vec,
             void* stream) {
  if (B < 0 || K < 0 || M < 1 || R < 1 || R > kMaxRank || KC < 8 ||
      KC % 8 != 0)
    return cudaErrorInvalidValue;
  // the segments tile K exactly: S of seg slots (a whole number of
  // chunks), the last one not empty
  if (S < 1 || seg < 0 || seg % KC != 0 || (long long)S * seg < K ||
      (S > 1 && (long long)(S - 1) * seg >= K) ||
      (long long)B * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long want_ws =
      S > 1 ? (long long)B * S * (long long)partial_floats(R) * 4 : 0;
  if (ws_bytes != want_ws || (want_ws > 0 && ws == nullptr))
    return cudaErrorInvalidValue;
  size_t smem;
  if (dma) {
    // a row must be a whole number of vec-byte pieces
    const int row_bytes = R * (int)sizeof(T);
    if ((vec != 16 && vec != 4) || row_bytes % vec != 0)
      return cudaErrorInvalidValue;
    smem = dma_smem_bytes(R, KC, (int)sizeof(T));
  } else {
    smem = taa_smem_bytes(R, KC);
  }
  if (tile != tiles_per_warp(R) || static_cast<size_t>(smem_bytes) != smem)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 1:
      return launch<T, 1>(dma, table, idx, cw, bw, reg, gram0, x, ws, B, K, M,
                          R, KC, S, seg, vec, smem, s);
    case 3:
      return launch<T, 3>(dma, table, idx, cw, bw, reg, gram0, x, ws, B, K, M,
                          R, KC, S, seg, vec, smem, s);
    case 6:
      return launch<T, 6>(dma, table, idx, cw, bw, reg, gram0, x, ws, B, K, M,
                          R, KC, S, seg, vec, smem, s);
    default:
      return launch<T, 10>(dma, table, idx, cw, bw, reg, gram0, x, ws, B, K,
                           M, R, KC, S, seg, vec, smem, s);
  }
}

template <typename T>
int dispatch_args(bool dma, const void* block) {
  const FusedArgs a = pio::load_args<FusedArgs>(block);
  return dispatch<T>(dma, a.table, a.idx, a.cw, a.bw, a.reg, a.gram0, a.x,
                     a.ws, a.B, a.K, a.M, a.R, a.kc, a.tile, a.smem_bytes,
                     a.segments, a.seg_len, a.ws_bytes, dma ? a.vec : 0,
                     a.stream);
}

}  // namespace

extern "C" {

// Pass 1 (FusedArgs).  table [M, R] (f32 or bf16), idx [B, K] int32,
// cw/bw [B, K] f32, reg [B] f32, gram0 [R, R] f32 (symmetric; its lower
// triangle is read) -> x [B, R] f32 when segments == 1, else the partials
// in ws ([B, segments, R(R+1)/2 + R] f32, ws_bytes bytes); all contiguous
// on the device of `stream`.  kc, tile, smem_bytes, segments, seg_len and
// ws_bytes come from fused_tile_plan and must match this file's own
// accounting.  Returns the CUDA error code of the launch (0 on success).
int pio_fused_als_f32(const void* block) {
  return dispatch_args<float>(false, block);
}

int pio_fused_als_bf16(const void* block) {
  return dispatch_args<__nv_bfloat16>(false, block);
}

// The "dma" form: `vec` is the cp.async piece size in bytes, 16 where a
// row and the table start are 16-byte aligned, else 4.
int pio_fused_als_dma_f32(const void* block) {
  return dispatch_args<float>(true, block);
}

int pio_fused_als_dma_bf16(const void* block) {
  return dispatch_args<__nv_bfloat16>(true, block);
}

// Pass 2 of a split bucket (ReduceArgs): ws [B, segments, R(R+1)/2 + R]
// f32 from pass 1, reg [B], gram0 [R, R] (NULL: zeros) -> x [B, R].
// seg_per_group and scratch_bytes come from ops/fused_als.py reduce_plan:
// stage 1 runs where scratch is not NULL, over ceil(segments /
// seg_per_group) groups, and scratch_bytes must then be the [B, groups,
// P] f32 scratch; without it a group must hold every segment.  Loads
// are 16 bytes where P % 4 == 0 and ws and scratch are 16-byte aligned,
// else 4.
int pio_fused_als_reduce(const void* block) {
  const ReduceArgs a = pio::load_args<ReduceArgs>(block);
  const int B = a.B, R = a.R, S = a.segments, spg = a.seg_per_group;
  if (B < 0 || R < 1 || R > kMaxRank || S < 1 || spg < 1 ||
      a.ws_bytes != (long long)B * S * (long long)partial_floats(R) * 4)
    return cudaErrorInvalidValue;
  const long long P = (long long)partial_floats(R);
  const int groups = (S + spg - 1) / spg;
  if (a.scratch != nullptr ? a.scratch_bytes != (long long)B * groups * P * 4
                           : groups != 1 || a.scratch_bytes != 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const bool vec4 = P % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.ws) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.scratch) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  return vec4 ? dispatch_reduce<4>(a, groups, s)
              : dispatch_reduce<1>(a, groups, s);
}

}  // extern "C"
