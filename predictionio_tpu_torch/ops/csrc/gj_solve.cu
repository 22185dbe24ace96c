// Batched SPD solve A[i] x[i] = b[i] in registers, for sm_90a.
//
// Replaces: predictionio_tpu/ops/solve.py _gj_kernel (pallas_call at
// ops/solve.py:162, launched by _solve_padded), the kernel behind
// ALSConfig(solver="pallas").  The TPU kernel runs Gauss-Jordan lock-step
// over a VMEM tile of systems; this kernel computes the same function (an
// SPD solve) by other steps: a root-free Cholesky factorisation of the
// lower triangle (symmetric Gaussian elimination, A = U^T D^-1 U) and one
// back substitution.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores),
// counting the least work of the function, not of this kernel: an SPD
// solve needs one triangle of A, R(R+1)/2 * 4 bytes, plus b and x
// (2*R*4), and about R^3/3 + 2R^2 flop.  At 65,536 systems of rank 64
// that is 0.58 GB, 0.173 ms at the memory rate, against 6.0 GFLOP, 0.09
// ms at the f32 rate: the function is memory-bound.
//
// What held the first design back (one block of 128 threads
// a system, [A | b] in shared memory, Gauss-Jordan): R pivot steps with
// two block barriers each, every step reading and rewriting R x (R+1-p)
// entries of shared memory (about 1.6 MB a system at R = 64), about R^3/2
// multiply-adds where Cholesky needs R^3/6, a division for every entry of
// the pivot row, and an integer e / R for each element loaded.  It took
// 10.58 ms for 65,536 rank-64 systems, 61x the bound.
//
// Design:
// * The kernel is compiled for four padded ranks RP (16, 32, 64, 128) and
//   runs any R <= 128 at the least RP >= R: rows and columns from R to RP
//   are the identity, so the extra entries of x come out zero, and the
//   steps past R are skipped (R is uniform over the block).
// * A thread holds rows of one system in registers: two, l and l + RP/2,
//   up to rank 64 (a system of rank 64 is one warp, and each entry of a
//   step's vector a thread reads serves both rows), one at rank 128 (128
//   of its 168 registers; two rows a thread would not fit).  Systems of
//   at most a warp share a block of up to 128 threads and 48 KB, fewer
//   where the batch is too small to give every SM a block; a rank-128
//   system has a block of its own, so that its barrier waits for no
//   other system (ops/solve.py gj_plan, which the entry point checks).
// * The block stages only the lower triangle of each A through shared
//   memory: 16-byte streaming loads where R % 4 == 0 and A is 16-byte
//   aligned, 4-byte loads otherwise, a row's pieces from RP / 4
//   neighbouring threads (no division), issued in batches of 8 before
//   their stores, so the block waits on device memory once a batch.  Each
//   thread then reads its symmetric rows (row i's lower part and column
//   i's lower part; leading dimension RP + 1, so both reads are free of
//   bank conflicts).
// * Step p: the rows below p have written their a[p] (column p of the
//   trailing matrix), and the pivot row its b and 1 / d, into a small
//   shared vector; one barrier (a warp's where a system lies within one
//   warp); then every row reads the vector back four entries at a time
//   (broadcast 16-byte loads) and subtracts c * col from its entries right
//   of p, c = a[p] / d below the pivot and 0 above it (no branch: a
//   branch around each row's update cost 17% at rank 64), and the rows
//   below write their a[p + 1] into the next step's vector, the next
//   pivot row its b and 1 / its pivot, so no thread divides after a
//   barrier.  The vector is double-buffered, so a step needs one barrier.
//   Rows keep their entries right of the diagonal (U), so the back
//   substitution needs no other data: one value of x is broadcast a step,
//   by a shuffle where a system lies within a warp.
// * The pivot is clamped as fused_als.cu chol_solve_block clamps it
//   (kEps = 1e-20): a zero system gives x = 0, as Gauss-Jordan does, and a
//   NaN stays NaN; a negative pivot is kept, as the Gauss-Jordan reference
//   keeps it (a root-free factorisation takes no square root).
//
// Measured (chip_smoke.py and kernel_variants.py gj, NVIDIA H100 80GB HBM3,
// 700 W): 1.104-1.108 ms for 65,536 rank-64 systems, 6.4x the bound,
// against 10.58-10.65 ms for the first design and 12.2-12.3 ms for
// cholesky_ex + cholesky_solve in the same runs.  The load of A alone
// takes 0.31 ms and the factorisation and solves alone 1.02 ms: what is
// left is the issue of about R^3/2 multiply-adds a system by one thread a
// row (rows above the pivot idle in their lanes) and the latency of 2R
// dependent steps.  Rank 128 (one row a thread, a block a system) is
// timed by chip_smoke.py phase gj at 16,384 systems; PERF.md gives it.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_args.cuh"

namespace {

// largest rank the kernel accepts (ops/solve.py MAX_RANK)
constexpr int kMaxRank = 128;
// threads a block holds at most (ops/solve.py _GJ_THREADS)
constexpr int kMaxThreads = 128;
// the pivot clamp of the reference elimination (ops/solve.py _EPS)
constexpr float kEps = 1e-20f;

// the padded rank a system of rank R runs at (ops/solve.py gj_plan)
__host__ __device__ constexpr int pad_rank(int R) {
  return R <= 16 ? 16 : R <= 32 ? 32 : R <= 64 ? 64 : 128;
}

// floats of one system's step vector: RP entries of column p, the pivot
// row's b (slot RP), the back substitution's x (slot RP + 1) and 1 / the
// pivot (slot RP + 2), padded to whole 16-byte pieces
__host__ __device__ constexpr int vec_floats(int RP) { return RP + 4; }

// one block's shared memory: each system's staged [RP][RP + 1] lower
// triangle, then two step vectors a system
__host__ __device__ inline size_t gj_smem_bytes(int RP, int systems) {
  return sizeof(float) * (size_t)systems *
         ((size_t)RP * (RP + 1) + 2 * (size_t)vec_floats(RP));
}

// rows of a system a thread holds: two up to rank 64 (so that each entry
// of a step's vector it reads serves two rows), one at rank 128 (whose
// rows take 128 registers each)
__host__ __device__ constexpr int rows_per_thread(int RP) {
  return RP == 128 ? 1 : 2;
}

// systems a block may hold at most: those of threads_per_system <= 32
// share a block of up to kMaxThreads threads and 48 KB of shared memory
// (the most without opting in); a larger system has a block of its own,
// so that its block barrier waits for no other system
__host__ __device__ inline int most_systems(int RP) {
  const int ts = RP / rows_per_thread(RP);
  if (ts > 32) return 1;
  int n = kMaxThreads / ts;
  while (n > 1 && gj_smem_bytes(RP, n) > 48 * 1024) n /= 2;
  return n;
}

// the barrier of one step for systems of TS threads: a warp's where each
// system lies within one warp (blocks are whole warps), else the
// block's, which holds one system
template <int TS>
__device__ __forceinline__ void step_barrier() {
  if (TS <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// 1 / the pivot d, clamped as fused_als.cu chol_solve_block clamps it
// (|d| <= kEps gives kEps, a NaN stays NaN); the reciprocal instruction
// and one multiply (within 2 ulp), so that no step branches to a
// division routine
__device__ __forceinline__ float pivot_recip(float d) {
  return __fdividef(1.0f, fabsf(d) > kEps ? d : (d != d ? d : kEps));
}

// One 16-byte chunk k of step p's update: a[h][4k..4k+3] -= c[h] * v at
// the entries right of p, for each group h of rows that may lie below
// the pivot (k and p are constants once the step loop is unrolled, so
// the tests are resolved at compile time; a row above the pivot has
// c = 0 and keeps its entries)
template <int H, int RP, int TS>
__device__ __forceinline__ void update_chunk(float (&a)[H][RP],
                                             const float (&c)[H], float4 v,
                                             int k, int p) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (p < (h + 1) * TS - 1) {
      if (4 * k + 0 > p) a[h][4 * k + 0] = fmaf(-c[h], v.x, a[h][4 * k + 0]);
      if (4 * k + 1 > p) a[h][4 * k + 1] = fmaf(-c[h], v.y, a[h][4 * k + 1]);
      if (4 * k + 2 > p) a[h][4 * k + 2] = fmaf(-c[h], v.z, a[h][4 * k + 2]);
      a[h][4 * k + 3] = fmaf(-c[h], v.w, a[h][4 * k + 3]);
    }
  }
}

template <int RP>
__global__ void __launch_bounds__(kMaxThreads)
    gj_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                    float* __restrict__ x, int B, int R, int vec16) {
  extern __shared__ __align__(16) float smem[];
  constexpr int H = rows_per_thread(RP);
  constexpr int TS = RP / H;  // threads a system
  constexpr int LD = RP + 1;
  constexpr int Q = RP / 4;  // 16-byte pieces of a padded row
  const int systems = blockDim.x / TS;
  const int t = threadIdx.x;
  const int s = t / TS;  // this thread's system in the block
  const int l = t % TS;  // its rows are l + h * TS, h < H
  const long sys0 = (long)blockIdx.x * systems;
  const long sys = sys0 + s;
  const bool live = sys < B;

  // stage the lower triangle of each system: row r of the block takes
  // its pieces from Q neighbouring threads, RP * H / 4 rows a thread
  // whatever the systems a block, in batches of 8 whose loads are all
  // issued before their first store (one wait on device memory a batch,
  // not a row)
  float* S = smem;
  constexpr int PASSES = RP * H / 4;
  constexpr int BATCH = PASSES < 8 ? PASSES : 8;
  const int stride = blockDim.x / Q, j = 4 * (t % Q);
#pragma unroll 1
  for (int k0 = 0; k0 < PASSES; k0 += BATCH) {
    float4 piece[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int r = t / Q + (k0 + k) * stride, rs = r / RP, ri = r % RP;
      const long rsys = sys0 + rs;
      piece[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (rsys < B && ri < R && j <= ri) {
        const float* src = A + (rsys * R + ri) * (long)R + j;
        if (vec16) {  // R % 4 == 0: the piece lies within the row
          piece[k] = __ldcs(reinterpret_cast<const float4*>(src));
        } else {
          piece[k].x = __ldcs(src);
          if (j + 1 <= ri) piece[k].y = __ldcs(src + 1);
          if (j + 2 <= ri) piece[k].z = __ldcs(src + 2);
          if (j + 3 <= ri) piece[k].w = __ldcs(src + 3);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int r = t / Q + (k0 + k) * stride, rs = r / RP, ri = r % RP;
      if (j <= ri) {  // entries right of the diagonal are never read
        float* dst = S + (rs * RP + ri) * LD + j;
        dst[0] = piece[k].x;
        dst[1] = piece[k].y;
        dst[2] = piece[k].z;
        dst[3] = piece[k].w;
      }
    }
  }
  float bi[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int i = l + h * TS;
    bi[h] = live && i < R ? __ldcs(b + sys * R + i) : 0.0f;
  }
  __syncthreads();

  // this thread's symmetric rows; the identity outside R (and for a
  // system past the batch)
  float a[H][RP];
  const float* Ss = S + s * RP * LD;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int i = l + h * TS;
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      float v = i == j ? 1.0f : 0.0f;
      if (live && i < R && j < R)
        v = j <= i ? Ss[i * LD + j] : Ss[j * LD + i];
      a[h][j] = v;
    }
  }

  float* vec0 = smem + systems * RP * LD + s * vec_floats(RP);
  float* vec1 = vec0 + systems * vec_floats(RP);
  // step 0's vector: column 0, the pivot row's b and 1 / its pivot
  float rdi[H];  // 1 / each row's pivot
#pragma unroll
  for (int h = 0; h < H; ++h) {
    vec0[l + h * TS] = a[h][0];
    rdi[h] = 0.0f;
  }
  if (l == 0) {
    rdi[0] = pivot_recip(a[0][0]);
    vec0[RP] = bi[0];
    vec0[RP + 2] = rdi[0];
  }
  // factorisation and forward substitution.  Each row below the pivot
  // then writes its a[p + 1] into the next step's vector, and the next
  // pivot row its b and reciprocal, so no thread divides after a
  // barrier.
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    if (p < R) {
      const float* col = (p & 1) ? vec1 : vec0;
      float* next = (p & 1) ? vec0 : vec1;
      step_barrier<TS>();
      const float rd = col[RP + 2], bp = col[RP];
      float c[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        // row l + h * TS lies below the pivot for every l where
        // p < h * TS, for none where p >= (h + 1) * TS - 1
        const bool below =
            p < h * TS || (p < (h + 1) * TS - 1 && l + h * TS > p);
        c[h] = below ? a[h][p] * rd : 0.0f;
        bi[h] = fmaf(-c[h], bp, bi[h]);
      }
      const float4* col4 = reinterpret_cast<const float4*>(col);
#pragma unroll
      for (int k = (p + 1) / 4; k < RP / 4; ++k)
        update_chunk<H, RP, TS>(a, c, col4[k], k, p);
      if (p + 1 < R) {  // then p + 1 < RP: q is p + 1
        const int q = p + 1 < RP ? p + 1 : p;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if (l + h * TS > p) next[l + h * TS] = a[h][q];
        }
        // the next pivot row: row l + hq * TS with l == q % TS
        const int hq = q / TS;
        const float rq = pivot_recip(a[hq][q]);
        if (l == q % TS) {
          rdi[hq] = rq;
          next[RP] = bi[hq];
          next[RP + 2] = rq;
        }
      }
    }
  }
  // back substitution: x_p = (b_p - sum_{j > p} U[p][j] x_j) / d_p,
  // x_p computed by row p's thread and broadcast by a shuffle where a
  // system lies within a warp, else through the vector (the buffer of
  // step p alternates with the forward steps' last one: forward step p
  // used (p & 1), back step p uses ((p + 1) & 1)).
  float acc[H], xi[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = xi[h] = 0.0f;
  const int group = (t & 31) & ~(TS - 1);  // the system's first lane
#pragma unroll
  for (int p = RP - 1; p >= 0; --p) {
    if (p < R) {
      const int hp = p / TS;
      const float xv = (bi[hp] - acc[hp]) * rdi[hp];  // row p's thread's
      float xp;
      if (TS <= 32) {
        xp = __shfl_sync(0xffffffffu, xv, group | (p % TS));
      } else {
        float* col = ((p + 1) & 1) ? vec1 : vec0;
        if (l == p % TS) col[RP + 1] = xv;
        step_barrier<TS>();
        xp = col[RP + 1];
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int i = l + h * TS;
        if (i < p) acc[h] = fmaf(a[h][p], xp, acc[h]);
        if (i == p) xi[h] = xp;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int i = l + h * TS;
    if (live && i < R) __stcs(x + sys * R + i, xi[h]);
  }
}

template <int RP>
cudaError_t launch_rank(const GjArgs& a, cudaStream_t stream) {
  const size_t smem = gj_smem_bytes(RP, a.systems);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gj_solve_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int vec16 = a.R % 4 == 0 && reinterpret_cast<uintptr_t>(a.A) % 16 == 0;
  gj_solve_kernel<RP><<<a.blocks, a.threads, smem, stream>>>(
      static_cast<const float*>(a.A), static_cast<const float*>(a.b),
      static_cast<float*>(a.x), a.B, a.R, vec16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// GjArgs: A [B, R, R], b [B, R], x [B, R]: float32, contiguous, on the
// device of `stream`; the plan of ops/solve.py gj_plan (padded rank,
// threads, systems a block, blocks, shared bytes).  The systems a block
// are the host's choice; this entry point recomputes everything else from
// them and refuses a plan that differs.  Returns the CUDA error code of
// the launch (0 on success).
int pio_gj_solve(const void* block) {
  const GjArgs a = pio::load_args<GjArgs>(block);
  const int B = a.B, R = a.R, RP = pad_rank(a.R);
  if (B < 0 || R < 1 || R > kMaxRank || a.rank_pad != RP)
    return cudaErrorInvalidValue;
  const int ts = RP / rows_per_thread(RP);
  const int least = ts < 32 ? 32 / ts : 1;
  if (a.systems < least || a.systems > most_systems(RP) ||
      (a.systems & (a.systems - 1)) != 0 || a.threads != a.systems * ts ||
      (long)a.blocks != ((long)B + a.systems - 1) / a.systems ||
      static_cast<size_t>(a.smem_bytes) != gj_smem_bytes(RP, a.systems))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  switch (RP) {
    case 16:
      return static_cast<int>(launch_rank<16>(a, s));
    case 32:
      return static_cast<int>(launch_rank<32>(a, s));
    case 64:
      return static_cast<int>(launch_rank<64>(a, s));
    default:
      return static_cast<int>(launch_rank<128>(a, s));
  }
}

}  // extern "C"
