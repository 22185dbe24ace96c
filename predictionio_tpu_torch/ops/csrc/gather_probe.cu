// The three gather probes behind ALSConfig(fused_gather="auto"), for
// sm_90a.
//
// Replaces: predictionio_tpu/ops/gather_probe.py
//   _taa0_kernel (taa0_gather, pallas_call at :98): out[i,j] = table[idx[i,j], j]
//   _taa1_kernel (taa1_gather, pallas_call at :144): out[i,j] = table[i, idx[i,j]]
//   _dma_kernel (dma_row_gather, pallas_call at :224): out[k] = table[idx[k]],
//     one asynchronous row copy per output row, _DMA_WINDOW = 16 in flight.
//
// On the TPU these kernels existed to find out which gather forms Mosaic
// lowers and how fast each runs, so that the fused ALS kernel could pick
// its in-kernel gather.  On Hopper the same question is which way table
// rows reach the fused kernel: plain loads through L2 (the "taa" form) or
// cp.async copies into shared memory (the "dma" form).  The probes time
// those two access patterns in isolation; ops/gather_probe.py
// preferred_order ranks them.
//
// Bound on an H100 (3.35 TB/s): a gather does no arithmetic, so each is
// bound by bytes: the indices read once, the rows they name read once and
// the output written once.  For the bytes-dominated shape of chip_smoke.py
// (2^20 rows of 64 f32, 256 MB out) that is about 0.13-0.21 ms; at the
// probe shape preferred_order uses (2,048 rows, 512 KB out) the bound is
// well under a microsecond and every form is held by latency: its launch,
// the index load and the row load behind it.
//
// Every element is copied as raw bits (4 bytes for f32, 2 for bf16), so
// the result is the table's value exactly.  Design:
// * taa0: one thread per output element in a grid-stride loop.
// * taa1 (redesigned): its first design, taa0's loop, took 0.80
//   ms at [64, 2^20] f32 against torch.gather's 0.64 and a 0.21 ms bytes
//   bound.  Each element cost a 64-bit e / M, and a thread had one random
//   table load in flight at a time, behind its own id load, while the ids
//   and the output (256 MB each) streamed through the L2 that should hold
//   table row i (4 MB).  Now the row comes from blockIdx.y and the columns
//   from blockIdx.x (no division).  A row of more than 1,024 columns
//   that is whole 16-byte vectors of ids and of output (M a multiple of
//   4 f32 or 8 bf16 columns, ids and output 16-byte aligned) takes 16
//   columns a thread as 16-byte vectors and issues all its table loads
//   before its first store; ids are loaded and the output stored with
//   streaming hints (evict first) and the table read through the
//   read-only path, so row i stays in L2 while its blocks run.  Every
//   other row takes one column a thread (taa1_col_kernel): a short row
//   (the probe's [64, 256]) is held by the latency of the id load and the
//   table load behind it, and the thread issues its id load before any
//   other work; a long row that is not whole aligned vectors (a tail, a
//   sliced tensor) loses 2-4% to the vector path there.  Below the bytes
//   bound, the practical floor at [64, 2^20] is the L2: each random
//   4-byte table read moves a 32-byte sector, 2^26 x 32 B = 2.1 GB,
//   beside 0.5 GB of streamed ids and output.  Measured (chip_smoke.py
//   and kernel_variants.py taa1, NVIDIA H100 80GB HBM3, 700 W): 0.602-0.610
//   ms at [64, 2^20] f32 against torch.gather's 0.638-0.645 in the same
//   turns (the first design 0.796-0.797); one column a thread on every
//   row 0.619 ms aligned and 0.626-0.629 unaligned, against the vector
//   path's 0.605 in the same turns; 1.33-1.36 us of device time a call at
//   [64, 256] (the first design 1.38-1.40).
// * dma_row_gather: a block of 128 threads is split into groups, each
//   group as wide as one row's 16-byte (or 4-byte) pieces; a group walks a
//   run of rows_per_group output rows with a ring of row slots in shared
//   memory.  Each thread issues cp.async for its own pieces of row s into
//   slot s % slots, commits one group per row, and once kWindow - 1
//   younger rows are in flight waits (cp.async.wait_group) and writes its
//   pieces of the oldest row back out: at most kWindow rows in flight per
//   group.  A thread only ever reads back what it copied itself, so the
//   ring needs no block barrier.
//   The run length comes from the host (ops/gather_probe.py dma_row_plan)
//   so that the grid covers the card: at 2,048 rows of 64 f32 a group
//   takes one row and the launch is 256 blocks on 132 SMs; at 2^20 rows a
//   group walks 32 and the ring keeps 16 in flight.  A group's ring holds
//   min(rows_per_group, kWindow) slots; a run shorter than kWindow is
//   copied whole and waited for once.  The block first stages its ids in
//   shared memory (one coalesced load, one barrier), so no step of a
//   group's walk waits on a load from device memory before its copy.
//   The copy stays a per-thread cp.async of 16-byte (or 4-byte) pieces,
//   the copy the fused kernel's "dma" form makes (fused_als.cu): this
//   probe stands for that form in preferred_order, so a TMA bulk copy
//   here would time a copy the fused kernel does not make.
// * An id outside the table writes NaN instead of reading out of bounds.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_args.cuh"

namespace {

constexpr int kThreads = 256;       // taa0 / taa1
constexpr int kRowThreads = 128;    // dma_row_gather
constexpr int kWindow = 16;         // the reference's _DMA_WINDOW
constexpr int kMaxRowsPerGroup = 2 * kWindow;
constexpr int kMaxBlocks = 132 * 16;

template <typename E>
__device__ __forceinline__ E nan_bits();

template <>
__device__ __forceinline__ uint32_t nan_bits<uint32_t>() {
  return 0x7fc00000u;  // f32 quiet NaN
}

template <>
__device__ __forceinline__ uint16_t nan_bits<uint16_t>() {
  return 0x7fc0u;  // bf16 quiet NaN
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    taa0_kernel(const E* __restrict__ table, const int* __restrict__ idx,
                E* __restrict__ out, int N, int R) {
  const size_t total = (size_t)N * R;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(e % R);
    const int id = idx[e];
    out[e] = (id >= 0 && id < N) ? table[(size_t)id * R + j] : nan_bits<E>();
  }
}

// taa1_gather's vector: 16 bytes of output, 4 f32 or 8 bf16 columns
template <typename E>
constexpr int kTaa1Vec = 16 / sizeof(E);
// columns a thread of taa1_kernel takes: 16, as 4 f32 or 2 bf16 vectors
constexpr int kTaa1Cols = 16;
// the longest row taa1_col_kernel takes where taa1_kernel could:
// 4 blocks of kThreads
constexpr int kTaa1Short = 4 * kThreads;

template <typename E>
__device__ __forceinline__ uint4 pack16(const E (&v)[16 / sizeof(E)]);

template <>
__device__ __forceinline__ uint4 pack16<uint32_t>(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ uint4 pack16<uint16_t>(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | (uint32_t)v[1] << 16, v[2] | (uint32_t)v[3] << 16,
                    v[4] | (uint32_t)v[5] << 16, v[6] | (uint32_t)v[7] << 16);
}

template <typename E>
__device__ __forceinline__ E taa1_pick(const E* __restrict__ row, int id,
                                       int M) {
  return (unsigned)id < (unsigned)M ? __ldg(row + id) : nan_bits<E>();
}

// out[i, j] = table[i, idx[i, j]] on rows of more than kTaa1Short columns
// that are whole 16-byte vectors of ids and of output (M a multiple of
// kTaa1Vec, idx and out 16-byte aligned: launch_taa1 checks): row i from
// blockIdx.y (looping where R exceeds the grid's 65,535), kTaa1Cols
// columns a thread from blockIdx.x.  The thread loads its ids as 16-byte
// vectors and stores 16-byte vectors, both streaming (evict first),
// issuing every table load of its columns before its first store; table
// rows go through the read-only path and stay in L2.
template <typename E>
__global__ void __launch_bounds__(kThreads)
    taa1_kernel(const E* __restrict__ table, const int* __restrict__ idx,
                E* __restrict__ out, int R, int M) {
  constexpr int V = kTaa1Vec<E>, U = kTaa1Cols / V;
  const int T = blockDim.x, nvec = M / V;
  const int v0 = blockIdx.x * T * U + threadIdx.x;
  for (int i = blockIdx.y; i < R; i += gridDim.y) {
    const size_t base = (size_t)i * M;
    const E* trow = table + base;
    const int4* irow = reinterpret_cast<const int4*>(idx + base);
    uint4* orow = reinterpret_cast<uint4*>(out + base);
    int ids[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * T;
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const int4 w = v < nvec ? __ldcs(irow + (size_t)v * (V / 4) + q)
                                : make_int4(0, 0, 0, 0);
        ids[u][4 * q + 0] = w.x;
        ids[u][4 * q + 1] = w.y;
        ids[u][4 * q + 2] = w.z;
        ids[u][4 * q + 3] = w.w;
      }
    }
    E vals[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[u][e] = taa1_pick(trow, ids[u][e], M);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * T;
      if (v < nvec) __stcs(orow + v, pack16<E>(vals[u]));
    }
  }
}

// The same one column a thread, the row from blockIdx.y: on a row of at
// most kTaa1Short columns (the probe's [64, 256]) the latency of the id
// load and the table load behind it is the whole cost, and the thread
// issues its id load first, with no other work before it; it also takes
// every row that is not whole aligned vectors, at any length.
template <typename E>
__global__ void __launch_bounds__(kThreads)
    taa1_col_kernel(const E* __restrict__ table, const int* __restrict__ idx,
                    E* __restrict__ out, int R, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  for (int i = blockIdx.y; i < R; i += gridDim.y) {
    const size_t e = (size_t)i * M + j;
    out[e] = taa1_pick(table + (size_t)i * M, __ldcs(idx + e), M);
  }
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int vec) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_window() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kWindow - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pieces of one row and the thread groups that copy them, for a row of
// row_bytes copied in vec-byte pieces by blocks of kRowThreads threads.
struct RowPlan {
  int pieces;   // pieces per row
  int lanes;    // threads per group
  int groups;   // groups per block
};

__host__ __device__ inline RowPlan row_plan(int row_bytes, int vec) {
  RowPlan p;
  p.pieces = row_bytes / vec;
  p.lanes = p.pieces < kRowThreads ? p.pieces : kRowThreads;
  p.groups = kRowThreads / p.lanes;
  return p;
}

__host__ __device__ inline int ring_slots(int rows_per_group) {
  return rows_per_group < kWindow ? rows_per_group : kWindow;
}

// One block's shared memory: each group's ring, then the block's ids.
inline size_t row_smem_bytes(int row_bytes, int vec, int rows_per_group) {
  return (size_t)row_plan(row_bytes, vec).groups *
         ((size_t)ring_slots(rows_per_group) * row_bytes +
          (size_t)rows_per_group * sizeof(int));
}

__global__ void __launch_bounds__(kRowThreads)
    dma_row_kernel(const unsigned char* __restrict__ table,
                   const int* __restrict__ idx, unsigned char* __restrict__ out,
                   int M, int nout, int row_bytes, int vec, int rows_per_group,
                   uint32_t nan4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RowPlan p = row_plan(row_bytes, vec);
  const int slots = ring_slots(rows_per_group);
  // the block's ids behind the rings (row_bytes is a multiple of 4)
  int* ids =
      reinterpret_cast<int*>(smem + (size_t)p.groups * slots * row_bytes);
  const int block_rows = p.groups * rows_per_group;
  const long base = (long)blockIdx.x * block_rows;
  for (int t = threadIdx.x; t < block_rows; t += kRowThreads)
    ids[t] = base + t < nout ? idx[base + t] : 0;
  __syncthreads();  // the only barrier: leaving after it is safe

  const int g = threadIdx.x / p.lanes;
  const int lane = threadIdx.x % p.lanes;
  if (g >= p.groups) return;
  const long first = base + (long)g * rows_per_group;
  if (first >= nout) return;
  const long left = (long)nout - first;
  const int n = left < rows_per_group ? (int)left : rows_per_group;
  const int* gid = ids + g * rows_per_group;
  unsigned char* ring = smem + (size_t)g * slots * row_bytes;

  auto issue = [&](int s) {  // this thread's pieces of row s into its slot
    const int id = gid[s];
    if (id >= 0 && id < M) {
      unsigned char* dst = ring + (size_t)(s % slots) * row_bytes;
      const unsigned char* src = table + (size_t)id * row_bytes;
      for (int q = lane; q < p.pieces; q += p.lanes)
        cp_async(dst + q * vec, src + q * vec, vec);
    }
  };
  auto write_back = [&](int k) {  // this thread's pieces of row k out
    const int id = gid[k];
    const bool ok = id >= 0 && id < M;
    const unsigned char* src = ring + (size_t)(k % slots) * row_bytes;
    unsigned char* dst = out + (size_t)(first + k) * row_bytes;
    for (int q = lane; q < p.pieces; q += p.lanes) {
      if (vec == 16) {
        const uint4 v = ok ? *reinterpret_cast<const uint4*>(src + q * 16)
                           : make_uint4(nan4, nan4, nan4, nan4);
        *reinterpret_cast<uint4*>(dst + q * 16) = v;
      } else {
        *reinterpret_cast<uint32_t*>(dst + q * 4) =
            ok ? *reinterpret_cast<const uint32_t*>(src + q * 4) : nan4;
      }
    }
  };

  if (rows_per_group < kWindow) {
    // a run shorter than the window: every row in flight at once, one
    // slot each, one wait
    for (int s = 0; s < n; ++s) issue(s);
    cp_async_commit();
    cp_async_wait_all();
    for (int k = 0; k < n; ++k) write_back(k);
    return;
  }
  // slots == kWindow: s % slots never reuses a slot whose row is still
  // in flight or not yet written out
  for (int s = 0; s < n + kWindow - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();  // one group per step, empty ones included
    const int k = s - (kWindow - 1);
    if (k >= 0) {
      cp_async_wait_window();  // the group of row k has landed
      write_back(k);
    }
  }
}

int grid_for(size_t total, int threads) {
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > (size_t)kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename E>
void launch_taa1(const TaaArgs& a, cudaStream_t s) {
  const int R = a.rows, M = a.cols;
  const E* table = static_cast<const E*>(a.table);
  const int* idx = static_cast<const int*>(a.idx);
  E* out = static_cast<E*>(a.out);
  const unsigned rows = R < 65535 ? R : 65535;
  const bool vectors =
      M > kTaa1Short && M % kTaa1Vec<E> == 0 &&
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (vectors) {
    const int per_block = kThreads * kTaa1Cols;
    taa1_kernel<E><<<dim3((M + per_block - 1) / per_block, rows), kThreads,
                     0, s>>>(table, idx, out, R, M);
    return;
  }
  int threads = 32;
  while (threads < M && threads < kThreads) threads *= 2;
  taa1_col_kernel<E><<<dim3((M + threads - 1) / threads, rows), threads, 0,
                       s>>>(table, idx, out, R, M);
}

}  // namespace

extern "C" {

// TaaArgs: table [N, R], idx [N, R] int32 -> out [N, R] (rows = N,
// cols = R); elem_bytes 4 (f32) or 2 (bf16).  Returns the CUDA error code
// of the launch.
int pio_taa0_gather(const void* block) {
  const TaaArgs a = pio::load_args<TaaArgs>(block);
  const int N = a.rows, R = a.cols;
  if (N < 0 || R < 0) return cudaErrorInvalidValue;
  const size_t total = (size_t)N * R;
  if (total == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  const int blocks = grid_for(total, kThreads);
  if (a.elem_bytes == 4) {
    taa0_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(a.table), static_cast<const int*>(a.idx),
        static_cast<uint32_t*>(a.out), N, R);
  } else if (a.elem_bytes == 2) {
    taa0_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(a.table), static_cast<const int*>(a.idx),
        static_cast<uint16_t*>(a.out), N, R);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// TaaArgs: table [R, M], idx [R, M] int32 -> out [R, M] (rows = R,
// cols = M); a row's columns over grid.x, the rows over grid.y.
int pio_taa1_gather(const void* block) {
  const TaaArgs a = pio::load_args<TaaArgs>(block);
  if (a.rows < 0 || a.cols < 0) return cudaErrorInvalidValue;
  if ((size_t)a.rows * a.cols == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  if (a.elem_bytes == 4) {
    launch_taa1<uint32_t>(a, s);
  } else if (a.elem_bytes == 2) {
    launch_taa1<uint16_t>(a, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// RowCopyArgs: table [M, R], idx [nout] int32 -> out [nout, R].  Rows
// are copied in vec-byte pieces (16, or 4 where a row or the table start
// is not 16-byte aligned), rows_per_group rows a copying group, over
// blocks blocks of smem_bytes each.  The plan comes from
// ops/gather_probe.py dma_row_plan; this file recomputes the grid and the
// shared memory from it and refuses a plan whose numbers differ.
int pio_dma_row_gather(const void* block) {
  const RowCopyArgs a = pio::load_args<RowCopyArgs>(block);
  const int M = a.M, nout = a.nout, R = a.R, elem_bytes = a.elem_bytes;
  const int vec = a.vec, rows_per_group = a.rows_per_group;
  if (M < 1 || nout < 0 || R < 1 || (elem_bytes != 4 && elem_bytes != 2))
    return cudaErrorInvalidValue;
  const int row_bytes = R * elem_bytes;
  if ((vec != 16 && vec != 4) || row_bytes % vec != 0)
    return cudaErrorInvalidValue;
  if (rows_per_group < 1 || rows_per_group > kMaxRowsPerGroup)
    return cudaErrorInvalidValue;
  const size_t smem = row_smem_bytes(row_bytes, vec, rows_per_group);
  if (static_cast<size_t>(a.smem_bytes) != smem) return cudaErrorInvalidValue;
  const long per_block = (long)row_plan(row_bytes, vec).groups * rows_per_group;
  if ((long)a.blocks != (nout + per_block - 1) / per_block)
    return cudaErrorInvalidValue;
  if (nout == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dma_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const uint32_t nan4 = elem_bytes == 4 ? 0x7fc00000u : 0x7fc07fc0u;
  dma_row_kernel<<<a.blocks, kRowThreads, smem,
                   static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const unsigned char*>(a.table),
      static_cast<const int*>(a.idx), static_cast<unsigned char*>(a.out), M,
      nout, row_bytes, vec, rows_per_group, nan4);
  return static_cast<int>(cudaGetLastError());
}

// Do nothing with their arguments: chip_smoke.py times the bare ctypes
// call into them beside the launch path's other steps, with taa0's fields
// as one block and, for comparison, as a list of arguments.
int pio_noop(const void*) { return 0; }

int pio_noop_list(const void*, const void*, void*, int, int, int, void*) {
  return 0;
}

}  // extern "C"
