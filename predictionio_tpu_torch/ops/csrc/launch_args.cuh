// The argument blocks of the library's C entry points.
//
// Every entry point takes one pointer to a block of its arguments, which
// ops/_build.py packs with Python's struct module in the same native
// layout (ops/_build.py ARG_STRUCTS mirrors each struct below, field for
// field; tests/test_torch_build.py holds the two together).  One packed
// block crosses ctypes at the cost of one argument, where a list of
// arguments costs a conversion each: the launch path stays within the
// host time of one PyTorch call.  An entry point copies its block into a
// local struct first (load_args), so the block's alignment does not
// matter.
//
// Field types are limited to what the struct module packs the same way
// as the compiler lays out: pointers ("P"), int ("i") and long long
// ("q"), in the native order, size and alignment ("@").

#pragma once

#include <cstring>

namespace pio {

template <typename T>
inline T load_args(const void* block) {
  T a;
  std::memcpy(&a, block, sizeof(T));
  return a;
}

}  // namespace pio

extern "C" {

// gj_solve.cu pio_gj_solve; rank_pad, threads, systems (a block),
// blocks and smem_bytes are the plan of ops/solve.py gj_plan
struct GjArgs {
  const void* A;
  const void* b;
  void* x;
  int B;
  int R;
  int rank_pad;
  int threads;
  int systems;
  int blocks;
  int smem_bytes;
  void* stream;
};

// fused_als.cu pio_fused_als_{f32,bf16} and pio_fused_als_dma_{f32,bf16};
// vec is the "dma" form's cp.async piece size, and the "taa" entry points
// ignore it
struct FusedArgs {
  const void* table;
  const void* idx;
  const void* cw;
  const void* bw;
  const void* reg;
  const void* gram0;
  void* x;
  void* ws;
  int B;
  int K;
  int M;
  int R;
  int kc;
  int tile;
  int smem_bytes;
  int segments;
  int seg_len;
  long long ws_bytes;
  int vec;
  void* stream;
};

// fused_als.cu pio_fused_als_reduce; seg_per_group and scratch_bytes
// are the plan of ops/fused_als.py reduce_plan (gram0 and scratch may be
// NULL)
struct ReduceArgs {
  const void* ws;
  const void* reg;
  const void* gram0;
  void* x;
  void* scratch;
  int B;
  int R;
  int segments;
  int seg_per_group;
  long long ws_bytes;
  long long scratch_bytes;
  void* stream;
};

// gather_probe.cu pio_taa0_gather (rows = N, cols = R), pio_taa1_gather
// (rows = R, cols = M) and pio_noop
struct TaaArgs {
  const void* table;
  const void* idx;
  void* out;
  int rows;
  int cols;
  int elem_bytes;
  void* stream;
};

// gather_probe.cu pio_dma_row_gather
struct RowCopyArgs {
  const void* table;
  const void* idx;
  void* out;
  int M;
  int nout;
  int R;
  int elem_bytes;
  int vec;
  int rows_per_group;
  int blocks;
  int smem_bytes;
  void* stream;
};

}  // extern "C"
