// Payload columns for the sorts (K7 csrc/sort.cu, K8 csrc/radix.cu): the
// sorting passes move only the keys and a 32-bit source index; one gather at
// the end moves every payload column by that index. The column pointers ride
// by value in the kernel's parameters (no device-side pointer array).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_COLUMNS = 16;
constexpr int GATHER_THREADS = 256;

struct Columns {
  const int* in[MAX_COLUMNS];
  int* out[MAX_COLUMNS];
};

// Columns from two host arrays of n pointers (n <= MAX_COLUMNS).
inline Columns make_columns(const void* const* in, void* const* out, int n) {
  Columns c{};
  for (int i = 0; i < n; ++i) {
    c.in[i] = static_cast<const int*>(in[i]);
    c.out[i] = static_cast<int*>(out[i]);
  }
  return c;
}

// out[c][t] = in[c][src[t]] for t < m: 32-bit words, so int32 and float32
// columns move as bits. src is a permutation of [0, m): a sort's final
// source indices.
__global__ void __launch_bounds__(GATHER_THREADS)
gather_columns(const int* __restrict__ src, Columns cols, int n_cols, long long m) {
  const long long t = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (t >= m) return;
  const long long s = src[t];
  for (int c = 0; c < n_cols; ++c) cols.out[c][t] = cols.in[c][s];
}

inline unsigned gather_blocks(long long m) {
  return (unsigned)((m + GATHER_THREADS - 1) / GATHER_THREADS);
}

}  // namespace
