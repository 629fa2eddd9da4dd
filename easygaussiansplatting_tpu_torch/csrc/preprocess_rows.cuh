// What K1 (preprocess.cu) and K2 (preprocess_bwd.cu) share: the kernel
// parameters, the table's width, the 128-gaussian block, the padded SH rows
// in shared memory, and the staging of a block's contiguous slices by
// 16-byte cp.async and its 16-byte stores back.
//
// Every slice a block stages starts at a multiple of B gaussians, so a
// 16-byte aligned array gives 16-byte aligned slices (the wrappers require
// it of every array staged or unstaged).

#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "memory_order.cuh"

namespace {

constexpr int TABLE_COLS = 12;
constexpr float MIN_DEPTH = 0.2f;
constexpr int B = 128;  // gaussians (threads) a block

struct PreParams {
  float cam[21];  // Rcw (9, row-major) tcw (3) twc (3) fx fy cx cy limx limy
  float shc[36];  // SH constants in basis order (utils/sh.py SH_CONSTS)
};

// SH floats a gaussian and their row stride in shared memory: an odd number
// of float4s where the width is a multiple of 4 (read as float4s), the odd
// width itself otherwise (read as floats); either way a warp's reads of its
// rows are free of bank conflicts.
template <int DEG>
struct ShRow {
  static constexpr int NB = (DEG + 1) * (DEG + 1);
  static constexpr int W = 3 * NB;
  static constexpr int SW = (W % 4 == 0 && (W / 4) % 2 == 0) ? W + 4 : W;
};

// count floats of a block's contiguous, 16-byte aligned slice src -> dst,
// flat element q to dst[(q / W) * SW + q % W], by 16-byte cp.async (W % 4
// == 0 or SW == W, so no 16-byte chunk straddles two rows); the last block's
// ragged tail by floats.
template <int W, int SW>
__device__ __forceinline__ void stage(float* dst, const float* src, int count) {
  static_assert(SW == W || W % 4 == 0, "padded rows must hold whole float4s");
  for (int q4 = threadIdx.x; q4 < count / 4; q4 += B) {
    const int e = 4 * q4;
    cp_async16(dst + (e / W) * SW + e % W, src + e);
  }
  for (int q = (count & ~3) + threadIdx.x; q < count; q += B)
    dst[(q / W) * SW + q % W] = src[q];
}

// count floats from shared memory to a block's contiguous, 16-byte aligned
// slice of dst, by 16-byte stores.
__device__ __forceinline__ void unstage(float* dst, const float* src, int count) {
  for (int q4 = threadIdx.x; q4 < count / 4; q4 += B)
    reinterpret_cast<float4*>(dst)[q4] = reinterpret_cast<const float4*>(src)[q4];
  for (int q = (count & ~3) + threadIdx.x; q < count; q += B) dst[q] = src[q];
}

}  // namespace
