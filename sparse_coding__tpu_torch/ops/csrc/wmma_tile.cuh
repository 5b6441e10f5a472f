// Tile geometry and helpers of the WMMA GEMMs of tied_sae_fwd.cu (K1 and K1n
// at D 768 and 1024): 64 x 128 output tiles of 8 warps (2 rows x 4
// columns of 32 x 32), fed depth-64 slices through two shared-memory stages
// by cp.async (the next slice loads while this one computes), with a
// deterministic block sum for the per-block loss partials. Included by one
// source of each library; everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps laid out 2 (rows) x 4 (cols)
constexpr int kBM = 64;        // rows of the output tile (batch)
constexpr int kBN = 128;       // cols of the output tile (dict or width)
constexpr int kBK = 64;        // depth of one shared-memory stage
// shared-memory row strides, padded 16 bytes past a multiple of 128 so the
// 16 rows of a WMMA fragment do not fall on the same banks
constexpr int kLdK = kBK + 8;   // bf16 tiles with kBK columns
constexpr int kLdN = kBN + 8;   // bf16 tiles with kBN columns
constexpr int kLdC = kBN + 4;   // the f32 output staging tile

// Two stages of operand tiles; the f32 output staging tile reuses them after
// the loop. A stage holds the [kBM][kLdK] A tile and a B tile of at most
// kBN * kLdK elements ([kBN][kLdK] for x . D^T; [kBK][kLdN] for c . D).
constexpr size_t kStageBytes = (size_t)(kBM * kLdK + kBN * kLdK) * sizeof(bf16);
constexpr size_t kCsBytes = (size_t)kBM * kLdC * sizeof(float);
constexpr size_t kSmemBytes = 2 * kStageBytes > kCsBytes ? 2 * kStageBytes : kCsBytes;

// Deterministic block sum: fixed shuffle tree inside each warp, then thread 0
// adds the warp partials in warp order. Valid in thread 0 only.
__device__ float block_sum(float v) {
  __shared__ float red[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

// Start copying a [rows, 64] bf16 tile (row stride `ld` elements) into
// shared memory as [rows][kLdK], 16 bytes per cp.async.
__device__ __forceinline__ void load_tile_k64(bf16* dst, const bf16* src, int rows, size_t ld) {
  for (int idx = threadIdx.x; idx < rows * (kBK / 8); idx += kThreads) {
    const int r = idx / (kBK / 8), c8 = (idx % (kBK / 8)) * 8;
    __pipeline_memcpy_async(dst + r * kLdK + c8, src + (size_t)r * ld + c8, 16);
  }
}

__device__ __forceinline__ bf16* stage_a(unsigned char* smem, int st) {
  return reinterpret_cast<bf16*>(smem + st * kStageBytes);
}

}  // namespace
