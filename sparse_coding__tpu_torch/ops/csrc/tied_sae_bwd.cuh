// K2 `tied_sae_bwd_adam` and K3 `tied_sae_bwd_grads`: the stacked tied-SAE
// backward pass for Hopper (sm_90a), with or without the encoder's Adam update.
// The dense kernel template, its launcher, the epilogue it shares with the
// sparse route, and K2's C entry; tied_sae_bwd.cu (K3, and K2 on the stored
// code), tied_sae_bwd_rc.cu (K2 rebuilding the code) and
// tied_sae_bwd_sparse.cu (K2 and K3 touching only the code's non-zeros, the
// TopK path's route) instantiate it, one library each, so their builds run
// in parallel.
//
// Replaces the Pallas TPU kernels in sparse_coding__tpu/ops/tied_sae_kernel.py:
//   K2 <- `_bwd_adam_kernel` + `_adam_epilogue` (and its batch-tiled variant
//         `_bwd_adam_accum_kernel`: every block here already loops over the
//         whole batch, so one kernel covers both TPU dispatches), with the
//         code rebuild `_code_tile(recompute=True)`;
//   K3 <- `_bwd_kernel`.
// Also the backward of the TopK step (ops/topk_kernel.py), called with l1 = 0
// as the Pallas `topk_grads_stacked` / `topk_adam_step_stacked` call these.
// A block owns (member m, a tile of dictionary rows) and walks the whole
// batch in stages of 32 rows:
//   [kRecompute] c = bf16(relu(x . Dj^T + b))    K1's encode, rebuilt on chip
//   dc     = [c > 0] * (dxh . Dj^T + l1/B)       f32; mask on the bf16 c
//   g_bias += sum_b dc                           f32, before rounding
//   g_dhat += c^T . dxh + bf16(dc)^T . x         f32 accumulators in registers
// then applies the row-normalisation VJP g = (g_dhat - Dj <g_dhat, Dj>) / |d|
// and either writes g (K3) or runs the Adam epilogue in place on the raw
// encoder and its moments (K2; the caller's tensors are updated in place, as
// the TPU kernel aliases them).
//
// What bounds it on the card, at BASELINE config 2 (M 8, B 2048, N 4096,
// D 512): bytes. K2 must read x, dxh and the code and read and write d_raw
// and its moments, 0.1459 ms at 3.35 TB/s (bf16 mu, f32 nu); its products
// are 206 GFLOP as computed densely, 103 GFLOP counting only the code's
// non-zeros (~half of them), ~0.10 ms at 989 TFLOP/s. What bounds this
// design is the L2: every dictionary tile of a member streams the member's
// whole x and dxh (2 MB each) from L2 into shared memory, and the card moves
// them at ~4.6 TB/s into its SMs (scripts/dense_bwd_probe.py: the mainloop
// with no products runs at that rate).
//
// The wgmma mainloop (`wg_bwd_kernel`, D 128, 256 and 512). A block is two
// consumer warpgroups and a producer warpgroup, whose one issuing thread keeps
// a ring of 2..4 stages (x, dxh and the code tile, each in 64-column panels
// in TMA's 128-byte swizzle) filled by TMA against `mbarrier`s: no
// block-wide barrier in the batch loop. Per stage a consumer warpgroup runs
//   dc^T [64 x 32] = Dj . dxh^T          wgmma m64n32k16, both from shared memory
//   mask, l1/B, g_bias sums              in registers, on the swizzled code tile
//   g += c^T . dxh                       wgmma m64n256k16, both MN-major
//   g += bf16(dc^T) . x                  the same, dc^T as the register A operand
// (dc^T never reaches shared memory: its accumulator layout is the A
// fragment's, as FlashAttention-3 feeds P). How a block's tile is cut
// (`WgShape`):
//   - D <= 256: 128 rows, one warpgroup a 64-row half at every column;
//   - D 512, stored code: a cluster of two blocks shares 128 rows, block r
//     holding columns [256 r, 256 r + 256) of x, dxh, Dj and g, so each
//     block streams only its half of x and dxh; the two depth partials of dc
//     meet through distributed shared memory (st.async into the peer's
//     slot, counted on its mbarrier) and are added in rank order; after the
//     batch the blocks trade quarters of the gradient so that block r holds
//     rows [64 r, 64 r + 64) at every column for the epilogue;
//   - D 512, code rebuilt (the encode needs whole rows of x and Dj): 64
//     rows, one warpgroup a column half, dc's depth halves added through
//     shared memory.
// L2 reads a launch at config 2 on the stored code: ~1.3 GB (512 blocks,
// each its column halves of x and dxh, 1 MB each, and its pair's 128-row
// code tile, 0.5 MB), against ~2.2 GB for the WMMA mainloop's 64-row
// tiles. Rebuilding the code, the column split still reads ~2.1 GB (512
// blocks of 64 rows, each the member's whole x and dxh): the pair split
// cannot take the encode, which needs whole rows of x and Dj. Multicasting each
// x/dxh stage to a cluster of two 64-row blocks halves the L2 reads as well,
// but not the bytes each SM takes in, and it ran slower than each block
// loading its own (scripts/dense_bwd_probe.py): the design moves fewer bytes
// into the SMs instead.
// Registers: in the batch loop the producer gives its warpgroup's registers
// to the consumers (setmaxnreg 40 / 232); a consumer holds 128 accumulators
// of g, 16 of dc and 8 of its bf16 A fragments. All twelve warps then run
// the epilogue at 168 registers each. Shared memory: the bf16 dictionary
// tile (64 KB), the ring (4 stages of 40 KB at D 256, 3 in the pair split,
// 2 of 68 KB in the column split), which becomes the f32 gradient tile after
// the batch (130 KB), dc's partials (two 16 KB slots in the pair split,
// 16 KB in the column split), radial sums and barriers: 222-227 KB at D 256
// and 512. The epilogue (below) streams d_raw, mu and nu once, after the
// batch loop: a row's update needs its whole gradient (the radial sum, and
// an int8 moment's absmax); an int8 moment's codes are read a second time,
// once the absmax is known.
//
// D 768 and 1024 keep the WMMA mainloop (`bwd_kernel`): 16 warps, the
// [Nt, D] gradient in WMMA accumulator registers (2 row bands x kCols column
// blocks of 16 x 16 a warp: Nt 32), x, dxh and c through two cp.async
// stages, dc's depth split into kParts slices summed in a fixed order, and
// at D 768 x single-buffered (kSplitX).
//
// The code rebuild (kRecompute): c is not read from device memory; each
// [32, Nt] code tile is rebuilt from the x tile and the dictionary tile
// already in shared memory with K1's encode exactly — the same 16 x 16 x 16
// products (mma.sync m16n8k16, fed by ldmatrix from the swizzled tiles in
// the wgmma mainloop), one accumulator over the whole depth from k = 0, the
// bias added by __fadd_rn after the product, jnp.maximum's NaN-keeping relu,
// bf16 round to nearest — so it is bit-identical to K1's stored c (and the
// step to the stored-code step).
//
// Every sum runs in an order fixed by the shapes alone (no float atomics),
// so results are the same from run to run.
//
// Moment tiers (kMu, kNu: 0 f32, 1 bf16, 2 int8 with one f32 absmax scale
// per row), `_adam_epilogue`'s expressions: int8 dequantized (q * scale), the
// EMA in f32 (a bf16 mu's decay product in bf16), the update from the
// unrounded moments, then the stores: bf16 mu round to nearest, bf16 nu by a
// stochastic rounding, int8 by floor(v / scale + u). The random bits are the
// JAX package's interpret-mode counter hash (`_mix32` over each JAX
// dictionary tile of `seed_tile` rows), so the plain PyTorch version gives
// the same bits. An int8 store needs its row's absmax: a block owns whole
// rows, so the first pass of the epilogue stores everything else and takes
// each row's absmax (warp max, then a shared-memory atomicMax on the bits of
// |v|, which orders NaN above inf as jnp.max propagates it), and a second
// pass recomputes the same f32 moments (from the VJP's g, kept in the
// gradient tile by the first) and writes the codes; the new scales
// land after a barrier, once every read of the old ones is done.
//
// Rounding points follow the Pallas code: Dj = bf16(d_raw / |d|) (K2) or the
// caller's bf16 rows (K3); the epilogue uses __f*_rn intrinsics so no
// multiply-add is contracted, matching the plain PyTorch version bit for bit
// given the same g. bf16 mu: b1 is rounded to bf16 and b1 * mu is rounded to
// bf16 before the f32 add (optax's weak-typed update_moment).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kElemsPerCol = kWarps * 2 * 256;  // Nt * D per column block of a warp
#ifndef SC_MAX_SMEM
#error "build with -DSC_MAX_SMEM=<bytes> (ops/_build.py passes ops/_wrap.py's MAX_SMEM)"
#endif
constexpr size_t kMaxSmem = SC_MAX_SMEM;  // shared memory a block may use on sm_90
// moment tiers of the C interface
constexpr int kF32 = 0, kBf16 = 1, kInt8 = 2;
// the stochastic stores' salts (`_adam_epilogue`)
constexpr uint32_t kSaltMuInt8 = 0x5117A55Au, kSaltNuInt8 = 0x00A11CE5u;

// Shared-memory row strides, padded 16 bytes (8 bf16 / 4 f32) past a
// multiple of 128 so the 16 rows of a WMMA fragment spread over the banks.
__host__ __device__ constexpr int ld_bf16(int cols) { return cols + 8; }
__host__ __device__ constexpr int ld_f32(int cols) { return cols + 4; }

// jnp.maximum(v, 0) keeps NaN; fmaxf would not.
__device__ __forceinline__ float relu_keep_nan(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

// The murmur3 finalizer of the JAX package's kernels (`_mix32`).
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// One block's shared memory, in bytes: the dictionary tile; then a region
// used by the batch loop (two stages of x/dxh/c tiles — x in a single buffer
// of its own with split_x — so the next tile loads while this one computes,
// plus the dc buffers: one f32 slice per depth part and the bf16 copy) and
// afterwards by the f32 gradient tile and the epilogue's per-row absmax
// words (`epi` bytes, int8 moments only); then the radial sums.
struct Plan {
  int tb;  // batch rows per stage
  size_t dj, stage, xbuf, loop, g, epi, total;
};

Plan make_plan(int D, int Nt, int tb, int parts, bool split_x, size_t epi) {
  Plan p;
  p.tb = tb;
  p.dj = (size_t)Nt * ld_bf16(D) * sizeof(bf16);
  p.stage = (size_t)tb * ((split_x ? 1 : 2) * ld_bf16(D) + ld_bf16(Nt)) * sizeof(bf16);
  p.xbuf = split_x ? (size_t)tb * ld_bf16(D) * sizeof(bf16) : 0;
  p.loop = 2 * p.stage + p.xbuf + (size_t)tb * ld_bf16(Nt) * sizeof(bf16) +
           (size_t)parts * tb * ld_f32(Nt) * sizeof(float);
  p.g = (size_t)Nt * ld_f32(D) * sizeof(float);
  p.epi = epi;
  p.total = p.dj + (p.loop > p.g + epi ? p.loop : p.g + epi) + (size_t)Nt * sizeof(float);
  return p;
}

// 32-row stages where they fit (every D but 1024), else 16-row stages
Plan choose_plan(int D, int Nt, int parts, bool split_x, size_t epi) {
  const Plan p = make_plan(D, Nt, 32, parts, split_x, epi);
  return p.total <= kMaxSmem ? p : make_plan(D, Nt, 16, parts, split_x, epi);
}

struct BwdArgs {
  const bf16* x;       // [B, D]
  const bf16* dxh;     // [M, B, D]
  const void* code;    // [M, B, N] bf16 c, or [M, N] f32 bias (kRecompute)
  const float* nrm;    // [M, N]
  const bf16* dhat_b;  // [M, N, D] (K3)
  float* d_raw;        // [M, N, D] (K2, in place)
  void* mu;            // [M, N, D] f32, bf16 or int8 codes (K2, in place)
  float* mu_scale;     // [M, N] (int8 mu, in place)
  void* nu;            // [M, N, D] f32, bf16 or int8 codes (K2, in place)
  float* nu_scale;     // [M, N] (int8 nu, in place)
  float* g_enc;        // [M, N, D] (K3)
  float* g_bias;       // [M, N]
  const float* l1_over_b;  // [M]
  const float* bc;     // [M, 2] bias corrections (K2)
  const int* seed;     // [1] the step count (stochastic stores)
  int seed_tile;       // rows of the JAX dictionary tile that seeds the stores
  float lr, b1, b2, eps, omb1, omb2;
  int B, N, D;
};

// four consecutive moment elements at offset o as f32 (dequantized, upcast)
template <int kTier>
__device__ __forceinline__ void load4(const void* v, const float* scale, size_t o, size_t row,
                                      float out[4]) {
  if constexpr (kTier == kF32) {
    const float4 t = *reinterpret_cast<const float4*>(static_cast<const float*>(v) + o);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (kTier == kBf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(v) + o);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __low2float(lo);
    out[1] = __high2float(lo);
    out[2] = __low2float(hi);
    out[3] = __high2float(hi);
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(static_cast<const int8_t*>(v) + o);
    const float s = scale[row];
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = __fmul_rn((float)(int8_t)(w >> (8 * e)), s);
  }
}

// the tile seed of dictionary row n of member m (`_adam_epilogue`'s
// base_seed over JAX tiles of seed_tile rows, mixed with the store's salt),
// and the row's element offset r * D within its JAX tile
__device__ __forceinline__ uint32_t tile_seed(uint32_t seed, int m, int n, int seed_tile,
                                              uint32_t salt) {
  const uint32_t base = seed ^ ((uint32_t)m * 0x9E3779B9u) ^ ((uint32_t)(n / seed_tile) * 0x7FEB352Du);
  return mix32(base ^ salt);
}

// int8 store of one element: floor(v / scale + u), u from the top 24 bits
__device__ __forceinline__ uint32_t quant_sr(float v, float scale, uint32_t bits) {
  float t = __fdiv_rn(v, scale);
  t = isnan(t) ? 0.f : fminf(fmaxf(t, -127.f), 127.f);
  const float u = (float)(bits >> 8) * 0x1p-24f;
  const float q = fminf(fmaxf(floorf(__fadd_rn(t, u)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)q;
}

// bf16 stochastic store: the low 16 bits added to the f32 pattern; non-finite
// values as a plain cast (inf kept, NaN the quiet 0x7FC0 with its sign)
__device__ __forceinline__ uint32_t bf16_sr(float v, uint32_t bits) {
  const uint32_t b = __float_as_uint(v);
  if (isfinite(v)) return (b + (bits & 0xFFFFu)) >> 16;
  return isnan(v) ? (((b >> 16) & 0x8000u) | 0x7FC0u) : (b >> 16);
}

// absmax scale of an int8 row from the bits of its largest |v|
__device__ __forceinline__ float int8_scale(int amax_bits) {
  const float a = __int_as_float(amax_bits);
  return a > 0.f ? __fdiv_rn(a, 127.f) : 1.f;  // NaN absmax -> 1, as jnp.where
}

// lane 0 raises the row's absmax word to the warp's largest |v| (compared as
// bits: NaN above inf, so a NaN propagates as jnp.max does)
__device__ __forceinline__ void warp_amax(const float v[4], int* word, int lane) {
  int a = __float_as_int(fabsf(v[0]));
#pragma unroll
  for (int e = 1; e < 4; ++e) a = max(a, __float_as_int(fabsf(v[e])));
  for (int o = 16; o > 0; o >>= 1) a = max(a, __shfl_xor_sync(0xffffffffu, a, o));
  if (lane == 0) atomicMax(word, a);
}

// The normalised dictionary tile of rows row0 .. (member-flat) into dj_s
// [rows][ld_bf16(D)]: bf16(d_raw / nrm) for K2, the caller's bf16 rows for K3
// (tile_elems = rows * D; a block of kThr threads).
template <bool kAdam, int kThr = kThreads>
__device__ __forceinline__ void load_dj_tile(const BwdArgs& a, bf16* dj_s, const size_t row0,
                                             const int tile_elems) {
  const int D = a.D, ldD = ld_bf16(D), tid = threadIdx.x;
  if constexpr (kAdam) {
    // four elements per step: one 16-byte load, two bf16 pairs stored
#pragma unroll 4
    for (int idx = tid * 4; idx < tile_elems; idx += kThr * 4) {
      const int r = idx / D, d = idx % D;
      const float4 v = *reinterpret_cast<const float4*>(a.d_raw + row0 * D + idx);
      const float nr = a.nrm[row0 + r];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(dj_s + r * ldD + d);
      dst[0] = __floats2bfloat162_rn(__fdiv_rn(v.x, nr), __fdiv_rn(v.y, nr));
      dst[1] = __floats2bfloat162_rn(__fdiv_rn(v.z, nr), __fdiv_rn(v.w, nr));
    }
  } else {
    for (int idx = tid * 8; idx < tile_elems; idx += kThr * 8)
      *reinterpret_cast<uint4*>(dj_s + (idx / D) * ldD + idx % D) =
          *reinterpret_cast<const uint4*>(a.dhat_b + row0 * D + idx);
  }
}

// Where the epilogue finds element (r, d) of the bf16 dictionary tile: the
// padded rows of the WMMA and sparse mainloops, or the 128-byte-swizzled
// panels that the wgmma mainloop multiplies from.
struct PaddedDj {
  __device__ static float at(const bf16* s, int r, int d, int D, int) {
    return __bfloat162float(s[r * ld_bf16(D) + d]);
  }
};
struct SwizzledDj {
  __device__ static float at(const bf16* s, int r, int d, int, int rows) {
    return __bfloat162float(
        *reinterpret_cast<const bf16*>(reinterpret_cast<const unsigned char*>(s) + sm90::swz(r, d, rows)));
  }
};

// The barrier of a block's kThr working threads: __syncthreads, or named
// barrier kBar where other warps of the block (a producer) do not take part.
template <int kThr, int kBar>
__device__ __forceinline__ void block_sync() {
  if constexpr (kBar == 0) __syncthreads();
  else sm90::bar_sync(kBar, kThr);
}

// The part of K2/K3 after the gradient tile is complete, shared by the dense
// (wg_bwd_kernel, bwd_kernel) and sparse (tied_sae_bwd_sparse.cu)
// mainloops: the radial sum <g_dhat, Dj> per row, the row-normalisation VJP,
// and either the f32 gradient's store (K3) or the Adam epilogue in place in
// every moment tier (K2), in one pass over the tile (two with int8 moments:
// absmax, then the codes). The block's kThr working threads (threads
// 0 .. kThr - 1, meeting at __syncthreads, or at named barrier kBar when
// other warps of the block do not take part) own dictionary rows
// n0 .. n0 + Nt - 1 of member m:
// tile_elems = Nt * D elements, g_s [Nt][ld_f32(D)] f32 and the bf16
// dictionary tile dj_s (laid out as `Dj` says: padded rows, or the wgmma
// mainloop's swizzled panels) in shared memory, radial_s [Nt] and (int8
// moments) amax_s [2 * Nt] shared scratch. The caller has synchronised after
// writing g_s; with int8 moments pass 1 overwrites it with the VJP's g.
template <bool kAdam, int kMu, int kNu, int kThr = kThreads, int kBar = 0, class Dj = PaddedDj>
__device__ __forceinline__ void epilogue(const BwdArgs& a, const int m, const int n0, const int Nt,
                                         const int tile_elems, const bf16* dj_s, float* g_s,
                                         float* radial_s, int* amax_s) {
  constexpr bool kAnyInt8 = kAdam && (kMu == kInt8 || kNu == kInt8);
  const int D = a.D;
  const int ldDf = ld_f32(D);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)m * a.N + n0;
  if constexpr (kAnyInt8) {
    if (tid < 2 * Nt) amax_s[tid] = 0;  // ordered before pass 1 by the barrier below
  }

  // radial component <g_dhat, Dj> per row: one warp per row, fixed shuffle tree
  for (int r = warp; r < Nt; r += kThr / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s = __fadd_rn(s, __fmul_rn(g_s[r * ldDf + d], Dj::at(dj_s, r, d, D, Nt)));
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) radial_s[r] = s;
  }
  block_sync<kThr, kBar>();

  float bc1 = 1.f, bc2 = 1.f, b1_bf = 0.f;
  uint32_t seed = 0;
  if constexpr (kAdam) {
    bc1 = a.bc[2 * m];
    bc2 = a.bc[2 * m + 1];
    b1_bf = __bfloat162float(__float2bfloat16_rn(a.b1));
    if constexpr (kMu == kInt8 || kNu != kF32) seed = (uint32_t)a.seed[0];
  }
  // the VJP of four consecutive elements of row r
  auto vjp4 = [&](int r, int d, float g[4]) {
    const float rad = radial_s[r], nr = a.nrm[row0 + r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float djf = Dj::at(dj_s, r, d + e, D, Nt);
      g[e] = __fdiv_rn(__fsub_rn(g_s[r * ldDf + d + e], __fmul_rn(djf, rad)), nr);
    }
  };
  // the moments' EMA (`_adam_epilogue`) from their stored values
  auto mu_ema = [&](const float prev[4], const float g[4], float out[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kMu == kBf16) {
        const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(b1_bf, prev[e])));
        out[e] = __fadd_rn(p, __fmul_rn(a.omb1, g[e]));
      } else {
        out[e] = __fadd_rn(__fmul_rn(a.b1, prev[e]), __fmul_rn(a.omb1, g[e]));
      }
    }
  };
  auto nu_ema = [&](const float prev[4], const float g[4], float out[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = __fadd_rn(__fmul_rn(a.b2, prev[e]), __fmul_rn(__fmul_rn(a.omb2, g[e]), g[e]));
  };
  // int8 codes of four elements (row n of the member, columns d..d+3)
  auto quant4 = [&](const float v[4], float scale, uint32_t salt, int n, int d) {
    const uint32_t ts = tile_seed(seed, m, n, a.seed_tile, salt);
    const uint32_t off = (uint32_t)((n % a.seed_tile) * D + d);
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) w |= quant_sr(v[e], scale, mix32((off + e) ^ ts)) << (8 * e);
    return w;
  };

  // pass 1: the VJP and the Adam epilogue, four consecutive elements of one
  // row per step (16-byte loads and stores); per element the arithmetic
  // follows `_adam_epilogue` term for term. Everything but the int8 codes
  // is stored here. The loads of kU steps are issued before any of their
  // stores: d_raw, mu and nu may alias as far as the compiler can tell, so it
  // would not move a later step's loads above an earlier step's stores, and
  // one step's loads a thread are too few bytes in flight for the stream.
  if constexpr (!kAdam) {
#pragma unroll 2
    for (int idx = tid * 4; idx < tile_elems; idx += kThr * 4) {
      float g[4];
      vjp4(idx / D, idx % D, g);
      *reinterpret_cast<float4*>(a.g_enc + row0 * D + idx) = make_float4(g[0], g[1], g[2], g[3]);
    }
  } else {
    constexpr int kU = 3;
    for (int base = tid * 4; base < tile_elems; base += kU * kThr * 4) {
      float4 dr4[kU];
      float mu_prev[kU][4], nu_prev[kU][4];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = base + u * kThr * 4;
        if (idx < tile_elems) {
          const size_t o = row0 * D + idx;
          dr4[u] = *reinterpret_cast<const float4*>(a.d_raw + o);
          load4<kMu>(a.mu, a.mu_scale, o, row0 + idx / D, mu_prev[u]);
          load4<kNu>(a.nu, a.nu_scale, o, row0 + idx / D, nu_prev[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = base + u * kThr * 4;
        if (idx >= tile_elems) break;
        const int r = idx / D, d = idx % D;
        const size_t o = row0 * D + idx;
        float g[4];
        vjp4(r, d, g);
        if constexpr (kAnyInt8) {  // pass 2 reads g back instead of dividing again
          *reinterpret_cast<float4*>(g_s + r * ldDf + d) = make_float4(g[0], g[1], g[2], g[3]);
        }
        float dr[4] = {dr4[u].x, dr4[u].y, dr4[u].z, dr4[u].w};
        float mu_new[4], nu_new[4];
        mu_ema(mu_prev[u], g, mu_new);
        nu_ema(nu_prev[u], g, nu_new);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mhat = __fdiv_rn(mu_new[e], bc1);
          const float vhat = __fdiv_rn(nu_new[e], bc2);
          const float upd = __fdiv_rn(__fmul_rn(a.lr, mhat), __fadd_rn(__fsqrt_rn(vhat), a.eps));
          dr[e] = __fsub_rn(dr[e], upd);
        }
        *reinterpret_cast<float4*>(a.d_raw + o) = make_float4(dr[0], dr[1], dr[2], dr[3]);
        if constexpr (kNu == kF32) {
          *reinterpret_cast<float4*>(static_cast<float*>(a.nu) + o) =
              make_float4(nu_new[0], nu_new[1], nu_new[2], nu_new[3]);
        } else if constexpr (kNu == kBf16) {
          const int n = n0 + r;
          const uint32_t ts = tile_seed(seed, m, n, a.seed_tile, 0u);
          const uint32_t off = (uint32_t)((n % a.seed_tile) * D + d);
          uint2 raw;
          raw.x = bf16_sr(nu_new[0], mix32(off ^ ts)) | (bf16_sr(nu_new[1], mix32((off + 1) ^ ts)) << 16);
          raw.y = bf16_sr(nu_new[2], mix32((off + 2) ^ ts)) | (bf16_sr(nu_new[3], mix32((off + 3) ^ ts)) << 16);
          *reinterpret_cast<uint2*>(static_cast<bf16*>(a.nu) + o) = raw;
        } else {
          warp_amax(nu_new, amax_s + Nt + r, lane);
        }
        if constexpr (kMu == kBf16) {
          uint2 raw;
          *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(mu_new[0], mu_new[1]);
          *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(mu_new[2], mu_new[3]);
          *reinterpret_cast<uint2*>(static_cast<bf16*>(a.mu) + o) = raw;
        } else if constexpr (kMu == kF32) {
          *reinterpret_cast<float4*>(static_cast<float*>(a.mu) + o) =
              make_float4(mu_new[0], mu_new[1], mu_new[2], mu_new[3]);
        } else {
          warp_amax(mu_new, amax_s + r, lane);
        }
      }
    }
  }

  if constexpr (kAnyInt8) {
    block_sync<kThr, kBar>();  // every row's absmax is in
    // pass 2: the same f32 moments again (the same g, read back from g_s, and
    // the same stored moments: an int8 moment's codes are not overwritten
    // until here, so the same bits), stored as codes
#pragma unroll 2
    for (int idx = tid * 4; idx < tile_elems; idx += kThr * 4) {
      const int r = idx / D, d = idx % D;
      const size_t o = row0 * D + idx;
      float prev[4], v[4];
      const float4 g4 = *reinterpret_cast<const float4*>(g_s + r * ldDf + d);
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
      if constexpr (kMu == kInt8) {
        load4<kInt8>(a.mu, a.mu_scale, o, row0 + r, prev);
        mu_ema(prev, g, v);
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.mu) + o) =
            quant4(v, int8_scale(amax_s[r]), kSaltMuInt8, n0 + r, d);
      }
      if constexpr (kNu == kInt8) {
        load4<kInt8>(a.nu, a.nu_scale, o, row0 + r, prev);
        nu_ema(prev, g, v);
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.nu) + o) =
            quant4(v, int8_scale(amax_s[Nt + r]), kSaltNuInt8, n0 + r, d);
      }
    }
    block_sync<kThr, kBar>();  // every read of the old scales is done
    if (tid < Nt) {
      if constexpr (kMu == kInt8) a.mu_scale[row0 + tid] = int8_scale(amax_s[tid]);
      if constexpr (kNu == kInt8) a.nu_scale[row0 + tid] = int8_scale(amax_s[Nt + tid]);
    }
  }
}

template <bool kAdam, int kMu, int kNu, bool kRecompute, int kCols>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(const BwdArgs a, const int Nt,
                                                          const Plan pl) {
  constexpr int kTileElems = kElemsPerCol * kCols;  // Nt * D
  constexpr int kParts = kCols == 3 ? 4 : 2;          // depth slices of dc
  constexpr bool kSplitX = kCols == 3;                // x single-buffered (D = 768)
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = a.B, N = a.N, D = a.D;
  const int tb = pl.tb;
  const int ldD = ld_bf16(D), ldN = ld_bf16(Nt), ldDf = ld_f32(D), ldNf = ld_f32(Nt);
  bf16* dj_s = reinterpret_cast<bf16*>(smem);                 // [Nt][ldD]
  unsigned char* u = smem + pl.dj;                            // loop region / gradient tile
  bf16* x1_s = reinterpret_cast<bf16*>(u + 2 * pl.stage);     // [tb][ldD], kSplitX only
  bf16* dcb_s = reinterpret_cast<bf16*>(u + 2 * pl.stage + pl.xbuf);  // [tb][ldN]
  float* dcf_s = reinterpret_cast<float*>(dcb_s + tb * ldN);  // [kParts][tb][ldNf], one per depth slice
  float* g_s = reinterpret_cast<float*>(u);                   // [Nt][ldDf], after the batch loop
  int* amax_s = reinterpret_cast<int*>(u + pl.g);             // [2][Nt] |mu|, |nu| maxima (int8)
  float* radial_s = reinterpret_cast<float*>(u + (pl.loop > pl.g + pl.epi ? pl.loop : pl.g + pl.epi));  // [Nt]
  // stage st: x [tb][ldD] (unless kSplitX), dxh [tb][ldD], c [tb][ldN]
  auto x_st = [&](int st) {
    return kSplitX ? x1_s : reinterpret_cast<bf16*>(u + st * pl.stage);
  };
  auto dxh_st = [&](int st) {
    return reinterpret_cast<bf16*>(u + st * pl.stage) + (kSplitX ? 0 : tb * ldD);
  };

  const int m = blockIdx.y, n0 = blockIdx.x * Nt;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t row0 = (size_t)m * N + n0;  // first (member, dict row) of the tile
  const float l1b = a.l1_over_b[m];
  const bf16* dxh_m = a.dxh + (size_t)m * B * D;
  const bf16* c_m = static_cast<const bf16*>(a.code) + (size_t)m * B * N;
  const bf16* x = a.x;

  // copies of batch tile b0 into stage st (x too, unless kSplitX; c unless
  // it is rebuilt), 16 bytes per cp.async
  auto issue = [&](int st, int b0) {
    bf16* ds = dxh_st(st);
    bf16* cs = ds + tb * ldD;
    for (int idx = tid * 8; idx < tb * D; idx += kThreads * 8) {
      const int so = (idx / D) * ldD + idx % D;
      if constexpr (!kSplitX) __pipeline_memcpy_async(x_st(st) + so, x + (size_t)b0 * D + idx, 16);
      __pipeline_memcpy_async(ds + so, dxh_m + (size_t)b0 * D + idx, 16);
    }
    if constexpr (!kRecompute) {
      for (int idx = tid * 8; idx < tb * Nt; idx += kThreads * 8) {
        const int r = idx / Nt, j = idx % Nt;
        __pipeline_memcpy_async(cs + r * ldN + j, c_m + (size_t)(b0 + r) * N + n0 + j, 16);
      }
    }
  };
  // kSplitX: copies of batch tile b0's x into the single x buffer
  auto copy_x = [&](int b0) {
    for (int idx = tid * 8; idx < tb * D; idx += kThreads * 8)
      __pipeline_memcpy_async(x1_s + (idx / D) * ldD + idx % D, x + (size_t)b0 * D + idx, 16);
  };
  issue(0, 0);
  __pipeline_commit();

  // the normalised dictionary tile, resident for the whole block
  load_dj_tile<kAdam>(a, dj_s, row0, kTileElems);

  // this warp's 2 x kCols gradient fragments: 2 row bands x kCols column
  // blocks of the [Nt, D] tile (each A fragment then feeds kCols MMAs, each
  // B fragment 2); (Nt / 32) * (D / (16 kCols)) = 16 warps at every width
  const int col_groups = D / (16 * kCols);
  const int fr0 = 2 * (warp / col_groups);
  const int fc0 = kCols * (warp % col_groups);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kCols];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < kCols; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  // bias gradient of dict row n0 + tid (tid < Nt), in 4 independent chains
  // over the rows of a tile (r % 4), added pairwise at the end
  float gb[4] = {0.f, 0.f, 0.f, 0.f};
  const int dc_frags = (tb / 16) * (Nt / 16);
  const int depth = D / kParts;

  const int n_tiles = B / tb;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if constexpr (kSplitX) {  // the buffer's last reader was tile t - 1
      copy_x(t * tb);
      __pipeline_commit();
    }
    if (t + 1 < n_tiles) issue(st ^ 1, (t + 1) * tb);
    __pipeline_commit();
    // this thread's dxh and c copies of tile t have landed (x may not, with
    // kSplitX, unless the code is rebuilt from it first)
    __pipeline_wait_prior(kSplitX && !kRecompute ? 2 : 1);
    __syncthreads();  // ... and everyone's (and dj_s is written)
    const bf16* xs = x_st(st);
    const bf16* ds = dxh_st(st);
    bf16* cs = const_cast<bf16*>(ds) + tb * ldD;

    if constexpr (kRecompute) {
      // c = bf16(relu(x . Dj^T + b)), K1's encode fragment for fragment:
      // one accumulator over the whole depth from k = 0, into dc slice 0
      const int c_frags = (tb / 16) * (Nt / 16);
      for (int f = warp; f < c_frags; f += kWarps) {
        const int r = f / (Nt / 16), cn = f % (Nt / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cacc;
        wmma::fill_fragment(cacc, 0.f);
        for (int k = 0; k < D; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, xs + r * 16 * ldD + k, ldD);
          wmma::load_matrix_sync(fb, dj_s + cn * 16 * ldD + k, ldD);
          wmma::mma_sync(cacc, fa, fb, cacc);
        }
        wmma::store_matrix_sync(dcf_s + r * 16 * ldNf + cn * 16, cacc, ldNf, wmma::mem_row_major);
      }
      __syncthreads();
      const float* bm = static_cast<const float*>(a.code) + row0;
      for (int idx = tid; idx < tb * Nt; idx += kThreads) {
        const int r = idx / Nt, j = idx % Nt;
        cs[r * ldN + j] = __float2bfloat16_rn(relu_keep_nan(__fadd_rn(dcf_s[r * ldNf + j], bm[j])));
      }
      __syncthreads();
    }

    // dc = dxh . Dj^T ([tb, Nt]): each fragment's depth D split into
    // kParts slices, so all 16 warps work
    for (int item = warp; item < kParts * dc_frags; item += kWarps) {
      const int h = item / dc_frags, f = item % dc_frags;
      const int r = f / (Nt / 16), cn = f % (Nt / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc;
      wmma::fill_fragment(dacc, 0.f);
      for (int k = h * depth; k < (h + 1) * depth; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, ds + r * 16 * ldD + k, ldD);
        wmma::load_matrix_sync(fb, dj_s + cn * 16 * ldD + k, ldD);
        wmma::mma_sync(dacc, fa, fb, dacc);
      }
      wmma::store_matrix_sync(dcf_s + h * tb * ldNf + r * 16 * ldNf + cn * 16, dacc, ldNf,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // relu mask on the code, l1 term, bf16 copy for the GEMM; the masked f32
    // dc goes back into slice 0
    for (int idx = tid; idx < tb * Nt; idx += kThreads) {
      const int r = idx / Nt, j = idx % Nt;
      float dc = dcf_s[r * ldNf + j];
#pragma unroll
      for (int h = 1; h < kParts; ++h) dc = __fadd_rn(dc, dcf_s[h * tb * ldNf + r * ldNf + j]);
      const float v = __bfloat162float(cs[r * ldN + j]) > 0.f ? __fadd_rn(dc, l1b) : 0.f;
      dcf_s[r * ldNf + j] = v;
      dcb_s[r * ldN + j] = __float2bfloat16_rn(v);
    }
    if constexpr (kSplitX && !kRecompute) __pipeline_wait_prior(1);  // tile t's x has landed
    __syncthreads();

    if (tid < Nt)
      for (int r = 0; r < tb; r += 4)
        for (int q = 0; q < 4; ++q) gb[q] = __fadd_rn(gb[q], dcf_s[(r + q) * ldNf + tid]);

    // g_dhat += c^T . dxh + dc_b^T . x  (depth tb)
    for (int kk = 0; kk < tb; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ac[2], ad[2];
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ac[i], cs + kk * ldN + (fr0 + i) * 16, ldN);
        wmma::load_matrix_sync(ad[i], dcb_s + kk * ldN + (fr0 + i) * 16, ldN);
      }
      for (int j = 0; j < kCols; ++j) {
        const int fc = fc0 + j;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bd, bx;
        wmma::load_matrix_sync(bd, ds + kk * ldD + fc * 16, ldD);
        wmma::load_matrix_sync(bx, xs + kk * ldD + fc * 16, ldD);
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc[i][j], ac[i], bd, acc[i][j]);
          wmma::mma_sync(acc[i][j], ad[i], bx, acc[i][j]);
        }
      }
    }
    __syncthreads();  // stage st and the dc buffers consumed before reuse
  }
  __pipeline_wait_prior(0);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < kCols; ++j)
      wmma::store_matrix_sync(g_s + (fr0 + i) * 16 * ldDf + (fc0 + j) * 16, acc[i][j], ldDf,
                              wmma::mem_row_major);
  if (tid < Nt) a.g_bias[row0 + tid] = __fadd_rn(__fadd_rn(gb[0], gb[1]), __fadd_rn(gb[2], gb[3]));
  __syncthreads();
  epilogue<kAdam, kMu, kNu>(a, m, n0, Nt, kTileElems, dj_s, g_s, radial_s, amax_s);
}

template <bool kAdam, int kMu, int kNu, bool kRecompute, int kCols>
int launch_cols(const BwdArgs& a, int M, cudaStream_t st) {
  constexpr int tile = kElemsPerCol * kCols;
  const int B = a.B, N = a.N, D = a.D;
  if (D % (16 * kCols) || tile % D || (tile / D) % 32) return (int)cudaErrorInvalidValue;
  const int Nt = tile / D;
  constexpr int kParts = kCols == 3 ? 4 : 2;
  constexpr int kInt8Moments = kAdam ? (kMu == kInt8) + (kNu == kInt8) : 0;
  const size_t epi = kInt8Moments ? 2 * (size_t)Nt * sizeof(int) : 0;
  const Plan p = choose_plan(D, Nt, kParts, kCols == 3, epi);
  if (p.total > kMaxSmem || B % p.tb || N % Nt || (D / 16) % kParts)
    return (int)cudaErrorInvalidValue;
  auto kern = bwd_kernel<kAdam, kMu, kNu, kRecompute, kCols>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(N / Nt, M), kThreads, p.total, st>>>(a, Nt, p);
  return (int)cudaGetLastError();
}

// -- the wgmma mainloop (D in {128, 256, 512}) ------------------------------------

constexpr int kWgConsumers = 256;               // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and a producer warpgroup (one thread issues)
constexpr int kWgTb = 32;                       // batch rows per stage
constexpr int kWgMaxStages = 4;
constexpr int kBarConsumers = 1;                // named barrier of the consumer warpgroups
constexpr int kBarAll = 2;                      // ... of every thread (the epilogue)

// How a block's tile is cut (WgShape::kMode):
//   kRowSplit (D 128, 256): 128 dictionary rows; warpgroup w owns rows
//     [64 w, 64 w + 64) at every column, and its rows' whole dc.
//   kPairSplit (D 512, the stored code): a cluster of two blocks owns 128
//     rows; block r holds columns [256 r, 256 r + 256) of x, dxh, the
//     dictionary and the gradient, warpgroup w rows [64 w, 64 w + 64). The
//     two blocks' depth partials of dc meet through distributed shared memory
//     (st.async), so each block streams only its half of x and dxh. After
//     the batch loop block r takes rows [64 r, 64 r + 64) at every column for
//     the epilogue.
//   kColSplit (D 512, the code rebuilt, whose encode needs whole rows of x
//     and the dictionary): 64 rows; warpgroup w owns columns
//     [256 w, 256 w + 256) and dc's depth slice over them, the two partials
//     meeting in shared memory.
constexpr int kRowSplit = 0, kPairSplit = 1, kColSplit = 2;

template <int kD, bool kRecompute>
struct WgShape {
  static constexpr int kMode = kD <= 256 ? kRowSplit : kRecompute ? kColSplit : kPairSplit;
  static constexpr int kNt = kMode == kColSplit ? 64 : 128;        // rows of the batch loop
  static constexpr int kCluster = kMode == kPairSplit ? 2 : 1;
  static constexpr int kDc = kMode == kPairSplit ? kD / 2 : kD;     // columns of x, dxh, Dj, g in the block
  static constexpr int kNw = kMode == kColSplit ? kD / 2 : kDc;     // gradient columns of a warpgroup
  static constexpr int kDepth = kMode == kColSplit ? kD / 2 : kDc;  // depth of a warpgroup's dc product
  static constexpr int kEpiRows = kMode == kPairSplit ? 64 : kNt;   // rows of the block's epilogue
  static constexpr uint32_t kDj = (uint32_t)kNt * kDc * 2;          // == kEpiRows * kD * 2
  static constexpr uint32_t kX = (uint32_t)kWgTb * kDc * 2;         // the x (or dxh) tile of a stage
  static constexpr uint32_t kC = (uint32_t)kWgTb * kNt * 2;
  static constexpr uint32_t kStage = 2 * kX + kC;
  // dc's depth partials: two slots of every consumer's 16 floats (pair),
  // or one of each warpgroup's (col)
  static constexpr uint32_t kXchg = kMode == kPairSplit ? 2u * kWgConsumers * (kWgTb / 2) * 4
                                    : kMode == kColSplit ? (uint32_t)kWgConsumers * (kWgTb / 2) * 4 : 0;
  static constexpr uint32_t kG = (uint32_t)kEpiRows * ld_f32(kD) * 4;
  static_assert(kNw <= 256 && kNw % 64 == 0 && kDc % 64 == 0, "whole 64-column panels, one wgmma wide");
  static_assert(kDj == (uint32_t)kEpiRows * kD * 2, "the epilogue's dictionary rows reuse the tile");
};

struct WgPlan {
  int stages;
  uint32_t region;  // the stages; after the batch loop the gradient tile and absmax words
  uint32_t total;   // dynamic shared memory, with 1024 bytes to align its base
};

// as many stages (2 .. kWgMaxStages) as fit beside the dictionary tile,
// with int8_moments int8 moment tiers (each an absmax word a row beside the
// gradient tile)
template <int kD, bool kRecompute>
constexpr WgPlan wg_plan(int int8_moments) {
  using S = WgShape<kD, kRecompute>;
  for (int st = kWgMaxStages; st >= 2; --st) {
    const uint32_t stages = st * S::kStage, g = S::kG + (int8_moments ? 2u * S::kEpiRows * 4 : 0u);
    const uint32_t region = stages > g ? stages : g;
    const uint32_t total = 1024 + S::kDj + region + S::kXchg + S::kEpiRows * 4 + (2 * st + 4) * 8;
    if (total <= kMaxSmem) return WgPlan{st, region, total};
  }
  return WgPlan{0, 0, 0};
}

// the TMA descriptors of one launch: x [B, D], dxh [M*B, D], c [M*B, N]
struct WgMaps {
  CUtensorMap x, dxh, c;
};

// Dictionary rows row0 .. row0 + kRows - 1, columns col0 .. col0 + kCols - 1,
// normalised, into dj_s in the 128-byte swizzle of the wgmma operands
// (kRows rows, panels of 64 columns); the same values as load_dj_tile, by the
// consumer threads.
template <bool kAdam, int kRows, int kCols>
__device__ __forceinline__ void load_dj_swizzled(const BwdArgs& a, bf16* dj_s, const size_t row0, const int col0) {
  unsigned char* base = reinterpret_cast<unsigned char*>(dj_s);
  const int tid = threadIdx.x, D = a.D;
  if constexpr (kAdam) {
    // kU float4 loads of d_raw in flight a thread before any division
    constexpr int kU = 8, kStep = kWgConsumers * 4;
    static_assert((kRows * kCols) % (kU * kStep) == 0, "whole batches of loads");
    for (int i0 = tid * 4; i0 < kRows * kCols; i0 += kU * kStep) {
      float4 v[kU];
      float nr[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = i0 + u * kStep, r = idx / kCols;
        v[u] = *reinterpret_cast<const float4*>(a.d_raw + (row0 + r) * D + col0 + idx % kCols);
        nr[u] = a.nrm[row0 + r];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = i0 + u * kStep;
        uint2 w;
        w.x = sm90::pack_bf16(__fdiv_rn(v[u].x, nr[u]), __fdiv_rn(v[u].y, nr[u]));
        w.y = sm90::pack_bf16(__fdiv_rn(v[u].z, nr[u]), __fdiv_rn(v[u].w, nr[u]));
        *reinterpret_cast<uint2*>(base + sm90::swz(idx / kCols, idx % kCols, kRows)) = w;
      }
    }
  } else {
    constexpr int kU = 4, kStep = kWgConsumers * 8;
    static_assert((kRows * kCols) % (kU * kStep) == 0, "whole batches of loads");
    for (int i0 = tid * 8; i0 < kRows * kCols; i0 += kU * kStep) {
      uint4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = i0 + u * kStep;
        v[u] = *reinterpret_cast<const uint4*>(a.dhat_b + (row0 + idx / kCols) * D + col0 + idx % kCols);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = i0 + u * kStep;
        *reinterpret_cast<uint4*>(base + sm90::swz(idx / kCols, idx % kCols, kRows)) = v[u];
      }
    }
  }
}

template <bool kAdam, int kMu, int kNu, bool kRecompute, int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
    wg_bwd_kernel(const BwdArgs a, const __grid_constant__ WgMaps maps, const WgPlan pl) {
  using S = WgShape<kD, kRecompute>;
  constexpr int kMode = S::kMode, kNt = S::kNt, kCluster = S::kCluster, kNw = S::kNw, kDc = S::kDc;
  constexpr uint32_t kPanelX = kWgTb * 128;  // bytes of a 64-column panel of a stage's tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* dj_s = reinterpret_cast<bf16*>(smem);                   // [kDc/64][kNt][64], swizzled
  unsigned char* stage0 = smem + S::kDj;                        // stage s: x, dxh, c tiles, swizzled
  float* xchg = reinterpret_cast<float*>(stage0 + pl.region);   // dc's depth partials
  float* radial_s = xchg + S::kXchg / 4;                        // [kEpiRows]
  uint64_t* full = reinterpret_cast<uint64_t*>(radial_s + S::kEpiRows);  // [stages] the stage has landed
  uint64_t* empty = full + pl.stages;                           // [stages] the stage may be refilled
  uint64_t* xfull = empty + pl.stages;                          // [2][2] slot, warpgroup: the peer's dc partial has landed (pair)
  float* g_s = reinterpret_cast<float*>(stage0);                // [kEpiRows][ld_f32(kD)], after the batch loop
  int* amax_s = reinterpret_cast<int*>(stage0 + S::kG);         // [2][kEpiRows] |mu|, |nu| maxima (int8)

  const int B = a.B, N = a.N;
  const int m = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = kCluster > 1 ? sm90::cluster_rank() : 0;
  const int n0 = kMode == kPairSplit ? (blockIdx.x >> 1) * kNt : blockIdx.x * kNt;  // first row of the loop
  const int col0 = kMode == kPairSplit ? rank * kDc : 0;                            // first column held
  const int epi_n0 = kMode == kPairSplit ? n0 + 64 * rank : n0;                     // first row of the epilogue
  const size_t row0 = (size_t)m * N + n0;
  const int n_tiles = B / kWgTb;

  if (tid == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // each consumer warpgroup
    }
    for (int i = 0; i < 4; ++i) sm90::mbar_init(&xfull[i], 1);
    sm90::fence_mbar_init();
  }
  if (tid < kWgConsumers) load_dj_swizzled<kAdam, kNt, kDc>(a, dj_s, row0, col0);
  sm90::fence_proxy_async();  // dj_s is read by wgmma
  if constexpr (kCluster > 1) sm90::cluster_sync();
  else __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // producer: one thread keeps the ring of stages filled by TMA (this
    // block's columns of x and dxh, its rows of the code). The warpgroup
    // gives its registers to the consumers (setmaxnreg moves them within the
    // block: 128 x (168 - 40) = 2 x 128 x (232 - 168)).
    sm90::reg_dealloc<40>();
    if (warp == kWgConsumers / 32 && lane == 0) {
      constexpr uint32_t kBytes = 2 * S::kX + (kRecompute ? 0 : S::kC);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % pl.stages;
        sm90::mbar_wait(&empty[s], ((t / pl.stages) & 1) ^ 1);
        unsigned char* st = stage0 + s * S::kStage;
        sm90::mbar_expect_tx(&full[s], kBytes);
        for (int p = 0; p < kDc / 64; ++p) {
          sm90::tma_load(st + p * kPanelX, &maps.x, &full[s], col0 + p * 64, t * kWgTb);
          sm90::tma_load(st + S::kX + p * kPanelX, &maps.dxh, &full[s], col0 + p * 64, m * B + t * kWgTb);
        }
        if constexpr (!kRecompute)
          for (int q = 0; q < kNt / 64; ++q)
            sm90::tma_load(st + 2 * S::kX + q * kPanelX, &maps.c, &full[s], n0 + q * 64, m * B + t * kWgTb);
      }
    }
    __syncwarp();
    if constexpr (kCluster > 1) {  // the consumers' two cluster barriers before the epilogue
      sm90::cluster_sync();
      sm90::cluster_sync();
    }
    // the epilogue streams on every warp of the block. The consumers hand
    // back registers (168 each again) before they reach kBarAll; this
    // warpgroup takes them only after it, so it can never hold registers
    // that the consumers' reg_alloc<232> at their start still waits for
    sm90::bar_sync(kBarAll, kWgThreads);
    sm90::reg_alloc<168>();
    epilogue<kAdam, kMu, kNu, kWgThreads, kBarAll, SwizzledDj>(a, m, epi_n0, S::kEpiRows, S::kEpiRows * kD, dj_s,
                                                               g_s, radial_s, amax_s);
  } else {
    sm90::reg_alloc<232>();
    const int wg = tid >> 7, wt = tid & 127;
    const int g = 16 * (wt >> 5) + (lane >> 2), t4 = lane & 3;  // accumulator row, column pair
    const int rbase = kMode == kColSplit ? 0 : 64 * wg;         // this warpgroup's first loop row
    const int cbase = kMode == kColSplit ? kNw * wg : 0;        // ... and first column of the block's
    const float l1b = a.l1_over_b[m];
    const uint32_t dj_a = sm90::smem_u32(dj_s);
    float acc[kNw / 2];  // g_dhat [64 x kNw], wgmma accumulator layout
#pragma unroll
    for (int i = 0; i < kNw / 2; ++i) acc[i] = 0.f;
    float gb[2] = {0.f, 0.f};  // bias gradient of rows g, g + 8: this thread's columns

    // kRecompute: warp w encodes the m16n8 code fragments of row block
    // (w % 2) and column blocks w / 2 + 4 i, with their bias
    constexpr int kEnc = (kWgTb / 16) * (kNt / 8) / (kWgConsumers / 32);
    static_assert(kWgTb / 16 == 2, "the encode's row blocks: two per tile");
    static_assert(!kRecompute || kMode != kPairSplit, "the encode needs whole rows");
    float ebias[kEnc][2];
    if constexpr (kRecompute) {
      const float* bm = static_cast<const float*>(a.code) + row0;
#pragma unroll
      for (int i = 0; i < kEnc; ++i) {
        const int n = ((warp >> 1) + 4 * i) * 8 + 2 * t4;
        ebias[i][0] = bm[n];
        ebias[i][1] = bm[n + 1];
      }
    }

    // Per tile: dc's product (this warpgroup's depth partial), sent to where
    // the other half is; then the tile's finish: g += c^T . dxh, which needs
    // no dc, runs on the tensor cores while the halves meet and the mask is
    // applied; then g += bf16(dc)^T . x, and the stage is released.
    float dc[kWgTb / 2];  // dc^T [64 x kWgTb], wgmma accumulator layout
    float4* x4 = reinterpret_cast<float4*>(xchg);
    auto stage_of = [&](int t) { return stage0 + (t % pl.stages) * S::kStage; };

    // the finish of tile t, whose partial is in dc
    auto finish = [&](int t) {
      const int s = t % pl.stages;
      const unsigned char* c_s = stage_of(t) + 2 * S::kX;
      const uint32_t xs = sm90::smem_u32(stage_of(t)), ds = xs + S::kX, cs = xs + 2 * S::kX;
      sm90::fence_regs(acc);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgTb / 16; ++kk)
        sm90::wgmma_ss<kNw, 1, 1>(acc, sm90::desc(cs + (rbase / 64) * kPanelX + kk * 2048, kPanelX, 1024),
                                  sm90::desc(ds + (cbase / 64) * kPanelX + kk * 2048, kPanelX, 1024));
      sm90::wg_commit();
      // the other depth half (column split: the other warpgroup's, in shared
      // memory; pair split: the peer block's, in slot t % 2); p0 + p1 in
      // that order
      if constexpr (kMode != kRowSplit) {
        const float4* other;
        if constexpr (kMode == kColSplit) {
          sm90::bar_sync(kBarConsumers, kWgConsumers);
          other = x4 + (wg ^ 1) * (kWgTb / 8) * 128 + wt;
        } else {
          sm90::mbar_wait_cluster(&xfull[2 * (t & 1) + wg], (t >> 1) & 1);
          other = x4 + (t & 1) * (kWgConsumers * (kWgTb / 8)) + tid;
        }
        const bool first = kMode == kColSplit ? wg == 0 : rank == 0;
        float ov[kWgTb / 2];
#pragma unroll
        for (int q = 0; q < kWgTb / 8; ++q) {
          const float4 o = other[q * (kMode == kColSplit ? 128 : kWgConsumers)];
          ov[4 * q] = o.x, ov[4 * q + 1] = o.y, ov[4 * q + 2] = o.z, ov[4 * q + 3] = o.w;
        }
        if constexpr (kMode == kColSplit) sm90::bar_sync(kBarConsumers, kWgConsumers);  // the buffer is free again
#pragma unroll
        for (int e = 0; e < kWgTb / 2; ++e) dc[e] = first ? __fadd_rn(dc[e], ov[e]) : __fadd_rn(ov[e], dc[e]);
      }

      // relu mask on the code, the l1 term, the bias gradient; then bf16(dc^T)
      // as the register A operand of the second gradient product
#pragma unroll
      for (int j = 0; j < kWgTb / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = 8 * j + 2 * t4 + (e & 1), n = rbase + g + 8 * (e >> 1);
          const float cv = __bfloat162float(*reinterpret_cast<const bf16*>(c_s + sm90::swz(b, n, kWgTb)));
          const float v = cv > 0.f ? __fadd_rn(dc[4 * j + e], l1b) : 0.f;
          dc[4 * j + e] = v;
          gb[e >> 1] = __fadd_rn(gb[e >> 1], v);
        }
      uint32_t af[kWgTb / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgTb / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) af[kk][q] = sm90::pack_bf16(dc[8 * kk + 2 * q], dc[8 * kk + 2 * q + 1]);

      // g += bf16(dc)^T . x (depth kWgTb)
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgTb / 16; ++kk)
        sm90::wgmma_rs<kNw, 1>(acc, af[kk], sm90::desc(xs + (cbase / 64) * kPanelX + kk * 2048, kPanelX, 1024));
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
      if (wt == 0) sm90::mbar_arrive(&empty[s]);  // this warpgroup is done with stage s
    };

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % pl.stages;
      sm90::mbar_wait(&full[s], (t / pl.stages) & 1);
      unsigned char* c_s = stage_of(t) + 2 * S::kX;
      const uint32_t xs = sm90::smem_u32(stage_of(t)), ds = xs + S::kX;

      if constexpr (kRecompute) {
        // c = bf16(relu(x . Dj^T + b)) as K1 encodes it: per m16n8 fragment
        // one mma.sync chain over the whole depth from k = 0, the bias added
        // after the product (so the same bits as K1's stored code)
        float e[kEnc][4];
#pragma unroll
        for (int i = 0; i < kEnc; ++i) e[i][0] = e[i][1] = e[i][2] = e[i][3] = 0.f;
        // fragments of step k + 16 are loaded while step k multiplies (the
        // chain itself is serial)
        const int ar = (warp & 1) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        uint32_t xa[2][4], bfr[2][kEnc][2];
        auto frags = [&](int k, int buf) {
          sm90::ldmatrix_x4(xa[buf], xs + sm90::swz(ar, k + 8 * (lane >> 4), kWgTb));
#pragma unroll
          for (int i = 0; i < kEnc; ++i)
            sm90::ldmatrix_x2(bfr[buf][i], dj_a + sm90::swz(((warp >> 1) + 4 * i) * 8 + (lane & 7),
                                                             k + 8 * ((lane >> 3) & 1), kNt));
        };
        frags(0, 0);
#pragma unroll 2
        for (int k = 0; k < kD; k += 32) {
          frags(k + 16, 1);
#pragma unroll
          for (int i = 0; i < kEnc; ++i) sm90::mma_16816(e[i], xa[0], bfr[0][i]);
          if (k + 32 < kD) frags(k + 32, 0);
#pragma unroll
          for (int i = 0; i < kEnc; ++i) sm90::mma_16816(e[i], xa[1], bfr[1][i]);
        }
#pragma unroll
        for (int i = 0; i < kEnc; ++i) {
          const int b = (warp & 1) * 16 + (lane >> 2), n = ((warp >> 1) + 4 * i) * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(c_s + sm90::swz(b, n, kWgTb)) =
              sm90::pack_bf16(relu_keep_nan(__fadd_rn(e[i][0], ebias[i][0])),
                              relu_keep_nan(__fadd_rn(e[i][1], ebias[i][1])));
          *reinterpret_cast<uint32_t*>(c_s + sm90::swz(b + 8, n, kWgTb)) =
              sm90::pack_bf16(relu_keep_nan(__fadd_rn(e[i][2], ebias[i][0])),
                              relu_keep_nan(__fadd_rn(e[i][3], ebias[i][1])));
        }
        sm90::fence_proxy_async();  // the code tile is read by wgmma
        sm90::bar_sync(kBarConsumers, kWgConsumers);
      }

      // dc^T [64 x kWgTb] = Dj . dxh^T over this warpgroup's depth
#pragma unroll
      for (int i = 0; i < kWgTb / 2; ++i) dc[i] = 0.f;
      sm90::fence_regs(dc);
      sm90::wg_fence();
#pragma unroll
      for (int k = 0; k < S::kDepth; k += 16) {
        const int kk = (kMode == kColSplit ? wg * S::kDepth : 0) + k;
        sm90::wgmma_ss<kWgTb, 0, 0>(dc, sm90::desc(dj_a + sm90::swz(rbase, kk, kNt), 16, 1024),
                                    sm90::desc(ds + sm90::swz(0, kk, kWgTb), 16, 1024));
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(dc);
      // send this warpgroup's partial (column split: into its half of the
      // buffer; pair split: each consumer to the same thread of the peer,
      // by st.async into slot t % 2 there, counted on the peer's xfull of
      // that slot and warpgroup; the peer's warpgroup sends tile t + 2's
      // into the slot only after it has all of this warpgroup's tile t + 1
      // partials, so after every read of tile t's here)
      if constexpr (kMode == kColSplit) {
#pragma unroll
        for (int q = 0; q < kWgTb / 8; ++q)
          x4[(wg * (kWgTb / 8) + q) * 128 + wt] = make_float4(dc[4 * q], dc[4 * q + 1], dc[4 * q + 2], dc[4 * q + 3]);
      } else if constexpr (kMode == kPairSplit) {
        float4* slot = x4 + (t & 1) * (kWgConsumers * (kWgTb / 8));
        uint64_t* bar = &xfull[2 * (t & 1) + wg];
        if (wt == 0) sm90::mbar_expect_tx(bar, 128 * (kWgTb / 2) * 4);
        const uint32_t peer_bar = sm90::map_rank(sm90::smem_u32(bar), rank ^ 1);
#pragma unroll
        for (int k = 0; k < kWgTb / 8; ++k)
          sm90::st_async(sm90::map_rank(sm90::smem_u32(slot + k * kWgConsumers + tid), rank ^ 1),
                         make_float4(dc[4 * k], dc[4 * k + 1], dc[4 * k + 2], dc[4 * k + 3]), peer_bar);
      }
      finish(t);
    }

    // bias gradient: the row's four lanes, a fixed butterfly
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gb[h] = __fadd_rn(gb[h], __shfl_xor_sync(0xffffffffu, gb[h], 1));
      gb[h] = __fadd_rn(gb[h], __shfl_xor_sync(0xffffffffu, gb[h], 2));
    }
    constexpr int ldg = ld_f32(kD);
    if constexpr (kMode == kPairSplit) {
      // warpgroup w's rows [64 w, 64 w + 64) go to block w's epilogue: its
      // columns of them into that block's gradient tile (here or in the
      // peer), once both blocks are done with their stages; then this block
      // reloads its epilogue rows' dictionary at every column
      sm90::cluster_sync();
      const uint32_t g_dst = sm90::map_rank(sm90::smem_u32(g_s), wg);
#pragma unroll
      for (int j = 0; j < kNw / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sm90::st_cluster(g_dst + ((g + 8 * h) * ldg + col0 + 8 * j + 2 * t4) * 4, acc[4 * j + 2 * h],
                           acc[4 * j + 2 * h + 1]);
      if (t4 == 0 && wg == (int)rank) {
        a.g_bias[row0 + 64 * wg + g] = gb[0];
        a.g_bias[row0 + 64 * wg + g + 8] = gb[1];
      }
      load_dj_swizzled<kAdam, 64, kD>(a, dj_s, (size_t)m * N + epi_n0, 0);
      sm90::cluster_sync();
    } else {
      sm90::bar_sync(kBarConsumers, kWgConsumers);  // the stages are consumed: they become the gradient tile
#pragma unroll
      for (int j = 0; j < kNw / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(g_s + (rbase + g + 8 * h) * ldg + cbase + 8 * j + 2 * t4) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (t4 == 0 && (kMode == kRowSplit || wg == 0)) {
        a.g_bias[row0 + rbase + g] = gb[0];
        a.g_bias[row0 + rbase + g + 8] = gb[1];
      }
    }
    sm90::reg_dealloc<168>();
    sm90::bar_sync(kBarAll, kWgThreads);  // the gradient tile is complete
    epilogue<kAdam, kMu, kNu, kWgThreads, kBarAll, SwizzledDj>(a, m, epi_n0, S::kEpiRows, S::kEpiRows * kD, dj_s,
                                                               g_s, radial_s, amax_s);
  }
}

template <bool kAdam, int kMu, int kNu, bool kRecompute, int kD>
int launch_wg(const BwdArgs& a, int M, cudaStream_t st) {
  using S = WgShape<kD, kRecompute>;
  constexpr int kInt8Moments = kAdam ? (kMu == kInt8) + (kNu == kInt8) : 0;
  constexpr WgPlan p = wg_plan<kD, kRecompute>(kInt8Moments);
  static_assert(p.stages >= 2, "two stages must fit beside the dictionary tile");
  static_assert(128 % (S::kEpiRows * S::kCluster) == 0,
                "shapes_supported (ops/tied_sae_kernel.py) takes every N % 128: a cluster's rows divide it");
  const int B = a.B, N = a.N;
  if (B % kWgTb || N % S::kNt) return (int)cudaErrorInvalidValue;
  WgMaps maps{};
  if (!sm90::encode_bf16_2d(&maps.x, a.x, B, kD, kWgTb) ||
      !sm90::encode_bf16_2d(&maps.dxh, a.dxh, (uint64_t)M * B, kD, kWgTb) ||
      (!kRecompute && !sm90::encode_bf16_2d(&maps.c, a.code, (uint64_t)M * B, N, kWgTb)))
    return (int)cudaErrorInvalidValue;
  auto kern = wg_bwd_kernel<kAdam, kMu, kNu, kRecompute, kD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / S::kEpiRows, M);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = p.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a, maps, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// D 128 .. 512: the wgmma mainloop; D 768 and 1024 the WMMA one (3 column
// blocks a warp at 768, where 32768 / D is no multiple of 32; 32 rows a
// block at both)
template <bool kAdam, int kMu, int kNu, bool kRecompute>
int launch(const BwdArgs& a, int M, cudaStream_t st) {
  switch (a.D) {
    case 128: return launch_wg<kAdam, kMu, kNu, kRecompute, 128>(a, M, st);
    case 256: return launch_wg<kAdam, kMu, kNu, kRecompute, 256>(a, M, st);
    case 512: return launch_wg<kAdam, kMu, kNu, kRecompute, 512>(a, M, st);
    case 768: return launch_cols<kAdam, kMu, kNu, kRecompute, 3>(a, M, st);
    case 1024: return launch_cols<kAdam, kMu, kNu, kRecompute, 4>(a, M, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2's routes: the dense mainloop on the stored code (tied_sae_bwd.cu) or
// rebuilding it (tied_sae_bwd_rc.cu), and the sparse mainloop on the stored
// code's non-zeros (tied_sae_bwd_sparse.cu, which defines `launch_sparse`).
constexpr int kStoredRoute = 0, kRebuildRoute = 1, kSparseRoute = 2;
template <bool kAdam, int kMu, int kNu>
int launch_sparse(const BwdArgs& a, int M, cudaStream_t st);

// K2's C entry at moment tiers mu_tier, nu_tier (0 f32, 1 bf16, 2 int8 codes
// with a [M, N] f32 scale in mu_scale / nu_scale; null otherwise), exported
// by tied_sae_bwd.cu and tied_sae_bwd_sparse.cu (code = c [M, B, N] bf16) and
// tied_sae_bwd_rc.cu (kRebuildRoute: code = the bias [M, N] f32 the code is
// rebuilt with).
// Shapes: x [B, D] bf16, dxh [M, B, D] bf16, nrm [M, N] f32, d_raw, mu, nu
// [M, N, D] (updated in place, with the scales), g_bias [M, N] f32 out,
// l1_over_b [M] f32, bc [M, 2] f32, seed [1] int32 the step count and
// seed_tile the rows of the JAX dictionary tile that seed the stochastic
// stores (read only by a stochastic tier). Needs D in {128, 256, 512, 768,
// 1024}, N % 128 == 0 (every dense block's rows divide it), B % 32 == 0 (the
// sparse route: N % 16 == 0, any B; the Python wrapper checks). Launches on
// `stream`, does not synchronise, returns the CUDA error code (0 on success;
// cudaErrorInvalidValue for a shape or tier it does not take).
template <int kRoute>
int adam_entry(const void* x, const void* dxh, const void* code, const void* nrm, void* d_raw,
               void* mu, void* mu_scale, int mu_tier, void* nu, void* nu_scale, int nu_tier,
               void* g_bias, const void* l1_over_b, const void* bc, const void* seed,
               int seed_tile, float lr, float b1, float b2, float eps, float omb1, float omb2,
               int M, int B, int N, int D, void* stream) {
  BwdArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.dxh = static_cast<const bf16*>(dxh);
  a.code = code;
  a.nrm = static_cast<const float*>(nrm);
  a.d_raw = static_cast<float*>(d_raw);
  a.mu = mu;
  a.mu_scale = static_cast<float*>(mu_scale);
  a.nu = nu;
  a.nu_scale = static_cast<float*>(nu_scale);
  a.g_bias = static_cast<float*>(g_bias);
  a.l1_over_b = static_cast<const float*>(l1_over_b);
  a.bc = static_cast<const float*>(bc);
  a.seed = static_cast<const int*>(seed);
  a.seed_tile = seed_tile;
  a.lr = lr, a.b1 = b1, a.b2 = b2, a.eps = eps, a.omb1 = omb1, a.omb2 = omb2;
  a.B = B, a.N = N, a.D = D;
  const bool stochastic = mu_tier == kInt8 || nu_tier != kF32;
  if ((mu_tier == kInt8 && !mu_scale) || (nu_tier == kInt8 && !nu_scale) ||
      (stochastic && (!seed || seed_tile <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define SC_TIER(MU, NU)                                                          \
  if (mu_tier == MU && nu_tier == NU) {                                          \
    if constexpr (kRoute == kSparseRoute) return launch_sparse<true, MU, NU>(a, M, st); \
    else return launch<true, MU, NU, kRoute == kRebuildRoute>(a, M, st);         \
  }
  SC_TIER(kF32, kF32) SC_TIER(kF32, kBf16) SC_TIER(kF32, kInt8)
  SC_TIER(kBf16, kF32) SC_TIER(kBf16, kBf16) SC_TIER(kBf16, kInt8)
  SC_TIER(kInt8, kF32) SC_TIER(kInt8, kBf16) SC_TIER(kInt8, kInt8)
#undef SC_TIER
  return (int)cudaErrorInvalidValue;
}

// The wgmma mainloop's plan at width D (128, 256 or 512) with int8_moments
// (0..2) int8 moment tiers: out[0] the stages of its ring, out[1] its
// dynamic shared memory in bytes. Returns cudaErrorInvalidValue at another D.
template <bool kRecompute>
int plan_entry(int D, int int8_moments, int* out) {
  WgPlan p{};
  switch (D) {
    case 128: p = wg_plan<128, kRecompute>(int8_moments); break;
    case 256: p = wg_plan<256, kRecompute>(int8_moments); break;
    case 512: p = wg_plan<512, kRecompute>(int8_moments); break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = p.stages;
  out[1] = (int)p.total;
  return 0;
}

}  // namespace
