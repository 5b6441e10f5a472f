// K2 `tied_sae_bwd_adam` and K3 `tied_sae_bwd_grads`: the stacked tied-SAE
// backward pass for Hopper (sm_90a), with or without the encoder's Adam update.
// The kernel template, its launcher and K2's C entry; tied_sae_bwd.cu (K3,
// and K2 on the stored code) and tied_sae_bwd_rc.cu (K2 rebuilding the code)
// instantiate it, one library each, so their builds run in parallel.
//
// Replaces the Pallas TPU kernels in sparse_coding__tpu/ops/tied_sae_kernel.py:
//   K2 <- `_bwd_adam_kernel` + `_adam_epilogue` (and its batch-tiled variant
//         `_bwd_adam_accum_kernel`: every block here already loops over the
//         whole batch, so one kernel covers both TPU dispatches), with the
//         code rebuild `_code_tile(recompute=True)`;
//   K3 <- `_bwd_kernel`.
// Also the backward of the TopK step (ops/topk_kernel.py), called with l1 = 0
// as the Pallas `topk_grads_stacked` / `topk_adam_step_stacked` call these.
// One block owns (member m, a tile of Nt dictionary rows) and walks the batch
// in tiles of 32 rows (16 at D = 1024):
//   [kRecompute] c = bf16(relu(x . Dj^T + b))    K1's encode, rebuilt on chip
//   dc     = [c > 0] * (dxh . Dj^T + l1/B)       f32; mask on the bf16 c
//   g_bias += sum_b dc                           f32, before rounding
//   g_dhat += c^T . dxh + bf16(dc)^T . x         f32 accumulators in registers
// then applies the row-normalisation VJP g = (g_dhat - Dj <g_dhat, Dj>) / |d|
// and either writes g (K3) or runs the Adam epilogue in place on the raw
// encoder and its moments (K2; the caller's tensors are updated in place, as
// the TPU kernel aliases them).
//
// What bounds it on the card: 3 GEMMs (4 with the rebuild), 206 GFLOP at
// M=8, B=2048, N=4096, D=512 against ~490 MB of traffic, so it is
// compute-bound; on the TopK path (M=7, N=12288, D=768) the code holds ~k of N
// entries per row, so the work its data needs is small and the ~2 GB of
// dictionary, moments and code it must move bound it. The TPU kernel
// holds the whole batch in VMEM; here x, dxh and c stream through two
// shared-memory stages by cp.async, the next tile loading while the current
// one computes (re-read from L2 by every dictionary tile of a member), while
// the [Nt, D] gradient stays in WMMA accumulator registers: 16 warps x
// (2 row bands x kCols column blocks) fragments, so Nt * D = 8192 * kCols —
// 32768 (kCols 4) at D in {128, 256, 512, 1024}, 24576 (kCols 3, Nt 32) at
// D = 768. The gradient never reaches device memory. dc's depth D is split
// into kParts slices so that enough warps share its dependent MMA chains
// (2 with 4 column blocks; 4 at D 768, whose dc tile is only 32 x 32),
// summed in a fixed order. At D = 768 two stages of x and dxh do not fit
// beside the dictionary tile, so x is single-buffered there (kSplitX): tile
// t's x is copied at the top of tile t and waited for only before the
// gradient GEMMs, behind dc and the mask, while dxh and c load a tile ahead.
// The bias-gradient sums run in a fixed order per column, so results are the
// same from run to run. No wgmma/TMA yet: that is later work.
//
// The code rebuild (kRecompute): c is not read from device memory; each
// [tb, Nt] code tile is rebuilt from the x tile and the dictionary tile
// already in shared memory with K1's encode exactly — the same 16 x 16 x 16
// fragments, one accumulator over the whole depth from k = 0, the bias added
// by __fadd_rn after the product, jnp.maximum's NaN-keeping relu, bf16 round
// to nearest — so it is bit-identical to K1's stored c (and the step to the
// stored-code step). It costs one more encode-sized GEMM, on (tb/16)·(Nt/16)
// warps (8 of 16 at D 512: the chain cannot be split without changing its
// sums).
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
// pass recomputes the same f32 moments and writes the codes; the new scales
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

template <bool kAdam, int kMu, int kNu, bool kRecompute, int kCols>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(const BwdArgs a, const int Nt,
                                                          const Plan pl) {
  constexpr int kTileElems = kElemsPerCol * kCols;  // Nt * D
  constexpr int kParts = kCols == 3 ? 4 : 2;          // depth slices of dc
  constexpr bool kSplitX = kCols == 3;                // x single-buffered (D = 768)
  constexpr bool kAnyInt8 = kAdam && (kMu == kInt8 || kNu == kInt8);
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
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
  if constexpr (kAdam) {
    // four elements per step: one 16-byte load, two bf16 pairs stored
#pragma unroll 4
    for (int idx = tid * 4; idx < kTileElems; idx += kThreads * 4) {
      const int r = idx / D, d = idx % D;
      const float4 v = *reinterpret_cast<const float4*>(a.d_raw + row0 * D + idx);
      const float nr = a.nrm[row0 + r];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(dj_s + r * ldD + d);
      dst[0] = __floats2bfloat162_rn(__fdiv_rn(v.x, nr), __fdiv_rn(v.y, nr));
      dst[1] = __floats2bfloat162_rn(__fdiv_rn(v.z, nr), __fdiv_rn(v.w, nr));
    }
  } else {
    for (int idx = tid * 8; idx < kTileElems; idx += kThreads * 8)
      *reinterpret_cast<uint4*>(dj_s + (idx / D) * ldD + idx % D) =
          *reinterpret_cast<const uint4*>(a.dhat_b + row0 * D + idx);
  }

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
  if constexpr (kAnyInt8) {
    if (tid < 2 * Nt) amax_s[tid] = 0;
  }
  __syncthreads();

  // radial component <g_dhat, Dj> per row: one warp per row, fixed shuffle tree
  for (int r = warp; r < Nt; r += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s = __fadd_rn(s, __fmul_rn(g_s[r * ldDf + d], __bfloat162float(dj_s[r * ldD + d])));
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) radial_s[r] = s;
  }
  __syncthreads();

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
      const float djf = __bfloat162float(dj_s[r * ldD + d + e]);
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
  // is stored here.
#pragma unroll 2
  for (int idx = tid * 4; idx < kTileElems; idx += kThreads * 4) {
    const int r = idx / D, d = idx % D;
    const size_t o = row0 * D + idx;
    float g[4];
    vjp4(r, d, g);
    if constexpr (!kAdam) {
      *reinterpret_cast<float4*>(a.g_enc + o) = make_float4(g[0], g[1], g[2], g[3]);
      continue;
    }
    const float4 dr4 = *reinterpret_cast<const float4*>(a.d_raw + o);
    float dr[4] = {dr4.x, dr4.y, dr4.z, dr4.w};
    float mu_prev[4], nu_prev[4], mu_new[4], nu_new[4];
    load4<kMu>(a.mu, a.mu_scale, o, row0 + r, mu_prev);
    load4<kNu>(a.nu, a.nu_scale, o, row0 + r, nu_prev);
    mu_ema(mu_prev, g, mu_new);
    nu_ema(nu_prev, g, nu_new);
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

  if constexpr (kAnyInt8) {
    __syncthreads();  // every row's absmax is in
    // pass 2: the same f32 moments again (same inputs, same bits: an int8
    // moment's stored value is not overwritten until here), stored as codes
#pragma unroll 2
    for (int idx = tid * 4; idx < kTileElems; idx += kThreads * 4) {
      const int r = idx / D, d = idx % D;
      const size_t o = row0 * D + idx;
      float g[4], prev[4], v[4];
      vjp4(r, d, g);
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
    __syncthreads();  // every read of the old scales is done
    if (tid < Nt) {
      if constexpr (kMu == kInt8) a.mu_scale[row0 + tid] = int8_scale(amax_s[tid]);
      if constexpr (kNu == kInt8) a.nu_scale[row0 + tid] = int8_scale(amax_s[Nt + tid]);
    }
  }
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

// 3 column blocks a warp where 32768 / D is no multiple of 32 (D = 768)
template <bool kAdam, int kMu, int kNu, bool kRecompute>
int launch(const BwdArgs& a, int M, cudaStream_t st) {
  if (a.D % 3 == 0) return launch_cols<kAdam, kMu, kNu, kRecompute, 3>(a, M, st);
  return launch_cols<kAdam, kMu, kNu, kRecompute, 4>(a, M, st);
}

// K2's C entry at moment tiers mu_tier, nu_tier (0 f32, 1 bf16, 2 int8 codes
// with a [M, N] f32 scale in mu_scale / nu_scale; null otherwise), exported
// by tied_sae_bwd.cu (code = c [M, B, N] bf16) and tied_sae_bwd_rc.cu
// (kRecompute: code = the bias [M, N] f32 the code is rebuilt with).
// Shapes: x [B, D] bf16, dxh [M, B, D] bf16, nrm [M, N] f32, d_raw, mu, nu
// [M, N, D] (updated in place, with the scales), g_bias [M, N] f32 out,
// l1_over_b [M] f32, bc [M, 2] f32, seed [1] int32 the step count and
// seed_tile the rows of the JAX dictionary tile that seed the stochastic
// stores (read only by a stochastic tier). Needs D in {128, 256, 512, 768,
// 1024}, N % Nt == 0 (Nt = 32768 / D, or 32 at D 768), B % 32 == 0 (the
// Python wrapper checks). Launches on `stream`, does not synchronise,
// returns the CUDA error code (0 on success; cudaErrorInvalidValue for a
// shape or tier it does not take).
template <bool kRecompute>
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
#define SC_TIER(MU, NU) \
  if (mu_tier == MU && nu_tier == NU) return launch<true, MU, NU, kRecompute>(a, M, st);
  SC_TIER(kF32, kF32) SC_TIER(kF32, kBf16) SC_TIER(kF32, kInt8)
  SC_TIER(kBf16, kF32) SC_TIER(kBf16, kBf16) SC_TIER(kBf16, kInt8)
  SC_TIER(kInt8, kF32) SC_TIER(kInt8, kBf16) SC_TIER(kInt8, kInt8)
#undef SC_TIER
  return (int)cudaErrorInvalidValue;
}

}  // namespace
