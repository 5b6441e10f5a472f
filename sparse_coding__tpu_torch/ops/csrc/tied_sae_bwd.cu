// K2 `tied_sae_bwd_adam` and K3 `tied_sae_bwd_grads`: the stacked tied-SAE
// backward pass for Hopper (sm_90a), with or without the encoder's Adam update.
//
// Replaces the Pallas TPU kernels in sparse_coding__tpu/ops/tied_sae_kernel.py:
//   K2 <- `_bwd_adam_kernel` + `_adam_epilogue` (and its batch-tiled variant
//         `_bwd_adam_accum_kernel`: every block here already loops over the
//         whole batch, so one kernel covers both TPU dispatches);
//   K3 <- `_bwd_kernel`.
// Also the backward of the TopK step (ops/topk_kernel.py), called with l1 = 0
// as the Pallas `topk_grads_stacked` / `topk_adam_step_stacked` call these.
// One block owns (member m, a tile of Nt dictionary rows) and walks the batch
// in tiles of 32 rows (16 at D = 1024):
//   dc     = [c > 0] * (dxh . Dj^T + l1/B)       f32; mask on the stored bf16 c
//   g_bias += sum_b dc                           f32, before rounding
//   g_dhat += c^T . dxh + bf16(dc)^T . x         f32 accumulators in registers
// then applies the row-normalisation VJP g = (g_dhat - Dj <g_dhat, Dj>) / |d|
// and either writes g (K3) or runs the Adam epilogue in place on the raw
// encoder and its moments (K2; the caller's tensors are updated in place, as
// the TPU kernel aliases them).
//
// What bounds it on the card: 3 GEMMs, 206 GFLOP at M=8, B=2048, N=4096,
// D=512 against ~490 MB of traffic, so it is compute-bound; on the TopK path
// (M=7, N=12288, D=768) the code holds ~k of N entries per row, so the work
// its data needs is small and the ~2 GB of dictionary, moments and code it
// must move bound it. The TPU kernel
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
// gradient GEMMs, behind dc and the mask, while dxh and c load a tile ahead. The bias-gradient sums run in a fixed
// order per column, so results are the same from run to run. No wgmma/TMA
// yet: that is later work.
//
// Rounding points follow the Pallas code: Dj = bf16(d_raw / |d|) (K2) or the
// caller's bf16 rows (K3); the epilogue uses __f*_rn intrinsics so no
// multiply-add is contracted, matching the plain PyTorch version bit for bit
// given the same g. bf16 mu: b1 is rounded to bf16 and b1 * mu is rounded to
// bf16 before the f32 add (optax's weak-typed update_moment).

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

// Shared-memory row strides, padded 16 bytes (8 bf16 / 4 f32) past a
// multiple of 128 so the 16 rows of a WMMA fragment spread over the banks.
__host__ __device__ constexpr int ld_bf16(int cols) { return cols + 8; }
__host__ __device__ constexpr int ld_f32(int cols) { return cols + 4; }

// One block's shared memory, in bytes: the dictionary tile; then a region
// used by the batch loop (two stages of x/dxh/c tiles — x in a single buffer
// of its own with split_x — so the next tile loads while this one computes,
// plus the dc buffers: one f32 slice per depth part and the bf16 copy) and
// afterwards by the f32 gradient tile; then the radial sums.
struct Plan {
  int tb;  // batch rows per stage
  size_t dj, stage, xbuf, loop, g, total;
};

Plan make_plan(int D, int Nt, int tb, int parts, bool split_x) {
  Plan p;
  p.tb = tb;
  p.dj = (size_t)Nt * ld_bf16(D) * sizeof(bf16);
  p.stage = (size_t)tb * ((split_x ? 1 : 2) * ld_bf16(D) + ld_bf16(Nt)) * sizeof(bf16);
  p.xbuf = split_x ? (size_t)tb * ld_bf16(D) * sizeof(bf16) : 0;
  p.loop = 2 * p.stage + p.xbuf + (size_t)tb * ld_bf16(Nt) * sizeof(bf16) +
           (size_t)parts * tb * ld_f32(Nt) * sizeof(float);
  p.g = (size_t)Nt * ld_f32(D) * sizeof(float);
  p.total = p.dj + (p.loop > p.g ? p.loop : p.g) + (size_t)Nt * sizeof(float);
  return p;
}

// 32-row stages where they fit (every D but 1024), else 16-row stages
Plan choose_plan(int D, int Nt, int parts, bool split_x) {
  const Plan p = make_plan(D, Nt, 32, parts, split_x);
  return p.total <= kMaxSmem ? p : make_plan(D, Nt, 16, parts, split_x);
}

template <bool kAdam, bool kMuBf16, int kCols>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(
    const bf16* __restrict__ x,       // [B, D]
    const bf16* __restrict__ dxh,     // [M, B, D]
    const bf16* __restrict__ c,       // [M, B, N]
    const float* __restrict__ nrm,    // [M, N]
    const bf16* __restrict__ dhat_b,  // [M, N, D] (K3)
    float* __restrict__ d_raw,        // [M, N, D] (K2, in place)
    void* __restrict__ mu_v,          // [M, N, D] f32 or bf16 (K2, in place)
    float* __restrict__ nu,           // [M, N, D] (K2, in place)
    float* __restrict__ g_enc,        // [M, N, D] (K3)
    float* __restrict__ g_bias,       // [M, N]
    const float* __restrict__ l1_over_b,  // [M]
    const float* __restrict__ bc,     // [M, 2] bias corrections (K2)
    float lr, float b1, float b2, float eps, float omb1, float omb2,
    int B, int N, int D, int Nt, Plan pl) {
  constexpr int kTileElems = kElemsPerCol * kCols;  // Nt * D
  constexpr int kParts = kCols == 3 ? 4 : 2;          // depth slices of dc
  constexpr bool kSplitX = kCols == 3;                // x single-buffered (D = 768)
  extern __shared__ __align__(128) unsigned char smem[];
  const int tb = pl.tb;
  const int ldD = ld_bf16(D), ldN = ld_bf16(Nt), ldDf = ld_f32(D), ldNf = ld_f32(Nt);
  bf16* dj_s = reinterpret_cast<bf16*>(smem);                 // [Nt][ldD]
  unsigned char* u = smem + pl.dj;                            // loop region / gradient tile
  bf16* x1_s = reinterpret_cast<bf16*>(u + 2 * pl.stage);     // [tb][ldD], kSplitX only
  bf16* dcb_s = reinterpret_cast<bf16*>(u + 2 * pl.stage + pl.xbuf);  // [tb][ldN]
  float* dcf_s = reinterpret_cast<float*>(dcb_s + tb * ldN);  // [kParts][tb][ldNf], one per depth slice
  float* g_s = reinterpret_cast<float*>(u);                   // [Nt][ldDf], after the batch loop
  float* radial_s = reinterpret_cast<float*>(u + (pl.loop > pl.g ? pl.loop : pl.g));  // [Nt]
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
  const float l1b = l1_over_b[m];
  const bf16* dxh_m = dxh + (size_t)m * B * D;
  const bf16* c_m = c + (size_t)m * B * N;

  // copies of batch tile b0 into stage st (x too, unless kSplitX), 16 bytes
  // per cp.async
  auto issue = [&](int st, int b0) {
    bf16* ds = dxh_st(st);
    bf16* cs = ds + tb * ldD;
    for (int idx = tid * 8; idx < tb * D; idx += kThreads * 8) {
      const int so = (idx / D) * ldD + idx % D;
      if constexpr (!kSplitX) __pipeline_memcpy_async(x_st(st) + so, x + (size_t)b0 * D + idx, 16);
      __pipeline_memcpy_async(ds + so, dxh_m + (size_t)b0 * D + idx, 16);
    }
    for (int idx = tid * 8; idx < tb * Nt; idx += kThreads * 8) {
      const int r = idx / Nt, j = idx % Nt;
      __pipeline_memcpy_async(cs + r * ldN + j, c_m + (size_t)(b0 + r) * N + n0 + j, 16);
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
      const float4 v = *reinterpret_cast<const float4*>(d_raw + row0 * D + idx);
      const float nr = nrm[row0 + r];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(dj_s + r * ldD + d);
      dst[0] = __floats2bfloat162_rn(__fdiv_rn(v.x, nr), __fdiv_rn(v.y, nr));
      dst[1] = __floats2bfloat162_rn(__fdiv_rn(v.z, nr), __fdiv_rn(v.w, nr));
    }
  } else {
    for (int idx = tid * 8; idx < kTileElems; idx += kThreads * 8)
      *reinterpret_cast<uint4*>(dj_s + (idx / D) * ldD + idx % D) =
          *reinterpret_cast<const uint4*>(dhat_b + row0 * D + idx);
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
    // this thread's dxh and c copies of tile t have landed (x may not, with kSplitX)
    __pipeline_wait_prior(kSplitX ? 2 : 1);
    __syncthreads();  // ... and everyone's (and dj_s is written)
    const bf16* xs = x_st(st);
    const bf16* ds = dxh_st(st);
    const bf16* cs = ds + tb * ldD;

    // dc = dxh . Dj^T ([tb, Nt]): each fragment's depth D split into
    // kParts slices, so all 16 warps work
    for (int item = warp; item < kParts * dc_frags; item += kWarps) {
      const int h = item / dc_frags, f = item % dc_frags;
      const int r = f / (Nt / 16), cn = f % (Nt / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc;
      wmma::fill_fragment(dacc, 0.f);
      for (int k = h * depth; k < (h + 1) * depth; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, ds + r * 16 * ldD + k, ldD);
        wmma::load_matrix_sync(b, dj_s + cn * 16 * ldD + k, ldD);
        wmma::mma_sync(dacc, a, b, dacc);
      }
      wmma::store_matrix_sync(dcf_s + h * tb * ldNf + r * 16 * ldNf + cn * 16, dacc, ldNf,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // relu mask on the stored code, l1 term, bf16 copy for the GEMM; the
    // masked f32 dc goes back into slice 0
    for (int idx = tid; idx < tb * Nt; idx += kThreads) {
      const int r = idx / Nt, j = idx % Nt;
      float dc = dcf_s[r * ldNf + j];
#pragma unroll
      for (int h = 1; h < kParts; ++h) dc = __fadd_rn(dc, dcf_s[h * tb * ldNf + r * ldNf + j]);
      const float v = __bfloat162float(cs[r * ldN + j]) > 0.f ? __fadd_rn(dc, l1b) : 0.f;
      dcf_s[r * ldNf + j] = v;
      dcb_s[r * ldN + j] = __float2bfloat16_rn(v);
    }
    if constexpr (kSplitX) __pipeline_wait_prior(1);  // tile t's x has landed
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
  if (tid < Nt) g_bias[row0 + tid] = __fadd_rn(__fadd_rn(gb[0], gb[1]), __fadd_rn(gb[2], gb[3]));
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
  if constexpr (kAdam) {
    bc1 = bc[2 * m];
    bc2 = bc[2 * m + 1];
    b1_bf = __bfloat162float(__float2bfloat16_rn(b1));
  }
  // the VJP and the Adam epilogue, four consecutive elements of one row per
  // step (16-byte loads and stores); per element the arithmetic follows
  // `_adam_epilogue` term for term
#pragma unroll 2
  for (int idx = tid * 4; idx < kTileElems; idx += kThreads * 4) {
    const int r = idx / D, d = idx % D;
    const size_t o = row0 * D + idx;
    const float rad = radial_s[r], nr = nrm[row0 + r];
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float djf = __bfloat162float(dj_s[r * ldD + d + e]);
      g[e] = __fdiv_rn(__fsub_rn(g_s[r * ldDf + d + e], __fmul_rn(djf, rad)), nr);
    }
    if constexpr (!kAdam) {
      *reinterpret_cast<float4*>(g_enc + o) = make_float4(g[0], g[1], g[2], g[3]);
      continue;
    }
    const float4 dr4 = *reinterpret_cast<const float4*>(d_raw + o);
    const float4 nv4 = *reinterpret_cast<const float4*>(nu + o);
    float dr[4] = {dr4.x, dr4.y, dr4.z, dr4.w};
    float nv[4] = {nv4.x, nv4.y, nv4.z, nv4.w};
    float mu_prev[4];
    if constexpr (kMuBf16) {
      const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<bf16*>(mu_v) + o);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      mu_prev[0] = __low2float(lo);
      mu_prev[1] = __high2float(lo);
      mu_prev[2] = __low2float(hi);
      mu_prev[3] = __high2float(hi);
    } else {
      const float4 mv = *reinterpret_cast<const float4*>(static_cast<float*>(mu_v) + o);
      mu_prev[0] = mv.x;
      mu_prev[1] = mv.y;
      mu_prev[2] = mv.z;
      mu_prev[3] = mv.w;
    }
    float mu_new[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kMuBf16) {
        const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(b1_bf, mu_prev[e])));
        mu_new[e] = __fadd_rn(p, __fmul_rn(omb1, g[e]));
      } else {
        mu_new[e] = __fadd_rn(__fmul_rn(b1, mu_prev[e]), __fmul_rn(omb1, g[e]));
      }
      nv[e] = __fadd_rn(__fmul_rn(b2, nv[e]), __fmul_rn(__fmul_rn(omb2, g[e]), g[e]));
      const float mhat = __fdiv_rn(mu_new[e], bc1);
      const float vhat = __fdiv_rn(nv[e], bc2);
      const float upd = __fdiv_rn(__fmul_rn(lr, mhat), __fadd_rn(__fsqrt_rn(vhat), eps));
      dr[e] = __fsub_rn(dr[e], upd);
    }
    *reinterpret_cast<float4*>(d_raw + o) = make_float4(dr[0], dr[1], dr[2], dr[3]);
    *reinterpret_cast<float4*>(nu + o) = make_float4(nv[0], nv[1], nv[2], nv[3]);
    if constexpr (kMuBf16) {
      uint2 raw;
      *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(mu_new[0], mu_new[1]);
      *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(mu_new[2], mu_new[3]);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(mu_v) + o) = raw;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(mu_v) + o) =
          make_float4(mu_new[0], mu_new[1], mu_new[2], mu_new[3]);
    }
  }
}

template <bool kAdam, bool kMuBf16, int kCols>
int launch_cols(const void* x, const void* dxh, const void* c, const void* nrm,
                const void* dhat_b, void* d_raw, void* mu, void* nu, void* g_enc, void* g_bias,
                const void* l1b, const void* bc, float lr, float b1, float b2, float eps,
                float omb1, float omb2, int M, int B, int N, int D, cudaStream_t st) {
  constexpr int tile = kElemsPerCol * kCols;
  if (D % (16 * kCols) || tile % D || (tile / D) % 32) return (int)cudaErrorInvalidValue;
  const int Nt = tile / D;
  constexpr int kParts = kCols == 3 ? 4 : 2;
  const Plan p = choose_plan(D, Nt, kParts, kCols == 3);
  if (p.total > kMaxSmem || B % p.tb || N % Nt || (D / 16) % kParts)
    return (int)cudaErrorInvalidValue;
  auto kern = bwd_kernel<kAdam, kMuBf16, kCols>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(N / Nt, M), kThreads, p.total, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dxh), static_cast<const bf16*>(c),
      static_cast<const float*>(nrm), static_cast<const bf16*>(dhat_b),
      static_cast<float*>(d_raw), mu, static_cast<float*>(nu), static_cast<float*>(g_enc),
      static_cast<float*>(g_bias), static_cast<const float*>(l1b),
      static_cast<const float*>(bc), lr, b1, b2, eps, omb1, omb2, B, N, D, Nt, p);
  return (int)cudaGetLastError();
}

// 3 column blocks a warp where 32768 / D is no multiple of 32 (D = 768)
template <bool kAdam, bool kMuBf16>
int launch(const void* x, const void* dxh, const void* c, const void* nrm, const void* dhat_b,
           void* d_raw, void* mu, void* nu, void* g_enc, void* g_bias, const void* l1b,
           const void* bc, float lr, float b1, float b2, float eps, float omb1, float omb2,
           int M, int B, int N, int D, cudaStream_t st) {
  if (D % 3 == 0)
    return launch_cols<kAdam, kMuBf16, 3>(x, dxh, c, nrm, dhat_b, d_raw, mu, nu, g_enc, g_bias,
                                          l1b, bc, lr, b1, b2, eps, omb1, omb2, M, B, N, D, st);
  return launch_cols<kAdam, kMuBf16, 4>(x, dxh, c, nrm, dhat_b, d_raw, mu, nu, g_enc, g_bias,
                                        l1b, bc, lr, b1, b2, eps, omb1, omb2, M, B, N, D, st);
}

}  // namespace

extern "C" {

// K2. Shapes: x [B, D] bf16, dxh [M, B, D] bf16, c [M, B, N] bf16, nrm [M, N]
// f32, d_raw [M, N, D] f32, mu [M, N, D] f32 (mu_bf16 = 0) or bf16
// (mu_bf16 = 1), nu [M, N, D] f32 — d_raw, mu and nu are updated in place —
// g_bias [M, N] f32 out, l1_over_b [M] f32, bc [M, 2] f32. Needs D in
// {128, 256, 512, 768, 1024}, N % Nt == 0 (Nt = 32768 / D, or 32 at D 768),
// B % 32 == 0 (the Python wrapper checks). Launches on `stream`, does not
// synchronise, returns the CUDA error code (0 on success).
int sc_tied_sae_bwd_adam(const void* x, const void* dxh, const void* c, const void* nrm,
                         void* d_raw, void* mu, int mu_bf16, void* nu, void* g_bias,
                         const void* l1_over_b, const void* bc, float lr, float b1, float b2,
                         float eps, float omb1, float omb2, int M, int B, int N, int D,
                         void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mu_bf16)
    return launch<true, true>(x, dxh, c, nrm, nullptr, d_raw, mu, nu, nullptr, g_bias, l1_over_b,
                              bc, lr, b1, b2, eps, omb1, omb2, M, B, N, D, st);
  return launch<true, false>(x, dxh, c, nrm, nullptr, d_raw, mu, nu, nullptr, g_bias, l1_over_b,
                             bc, lr, b1, b2, eps, omb1, omb2, M, B, N, D, st);
}

// K3. As K2 without Adam: dhat_b [M, N, D] bf16 in, g_enc [M, N, D] f32 and
// g_bias [M, N] f32 out.
int sc_tied_sae_bwd_grads(const void* x, const void* dxh, const void* c, const void* nrm,
                          const void* dhat_b, void* g_enc, void* g_bias, const void* l1_over_b,
                          int M, int B, int N, int D, void* stream) {
  return launch<false, false>(x, dxh, c, nrm, dhat_b, nullptr, nullptr, nullptr, g_enc, g_bias,
                              l1_over_b, nullptr, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, M, B, N, D,
                              reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
