// K1 `tied_sae_fwd` and K1n `tied_sae_fwd_nocode`: the stacked tied-SAE
// forward pass, for Hopper (sm_90a).
//
// K1 replaces the Pallas TPU kernel `sparse_coding__tpu/ops/tied_sae_kernel.py::
// _fwd_kernel` (body `_fwd_body`). Per member m:
//   c   = relu(x_b . D_b[m]^T + b[m])        stored bf16, sum(c) from the f32 c
//   x^  = c_b . D_b[m]                       accumulated in f32
//   dxh = bf16(scale * (x^ - f32(x_b)))      scale = 2 / (B * D)
//   sum((x^ - x)^2)
// K1n replaces `_fwd_kernel_nocode` (the forward of the code-recompute step,
// SC_RECOMPUTE_CODE=1): the same outputs but c, which never leaves the chip.
//
// What bounds them on the card: operations. At BASELINE config 2 (M 8,
// B 2048, N 4096, D 512) the encode is 69 GFLOP and the decode 34 GFLOP over
// the code's non-zeros (half of them), against ~190 MB of inputs and outputs
// (K1: 134 MB of them the code): ~0.10 ms at the bf16 tensor-core rate. The
// TPU kernel keeps a whole 4 MB member dictionary in VMEM; an SM has 227 KB.
//
// Design at D 128, 256 and 512 (`pp_fwd_kernel<kD, kStoreCode>`, below, K1
// with kStoreCode): a block of 64 batch rows keeps its x tile in shared
// memory and its x^ [64, D] in the f32 `wgmma` accumulators of two
// warpgroups, while TMA streams the member's dictionary (from L2) through a
// ring of 64-row stages against mbarriers; each warpgroup's half of a code
// tile leaves the encode's accumulators as the decode's register A operand
// (bf16 packing only), trading halves warp by warp with the other
// warpgroup, so no barrier of the whole block runs in the loop and the code
// never makes a round trip through device memory. K1 stores each
// warpgroup's half of the code tile while the decode's products run: a
// rotation in each quad of threads turns the fragments' 4-byte pieces into
// one 16-byte store a row. At D 768 and 1024, which no tied path runs, K1
// keeps its first design, two WMMA launches (`encode_kernel`: bias + relu +
// sum(c), writes c; `decode_kernel`: reads c back, writes dxh and
// sum(err^2)) over two cp.async stages, and K1n one block of 16 warps a 32
// rows (`nocode_kernel`) walking the dictionary in 32-row tiles.
// Bits: the encode runs, per output element, one f32 chain of k16 steps over
// the depth from k = 0 with the bias added after the product, and each x^
// element is one accumulator carried across the dictionary in k16 steps in
// N order. A `wgmma` k16 chain gives the bits of an `mma.sync` m16n8k16
// chain on the same operands (WMMA 16 x 16 x 16 is two of those), so c, x^
// and dxh are the same bits on every route, and K2's rebuild of the code
// (`tied_sae_bwd.cuh`, `mma.sync`) reproduces K1's c. Loss sums are per-block
// partials summed by the wrapper (no float atomics: the same bits every
// run); they group per 64-row block on the pipelined kernel and per output
// tile on the WMMA ones, so l_rec and l_l1 may differ between the two in
// the last bits.

#include "wmma_tile.cuh"
#include "sm90.cuh"

using namespace nvcuda;

namespace {

// jnp.maximum(v, 0) keeps NaN; fmaxf would not.
__device__ __forceinline__ float relu_keep_nan(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

// grid (N/kBN, B/kBM, M): c[m, b-tile, n-tile] and its sum.
__global__ void __launch_bounds__(kThreads) encode_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dhat,
    const float* __restrict__ bias, bf16* __restrict__ c,
    float* __restrict__ l1_part, int B, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);  // [kBM][kLdC], after the loop
  const int m = blockIdx.z, b0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, wm = warp / 4, wn = warp % 4;
  const bf16* dm = dhat + (size_t)m * N * D;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // stage st: x tile [kBM][kLdK], then the dict tile [kBN][kLdK]
  auto load = [&](int st, int k0) {
    load_tile_k64(stage_a(smem, st), x + (size_t)b0 * D + k0, kBM, D);
    load_tile_k64(stage_a(smem, st) + kBM * kLdK, dm + (size_t)n0 * D + k0, kBN, D);
  };
  load(0, 0);
  __pipeline_commit();
  const int nk = D / kBK;
  for (int ks = 0; ks < nk; ++ks) {
    if (ks + 1 < nk) load((ks + 1) & 1, (ks + 1) * kBK);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const bf16* As = stage_a(smem, ks & 1);
    const bf16* Bs = As + kBM * kLdK;
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLdK + kk, kLdK);
      // D^T as a col-major [k, n] operand: element (k, n) is Bs[n * kLdK + k]
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * kLdK + kk, kLdK);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  __pipeline_wait_prior(0);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  const float* bm = bias + (size_t)m * N + n0;
  float s = 0.f;
  for (int idx = threadIdx.x; idx < kBM * kBN / 2; idx += kThreads) {
    const int r = idx / (kBN / 2), cc = (idx % (kBN / 2)) * 2;
    const float v0 = relu_keep_nan(__fadd_rn(Cs[r * kLdC + cc], bm[cc]));
    const float v1 = relu_keep_nan(__fadd_rn(Cs[r * kLdC + cc + 1], bm[cc + 1]));
    s = __fadd_rn(s, v0);
    s = __fadd_rn(s, v1);
    *reinterpret_cast<__nv_bfloat162*>(c + ((size_t)m * B + b0 + r) * N + n0 + cc) =
        __floats2bfloat162_rn(v0, v1);
  }
  const float tot = block_sum(s);
  if (threadIdx.x == 0)
    l1_part[((size_t)m * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = tot;
}

// grid (D/kBN, B/kBM, M): x^ tile = c_b . D_b over all N, then dxh and sum(err^2).
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dhat,
    const bf16* __restrict__ c, bf16* __restrict__ dxh,
    float* __restrict__ lrec_part, float scale, int B, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);  // [kBM][kLdC], after the loop
  const int m = blockIdx.z, b0 = blockIdx.y * kBM, d0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, wm = warp / 4, wn = warp % 4;
  const bf16* dm = dhat + (size_t)m * N * D;
  const bf16* cm = c + (size_t)m * B * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // stage st: c tile [kBM][kLdK], then the dict tile [kBK][kLdN]
  auto load = [&](int st, int k0) {
    load_tile_k64(stage_a(smem, st), cm + (size_t)b0 * N + k0, kBM, N);
    bf16* bs = stage_a(smem, st) + kBM * kLdK;
    for (int idx = threadIdx.x; idx < kBK * (kBN / 8); idx += kThreads) {
      const int r = idx / (kBN / 8), c8 = (idx % (kBN / 8)) * 8;
      __pipeline_memcpy_async(bs + r * kLdN + c8, dm + (size_t)(k0 + r) * D + d0 + c8, 16);
    }
  };
  load(0, 0);
  __pipeline_commit();
  const int nk = N / kBK;
  for (int ks = 0; ks < nk; ++ks) {
    if (ks + 1 < nk) load((ks + 1) & 1, (ks + 1) * kBK);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const bf16* As = stage_a(smem, ks & 1);
    const bf16* Bs = As + kBM * kLdK;
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLdK + kk, kLdK);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdN + wn * 32 + j * 16, kLdN);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  __pipeline_wait_prior(0);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  float s = 0.f;
  for (int idx = threadIdx.x; idx < kBM * kBN / 2; idx += kThreads) {
    const int r = idx / (kBN / 2), cc = (idx % (kBN / 2)) * 2;
    const size_t o = (size_t)(b0 + r) * D + d0 + cc;
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + o);
    const float e0 = __fsub_rn(Cs[r * kLdC + cc], __low2float(xv));
    const float e1 = __fsub_rn(Cs[r * kLdC + cc + 1], __high2float(xv));
    s = __fadd_rn(s, __fmul_rn(e0, e0));
    s = __fadd_rn(s, __fmul_rn(e1, e1));
    *reinterpret_cast<__nv_bfloat162*>(dxh + (size_t)m * B * D + o) =
        __floats2bfloat162_rn(__fmul_rn(scale, e0), __fmul_rn(scale, e1));
  }
  const float tot = block_sum(s);
  if (threadIdx.x == 0)
    lrec_part[((size_t)m * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = tot;
}

// -- K1n at D 768 and 1024 --------------------------------------------------------

constexpr int kNcThreads = 512;  // 16 warps
constexpr int kNcWarps = kNcThreads / 32;

// Deterministic block sum over kNcThreads threads (as block_sum). Valid in
// thread 0 only.
__device__ float block_sum_nc(float v) {
  __shared__ float red[kNcWarps];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kNcWarps; ++i) t += red[i];
  return t;
}

// K1n's shared memory: x [kRows][D+8], two dictionary stages [kRows][D+8]
// (after the loop: x^ [kRows][D+4] f32), the f32 pre-activation [kRows][kRows+4]
// and the bf16 code tile [kRows][kRows+8].
__host__ __device__ constexpr size_t nocode_smem(int rows, int D) {
  return (size_t)rows * (D + 8) * 2 * 3 + (size_t)rows * (rows + 4) * 4 + (size_t)rows * (rows + 8) * 2;
}

// grid (B/kRows, M): dxh and the loss partials of kRows batch rows.
template <int kRows, int kCols>
__global__ void __launch_bounds__(kNcThreads, 1) nocode_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dhat, const float* __restrict__ bias,
    bf16* __restrict__ dxh, float* __restrict__ lrec_part, float* __restrict__ l1_part,
    float scale, int B, int N, int D) {
  constexpr int kNt = kRows;  // dictionary rows per tile
  constexpr int kLdP = kNt + 4, kLdC = kNt + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldD = D + 8, ldX = D + 4;
  bf16* xs = reinterpret_cast<bf16*>(smem);                     // [kRows][ldD]
  bf16* dst0 = xs + kRows * ldD;                                // 2 x [kNt][ldD]
  float* pre = reinterpret_cast<float*>(dst0 + 2 * kNt * ldD);  // [kRows][kLdP]
  bf16* cb = reinterpret_cast<bf16*>(pre + kRows * kLdP);       // [kRows][kLdC]
  float* xh = reinterpret_cast<float*>(dst0);                   // [kRows][ldX], after the loop
  const int m = blockIdx.y, b0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bf16* dm = dhat + (size_t)m * N * D;
  const float* bm = bias + (size_t)m * N;

  auto load_dict = [&](int st, int n0) {
    bf16* ds = dst0 + st * kNt * ldD;
    for (int idx = tid * 8; idx < kNt * D; idx += kNcThreads * 8)
      __pipeline_memcpy_async(ds + (idx / D) * ldD + idx % D, dm + (size_t)n0 * D + idx, 16);
  };
  for (int idx = tid * 8; idx < kRows * D; idx += kNcThreads * 8)
    __pipeline_memcpy_async(xs + (idx / D) * ldD + idx % D, x + (size_t)b0 * D + idx, 16);
  load_dict(0, 0);
  __pipeline_commit();

  // x^ fragments of this warp: row bands 2*rp, 2*rp + 1, column blocks
  // c0 .. c0 + kCols - 1
  constexpr int kColGroups = kNcWarps / (kRows / 32);
  const int rb0 = 2 * (warp / kColGroups), cb0 = kCols * (warp % kColGroups);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kCols];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < kCols; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float l1 = 0.f;
  constexpr int kEncFrags = (kRows / 16) * (kNt / 16);

  const int n_tiles = N / kNt;
  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt + 1 < n_tiles) load_dict((jt + 1) & 1, (jt + 1) * kNt);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const bf16* ds = dst0 + (jt & 1) * kNt * ldD;

    // encode: encode_kernel's fragment, one accumulator from k = 0
    for (int f = warp; f < kEncFrags; f += kNcWarps) {
      const int r = f / (kNt / 16), cn = f % (kNt / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> e;
      wmma::fill_fragment(e, 0.f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, xs + r * 16 * ldD + k, ldD);
        wmma::load_matrix_sync(fb, ds + cn * 16 * ldD + k, ldD);
        wmma::mma_sync(e, fa, fb, e);
      }
      wmma::store_matrix_sync(pre + r * 16 * kLdP + cn * 16, e, kLdP, wmma::mem_row_major);
    }
    __syncthreads();
    const float* bt = bm + (size_t)jt * kNt;
    for (int idx = tid; idx < kRows * kNt; idx += kNcThreads) {
      const int r = idx / kNt, j = idx % kNt;
      const float v = relu_keep_nan(__fadd_rn(pre[r * kLdP + j], bt[j]));
      l1 = __fadd_rn(l1, v);
      cb[r * kLdC + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    // x^ += c . Dj, decode_kernel's fragments in N order
    for (int kk = 0; kk < kNt; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], cb + (rb0 + i) * 16 * kLdC + kk, kLdC);
      for (int j = 0; j < kCols; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, ds + kk * ldD + (cb0 + j) * 16, ldD);
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();  // this stage and the code tile consumed before reuse
  }
  __pipeline_wait_prior(0);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < kCols; ++j)
      wmma::store_matrix_sync(xh + (rb0 + i) * 16 * ldX + (cb0 + j) * 16, acc[i][j], ldX,
                              wmma::mem_row_major);
  __syncthreads();

  // dxh and sum(err^2), as decode_kernel's epilogue
  float s = 0.f;
  for (int idx = tid; idx < kRows * D / 2; idx += kNcThreads) {
    const int r = idx / (D / 2), cc = (idx % (D / 2)) * 2;
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xs + r * ldD + cc);
    const float e0 = __fsub_rn(xh[r * ldX + cc], __low2float(xv));
    const float e1 = __fsub_rn(xh[r * ldX + cc + 1], __high2float(xv));
    s = __fadd_rn(s, __fmul_rn(e0, e0));
    s = __fadd_rn(s, __fmul_rn(e1, e1));
    *reinterpret_cast<__nv_bfloat162*>(dxh + ((size_t)m * B + b0 + r) * D + cc) =
        __floats2bfloat162_rn(__fmul_rn(scale, e0), __fmul_rn(scale, e1));
  }
  const float lrec = block_sum_nc(s);
  __syncthreads();  // thread 0 has read the first sum's partials
  const float l1_tot = block_sum_nc(l1);
  if (tid == 0) {
    lrec_part[(size_t)m * gridDim.x + blockIdx.x] = lrec;
    l1_part[(size_t)m * gridDim.x + blockIdx.x] = l1_tot;
  }
}

// -- K1 and K1n at D 128, 256, 512: a pipelined encode -> decode ---------------

// A block owns kPpRows = 64 batch rows and keeps their x tile resident in
// shared memory; the member's dictionary streams through a ring of 64-row
// stages by TMA (128-byte-swizzled, each landing on a `full` mbarrier; the
// last warp done with a stage refills it, counted in shared memory). Two
// warpgroups each hold x^ for all 64 rows and half the columns in f32
// `wgmma` accumulators (128 registers a thread at D 512; a ninth, producer
// warp would cap every warp at 168 registers, since a quarter of the SM's
// register file serves three warps). Per stage a warpgroup encodes its
// [64 x 32] half of the code tile (m64n32k16, x and Dj from shared memory,
// one f32 chain over the depth from k = 0), adds the bias, applies relu and
// packs bf16: in registers, the A operand of the decode for its 32 code
// columns. Each warp trades its two k16 fragments with the warp of the same
// rows in the other warpgroup (a 64-thread named barrier, double-buffered
// slot), then the warpgroup adds c . Dj into its x^ in the tile's four k16
// steps, in N order (m64nNk16, A from registers, Dj N-major from shared
// memory). A chain of `wgmma` k16 steps gives the bits of a chain of
// `mma.sync` m16n8k16 steps on the same operands (scripts/fwd_probe.py, and
// the cuda tests hold K1n's dxh to the WMMA route's bit for bit at every
// width), so c, x^ and dxh are the first design's. No barrier of the whole
// block runs inside the loop. K1 (kStoreCode) adds the code's store.
constexpr int kPpRows = 64;
constexpr int kPpNt = 64;
constexpr int kPpWarps = 8;
constexpr int kPpThreads = kPpWarps * 32;

template <int kD>
struct PpShape {
  static constexpr int kStages = kD == 512 ? 2 : 4;
  static constexpr uint32_t kPanel = kPpRows * 128;  // bytes of a 64-column panel
  static constexpr uint32_t kX = kPpRows * kD * 2;
  static constexpr uint32_t kStage = kPpNt * kD * 2;
  static constexpr uint32_t kXchg = 2 * 2 * 2 * 128 * 16;  // [slot][warpgroup][k16 step][thread] uint4
  static constexpr int kCols = kD / 2;  // x^ columns of a warpgroup
  static constexpr size_t kSmem = 1024 + kX + kStages * kStage + kXchg + (kStages + 1) * 8 + kStages * 4 + 2 * kPpWarps * 4;
  static_assert(kPpRows == kPpNt, "x and the dictionary stages share one swizzled tile height");
  static_assert(kSmem <= (size_t)SC_MAX_SMEM, "K1n's x tile and stages fit a block");
};

struct PpMaps {
  CUtensorMap x, dhat;
};

// grid (B/kPpRows, M): dxh and the loss partials of kPpRows batch rows;
// with kStoreCode (K1) also their code c [M, B, N] bf16.
template <int kD, bool kStoreCode>
__global__ void __launch_bounds__(kPpThreads, 1) pp_fwd_kernel(
    const __grid_constant__ PpMaps maps, const float* __restrict__ bias, bf16* __restrict__ c,
    bf16* __restrict__ dxh, float* __restrict__ lrec_part, float* __restrict__ l1_part, float scale, int B,
    int N) {
  using S = PpShape<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_s = smem;                                     // [kD/64][kPpRows][128 B]
  unsigned char* stage0 = x_s + S::kX;                           // stage s: [kD/64][kPpNt][128 B]
  uint4* xchg = reinterpret_cast<uint4*>(stage0 + S::kStages * S::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + S::kXchg / 16);  // [stages] the stage has landed
  uint64_t* xbar = full + S::kStages;                                 // the x tile has landed
  int* done = reinterpret_cast<int*>(xbar + 1);                       // [stages] warps done with the stage, ever
  float* sums = reinterpret_cast<float*>(done + S::kStages);          // [2][kPpWarps]
  const int m = blockIdx.y, b0 = blockIdx.x * kPpRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = N / kPpNt;

  // dictionary tile t into stage t % kStages
  auto load_tile = [&](int t) {
    const int s = t % S::kStages;
    sm90::mbar_expect_tx(&full[s], S::kStage);
    for (int p = 0; p < kD / 64; ++p)
      sm90::tma_load(stage0 + s * S::kStage + p * S::kPanel, &maps.dhat, &full[s], p * 64, m * N + t * kPpNt);
  };
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    sm90::mbar_init(xbar, 1);
    sm90::fence_mbar_init();
    sm90::mbar_expect_tx(xbar, S::kX);
    for (int p = 0; p < kD / 64; ++p) sm90::tma_load(x_s + p * S::kPanel, &maps.x, xbar, p * 64, b0);
    for (int t = 0; t < S::kStages && t < n_tiles; ++t) load_tile(t);
  }
  __syncthreads();

  const int wg = tid >> 7, wt = tid & 127;             // warpgroup, its thread
  const int g = 16 * (wt >> 5) + (lane >> 2), t4 = lane & 3;  // accumulator row, column pair
  const uint32_t xs = sm90::smem_u32(x_s);
  const float* bm = bias + (size_t)m * N + 32 * wg + 2 * t4;

  float acc[S::kCols / 2];  // x^ rows g, g + 8; columns wg*kCols + 8 j + 2 t4 (+1)
#pragma unroll
  for (int i = 0; i < S::kCols / 2; ++i) acc[i] = 0.f;
  float l1 = 0.f;

  sm90::mbar_wait(xbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S::kStages, slot = t & 1;
    const uint32_t ds = sm90::smem_u32(stage0 + s * S::kStage);
    float bv[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(bm + t * kPpNt + 8 * j);
      bv[2 * j] = b2.x, bv[2 * j + 1] = b2.y;
    }
    sm90::mbar_wait(&full[s], (t / S::kStages) & 1);

    // encode: code columns 32 wg .. + 31 of the tile, one chain from k = 0
    float e[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) e[i] = 0.f;
    sm90::fence_regs(e);
    __syncwarp();
    sm90::wg_fence();
#pragma unroll
    for (int k = 0; k < kD; k += 16)
      sm90::wgmma_ss<32, 0, 0>(e, sm90::desc(xs + sm90::swz(0, k, kPpRows), 16, 1024),
                               sm90::desc(ds + sm90::swz(32 * wg, k, kPpNt), 16, 1024));
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(e);

    // bias, relu (NaN kept), sum(c) from the f32 code, bf16: this
    // warpgroup's two k16 A fragments (rows g, g + 8)
    uint32_t af[4][4];  // the tile's four k16 steps; 2 wg, 2 wg + 1 are this warpgroup's
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v[8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          v[4 * h + e4] = relu_keep_nan(__fadd_rn(e[4 * (2 * q + h) + e4], bv[2 * (2 * q + h) + (e4 & 1)]));
          l1 = __fadd_rn(l1, v[4 * h + e4]);
        }
      uint32_t* a = af[2 * wg + q];
      a[0] = sm90::pack_bf16(v[0], v[1]);
      a[1] = sm90::pack_bf16(v[2], v[3]);
      a[2] = sm90::pack_bf16(v[4], v[5]);
      a[3] = sm90::pack_bf16(v[6], v[7]);
      xchg[((slot * 2 + wg) * 2 + q) * 128 + wt] = make_uint4(a[0], a[1], a[2], a[3]);
    }
    sm90::bar_sync(1 + (wt >> 5), 64);  // this warp and the warp of the same rows in the other warpgroup
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 o = xchg[((slot * 2 + (wg ^ 1)) * 2 + q) * 128 + wt];
      uint32_t* a = af[2 * (wg ^ 1) + q];
      a[0] = o.x, a[1] = o.y, a[2] = o.z, a[3] = o.w;
    }

    // decode: x^ += c . Dj, the tile's k16 steps in N order
    sm90::fence_regs(acc);
    sm90::wg_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sm90::wgmma_rs<S::kCols, 1>(acc, af[q], sm90::desc(ds + (wg * S::kCols / 64) * S::kPanel + q * 2048, S::kPanel, 1024));
    sm90::wg_commit();
    if constexpr (kStoreCode) {
      // K1: this warpgroup's half of the code tile, stored while the decode's
      // products run (they only read the fragments). Of rows g and g + 8,
      // thread t4 of a quad holds two columns (2 t4, 2 t4 + 1) of each of
      // the half's four 8-column groups j = 2 q + e (fragment q, registers
      // 2 e + h); a 4 x 4 rotation in the quad (three shuffles) gives it
      // group t4 whole: one 16-byte store a row.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v[4] = {af[2 * wg][h], af[2 * wg][2 + h], af[2 * wg + 1][h], af[2 * wg + 1][2 + h]};
        uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // round r: give lane t4 - r its group, take group t4 from lane t4 + r
          const int give = (t4 - r) & 3, from = (t4 + r) & 3;
          const uint32_t mine = give == 0 ? v[0] : give == 1 ? v[1] : give == 2 ? v[2] : v[3];
          const uint32_t got = r == 0 ? mine : __shfl_sync(0xffffffffu, mine, (lane & ~3) | from);
#pragma unroll
          for (int k = 0; k < 4; ++k) o[k] = from == k ? got : o[k];
        }
        *reinterpret_cast<uint4*>(c + ((size_t)m * B + b0 + g + 8 * h) * N + t * kPpNt + 32 * wg + 8 * t4) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(acc);

    // the last warp done with stage s refills it with tile t + kStages (every
    // warp's products that read it have completed)
    __syncwarp();
    if (lane == 0 && atomicAdd(&done[s], 1) % kPpWarps == kPpWarps - 1 && t + S::kStages < n_tiles) {
      __threadfence_block();
      load_tile(t + S::kStages);
    }
  }

  // dxh and sum(err^2) as decode_kernel's epilogue, x from the resident tile
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < S::kCols / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h, col = wg * S::kCols + 8 * j + 2 * t4;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x_s + sm90::swz(r, col, kPpRows));
      const float e0 = __fsub_rn(acc[4 * j + 2 * h], __low2float(xv));
      const float e1 = __fsub_rn(acc[4 * j + 2 * h + 1], __high2float(xv));
      sq = __fadd_rn(sq, __fmul_rn(e0, e0));
      sq = __fadd_rn(sq, __fmul_rn(e1, e1));
      *reinterpret_cast<__nv_bfloat162*>(dxh + ((size_t)m * B + b0 + r) * kD + col) =
          __floats2bfloat162_rn(__fmul_rn(scale, e0), __fmul_rn(scale, e1));
    }
  // deterministic sums: a fixed shuffle tree a warp, then the warps in order
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_down_sync(0xffffffffu, sq, o);
    l1 += __shfl_down_sync(0xffffffffu, l1, o);
  }
  if (lane == 0) {
    sums[warp] = sq;
    sums[kPpWarps + warp] = l1;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kPpWarps; ++w) {
      a += sums[w];
      b += sums[kPpWarps + w];
    }
    lrec_part[(size_t)m * gridDim.x + blockIdx.x] = a;
    l1_part[(size_t)m * gridDim.x + blockIdx.x] = b;
  }
}

// c: the code's output (K1), or null (K1n)
template <int kD>
int launch_pp(const void* x, const void* dhat, const void* bias, void* c, void* dxh, void* lrec_part,
              void* l1_part, int M, int B, int N, float scale, cudaStream_t st) {
  using S = PpShape<kD>;
  if (B % kPpRows || N % kPpNt) return (int)cudaErrorInvalidValue;
  PpMaps maps{};
  if (!sm90::encode_bf16_2d(&maps.x, x, B, kD, kPpRows) ||
      !sm90::encode_bf16_2d(&maps.dhat, dhat, (uint64_t)M * N, kD, kPpNt))
    return (int)cudaErrorInvalidValue;
  auto kern = c != nullptr ? pp_fwd_kernel<kD, true> : pp_fwd_kernel<kD, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B / kPpRows, M), kPpThreads, S::kSmem, st>>>(
      maps, static_cast<const float*>(bias), static_cast<bf16*>(c), static_cast<bf16*>(dxh),
      static_cast<float*>(lrec_part), static_cast<float*>(l1_part), scale, B, N);
  return (int)cudaGetLastError();
}

template <int kRows, int kCols>
int launch_nocode(const void* x, const void* dhat, const void* bias, void* dxh, void* lrec_part,
                  void* l1_part, int M, int B, int N, int D, float scale, cudaStream_t st) {
  const size_t bytes = nocode_smem(kRows, D);
  if (B % kRows || N % kRows || bytes > (size_t)SC_MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = nocode_kernel<kRows, kCols>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B / kRows, M), kNcThreads, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dhat), static_cast<const float*>(bias),
      static_cast<bf16*>(dxh), static_cast<float*>(lrec_part), static_cast<float*>(l1_part), scale,
      B, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sc_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Shapes: x [B, D] bf16, dhat [M, N, D] bf16, bias [M, N] f32; outputs c [M, B, N]
// bf16, dxh [M, B, D] bf16 and the loss partials: at D 128, 256 and 512
// (the pipelined kernel) l1_part and lrec_part [M, B/64] f32, at 768 and
// 1024 l1_part [M, B/64, N/128] and lrec_part [M, B/64, D/128]. Needs
// B % 64 == 0, N % 128 == 0, D % 128 == 0 (the Python wrapper checks).
// Launches on `stream`, does not synchronise, and returns the CUDA error
// code of the launches (0 on success).
int sc_tied_sae_fwd(const void* x, const void* dhat, const void* bias, void* c, void* dxh,
                    void* l1_part, void* lrec_part, int M, int B, int N, int D, float scale,
                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch_pp<128>(x, dhat, bias, c, dxh, lrec_part, l1_part, M, B, N, scale, st);
    case 256: return launch_pp<256>(x, dhat, bias, c, dxh, lrec_part, l1_part, M, B, N, scale, st);
    case 512: return launch_pp<512>(x, dhat, bias, c, dxh, lrec_part, l1_part, M, B, N, scale, st);
    default: break;
  }
  cudaError_t e = cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  encode_kernel<<<dim3(N / kBN, B / kBM, M), kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dhat),
      static_cast<const float*>(bias), static_cast<bf16*>(c), static_cast<float*>(l1_part), B,
      N, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_kernel<<<dim3(D / kBN, B / kBM, M), kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dhat), static_cast<const bf16*>(c),
      static_cast<bf16*>(dxh), static_cast<float*>(lrec_part), scale, B, N, D);
  return (int)cudaGetLastError();
}

// K1n. As sc_tied_sae_fwd without c: outputs dxh [M, B, D] bf16, lrec_part
// and l1_part [M, B / rows] f32 (rows = 64 at D <= 512, else 32). Needs D in
// {128, 256, 512, 768, 1024}, B and N multiples of rows (the Python wrapper
// checks). Launches on `stream`, does not synchronise, returns the CUDA error
// code (0 on success).
int sc_tied_sae_fwd_nocode(const void* x, const void* dhat, const void* bias, void* dxh,
                           void* lrec_part, void* l1_part, int M, int B, int N, int D, float scale,
                           void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch_pp<128>(x, dhat, bias, nullptr, dxh, lrec_part, l1_part, M, B, N, scale, st);
    case 256: return launch_pp<256>(x, dhat, bias, nullptr, dxh, lrec_part, l1_part, M, B, N, scale, st);
    case 512: return launch_pp<512>(x, dhat, bias, nullptr, dxh, lrec_part, l1_part, M, B, N, scale, st);
    case 768: return launch_nocode<32, 3>(x, dhat, bias, dxh, lrec_part, l1_part, M, B, N, D, scale, st);
    case 1024: return launch_nocode<32, 4>(x, dhat, bias, dxh, lrec_part, l1_part, M, B, N, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
