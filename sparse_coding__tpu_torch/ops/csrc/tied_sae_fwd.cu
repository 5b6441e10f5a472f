// K1 `tied_sae_fwd`: the stacked tied-SAE forward pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sparse_coding__tpu/ops/tied_sae_kernel.py::
// _fwd_kernel` (body `_fwd_body`). Per member m:
//   c   = relu(x_b . D_b[m]^T + b[m])        stored bf16, sum(c) from the f32 c
//   x^  = c_b . D_b[m]                       accumulated in f32
//   dxh = bf16(scale * (x^ - f32(x_b)))      scale = 2 / (B * D)
//   sum((x^ - x)^2)
//
// What bounds it on the card: at M=8, B=2048, N=4096, D=512 the two GEMMs are
// 137 GFLOP against ~187 MB of traffic, so it is compute-bound (bf16 tensor
// cores). The TPU kernel keeps a whole 4 MB member dictionary resident in VMEM;
// an SM has 227 KB, so here the forward is two plain tiled GEMMs with their
// epilogues fused in: `encode_kernel` (bias + relu + sum(c), writes c) and
// `decode_kernel` (reads c back, writes dxh and sum(err^2)). Both consume the
// same bf16 c, so the outputs equal a single fused kernel's. Operands go
// through two shared-memory stages (cp.async: the next depth slice loads
// while this one computes) into WMMA bf16 fragments with f32 accumulation.
// Loss partials are written per block and summed afterwards: no float
// atomics, so every run gives the same bits. wgmma/TMA tiling is later work.
//
// K1n `tied_sae_fwd_nocode` replaces `_fwd_kernel_nocode` (the forward of the
// code-recompute step, SC_RECOMPUTE_CODE=1): the same outputs but c, which
// never leaves the chip. One block of 16 warps owns kRows batch rows (64 at
// D <= 512, else 32) and keeps their whole x^ [kRows, D] in f32 WMMA
// accumulators (2 row bands x kCols column blocks a warp), with its x tile
// resident in shared memory; it walks the member's dictionary in tiles of
// kRows rows (double-buffered by cp.async): encode the [kRows, kRows] code
// tile into shared memory (bias, relu, sum(c), bf16), then x^ += c . Dj.
// The whole dictionary streams through every block (from L2: a member's
// 4 MB at config 2), and the encode of a tile runs on (kRows/16)^2 warps (all
// 16 at D <= 512, 4 above) while the rest wait — one encode, no
// recomputation, and c's 2 x 134 MB round trip of K1 saved.
// Bit-equal to K1: the encode uses encode_kernel's fragments and k order from
// k = 0 with the bias added after the product, and each x^ fragment is one
// accumulator carried across the dictionary tiles in N order, as
// decode_kernel's; so c, x^ and dxh are K1's bits. The loss sums group their
// per-block partials differently (a block per kRows rows instead of per
// 64 x 128 tile), so l_rec and l_l1 may differ from K1's in the last bits.

#include "wmma_tile.cuh"

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

// -- K1n ----------------------------------------------------------------------

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
// bf16, dxh [M, B, D] bf16, l1_part [M, B/64, N/128] f32, lrec_part
// [M, B/64, D/128] f32. Needs B % 64 == 0, N % 128 == 0, D % 128 == 0 (the
// Python wrapper checks). Launches on `stream`, does not synchronise, and
// returns the CUDA error code of the launches (0 on success).
int sc_tied_sae_fwd(const void* x, const void* dhat, const void* bias, void* c, void* dxh,
                    void* l1_part, void* lrec_part, int M, int B, int N, int D, float scale,
                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
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
    case 128: return launch_nocode<64, 1>(x, dhat, bias, dxh, lrec_part, l1_part, M, B, N, D, scale, st);
    case 256: return launch_nocode<64, 2>(x, dhat, bias, dxh, lrec_part, l1_part, M, B, N, D, scale, st);
    case 512: return launch_nocode<64, 4>(x, dhat, bias, dxh, lrec_part, l1_part, M, B, N, D, scale, st);
    case 768: return launch_nocode<32, 3>(x, dhat, bias, dxh, lrec_part, l1_part, M, B, N, D, scale, st);
    case 1024: return launch_nocode<32, 4>(x, dhat, bias, dxh, lrec_part, l1_part, M, B, N, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
