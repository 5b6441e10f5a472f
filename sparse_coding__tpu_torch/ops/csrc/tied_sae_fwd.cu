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

}  // extern "C"
