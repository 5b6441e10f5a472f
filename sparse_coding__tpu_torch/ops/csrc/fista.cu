// K_f `fista_solve`: the whole FISTA loop of the decoder update, for Hopper
// (sm_90a), every member of a stacked ensemble at once.
//
// Replaces both Pallas TPU kernels in sparse_coding__tpu/ops/fista_pallas.py,
// `_fista_kernel` and `_fista_kernel_hbm_dict`: they compute the same function
// (`_fista_loop`) and differ only in how the TPU's VMEM holds the dictionary.
// For member m, from the warm start a = y = c0, iteration `it` does
//   res = x - y . D[m]                                   (launch 1)
//   y  += eta[m] * (res . D[m]^T)                         (launch 2, then its
//   a'  = max(y - eta[m] * l1[m], 0)                       epilogue on every
//   y   = a' + (a' - a) * mom[it];  a = a'                 element of a and y)
// with mom[it] = (t_k - 1) / t_{k+1} from a float32 table made on the host.
// The epilogue rounds each product and sum on its own (__fmul_rn/__fadd_rn:
// no fused multiply-add), as the plain version does. Shapes: x [B, D],
// D [M, N, D], a, y [M, B, N], res [M, B, D], all f32.
//
// What bounds it on the card: operations. At BASELINE config 3 (M 4, B 2048,
// N 2048, D 512, 500 iterations) the two products are 1.72e13 FLOP against
// ~150 MB of inputs and outputs, and they stay float32 (bf16 operands move
// the codes; TF32 would too), so they run as FMAs on the CUDA cores: 67
// TFLOP/s on an H100 SXM, a bound of ~256 ms per solve.
//
// Design. The TPU kernel keeps one batch tile's codes and the dictionary in
// VMEM for all iterations; a tile's f32 codes twice over do not fit in an
// SM's 227 KB at any useful tile height, and a batch-tile grid would reread
// the dictionary per small tile. So each product is one GEMM-shaped launch
// over (output tile, member), and the iterations follow each other on the
// stream: 2 * num_iter launches behind one C call, no host synchronisation.
// Each launch is a register-tiled f32 GEMM: 128 x 128 output tiles, 256
// threads with 8 x 8 outputs each, depth-8 stages double-buffered in shared
// memory with the next stage prefetched into registers; ragged batch rows
// and dictionary/width edges are masked, not padded. Rows of N and D floats
// that are whole float4s (N % 4 == 0 and D % 4 == 0, as at every BASELINE
// config) move as 16-byte loads and stores (kVec); any other N or D takes
// the same kernels with each float of a 4-wide piece loaded, stored and
// masked on its own, so the products sum in the same order either way.
//
// Early exit (tol > 0), as `models.fista.fista`: one largest |a' - a| per
// member over its whole batch, kept on the device. Each update launch raises
// delta[m][it] by an unsigned atomicMax on the bits of |a' - a| (order-free,
// so deterministic; NaN's bits top every number, so a NaN change stops the
// member as the JAX loop's `delta > thresh` does). Both launches of
// iteration it > 0 skip member m unless delta[m][it-1] > exit_thresh[m];
// a skipped member never writes its slot again, so it stays stopped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // output tile: batch rows x output columns
constexpr int kDepth = 8;      // depth of one shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kTile + 4; // padded stage row (keeps float4 alignment)
constexpr int kHalf = kTile / 2;

struct Stage {
  float a[kDepth][kLd];  // A tile, depth-major
  float b[kDepth][kLd];  // B tile, depth-major
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Four consecutive floats p[0..3] of which the first `valid` exist (zeros
// past them): one 16-byte load with kVec (valid is then 0 or 4), else four.
template <bool kVec>
__device__ __forceinline__ float4 load4_masked(const float* __restrict__ p, int valid) {
  if (kVec) return valid > 0 ? *reinterpret_cast<const float4*>(p) : zero4();
  return make_float4(valid > 0 ? p[0] : 0.f, valid > 1 ? p[1] : 0.f, valid > 2 ? p[2] : 0.f,
                     valid > 3 ? p[3] : 0.f);
}

// A matrix [rows, K] with K contiguous: thread t fetches row t/2, depths
// (t%2)*4 .. +3. With kVec (K % 4 == 0) a float4 is wholly inside or outside.
template <bool kVec>
__device__ __forceinline__ float4 fetch_kmajor(const float* __restrict__ p, int rows, int K, int row0,
                                               int k0, int tid) {
  const int r = row0 + (tid >> 1), k = k0 + (tid & 1) * 4;
  if (r >= rows) return zero4();
  return load4_masked<kVec>(p + (size_t)r * K + k, K - k);
}
__device__ __forceinline__ void store_kmajor(float (*s)[kLd], float4 v, int tid) {
  const int r = tid >> 1, k = (tid & 1) * 4;
  s[k][r] = v.x;
  s[k + 1][r] = v.y;
  s[k + 2][r] = v.z;
  s[k + 3][r] = v.w;
}
// A matrix [K, cols] with cols contiguous: thread t fetches depth t/32,
// columns (t%32)*4 .. +3 (whole float4s with kVec: cols % 4 == 0).
template <bool kVec>
__device__ __forceinline__ float4 fetch_nmajor(const float* __restrict__ p, int cols, int K, int col0,
                                               int k0, int tid) {
  const int k = k0 + (tid >> 5), c = col0 + (tid & 31) * 4;
  if (k >= K) return zero4();
  return load4_masked<kVec>(p + (size_t)k * cols + c, cols - c);
}
__device__ __forceinline__ void store_nmajor(float (*s)[kLd], float4 v, int tid) {
  *reinterpret_cast<float4*>(&s[tid >> 5][(tid & 31) * 4]) = v;
}

// acc = A[row0 + r, :] . Bop[:, col0 + c] over the depth K for this thread's
// rows r = ty*4 + {0..3}, 64 + ty*4 + {0..3} and columns likewise with tx.
// A is [rows, K] (K contiguous). Bop is [K, cols] stored with cols contiguous
// (kBT false) or stored as its transpose [cols, K] with K contiguous (kBT).
template <bool kBT, bool kVec>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A, const float* __restrict__ Bm, int rows,
                                          int cols, int K, int row0, int col0, Stage* st,
                                          float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int stages = (K + kDepth - 1) / kDepth;
  float4 ra = fetch_kmajor<kVec>(A, rows, K, row0, 0, tid);
  float4 rb = kBT ? fetch_kmajor<kVec>(Bm, cols, K, col0, 0, tid) : fetch_nmajor<kVec>(Bm, cols, K, col0, 0, tid);
  store_kmajor(st[0].a, ra, tid);
  if (kBT) store_kmajor(st[0].b, rb, tid); else store_nmajor(st[0].b, rb, tid);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < stages;
    if (more) {
      const int k0 = (s + 1) * kDepth;
      ra = fetch_kmajor<kVec>(A, rows, K, row0, k0, tid);
      rb = kBT ? fetch_kmajor<kVec>(Bm, cols, K, col0, k0, tid) : fetch_nmajor<kVec>(Bm, cols, K, col0, k0, tid);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&st[cur].a[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&st[cur].a[k][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&st[cur].b[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&st[cur].b[k][kHalf + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      // the other stage was last read before the previous barrier
      store_kmajor(st[cur ^ 1].a, ra, tid);
      if (kBT) store_kmajor(st[cur ^ 1].b, rb, tid); else store_nmajor(st[cur ^ 1].b, rb, tid);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int out_row(int row0, int ty, int i) {
  return row0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4);
}

// Whether member m stopped before iteration `it` (tol > 0 only).
__device__ __forceinline__ bool member_done(const uint32_t* __restrict__ delta,
                                            const float* __restrict__ exit_thresh, int m, int it,
                                            int num_iter) {
  return delta != nullptr && it > 0 &&
         !(__uint_as_float(delta[(size_t)m * num_iter + it - 1]) > exit_thresh[m]);
}

// grid (ceil(D/128), ceil(B/128), M): res[m] = x - y[m] . D[m].
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) residual_kernel(
    const float* __restrict__ x, const float* __restrict__ dict, const float* __restrict__ y,
    float* __restrict__ res, const uint32_t* __restrict__ delta, const float* __restrict__ exit_thresh,
    int it, int num_iter, int B, int N, int D) {
  const int m = blockIdx.z;
  if (member_done(delta, exit_thresh, m, it, num_iter)) return;
  __shared__ __align__(16) Stage st[2];
  float acc[8][8];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  gemm_tile<false, kVec>(y + (size_t)m * B * N, dict + (size_t)m * N * D, B, D, N, row0, col0, st, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* r = res + (size_t)m * B * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = out_row(row0, ty, i);
    if (row >= B) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + h * kHalf + tx * 4;
      if (col >= D) continue;
      const size_t off = (size_t)row * D + col;
      if (kVec) {
        const float4 xv = *reinterpret_cast<const float4*>(x + off);
        float4 o;
        o.x = __fsub_rn(xv.x, acc[i][h * 4 + 0]);
        o.y = __fsub_rn(xv.y, acc[i][h * 4 + 1]);
        o.z = __fsub_rn(xv.z, acc[i][h * 4 + 2]);
        o.w = __fsub_rn(xv.w, acc[i][h * 4 + 3]);
        *reinterpret_cast<float4*>(r + off) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) r[off + e] = __fsub_rn(x[off + e], acc[i][h * 4 + e]);
      }
    }
  }
}

// One element's step after G = (res . D^T) is known.
__device__ __forceinline__ void fista_step(float& yv, float& av, float g, float eta, float thr, float mom,
                                           uint32_t& dmax) {
  const float y1 = __fadd_rn(yv, __fmul_rn(eta, g));
  const float v = __fsub_rn(y1, thr);
  const float an = (v > 0.f || v != v) ? v : 0.f;  // max(v, 0), a NaN kept as jnp.maximum keeps it
  const float d = __fsub_rn(an, av);
  dmax = max(dmax, __float_as_uint(fabsf(d)));
  yv = __fadd_rn(an, __fmul_rn(d, mom));
  av = an;
}

// grid (ceil(N/128), ceil(B/128), M): G = res[m] . D[m]^T, then the FISTA
// step on a[m] and y[m] in place; with `delta`, the member's largest |a' - a|.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) update_kernel(
    const float* __restrict__ dict, const float* __restrict__ res, float* __restrict__ a,
    float* __restrict__ y, const float* __restrict__ eta, const float* __restrict__ l1,
    const float* __restrict__ mom, uint32_t* __restrict__ delta, const float* __restrict__ exit_thresh,
    int it, int num_iter, int B, int N, int D) {
  const int m = blockIdx.z;
  if (member_done(delta, exit_thresh, m, it, num_iter)) return;
  __shared__ __align__(16) Stage st[2];
  float acc[8][8];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  gemm_tile<true, kVec>(res + (size_t)m * B * D, dict + (size_t)m * N * D, B, N, D, row0, col0, st, acc);
  const float e = eta[m];
  const float thr = __fmul_rn(e, l1[m]);
  const float mo = mom[it];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* am = a + (size_t)m * B * N;
  float* ym = y + (size_t)m * B * N;
  uint32_t dmax = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = out_row(row0, ty, i);
    if (row >= B) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + h * kHalf + tx * 4;
      if (col >= N) continue;
      const size_t off = (size_t)row * N + col;
      if (kVec) {
        float4 av = *reinterpret_cast<const float4*>(am + off);
        float4 yv = *reinterpret_cast<const float4*>(ym + off);
        fista_step(yv.x, av.x, acc[i][h * 4 + 0], e, thr, mo, dmax);
        fista_step(yv.y, av.y, acc[i][h * 4 + 1], e, thr, mo, dmax);
        fista_step(yv.z, av.z, acc[i][h * 4 + 2], e, thr, mo, dmax);
        fista_step(yv.w, av.w, acc[i][h * 4 + 3], e, thr, mo, dmax);
        *reinterpret_cast<float4*>(am + off) = av;
        *reinterpret_cast<float4*>(ym + off) = yv;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (col + q >= N) break;
          float av = am[off + q], yv = ym[off + q];
          fista_step(yv, av, acc[i][h * 4 + q], e, thr, mo, dmax);
          am[off + q] = av;
          ym[off + q] = yv;
        }
      }
    }
  }
  if (delta != nullptr) {
    dmax = __reduce_max_sync(0xffffffffu, dmax);
    if ((threadIdx.x & 31) == 0) atomicMax(delta + (size_t)m * num_iter + it, dmax);
  }
}

}  // namespace

extern "C" {

// K_f. Inputs: x [B, D], dict [M, N, D], eta [M], l1 [M], mom [num_iter];
// a and y [M, B, N] both hold the warm start and are updated in place (a
// ends as the codes); res [M, B, D] is scratch. With tol > 0 the caller
// passes exit_thresh [M] = tol * eta and delta [M, num_iter] zeroed; with
// tol = 0 both are null and no reduction runs. All f32 except delta (u32),
// contiguous, 16-byte aligned. Takes any N, D >= 1 (16-byte loads where N
// and D are multiples of 4) and ceil(B / 128) <= 65535 (the Python wrapper
// checks). Enqueues 2 * num_iter
// launches on `stream`, does not synchronise, and returns the first CUDA
// error code (0 on success).
int sc_fista_solve(const void* x, const void* dict, const void* eta, const void* l1, const void* mom,
                   const void* exit_thresh, void* delta, void* a, void* y, void* res, int M, int B, int N,
                   int D, int num_iter, void* stream) {
  if (M < 1 || B < 1 || N < 1 || D < 1 || num_iter < 0 ||
      (B + kTile - 1) / kTile > 65535 || M > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const dim3 grid_res((D + kTile - 1) / kTile, (B + kTile - 1) / kTile, M);
  const dim3 grid_upd((N + kTile - 1) / kTile, (B + kTile - 1) / kTile, M);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dict);
  const float* ef = static_cast<const float*>(eta);
  const float* lf = static_cast<const float*>(l1);
  const float* mf = static_cast<const float*>(mom);
  const float* tf = static_cast<const float*>(exit_thresh);
  uint32_t* dl = static_cast<uint32_t*>(delta);
  float* af = static_cast<float*>(a);
  float* yf = static_cast<float*>(y);
  float* rf = static_cast<float*>(res);
  const bool vec = N % 4 == 0 && D % 4 == 0;
  for (int it = 0; it < num_iter; ++it) {
    if (vec) residual_kernel<true><<<grid_res, block, 0, st>>>(xf, df, yf, rf, dl, tf, it, num_iter, B, N, D);
    else residual_kernel<false><<<grid_res, block, 0, st>>>(xf, df, yf, rf, dl, tf, it, num_iter, B, N, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (vec) update_kernel<true><<<grid_upd, block, 0, st>>>(df, rf, af, yf, ef, lf, mf, dl, tf, it, num_iter, B, N, D);
    else update_kernel<false><<<grid_upd, block, 0, st>>>(df, rf, af, yf, ef, lf, mf, dl, tf, it, num_iter, B, N, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
