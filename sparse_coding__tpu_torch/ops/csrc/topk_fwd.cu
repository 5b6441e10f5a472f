// K_s `topk_scores` and K_d `topk_decode`: the forward of the stacked TopK
// training step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in sparse_coding__tpu/ops/topk_kernel.py:
//   K_s <- `_topk_scores_kernel`: s = bf16(x_b . D_b[m]^T), and per row the
//          exact k[m]-th largest bf16 score t (ties kept), as f32;
//   K_d <- `_topk_decode_kernel`: c = s where (s >= t && s > 0), stored bf16;
//          x^ = c . D_b[m] accumulated in f32 over all N;
//          dxh = bf16(scale * (x^ - f32(x_b))), scale = 2 / (B * D); sum(err^2).
// The backward is K2 / K3 of tied_sae_bwd.cu at l1 = 0, as on the TPU.
//
// What bounds it on the card, at M=7, B=2048, N=12288, D=768: K_s's GEMM is
// 271 GFLOP against ~490 MB of traffic (the 352 MB score tensor written once
// and read back by the select), so it is compute-bound. K_d's code holds ~k
// of N entries a row (0.55% at config 4), so the work its data needs is
// small: its bound is the 704 MB of s in and c out, and the kept rows of D^
// it gathers (~1.5 GB from L2 at config 4) come next. The TPU kernel keeps a
// batch tile's whole score row in VMEM for the select; an SM has 227 KB, so
// K_s is two launches behind one wrapper:
//   `scores_kernel`  a tiled GEMM (K1's encode tiling, wmma_tile.cuh: 64 x
//                    128 tiles, depth 64 in two cp.async stages, WMMA bf16
//                    with f32 sums) that writes s once;
//   `select_kernel`  one block per (member, row): the row's 16-bit ordered
//                    keys (N * 2 bytes) staged in shared memory, then a
//                    two-pass radix select on 8-bit digits — a histogram of
//                    the high byte, the digit where the count from the top
//                    reaches k, then a histogram of the low byte among the
//                    keys with that high byte. The result is the largest key
//                    t with count(key >= t) >= k: the same key as the Pallas
//                    kernel's 16-pass bisection. Shared-memory integer
//                    atomics count exactly, so their order does not matter.
// K_d (`decode_kernel`) is a sparse decode: no dense product. A warp owns a
// (member, row): it streams the score row once in 16-byte loads, masks it
// against the row's threshold (the f32 value of the stored bf16 score, so c
// equals the plain version's bit for bit), writes c, and lists the kept
// columns in ascending order in shared memory (ballot + warp scan). For each
// listed j it gathers the row D^[m, j, :] from L2 (several rows in flight a
// lane) and adds c_j . D^[m, j, :] into f32 registers, in ascending j; then
// dxh and the row's sum(err^2). The grid runs one member's blocks together,
// so its D^ (18.9 MB at config 4) stays in the 50 MB L2. Loss partials go
// to per-row buffers summed afterwards: no float atomics.

#include "wmma_tile.cuh"

using namespace nvcuda;

namespace {

constexpr int kSelThreads = 256;

// bf16 bits -> a key whose unsigned order is the float order (the Pallas
// `_ordered_i32`): negatives flipped, non-negatives above them; and back.
__device__ __forceinline__ uint32_t ordered_key(uint32_t b) {
  return b >= 0x8000u ? 0xFFFFu - b : b + 0x8000u;
}
__device__ __forceinline__ uint32_t unordered_key(uint32_t k) {
  return k >= 0x8000u ? k - 0x8000u : 0xFFFFu - k;
}

// grid (N/kBN, B/kBM, M): s[m, b-tile, n-tile] = bf16(x_b . D_b[m]^T).
__global__ void __launch_bounds__(kThreads) scores_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dhat, bf16* __restrict__ s,
    int B, int N, int D) {
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
  for (int idx = threadIdx.x; idx < kBM * kBN / 2; idx += kThreads) {
    const int r = idx / (kBN / 2), cc = (idx % (kBN / 2)) * 2;
    *reinterpret_cast<__nv_bfloat162*>(s + ((size_t)m * B + b0 + r) * N + n0 + cc) =
        __floats2bfloat162_rn(Cs[r * kLdC + cc], Cs[r * kLdC + cc + 1]);
  }
}

// Warp 0 of a select block: the digit (0..255) where the count of keys in
// the digits from 255 down first reaches `need`, and how many keys of that
// digit are still needed. Lane l sums digits 255 - 8l down to 248 - 8l; an
// inclusive scan over lanes and a ballot find the lane, which walks its 8.
__device__ void find_digit(const int* hist, int need, int* pick) {
  const int lane = threadIdx.x & 31;
  const int top = 255 - 8 * lane;
  int sum = 0;
  for (int j = 0; j < 8; ++j) sum += hist[top - j];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
  if (lane == __ffs(hit) - 1) {
    int above = incl - sum;  // keys in the digits above this lane's
    for (int j = 0; j < 8; ++j) {
      const int h = hist[top - j];
      if (above + h >= need) {
        pick[0] = top - j;
        pick[1] = need - above;
        break;
      }
      above += h;
    }
  }
}

// grid (B, M): thresh[m, b] = f32 of the k[m]-th largest bf16 score of row
// (m, b) of s (k clamped to [1, N]).
__global__ void __launch_bounds__(kSelThreads) select_kernel(
    const bf16* __restrict__ s, const int* __restrict__ k, float* __restrict__ thresh,
    int B, int N) {
  extern __shared__ __align__(16) uint16_t keys[];  // [N]
  __shared__ int hist[256];
  __shared__ int pick[2];
  const int m = blockIdx.y;
  const size_t row = (size_t)m * B + blockIdx.x;
  const uint16_t* src = reinterpret_cast<const uint16_t*>(s) + row * N;
  const int tid = threadIdx.x;
  int need = k[m];
  need = need < 1 ? 1 : (need > N ? N : need);

  for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
  for (int i = tid * 8; i < N; i += kSelThreads * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
    for (int e = 0; e < 4; ++e)
      o[e] = ordered_key(w[e] & 0xFFFFu) | (ordered_key(w[e] >> 16) << 16);
    *reinterpret_cast<uint4*>(keys + i) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();
  for (int i = tid; i < N; i += kSelThreads) atomicAdd(&hist[keys[i] >> 8], 1);
  __syncthreads();
  if (tid < 32) find_digit(hist, need, pick);
  __syncthreads();
  const uint32_t hi = pick[0];
  need = pick[1];
  for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
  __syncthreads();
  for (int i = tid; i < N; i += kSelThreads) {
    const uint32_t key = keys[i];
    if ((key >> 8) == hi) atomicAdd(&hist[key & 0xFFu], 1);
  }
  __syncthreads();
  if (tid < 32) find_digit(hist, need, pick);
  __syncthreads();
  if (tid == 0) {
    const uint32_t bits = unordered_key((hi << 8) | (uint32_t)pick[0]);
    thresh[row] = __uint_as_float(bits << 16);
  }
}

// the TopK mask on one stored bf16 score (bits in the low 16): kept when
// its f32 value is >= the row threshold and > 0 (NaN is dropped)
__device__ __forceinline__ uint32_t keep_or_zero(uint32_t bits, float t) {
  const float f = __uint_as_float(bits << 16);
  return (f >= t && f > 0.f) ? bits : 0u;
}

// K_d's geometry: a warp per (member, batch row); the row's kept columns
// listed in shared memory (at most kList before they are gathered: a longer
// list is walked in pieces, so no kept entry is ever dropped); kScan 16-byte
// score loads and kGather dictionary rows in flight per lane; x^ held in
// registers 256 columns a unit, kUnits units a pass over the list. Three
// blocks an SM (80 registers) with 2 rows in flight a warp ran faster on
// the H100 than two blocks with 4; 3 or 4 rows at three blocks spill.
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kList = 512;
constexpr int kScan = 4;
constexpr int kGather = 2;
constexpr int kMaxUnits = 4;

// grid (B/8, M), the member slowest, so the blocks of one member (whose D^
// L2 holds) run together: c = the masked scores (written on the first pass),
// x^ = sum over the kept j, in ascending j, of c_j . D^[m, j, :] (f32 FMAs),
// dxh = bf16(scale . (x^ - x)) and the row's sum(err^2) in lrec_part[m, b].
template <int kUnits>
__global__ void __launch_bounds__(kDecThreads, 3) decode_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dhat, const bf16* __restrict__ s,
    const float* __restrict__ thresh, bf16* __restrict__ c, bf16* __restrict__ dxh,
    float* __restrict__ lrec_part, float scale, int B, int N, int D) {
  __shared__ int list_j[kDecWarps][kList];
  __shared__ float list_c[kDecWarps][kList];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.y, b = blockIdx.x * kDecWarps + warp;
  const size_t row = (size_t)m * B + b;
  const float t = thresh[row];
  const uint4* src = reinterpret_cast<const uint4*>(s + row * N);
  uint4* dst = reinterpret_cast<uint4*>(c + row * N);
  const bf16* dm = dhat + (size_t)m * N * D;
  int* lj = list_j[warp];
  float* lc = list_c[warp];
  float sq = 0.f;

  for (int d0 = 0; d0 < D; d0 += 256 * kUnits) {
    float acc[kUnits][8];
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[u][e] = 0.f;

    // x^ += c_j . D^[j, d0 ..] over the first `cnt` listed entries, in list
    // order; kGather rows' loads are issued before their products
    auto gather = [&](int cnt) {
      __syncwarp();  // the list's entries are written
      for (int e0 = 0; e0 < cnt; e0 += kGather) {
        uint4 w[kGather][kUnits];
        float cv[kGather];
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          cv[g] = 0.f;
          if (e0 + g < cnt) {
            cv[g] = lc[e0 + g];
            const bf16* rp = dm + (size_t)lj[e0 + g] * D + d0 + lane * 8;
#pragma unroll
            for (int u = 0; u < kUnits; ++u)
              if (d0 + u * 256 + lane * 8 < D) w[g][u] = __ldg(reinterpret_cast<const uint4*>(rp + u * 256));
          }
        }
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          if (e0 + g >= cnt) break;
#pragma unroll
          for (int u = 0; u < kUnits; ++u) {
            if (d0 + u * 256 + lane * 8 >= D) break;
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w[g][u]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 f = __bfloat1622float2(h[q]);
              acc[u][2 * q] = __fmaf_rn(cv[g], f.x, acc[u][2 * q]);
              acc[u][2 * q + 1] = __fmaf_rn(cv[g], f.y, acc[u][2 * q + 1]);
            }
          }
        }
      }
      __syncwarp();  // the list may be refilled
    };

    // stream the score row once: mask, store c, list the kept columns in
    // ascending order (lane l holds columns 8l .. 8l + 7 of a 256-column
    // piece; a ballot skips pieces with nothing kept, a warp scan places the
    // rest)
    int cnt = 0;
    for (int i0 = 0; i0 < N; i0 += 256 * kScan) {
      uint4 v[kScan];
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int col = i0 + u * 256 + lane * 8;
        v[u] = col < N ? src[col / 8] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int col = i0 + u * 256 + lane * 8;
        uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        uint32_t keep = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo = keep_or_zero(w[e] & 0xFFFFu, t), hi = keep_or_zero(w[e] >> 16, t);
          keep |= (lo != 0u ? 1u : 0u) << (2 * e) | (hi != 0u ? 1u : 0u) << (2 * e + 1);
          w[e] = lo | (hi << 16);
        }
        if (d0 == 0 && col < N) dst[col / 8] = make_uint4(w[0], w[1], w[2], w[3]);
        if (!__ballot_sync(0xffffffffu, keep != 0u)) continue;
        const int n = __popc(keep);
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        const int total = __shfl_sync(0xffffffffu, incl, 31);
        if (cnt + total > kList) {
          gather(cnt);
          cnt = 0;
        }
        int pos = cnt + incl - n;
        while (keep) {
          const int e = __ffs(keep) - 1;
          keep &= keep - 1u;
          lj[pos] = col + e;
          lc[pos] = __uint_as_float(((w[e >> 1] >> (16 * (e & 1))) & 0xFFFFu) << 16);
          ++pos;
        }
        cnt += total;
      }
    }
    gather(cnt);

    // dxh and sum(err^2) of this pass's columns
    const bf16* xr = x + (size_t)b * D;
    bf16* dr = dxh + row * D;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int col = d0 + u * 256 + lane * 8;
      if (col >= D) break;
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + col);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xf = __bfloat1622float2(xh[q]);
        const float e0 = __fsub_rn(acc[u][2 * q], xf.x), e1 = __fsub_rn(acc[u][2 * q + 1], xf.y);
        sq = __fadd_rn(sq, __fmul_rn(e0, e0));
        sq = __fadd_rn(sq, __fmul_rn(e1, e1));
        const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(scale, e0), __fmul_rn(scale, e1));
        o[q] = *reinterpret_cast<const uint32_t*>(&r);
      }
      *reinterpret_cast<uint4*>(dr + col) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, o);
  if (lane == 0) lrec_part[row] = sq;
}

template <int kUnits>
int launch_decode(const void* x, const void* dhat, const void* s, const void* thresh, void* c, void* dxh,
                  void* lrec_part, int M, int B, int N, int D, float scale, cudaStream_t st) {
  decode_kernel<kUnits><<<dim3(B / kDecWarps, M), kDecThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dhat), static_cast<const bf16*>(s),
      static_cast<const float*>(thresh), static_cast<bf16*>(c), static_cast<bf16*>(dxh),
      static_cast<float*>(lrec_part), scale, B, N, D);
  return (int)cudaGetLastError();
}

// the tiling; a row of keys too large for shared memory is refused by
// cudaFuncSetAttribute at launch
bool shapes_ok(int B, int N, int D) { return B % kBM == 0 && N % kBN == 0 && D % kBN == 0; }

}  // namespace

extern "C" {

// K_s. Shapes: x [B, D] bf16, dhat [M, N, D] bf16, k [M] int32; outputs
// s [M, B, N] bf16, thresh [M, B] f32. Needs B % 64 == 0, N % 128 == 0,
// D % 128 == 0 and N * 2 bytes of shared memory for one row (the Python
// wrapper checks). Launches on `stream`, does not synchronise, and returns
// the CUDA error code of the launches (0 on success).
int sc_topk_scores(const void* x, const void* dhat, const void* k, void* s, void* thresh, int M,
                   int B, int N, int D, void* stream) {
  if (!shapes_ok(B, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const size_t sel_smem = (size_t)N * sizeof(uint16_t);
  e = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sel_smem);
  if (e != cudaSuccess) return (int)e;
  scores_kernel<<<dim3(N / kBN, B / kBM, M), kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dhat), static_cast<bf16*>(s), B, N,
      D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  select_kernel<<<dim3(B, M), kSelThreads, sel_smem, st>>>(
      static_cast<const bf16*>(s), static_cast<const int*>(k), static_cast<float*>(thresh), B, N);
  return (int)cudaGetLastError();
}

// K_d. Shapes: x [B, D] bf16, dhat [M, N, D] bf16, s [M, B, N] bf16, thresh
// [M, B] f32; outputs c [M, B, N] bf16, dxh [M, B, D] bf16, lrec_part
// [M, B] f32 (each row's sum(err^2)). Same shape needs as K_s, without its
// shared-memory row.
int sc_topk_decode(const void* x, const void* dhat, const void* s, const void* thresh, void* c,
                   void* dxh, void* lrec_part, int M, int B, int N, int D, float scale,
                   void* stream) {
  if (!shapes_ok(B, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch ((D < 256 * kMaxUnits ? D + 255 : 256 * kMaxUnits) / 256) {
    case 1: return launch_decode<1>(x, dhat, s, thresh, c, dxh, lrec_part, M, B, N, D, scale, st);
    case 2: return launch_decode<2>(x, dhat, s, thresh, c, dxh, lrec_part, M, B, N, D, scale, st);
    case 3: return launch_decode<3>(x, dhat, s, thresh, c, dxh, lrec_part, M, B, N, D, scale, st);
    default: return launch_decode<4>(x, dhat, s, thresh, c, dxh, lrec_part, M, B, N, D, scale, st);
  }
}

}  // extern "C"
