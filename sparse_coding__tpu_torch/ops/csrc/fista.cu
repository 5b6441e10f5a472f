// K_f `fista_solve`: the whole FISTA loop of the decoder update, for Hopper
// (sm_90a), every member of a stacked ensemble at once, in one launch.
//
// Replaces both Pallas TPU kernels in sparse_coding__tpu/ops/fista_pallas.py,
// `_fista_kernel` and `_fista_kernel_hbm_dict`: they compute the same function
// (`_fista_loop`) and differ only in how the TPU's VMEM holds the dictionary.
// For member m, from the warm start a = y = c0, iteration `it` does
//   res = x - y . D[m]                                   (phase 1)
//   y  += eta[m] * (res . D[m]^T)                         (phase 2, then its
//   a'  = max(y - eta[m] * l1[m], 0)                       epilogue on every
//   y   = a' + (a' - a) * mom[it];  a = a'                 element of a and y)
// with mom[it] = (t_k - 1) / t_{k+1} from a float32 table made on the host.
// The epilogue rounds each product and sum on its own (__fmul_rn/__fadd_rn:
// no fused multiply-add), as the plain version does. The kernel keeps the
// batch fastest: xT [D, B], aT and yT [M, N, B], resT [M, D, B], beside the
// dictionary D [M, N, D] and its transpose Dt [M, D, N], all f32, with B,
// N and D multiples of 4 (the wrapper transposes, and pads other sizes with
// zeros, which changes no sum).
//
// What bounds it on the card: operations, and they must stay float32 FMAs on
// the CUDA cores. At BASELINE config 3 (M 4, B 2048, N 2048, D 512, 500
// iterations) the two products are 1.72e13 FLOP against ~150 MB of inputs
// and outputs: ~256 ms at the H100's 67 TFLOP/s (~189 ms counting only the
// non-zeros of y that the first product meets). Tensor cores do not keep the
// result: bf16 operands move the codes, and so does any other order of the
// float32 sums. After 500 iterations at config 3 the codes are chaotic in the
// last bits: summing each product's depth in two halves, rounding exact
// products once, or 3xTF32 tensor-core splitting each leave the codes within
// 1e-3 of the plain loop but flip the support of ~0.17% of them
// (scripts/fista_probe.py --order-study), above the 0.1% the checks allow. So
// each output is one fmaf chain over the depth from k = 0, as the plain
// loop's cuBLAS product computes it, and the codes are the plain loop's bit
// for bit.
//
// Design. One cooperative launch runs every iteration: a persistent grid (as
// many blocks as the card holds at once, at most the tiles of a phase) walks
// the output tiles of phase 1, meets at a grid barrier, walks those of phase
// 2, and meets again; a block's tiles change from phase to phase, so y, a and
// res live in device memory (read through L2 only: another SM wrote them).
// Each tile is kT x kT outputs (kT 128, 64 or 32: the largest whose phase-1
// tiles fill the card, so small shapes still spread over the SMs), 256
// threads with (kT/16)^2 outputs each. Both products find both operands
// with the depth slowest (yT and D for phase 1, resT and Dt for phase 2),
// so every operand tile moves by 16-byte cp.async.cg straight from L2 into
// two shared-memory stages of kDepth (= 2048 / kT) depths, one landing
// while the other is multiplied, and a thread reads its 8 rows and 8
// columns of a depth as four float4s (kT 128): 64 FMAs for four 16-byte
// shared-memory reads, in registers enough for two blocks an SM. The batch
// rows' thread group varies fastest in a warp, so the transposed epilogues
// move 256 contiguous bytes of a row per warp. At config 3 the FMAs then
// set the pace (scripts/fista_probe.py: without its operand copies K_f
// takes 95% of its time); the first one-launch design staged each stage
// through registers, one in flight, and with 1/8 of its products still took
// 74% of its time, and reading A row-major (float4s over the depth)
// spilled. Edge tiles are
// zero past the rows, columns and depth in the stages, and masked in the
// epilogues.
//
// Early exit (tol > 0), as `models.fista.fista`: one largest |a' - a| per
// member over its whole batch, kept on the device. Phase 2 raises
// delta[m][it] by an unsigned atomicMax on the bits of |a' - a| (order-free,
// so deterministic; NaN's bits top every number, so a NaN change stops the
// member as the JAX loop's `delta > thresh` does). After the grid barrier
// every block reads the same deltas: iteration it > 0 skips member m unless
// delta[m][it-1] > exit_thresh[m] (a skipped member never writes its slot
// again, so it stays stopped), and once every member has stopped all blocks
// leave the loop together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kStages = 2;     // operand stages: one lands while the other is multiplied

template <int kT>
struct Tile {
  static constexpr int kDepth = 2048 / kT;  // depths a stage holds
  static constexpr int kLd = kT + 4;        // a stage row: kT rows or columns (padded, 16-byte aligned)
  static constexpr int kH = kT / 32;        // outputs a thread holds in each half, per axis
  static constexpr int kChunks = kT * kDepth / 4 / kThreads;  // 16-byte copies a thread, per operand
  static constexpr int kStageFloats = 2 * kDepth * kLd;       // A then B, each [kDepth][kLd]
  static constexpr size_t kSmem = (size_t)kStages * kStageFloats * 4;
  static_assert(kChunks * 4 * kThreads == kT * kDepth, "whole 16-byte copies a thread");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared through L2 only (another SM may have written them)
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// kH consecutive floats of a stage row
template <int kH>
__device__ __forceinline__ void lds(float* v, const float* p) {
  if constexpr (kH == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (kH == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// the tile's row (or column) of this thread's accumulator index i: its two
// halves of kH, kT/2 apart
template <int kT>
__device__ __forceinline__ int out_idx(int t, int i) {
  constexpr int kH = Tile<kT>::kH;
  return i < kH ? t * kH + i : kT / 2 + t * kH + i - kH;
}

// acc[i][j] = sum over k of At[k][row0 + out_idx(ty, i)] * Bm[k][col0 +
// out_idx(tx, j)], each output one fmaf chain from k = 0. Both operands are
// [K, rows or cols] row-major (the depth slowest; rows, cols and K multiples
// of 4), so a stage of kDepth depths is two [kDepth][kT] tiles that move by
// 16-byte copies; At is read through L2 (written during the launch), Bm is
// the dictionary. Per depth a thread reads 2 x kH floats of each (float4s at
// kT 128).
template <int kT>
__device__ __forceinline__ void gemm_tile(const float* At, const float* Bm, int rows, int cols, int K, int row0,
                                          int col0, float* smem, float (&acc)[2 * Tile<kT>::kH][2 * Tile<kT>::kH]) {
  using T = Tile<kT>;
  constexpr int kH = T::kH, kHalf = kT / 2;
  // ty (the batch rows' group) varies fastest in a warp: the transposed
  // epilogues then read and write 256 contiguous bytes of a row per warp
  const int tid = threadIdx.x, ty = tid & 15, tx = tid >> 4;
#pragma unroll
  for (int i = 0; i < 2 * kH; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kH; ++j) acc[i][j] = 0.f;
  // stage `slot` <- depths [k0, k0 + kDepth) of both operands: copies where
  // the source exists, zeros where it does not (past the rows, columns or K)
  auto load = [&](int slot, int k0) {
    float* sa = smem + slot * T::kStageFloats;
    float* sb = sa + T::kDepth * T::kLd;
#pragma unroll
    for (int q = 0; q < T::kChunks; ++q) {
      const int c = tid + q * kThreads;
      const int k = c / (kT / 4), o = (c % (kT / 4)) * 4;
      const bool in_k = k0 + k < K;
      if (in_k && row0 + o < rows) cp16(sa + k * T::kLd + o, At + (size_t)(k0 + k) * rows + row0 + o);
      else *reinterpret_cast<float4*>(sa + k * T::kLd + o) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in_k && col0 + o < cols) cp16(sb + k * T::kLd + o, Bm + (size_t)(k0 + k) * cols + col0 + o);
      else *reinterpret_cast<float4*>(sb + k * T::kLd + o) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const int stages = (K + T::kDepth - 1) / T::kDepth;
  __syncthreads();  // the previous tile's last reads of the stages are done
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(s, s * T::kDepth);
    cp_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_wait<kStages - 2>();  // this thread's copies of stage s have landed
    __syncthreads();         // everyone's have; stage s - 1 is no longer read
    if (s + kStages - 1 < stages) load((s + kStages - 1) % kStages, (s + kStages - 1) * T::kDepth);
    cp_commit();
    const float* sa = smem + (s % kStages) * T::kStageFloats;
    const float* sb = sa + T::kDepth * T::kLd;
#pragma unroll
    for (int k = 0; k < T::kDepth; ++k) {
      float av[2 * kH], bv[2 * kH];
      lds<kH>(av, sa + k * T::kLd + ty * kH);
      lds<kH>(av + kH, sa + k * T::kLd + kHalf + ty * kH);
      lds<kH>(bv, sb + k * T::kLd + tx * kH);
      lds<kH>(bv + kH, sb + k * T::kLd + kHalf + tx * kH);
#pragma unroll
      for (int i = 0; i < 2 * kH; ++i)
#pragma unroll
        for (int j = 0; j < 2 * kH; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Whether member m stopped before iteration `it` (tol > 0 only); delta is
// read from L2, where every block's atomicMax landed before the grid barrier.
__device__ __forceinline__ bool member_done(const uint32_t* delta, const float* __restrict__ exit_thresh, int m,
                                            int it, int num_iter) {
  return delta != nullptr && it > 0 &&
         !(__uint_as_float(__ldcg(delta + (size_t)m * num_iter + it - 1)) > exit_thresh[m]);
}

// Every thread of every block of the (co-resident, cooperative) grid arrives
// before any leaves; `count` rises by gridDim.x at each barrier from 0.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  __threadfence();  // this thread's writes reach L2 before the arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned*>(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// res[m]^T tile = (x - y[m] . D[m])^T: the operands yT [N, B] and D [N, D],
// x read as xT [D, B]; this thread's rows (batch) are kH consecutive in each
// half, so it reads and writes float4s (kH 4) along the batch
template <int kT>
__device__ __forceinline__ void residual_tile(const float* __restrict__ xt, const float* __restrict__ dict,
                                              const float* yt, float* rest, int m, int row0, int col0, int B, int N,
                                              int D, float* smem) {
  constexpr int kH = Tile<kT>::kH;
  float acc[2 * kH][2 * kH];
  gemm_tile<kT>(yt + (size_t)m * N * B, dict + (size_t)m * N * D, B, D, N, row0, col0, smem, acc);
  const int ty = threadIdx.x & 15, tx = threadIdx.x >> 4;  // as in gemm_tile
  float* r = rest + (size_t)m * D * B;
#pragma unroll
  for (int j = 0; j < 2 * kH; ++j) {
    const int col = col0 + out_idx<kT>(tx, j);
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * (kT / 2) + ty * kH;
      if (row >= B) continue;  // B % 4 == 0: a thread's kH rows are all in or all out
      const size_t off = (size_t)col * B + row;
      if constexpr (kH == 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + off);
        const float4 o = make_float4(__fsub_rn(xv.x, acc[h * 4 + 0][j]), __fsub_rn(xv.y, acc[h * 4 + 1][j]),
                                     __fsub_rn(xv.z, acc[h * 4 + 2][j]), __fsub_rn(xv.w, acc[h * 4 + 3][j]));
        *reinterpret_cast<float4*>(r + off) = o;
      } else {
#pragma unroll
        for (int e = 0; e < kH; ++e) r[off + e] = __fsub_rn(xt[off + e], acc[h * kH + e][j]);
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

// G tile = res[m] . D[m]^T from the operands resT [D, B] and Dt [D, N],
// then the FISTA step on a[m]^T and y[m]^T [N, B] in place; returns this
// thread's largest |a' - a| bits
template <int kT>
__device__ __forceinline__ uint32_t update_tile(const float* __restrict__ dict_t, const float* rest, float* at,
                                                float* yt, float e, float thr, float mo, int m, int row0, int col0,
                                                int B, int N, int D, float* smem) {
  constexpr int kH = Tile<kT>::kH;
  float acc[2 * kH][2 * kH];
  gemm_tile<kT>(rest + (size_t)m * D * B, dict_t + (size_t)m * N * D, B, N, D, row0, col0, smem, acc);
  const int ty = threadIdx.x & 15, tx = threadIdx.x >> 4;  // as in gemm_tile
  float* am = at + (size_t)m * N * B;
  float* ym = yt + (size_t)m * N * B;
  uint32_t dmax = 0;
#pragma unroll
  for (int j = 0; j < 2 * kH; ++j) {
    const int col = col0 + out_idx<kT>(tx, j);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * (kT / 2) + ty * kH;
      if (row >= B) continue;
      const size_t off = (size_t)col * B + row;
      if constexpr (kH == 4) {
        float4 av = __ldcg(reinterpret_cast<const float4*>(am + off));
        float4 yv = __ldcg(reinterpret_cast<const float4*>(ym + off));
        fista_step(yv.x, av.x, acc[h * 4 + 0][j], e, thr, mo, dmax);
        fista_step(yv.y, av.y, acc[h * 4 + 1][j], e, thr, mo, dmax);
        fista_step(yv.z, av.z, acc[h * 4 + 2][j], e, thr, mo, dmax);
        fista_step(yv.w, av.w, acc[h * 4 + 3][j], e, thr, mo, dmax);
        *reinterpret_cast<float4*>(am + off) = av;
        *reinterpret_cast<float4*>(ym + off) = yv;
      } else {
#pragma unroll
        for (int q = 0; q < kH; ++q) {
          float av = __ldcg(am + off + q), yv = __ldcg(ym + off + q);
          fista_step(yv, av, acc[h * kH + q][j], e, thr, mo, dmax);
          am[off + q] = av;
          ym[off + q] = yv;
        }
      }
    }
  }
  return dmax;
}

// x, a, y and res transposed: xT [D, B], aT and yT [M, N, B], resT [M, D, B]
struct Args {
  const float* x;
  const float* dict;
  const float* dict_t;
  const float* eta;
  const float* l1;
  const float* mom;
  const float* exit_thresh;  // [M] (tol > 0) or null
  uint32_t* delta;           // [M, num_iter] zeroed (tol > 0) or null
  float* a;
  float* y;
  float* res;
  unsigned* sync;  // the grid barrier's count, zeroed
  int M, B, N, D, num_iter;
};

// grid: at most the co-resident blocks; every iteration's two phases, each
// over its tiles (member slowest, then batch rows, then columns)
template <int kT>
__global__ void __launch_bounds__(kThreads, 2) solve_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_b = (p.B + kT - 1) / kT;
  const int tiles_d = (p.D + kT - 1) / kT, tiles_n = (p.N + kT - 1) / kT;
  const int n_res = p.M * tiles_b * tiles_d, n_upd = p.M * tiles_b * tiles_n;
  unsigned target = 0;
  for (int it = 0; it < p.num_iter; ++it) {
    if (p.delta != nullptr && it > 0) {
      bool any = false;
      for (int m = 0; m < p.M && !any; ++m) any = !member_done(p.delta, p.exit_thresh, m, it, p.num_iter);
      if (!any) break;  // every block reads the same deltas and leaves here
    }
    for (int t = blockIdx.x; t < n_res; t += gridDim.x) {
      const int m = t / (tiles_b * tiles_d), rem = t % (tiles_b * tiles_d);
      if (member_done(p.delta, p.exit_thresh, m, it, p.num_iter)) continue;
      residual_tile<kT>(p.x, p.dict, p.y, p.res, m, (rem / tiles_d) * kT, (rem % tiles_d) * kT, p.B, p.N, p.D, smem);
    }
    grid_sync(p.sync, target += gridDim.x);
    const float mo = p.mom[it];
    for (int t = blockIdx.x; t < n_upd; t += gridDim.x) {
      const int m = t / (tiles_b * tiles_n), rem = t % (tiles_b * tiles_n);
      if (member_done(p.delta, p.exit_thresh, m, it, p.num_iter)) continue;
      const float e = p.eta[m];
      const uint32_t dmax = update_tile<kT>(p.dict_t, p.res, p.a, p.y, e, __fmul_rn(e, p.l1[m]), mo, m,
                                            (rem / tiles_n) * kT, (rem % tiles_n) * kT, p.B, p.N, p.D, smem);
      if (p.delta != nullptr) {
        const uint32_t w = __reduce_max_sync(0xffffffffu, dmax);
        if ((threadIdx.x & 31) == 0) atomicMax(p.delta + (size_t)m * p.num_iter + it, w);
      }
    }
    grid_sync(p.sync, target += gridDim.x);
  }
}

template <int kT>
int launch(Args p, int sms, cudaStream_t st) {
  auto kern = solve_kernel<kT>;
  constexpr size_t smem = Tile<kT>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles_b = (p.B + kT - 1) / kT;
  const long long tiles = p.M * tiles_b * (((p.N > p.D ? p.N : p.D) + kT - 1) / kT);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  if (2LL * p.num_iter * grid > 0xffffffffLL) return (int)cudaErrorInvalidValue;  // the barrier's u32 count
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads), args, smem, st);
}

}  // namespace

extern "C" {

// K_f. Inputs: x_t [D, B] (the batch transposed), dict [M, N, D] and
// dict_t [M, D, N] (its transpose), eta [M], l1 [M], mom [num_iter]; a_t
// and y_t [M, N, B] both hold the warm start, transposed, and are updated
// in place (a_t ends as the codes); res_t [M, D, B] is scratch; sync one
// zeroed u32. With tol > 0 the caller passes exit_thresh [M] = tol * eta
// and delta [M, num_iter] zeroed; with tol = 0 both are null and no
// reduction runs. All f32 except delta and sync (u32), contiguous, 16-byte
// aligned. Takes any M >= 1 and B, N, D multiples of 4 whose tile count at
// 32 x 32 tiles fits an int. Enqueues one cooperative launch on `stream`
// (none for num_iter 0), does not synchronise, and returns the CUDA error
// code (0 on success).
int sc_fista_solve(const void* x_t, const void* dict, const void* dict_t, const void* eta, const void* l1,
                   const void* mom, const void* exit_thresh, void* delta, void* a_t, void* y_t, void* res_t,
                   void* sync, int M, int B, int N, int D, int num_iter, void* stream) {
  const long long most = (long long)M * ((B + 31) / 32) * (((N > D ? N : D) + 31) / 32);
  if (M < 1 || B < 4 || N < 4 || D < 4 || B % 4 || N % 4 || D % 4 || num_iter < 0 || most > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (num_iter == 0) return 0;
  Args p{static_cast<const float*>(x_t), static_cast<const float*>(dict), static_cast<const float*>(dict_t),
         static_cast<const float*>(eta), static_cast<const float*>(l1), static_cast<const float*>(mom),
         static_cast<const float*>(exit_thresh), static_cast<uint32_t*>(delta), static_cast<float*>(a_t),
         static_cast<float*>(y_t), static_cast<float*>(res_t), static_cast<unsigned*>(sync), M, B, N, D, num_iter};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // the tile edge: the largest of 128 and 64 whose phase-1 tiles (the fewer:
  // D <= N at every BASELINE config) number at least the card's SMs, else 32
  auto fills = [&](long long t) { return (long long)M * ((B + t - 1) / t) * ((D + t - 1) / t) >= sms; };
  if (fills(128)) return launch<128>(p, sms, st);
  if (fills(64)) return launch<64>(p, sms, st);
  return launch<32>(p, sms, st);
}

}  // extern "C"
