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
// 271 GFLOP (0.274 ms at the bf16 tensor-core rate) against ~490 MB of
// traffic (the 352 MB score tensor written once and read back by the
// select), so it is compute-bound. K_d's code holds ~k of N entries a row
// (0.55% at config 4), so the work its data needs is small: its bound is the
// 704 MB of s in and c out, and the kept rows of D^ it gathers (~1.5 GB from
// L2 at config 4) come next. The TPU kernel keeps a batch tile's whole score
// row in VMEM for the select; an SM has 227 KB, so K_s is two launches
// behind one C entry:
//   `scores_kernel`  the GEMM on Hopper's own path: a persistent block an SM
//                    walks the [128 x 256] output tiles, the member slowest
//                    (its D^, 18.9 MB at config 4, stays in the 50 MB L2);
//                    a producer warpgroup's one thread keeps a ring of four
//                    48 KB stages (x [128 x 64] and D^ [256 x 64], TMA in the
//                    128-byte swizzle) filled against mbarriers, running
//                    ahead into the next tile while the consumers store this
//                    one; two consumer warpgroups each multiply a 64-row half
//                    by `wgmma` m64n256k16 (both operands K-major from shared
//                    memory, 128 f32 accumulators a thread, setmaxnreg
//                    40 / 232), then round to bf16 in registers and store
//                    16 bytes a row piece (a rotation in each quad of
//                    threads), with no staging through shared memory. Tiles
//                    past B or N (B % 128 == 64, N % 256 == 128) are loaded
//                    whole (TMA fills rows past the tensor with zeros) and
//                    stored masked. What holds it is the operand stream from
//                    L2 into the SMs (3.2 GB a launch at config 4: the ring
//                    with no products takes most of the GEMM's time,
//                    scripts/fwd_probe.py). Clusters of two blocks sharing
//                    each D^ tile by TMA multicast read half the D^ bytes
//                    from L2 but ran slower on the H100, as K2's multicast
//                    did, so each block loads its own;
//   `select_kernel`  a block of 128 threads a (member, row) reads the row
//                    once in 16-byte loads and keeps its keys in registers as
//                    fp16 integers 1024 + byte (one byte_perm per two keys):
//                    the high and the low byte of the 16-bit ordered key.
//                    Each byte is found by bisection, high byte first (one
//                    pass finds the row's largest high byte; candidates
//                    above it count 0 without a pass, so where the k-th key
//                    shares the largest one's high byte, as at small k, the
//                    high byte takes two passes, not eight): per
//                    candidate c a pass counts the keys >= c by a saturated
//                    fp16 subtraction (1 if >= c, else 0) and an fp16 add
//                    into one of four accumulators, two keys an instruction
//                    on the FMA pipe (every sum is an integer < 2048, so
//                    exact), then one integer reduction a warp and the
//                    block's warps in order. The low byte is bisected
//                    among the keys whose high byte is the one found, against
//                    k less the count above that byte. No atomics. The result
//                    is the largest key t with count(key >= t) >= k: the same
//                    key as the Pallas kernel's 16-pass bisection. A row
//                    longer than the registers hold is counted in pieces,
//                    reloaded each pass.
// Bits: each output of the GEMM is one f32 chain of k16 steps over the depth
// from k = 0, in ascending depth; a `wgmma` k16 chain gives the bits of an
// `mma.sync` m16n8k16 chain on the same operands (scripts/fwd_probe.py), so s
// is the WMMA tiling's (the first design's) bit for bit, and with it the
// thresholds and K_d's code.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// the forward output tiles' multiples the wrapper checks (ops/_wrap.py
// FWD_ROWS x FWD_COLS): B % 64, N % 128, D % 128
constexpr int kFwdRows = 64;
constexpr int kFwdCols = 128;

// -- K_s: the scores GEMM ------------------------------------------------------------

constexpr int kSRows = 128;                   // batch rows of an output tile: a 64-row half a consumer warpgroup
constexpr int kSCols = 256;                   // dictionary columns of an output tile (m64n256k16)
constexpr int kSDepth = 64;                   // depth of a stage: one 128-byte-swizzled panel
constexpr int kSStages = 4;
constexpr int kSConsumers = 256;              // two consumer warpgroups
constexpr int kSThreads = kSConsumers + 128;  // and a producer warpgroup (one thread starts the copies)
constexpr uint32_t kSX = kSRows * kSDepth * 2;
constexpr uint32_t kSStage = kSX + kSCols * kSDepth * 2;  // 48 KB: x [128][128 B], then D^ [256][128 B]
constexpr size_t kSSmem = 1024 + kSStages * kSStage + 2 * kSStages * 8;
static_assert(kSSmem <= (size_t)SC_MAX_SMEM, "K_s's stages fit a block");

struct ScoresMaps {
  CUtensorMap x, dhat;
};

// tile -> (member, first dictionary column, first batch row): the batch
// tile fastest, the member slowest
struct ScoresTile {
  int m, n0, b0;
};
__device__ __forceinline__ ScoresTile scores_tile(int tile, int n_bt, int n_nt) {
  const int rest = tile / n_bt;
  return {rest / n_nt, (rest % n_nt) * kSCols, (tile % n_bt) * kSRows};
}

// grid: at most one block an SM, each walking tiles blockIdx.x, + gridDim.x,
// ...: s[m, b0 .., n0 ..] = bf16(x_b . D_b[m]^T), f32 sums.
__global__ void __launch_bounds__(kSThreads, 1) scores_kernel(
    const __grid_constant__ ScoresMaps maps, bf16* __restrict__ s, int M, int B, int N, int D) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSStages * kSStage);  // [stages] the stage has landed
  uint64_t* empty = full + kSStages;                                         // [stages] the stage may be refilled
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_bt = (B + kSRows - 1) / kSRows, n_nt = (N + kSCols - 1) / kSCols;
  const int n_tiles = M * n_nt * n_bt, nk = D / kSDepth;

  if (tid == 0) {
    for (int i = 0; i < kSStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], 2);  // each consumer warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= kSConsumers / 32) {
    // producer: the warpgroup gives its registers to the consumers
    // (128 x (168 - 40) = 2 x 128 x (232 - 168)); one thread walks the same
    // tiles as the consumers, every stage of each, through the ring
    sm90::reg_dealloc<40>();
    if (warp == kSConsumers / 32 && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const ScoresTile tl = scores_tile(tile, n_bt, n_nt);
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int st = it % kSStages;
          sm90::mbar_wait(&empty[st], ((it / kSStages) & 1) ^ 1);
          unsigned char* stage = smem + st * kSStage;
          sm90::mbar_expect_tx(&full[st], kSStage);
          sm90::tma_load(stage, &maps.x, &full[st], ks * kSDepth, tl.b0);
          sm90::tma_load(stage + kSX, &maps.dhat, &full[st], ks * kSDepth, tl.m * N + tl.n0);
        }
      }
    }
    return;
  }

  sm90::reg_alloc<232>();
  const int wg = tid >> 7, wt = tid & 127;
  const int g = 16 * (wt >> 5) + (lane >> 2), t4 = lane & 3;  // accumulator row, column pair
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const ScoresTile tl = scores_tile(tile, n_bt, n_nt);
    float acc[kSCols / 2];  // rows g, g + 8 of this warpgroup's half; columns 8 j + 2 t4 (+1)
#pragma unroll
    for (int i = 0; i < kSCols / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % kSStages;
      sm90::mbar_wait(&full[st], (it / kSStages) & 1);
      const uint32_t xs = sm90::smem_u32(smem + st * kSStage), ds = xs + kSX;
      sm90::fence_regs(acc);
      sm90::wg_fence();
#pragma unroll
      for (int k = 0; k < kSDepth; k += 16)
        sm90::wgmma_ss<kSCols, 0, 0>(acc, sm90::desc(xs + sm90::swz(64 * wg, k, kSRows), 16, 1024),
                                     sm90::desc(ds + sm90::swz(0, k, kSCols), 16, 1024));
      sm90::wg_commit();
      // the previous stage's products have completed: it may be refilled
      sm90::wg_wait<1>();
      if (ks > 0 && wt == 0) sm90::mbar_arrive(&empty[(it - 1) % kSStages]);
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(acc);
    if (wt == 0) sm90::mbar_arrive(&empty[(it - 1) % kSStages]);

    // bf16 in registers, then 16-byte stores: of rows g and g + 8, thread t4
    // of a quad holds columns 2 t4, 2 t4 + 1 of each 8-column group; a 4 x 4
    // rotation in the quad (three shuffles) gives it group 4 q + t4 of each
    // 32-column piece q whole
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tl.b0 + 64 * wg + g + 8 * h;
      bf16* dst = s + ((size_t)tl.m * B + r) * N + tl.n0 + 8 * t4;
#pragma unroll
      for (int q = 0; q < kSCols / 32; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = sm90::pack_bf16(acc[4 * (4 * q + i) + 2 * h], acc[4 * (4 * q + i) + 2 * h + 1]);
        uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          // round rr: give lane t4 - rr its group, take group t4 from lane t4 + rr
          const int give = (t4 - rr) & 3, from = (t4 + rr) & 3;
          const uint32_t mine = give == 0 ? v[0] : give == 1 ? v[1] : give == 2 ? v[2] : v[3];
          const uint32_t got = rr == 0 ? mine : __shfl_sync(0xffffffffu, mine, (lane & ~3) | from);
#pragma unroll
          for (int k = 0; k < 4; ++k) o[k] = from == k ? got : o[k];
        }
        if (r < B && tl.n0 + 32 * q < N)
          *reinterpret_cast<uint4*>(dst + 32 * q) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

// -- K_s: the exact select ------------------------------------------------------------

constexpr int kSelThreads = 128;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelMaxChunks = 16;  // 16-byte chunks of the row a thread holds in registers, at most

// a 16-bit ordered key (the Pallas `_ordered_i32`: negatives flipped,
// non-negatives above them, so that unsigned order is float order) -> the
// bf16 bits it orders
__device__ __forceinline__ uint32_t unordered_key(uint32_t k) {
  return k >= 0x8000u ? k - 0x8000u : 0xFFFFu - k;
}

__device__ __forceinline__ __half2 as_h2(uint32_t v) { return *reinterpret_cast<const __half2*>(&v); }
__device__ __forceinline__ uint32_t as_u32(__half2 v) { return *reinterpret_cast<const uint32_t*>(&v); }

// grid (B, M): thresh[m, b] = f32 of the k[m]-th largest bf16 score of row
// (m, b) of s (k clamped to [1, N]). A thread holds chunks tid, tid + 128,
// ... (8 keys each) of a piece of kChunks * 128 chunks; hv / lv hold each
// key's high / low ordered byte as the fp16 integer 1024 + byte, two keys a
// word (zeros past the row: they never count).
template <int kChunks>
__global__ void __launch_bounds__(kSelThreads) select_kernel(
    const bf16* __restrict__ s, const int* __restrict__ k, float* __restrict__ thresh, int B, int N) {
  __shared__ uint32_t red[2][kSelWarps];
  const int m = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row = (size_t)m * B + blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(s + row * N);
  const int n_chunks = N / 8, pieces = (n_chunks + kChunks * kSelThreads - 1) / (kChunks * kSelThreads);
  int need = k[m];
  need = need < 1 ? 1 : (need > N ? N : need);

  uint32_t hv[kChunks][4], lv[kChunks][4];
  auto load = [&](int piece) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = (piece * kChunks + c) * kSelThreads + tid;
      const uint4 v = idx < n_chunks ? src[idx] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the ordered keys of the two scores: b ^ 0xFFFF if negative, else b ^ 0x8000
        const uint32_t key = w[e] ^ (((w[e] >> 15) & 0x00010001u) * 0x7FFFu) ^ 0x80008000u;
        hv[c][e] = idx < n_chunks ? __byte_perm(key, 0x64646464u, 0x4341) : 0u;
        lv[c][e] = idx < n_chunks ? __byte_perm(key, 0x64646464u, 0x4240) : 0u;
      }
    }
  };
  // keep only the keys whose high byte is hi (the others' low bytes become 0)
  auto in_bin = [&](int hi) {
    const __half2 h2 = __float2half2_rn(1024.f + (float)hi);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) lv[c][e] = as_u32(__hmul2(__heq2(as_h2(hv[c][e]), h2), as_h2(lv[c][e])));
  };
  // this thread's count of bytes >= cand in v: sat(1024 + byte - (1023 + cand))
  // summed in four fp16 accumulators (word e of each chunk into a[e]), the
  // first from 1024, so that their sum 1024 + n (n < 1024) has the bits
  // 0x6400 + n in each half
  auto count = [&](const uint32_t (&v)[kChunks][4], int cand) {
    const __half2 c2 = __float2half2_rn(1023.f + (float)cand), zero = __float2half2_rn(0.f);
    __half2 a[4] = {__float2half2_rn(1024.f), zero, zero, zero};
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = __hadd2(a[e], __hsub2_sat(as_h2(v[c][e]), c2));
    const uint32_t u = as_u32(__hadd2(__hadd2(a[0], a[1]), __hadd2(a[2], a[3])));
    return (u & 0xFFFFu) + (u >> 16) - 2u * 0x6400u;
  };
  int pass = 0;
  // the block's count of bytes >= cand (high bytes, or low bytes of the keys
  // whose high byte is hi), the same in every thread
  auto block_count = [&](bool low, int cand, int hi) {
    uint32_t n = 0;
    if (pieces == 1) {
      n = low ? count(lv, cand) : count(hv, cand);
    } else {
      for (int p = 0; p < pieces; ++p) {
        load(p);
        if (low) in_bin(hi);
        n += low ? count(lv, cand) : count(hv, cand);
      }
    }
    n = __reduce_add_sync(0xffffffffu, n);
    uint32_t* slot = red[pass++ & 1];
    if (lane == 0) slot[warp] = n;
    __syncthreads();
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kSelWarps; ++w) total += slot[w];
    return (int)total;
  };

  // the row's largest high byte, the same in every thread
  auto block_top = [&]() {
    uint32_t top = 0;
    for (int p = 0; p < pieces; ++p) {
      if (pieces > 1) load(p);
      __half2 m2 = as_h2(hv[0][0]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) m2 = __hmax2(m2, as_h2(hv[c][e]));
      const uint32_t u = as_u32(m2);
      top = max(top, max(u & 0xFFFFu, u >> 16));
    }
    top = __reduce_max_sync(0xffffffffu, top);
    uint32_t* slot = red[pass++ & 1];
    if (lane == 0) slot[warp] = top;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kSelWarps; ++w) top = max(top, slot[w]);
    return (int)top - 0x6400;  // the bits of 1024 + byte
  };

  if (pieces == 1) load(0);
  // the high byte: the largest hi with count(high byte >= hi) >= need; and
  // count(high byte > hi), the count of the last candidate refused (the
  // candidate hi + 1), or 0 when none was. A candidate above the row's
  // largest high byte counts 0 without a pass: where the k-th key shares the
  // largest key's high byte (small k), two passes find it instead of eight
  const int top = block_top();
  int hi = 0, above = 0;
  for (int bit = 7; bit >= 0; --bit) {
    const int cand = hi | (1 << bit);
    const int n = cand > top ? 0 : block_count(false, cand, 0);
    if (n >= need) hi = cand;
    else above = n;
  }
  // the low byte among the keys of high byte hi, against need - above
  if (pieces == 1) in_bin(hi);
  const int need_lo = need - above;
  int lo = 0;
  for (int bit = 7; bit >= 0; --bit) {
    const int cand = lo | (1 << bit);
    if (block_count(true, cand, hi) >= need_lo) lo = cand;
  }
  if (tid == 0) thresh[row] = __uint_as_float(unordered_key((uint32_t)(hi << 8 | lo)) << 16);
}

// the chunks of 8 keys a select thread holds in registers for a row of N
// keys: the fewest instantiation that holds the row, else the most (the row
// is then counted in pieces)
int select_chunks(int N) {
  const int per_thread = (N / 8 + kSelThreads - 1) / kSelThreads;
  constexpr int kFits[] = {1, 2, 3, 4, 6, 8, 12};
  for (const int c : kFits)
    if (per_thread <= c) return c;
  return kSelMaxChunks;
}

template <int kChunks>
int launch_select_t(const void* s, const void* k, void* thresh, int M, int B, int N, cudaStream_t st) {
  select_kernel<kChunks><<<dim3(B, M), kSelThreads, 0, st>>>(static_cast<const bf16*>(s), static_cast<const int*>(k),
                                                           static_cast<float*>(thresh), B, N);
  return (int)cudaGetLastError();
}

int launch_select(const void* s, const void* k, void* thresh, int M, int B, int N, cudaStream_t st) {
  switch (select_chunks(N)) {
    case 1: return launch_select_t<1>(s, k, thresh, M, B, N, st);
    case 2: return launch_select_t<2>(s, k, thresh, M, B, N, st);
    case 3: return launch_select_t<3>(s, k, thresh, M, B, N, st);
    case 4: return launch_select_t<4>(s, k, thresh, M, B, N, st);
    case 6: return launch_select_t<6>(s, k, thresh, M, B, N, st);
    case 8: return launch_select_t<8>(s, k, thresh, M, B, N, st);
    case 12: return launch_select_t<12>(s, k, thresh, M, B, N, st);
    default: return launch_select_t<kSelMaxChunks>(s, k, thresh, M, B, N, st);
  }
}

int launch_scores(const void* x, const void* dhat, void* s, int M, int B, int N, int D, cudaStream_t st) {
  ScoresMaps maps{};
  if (!sm90::encode_bf16_2d(&maps.x, x, B, D, kSRows) ||
      !sm90::encode_bf16_2d(&maps.dhat, dhat, (uint64_t)M * N, D, kSCols))
    return (int)cudaErrorInvalidValue;
  static int sms = 0;  // a persistent grid: one block an SM
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e = cudaFuncSetAttribute(scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = M * ((N + kSCols - 1) / kSCols) * ((B + kSRows - 1) / kSRows);
  scores_kernel<<<tiles < sms ? tiles : sms, kSThreads, kSSmem, st>>>(maps, static_cast<bf16*>(s), M, B, N, D);
  return (int)cudaGetLastError();
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

// the forward tiling's multiples (K_s takes ragged 128 x 256 tiles)
bool shapes_ok(int B, int N, int D) { return B % kFwdRows == 0 && N % kFwdCols == 0 && D % kFwdCols == 0; }

}  // namespace

extern "C" {

// K_s. Shapes: x [B, D] bf16, dhat [M, N, D] bf16, k [M] int32; outputs
// s [M, B, N] bf16, thresh [M, B] f32. Needs B % 64 == 0, N % 128 == 0,
// D % 128 == 0 (the Python wrapper checks). Launches the scores GEMM, then
// the select, on `stream`; does not synchronise, and returns the CUDA error
// code of the launches (0 on success).
int sc_topk_scores(const void* x, const void* dhat, const void* k, void* s, void* thresh, int M,
                   int B, int N, int D, void* stream) {
  if (!shapes_ok(B, N, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int e = launch_scores(x, dhat, s, M, B, N, D, st);
  if (e != 0) return e;
  return launch_select(s, k, thresh, M, B, N, st);
}

// K_s's select alone, on given scores: s [M, B, N] bf16, k [M] int32 ->
// thresh [M, B] f32, the k[m]-th largest score of each row (ties kept, k
// clamped to [1, N]). Needs N % 8 == 0. For tests and probes: the TopK path
// calls sc_topk_scores.
int sc_topk_select(const void* s, const void* k, void* thresh, int M, int B, int N, void* stream) {
  if (N % 8 || N <= 0 || B <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  return launch_select(s, k, thresh, M, B, N, reinterpret_cast<cudaStream_t>(stream));
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
