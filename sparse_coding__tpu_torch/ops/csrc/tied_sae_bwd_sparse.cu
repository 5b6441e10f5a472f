// K2 `tied_sae_bwd_adam` and K3 `tied_sae_bwd_grads` on a sparse code: the
// TopK path's backward for Hopper (sm_90a), touching only the code's
// non-zeros. Instantiates the epilogue of tied_sae_bwd.cuh (the radial sum,
// the row-normalisation VJP and the Adam epilogue in every moment tier, or
// K3's f32 store) behind its own mainloop.
//
// Replaces the Pallas TPU kernels in sparse_coding__tpu/ops/tied_sae_kernel.py
// `_bwd_adam_kernel` + `_adam_epilogue` (K2) and `_bwd_kernel` (K3) where
// sparse_coding__tpu/ops/topk_kernel.py's `topk_adam_step_stacked` and
// `topk_grads_stacked` call them (l1 = 0). For member m and dictionary row n,
// over the batch rows b where c[m, b, n] != 0 and nowhere else:
//   dc      = [c > 0] * (dxh[m, b] . Dj[n] + l1/B)   f32, one fixed shuffle tree
//   g_bias += dc
//   g_dhat += c * dxh[m, b] + bf16(dc) * x[b]       f32, in ascending b
// (an entry with c = 0 adds exactly nothing in the dense product, and a
// negative c only its c * dxh term). Then the shared epilogue.
//
// What bounds it on the card: bytes. A TopK code holds ~k of N entries per
// row (0.55% at BASELINE config 4: M 7, B 2048, N 12288, D 768, k 1..151),
// so the products the data needs are ~B * sum(k) * D * 6 = 4.4 GFLOP, while
// the moments and the dictionary it must stream are ~1.6 GB (f32 d_raw, mu
// and nu, each read and written) plus the 352 MB bf16 code, read once: 2.2
// FLOP a byte, against a ridge of ~20 for the f32 CUDA cores and ~295 for
// bf16 tensor cores. So the products run on the CUDA cores, as dot products
// and AXPYs over the gathered rows; tensor cores would multiply zeros.
//
// Design. One block (8 warps) owns (member m, 8 dictionary rows); warp w
// owns row n0 + w. Two blocks share an SM (at most 128 registers a thread,
// ~100 KB of shared memory at D 768, ~112 KB at D 1024), so one block's
// epilogue streams while the other gathers. The block walks the batch in
// chunks of kChunk rows:
//   - its [kChunk, 8] slice of the bf16 code (one 16-byte copy a row) is
//     read once, by cp.async into a ring of kStages chunks issued ahead (all
//     of a 2048-row batch at once);
//   - warp w compacts column w's non-zeros into a list in ascending b (one
//     ballot per 32 rows), so a list holds at most kChunk entries whatever
//     the data: capacity is bounded by the chunk, not by the code's density;
//   - the lists are cut into segments of kSeg entries. Warp w takes the
//     first segment of its own list into its register accumulators (its
//     row's g_dhat, 4 columns of every 128 a lane, and g_bias); the further
//     segments of long lists (a hot feature) go to all 8 warps in turn, one
//     a warp per wave, each summed from zero into a shared-memory slot and
//     then added by the owner in segment order. No float atomics: every sum
//     runs in an order fixed by the data alone, so two launches on the same
//     inputs give the same bits.
//   - per entry a warp gathers the dxh row and the x row of its batch row
//     from L2 (a member's dxh and x are 3 MB each, and the blocks in flight
//     at a time are mostly one member's), 8 bytes a lane per 128 columns,
//     straight into registers. A shared-memory ring of
//     gathered rows (cp.async or TMA) was the alternative: at D 768 two
//     entries a warp take 48 KB a block, which would cost the second block
//     on the SM; and the gathers already run near the L2's read rate (~3.0
//     GB of rows at config 4, ~0.5 ms on an H100: scripts/sparse_bwd_probe.py).
// After the batch, the owners write their rows into the shared gradient tile
// and the epilogue streams d_raw, mu and nu (an int8 tier reads its 1-byte
// codes twice). The HBM bytes (the code once, the
// dictionary and the moments once) set the card's bound; the gathers' ~3.0
// GB of L2 reads at config 4 set this design's own floor above it.

#include "tied_sae_bwd.cuh"

namespace {

constexpr int kSpThreads = 256;                // 8 warps; two blocks share an SM
constexpr int kSpWarps = kSpThreads / 32;
constexpr int kSpRows = kSpWarps;              // dictionary rows per block: warp w owns row w
constexpr int kChunk = 1024;                   // batch rows compacted per chunk (each list's capacity)
constexpr int kStages = 2;                     // code chunks in flight (cp.async ring)
constexpr int kSeg = 32;                       // entries per work item; a longer list is split over warps
static_assert(kSpRows * sizeof(bf16) == 16, "a chunk row of the code is one 16-byte copy");

// One block's shared memory, in bytes: the dictionary tile; then the batch
// loop's region (the ring of code chunks, the lists, the partial rows of one
// wave with their bias sums and owner rows, the list lengths), which
// afterwards holds the f32 gradient tile and the epilogue's absmax words;
// then the radial sums.
struct SparsePlan {
  size_t dj, code, lists, slots, loop, g, epi, total;
};

SparsePlan sparse_plan(int D, size_t epi) {
  SparsePlan p;
  p.dj = (size_t)kSpRows * ld_bf16(D) * sizeof(bf16);
  p.code = (size_t)kStages * kChunk * kSpRows * sizeof(bf16);
  p.lists = (size_t)kSpRows * kChunk * sizeof(uint32_t);
  p.slots = (size_t)kSpWarps * (D * sizeof(float) + sizeof(float) + sizeof(int)) + kSpRows * sizeof(int);
  p.loop = p.code + p.lists + p.slots;
  p.g = (size_t)kSpRows * ld_f32(D) * sizeof(float);
  p.epi = epi;
  p.total = p.dj + (p.loop > p.g + epi ? p.loop : p.g + epi) + kSpRows * sizeof(float);
  return p;
}

// extra segments of a list of n entries beyond its first
__device__ __forceinline__ int extra_segments(int n) { return n > kSeg ? (n - 1) / kSeg : 0; }

// a lane's share of one bf16 row of D = 128 * kP: 4 columns of every 128
template <int kP>
struct RowPart {
  uint2 v[kP];
};

template <int kP>
__device__ __forceinline__ void gather(RowPart<kP>& out, const bf16* row, int lane) {
#pragma unroll
  for (int k = 0; k < kP; ++k) out.v[k] = __ldg(reinterpret_cast<const uint2*>(row + k * 128 + lane * 4));
}

__device__ __forceinline__ void unpack4(uint2 w, float f[4]) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  f[0] = __low2float(lo);
  f[1] = __high2float(lo);
  f[2] = __low2float(hi);
  f[3] = __high2float(hi);
}

// Entries lo .. hi - 1 of a list (each (row in chunk << 16) | bf16 bits of
// c) against dictionary row dj_row (read from shared memory at each entry:
// registers go to the gathered rows): acc += c dxh + bf16(dc) x and gb += dc,
// one entry after another. (Loading the next entry's rows ahead, at the cost
// of a second pair of rows in registers, gained nothing on an H100 at D 768,
// scripts/sparse_bwd_probe.py: the gathers run at the L2's read rate.)
template <int kP>
__device__ __forceinline__ void consume(const uint32_t* list, int lo, int hi, const bf16* dxh_rows,
                                        const bf16* x_rows, const bf16* dj_row, float l1b, int lane,
                                        float (&acc)[kP][4], float& gb) {
  constexpr int D = kP * 128;
  for (int i = lo; i < hi; ++i) {
    const uint32_t e = list[i];
    RowPart<kP> dr, xr;
    gather(dr, dxh_rows + (size_t)(e >> 16) * D, lane);
    gather(xr, x_rows + (size_t)(e >> 16) * D, lane);
    const float c = __bfloat162float(__ushort_as_bfloat16((unsigned short)(e & 0xFFFFu)));
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      float dv[4], jv[4];
      unpack4(dr.v[k], dv);
      unpack4(*reinterpret_cast<const uint2*>(dj_row + k * 128 + lane * 4), jv);
#pragma unroll
      for (int q = 0; q < 4; ++q) s = fmaf(dv[q], jv[q], s);
    }
    // xor butterfly: every lane ends with the same bits
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const float dc = c > 0.f ? __fadd_rn(s, l1b) : 0.f;
    const float dcb = __bfloat162float(__float2bfloat16_rn(dc));
    gb = __fadd_rn(gb, dc);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      float dv[4], xv[4];
      unpack4(dr.v[k], dv);
      unpack4(xr.v[k], xv);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = fmaf(dcb, xv[q], fmaf(c, dv[q], acc[k][q]));
    }
  }
}

template <bool kAdam, int kMu, int kNu, int kP>
__global__ void __launch_bounds__(kSpThreads, 2) sparse_bwd_kernel(const BwdArgs a, const SparsePlan pl) {
  constexpr int Nt = kSpRows, D = kP * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = a.B, N = a.N;
  bf16* dj_s = reinterpret_cast<bf16*>(smem);                            // [Nt][ld_bf16(D)]
  unsigned char* u = smem + pl.dj;                                       // loop region / gradient tile
  bf16* code_s = reinterpret_cast<bf16*>(u);                             // [kStages][kChunk][Nt]
  uint32_t* list_s = reinterpret_cast<uint32_t*>(u + pl.code);           // [Nt][kChunk]
  float* slot_s = reinterpret_cast<float*>(u + pl.code + pl.lists);      // [kSpWarps][D] partial rows
  float* slot_b = slot_s + kSpWarps * D;                                 // [kSpWarps] their bias sums
  int* slot_row = reinterpret_cast<int*>(slot_b + kSpWarps);             // [kSpWarps] owner, -1 empty
  int* count_s = slot_row + kSpWarps;                                    // [Nt] list lengths
  float* g_s = reinterpret_cast<float*>(u);                              // [Nt][ld_f32(D)], after the loop
  int* amax_s = reinterpret_cast<int*>(u + pl.g);                        // [2][Nt] (int8 moments)
  float* radial_s = reinterpret_cast<float*>(u + (pl.loop > pl.g + pl.epi ? pl.loop : pl.g + pl.epi));

  const int m = blockIdx.y, n0 = blockIdx.x * Nt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)m * N + n0;
  const float l1b = a.l1_over_b[m];
  const bf16* dxh_m = a.dxh + (size_t)m * B * D;
  const bf16* c_m = static_cast<const bf16*>(a.code) + (size_t)m * B * N + n0;
  const int n_chunks = (B + kChunk - 1) / kChunk;

  // chunk `chunk` of the code into ring stage chunk % kStages, one 16-byte
  // copy per batch row; one commit group per chunk (empty past the batch)
  auto issue_code = [&](int chunk) {
    if (chunk < n_chunks) {
      const int b0 = chunk * kChunk, rows = min(kChunk, B - b0);
      bf16* st = code_s + (chunk % kStages) * kChunk * Nt;
      for (int r = tid; r < rows; r += kSpThreads)
        __pipeline_memcpy_async(st + r * Nt, c_m + (size_t)(b0 + r) * N, 16);
    }
    __pipeline_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) issue_code(c);
  load_dj_tile<kAdam, kSpThreads>(a, dj_s, row0, Nt * D);

  float acc[kP][4];
#pragma unroll
  for (int k = 0; k < kP; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
  float gb = 0.f;
  const bf16* my_dj = dj_s + warp * ld_bf16(D);
  uint32_t* my_list = list_s + warp * kChunk;

  for (int t = 0; t < n_chunks; ++t) {
    const int b0 = t * kChunk, rows = min(kChunk, B - b0);
    // into the stage chunk t - 1 was compacted from (a barrier ago)
    issue_code(t + kStages - 1);
    __pipeline_wait_prior(kStages - 1);  // this thread's copies of chunk t have landed
    __syncthreads();                     // ... and everyone's (and dj_s is written)

    // warp w lists column w's non-zeros in ascending batch row
    const unsigned short* col = reinterpret_cast<const unsigned short*>(code_s + (t % kStages) * kChunk * Nt) + warp;
    int cnt = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const unsigned short bits = r < rows ? col[r * Nt] : (unsigned short)0;
      const bool nz = __bfloat162float(__ushort_as_bfloat16(bits)) != 0.f;  // NaN counts, as in c . dxh
      const uint32_t mask = __ballot_sync(0xffffffffu, nz);
      if (nz) my_list[cnt + __popc(mask & ((1u << lane) - 1u))] = ((uint32_t)r << 16) | bits;
      cnt += __popc(mask);
    }
    if (lane == 0) count_s[warp] = cnt;
    __syncwarp();
    const bf16* dxh_rows = dxh_m + (size_t)b0 * D;
    const bf16* x_rows = a.x + (size_t)b0 * D;
    // the first segment of the warp's own list, into its accumulators
    consume<kP>(my_list, 0, min(cnt, kSeg), dxh_rows, x_rows, my_dj, l1b, lane, acc, gb);
    __syncthreads();  // every list and length is in; the code stage is free

    // the further segments of long lists, items (row j, segment s >= 1) in
    // order of (j, s), one per warp a wave; the owner adds them in order
    int extra = 0;
    for (int j = 0; j < Nt; ++j) extra += extra_segments(count_s[j]);
    for (int w0 = 0; w0 < extra; w0 += kSpWarps) {
      int item = w0 + warp;
      if (item < extra) {
        int j = 0;
        while (item >= extra_segments(count_s[j])) item -= extra_segments(count_s[j++]);
        const int lo = (item + 1) * kSeg, hi = min(count_s[j], lo + kSeg);
        float part[kP][4];
#pragma unroll
        for (int k = 0; k < kP; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[k][q] = 0.f;
        float pb = 0.f;
        consume<kP>(list_s + j * kChunk, lo, hi, dxh_rows, x_rows, dj_s + j * ld_bf16(D), l1b, lane,
                           part, pb);
#pragma unroll
        for (int k = 0; k < kP; ++k)
          *reinterpret_cast<float4*>(slot_s + warp * D + k * 128 + lane * 4) =
              make_float4(part[k][0], part[k][1], part[k][2], part[k][3]);
        if (lane == 0) {
          slot_b[warp] = pb;
          slot_row[warp] = j;
        }
      } else if (lane == 0) {
        slot_row[warp] = -1;
      }
      __syncthreads();
      for (int s = 0; s < kSpWarps; ++s) {
        if (slot_row[s] != warp) continue;
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          const float4 p = *reinterpret_cast<const float4*>(slot_s + s * D + k * 128 + lane * 4);
          acc[k][0] = __fadd_rn(acc[k][0], p.x);
          acc[k][1] = __fadd_rn(acc[k][1], p.y);
          acc[k][2] = __fadd_rn(acc[k][2], p.z);
          acc[k][3] = __fadd_rn(acc[k][3], p.w);
        }
        gb = __fadd_rn(gb, slot_b[s]);
      }
      __syncthreads();  // the slots are free for the next wave
    }
  }

  __pipeline_wait_prior(0);
  __syncthreads();  // every read of the loop region is done: it becomes the gradient tile
  float* g_row = g_s + warp * ld_f32(D);
#pragma unroll
  for (int k = 0; k < kP; ++k)
    *reinterpret_cast<float4*>(g_row + k * 128 + lane * 4) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  if (lane == 0) a.g_bias[row0 + warp] = gb;
  __syncthreads();
  epilogue<kAdam, kMu, kNu, kSpThreads>(a, m, n0, Nt, Nt * D, dj_s, g_s, radial_s, amax_s);
}

template <bool kAdam, int kMu, int kNu, int kP>
int launch_sparse_width(const BwdArgs& a, int M, cudaStream_t st) {
  constexpr int kInt8Moments = kAdam ? (kMu == kInt8) + (kNu == kInt8) : 0;
  const size_t epi = kInt8Moments ? 2 * (size_t)kSpRows * sizeof(int) : 0;
  const SparsePlan p = sparse_plan(a.D, epi);
  if (p.total > kMaxSmem || a.N % kSpRows || a.B < 1 || M < 1) return (int)cudaErrorInvalidValue;
  auto kern = sparse_bwd_kernel<kAdam, kMu, kNu, kP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.N / kSpRows, M), kSpThreads, p.total, st>>>(a, p);
  return (int)cudaGetLastError();
}

// declared in tied_sae_bwd.cuh (K2's entry routes here)
template <bool kAdam, int kMu, int kNu>
int launch_sparse(const BwdArgs& a, int M, cudaStream_t st) {
  switch (a.D) {
    case 128: return launch_sparse_width<kAdam, kMu, kNu, 1>(a, M, st);
    case 256: return launch_sparse_width<kAdam, kMu, kNu, 2>(a, M, st);
    case 512: return launch_sparse_width<kAdam, kMu, kNu, 4>(a, M, st);
    case 768: return launch_sparse_width<kAdam, kMu, kNu, 6>(a, M, st);
    case 1024: return launch_sparse_width<kAdam, kMu, kNu, 8>(a, M, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
}  // namespace

extern "C" {

// K2 on the code's non-zeros: `code` = c [M, B, N] bf16; the rest as
// `adam_entry` (every moment tier). Needs D in {128, 256, 512, 768, 1024}
// and N % 16 == 0; any B.
int sc_tied_sae_bwd_adam_sparse(const void* x, const void* dxh, const void* code, const void* nrm,
                                void* d_raw, void* mu, void* mu_scale, int mu_tier, void* nu,
                                void* nu_scale, int nu_tier, void* g_bias, const void* l1_over_b,
                                const void* bc, const void* seed, int seed_tile, float lr, float b1,
                                float b2, float eps, float omb1, float omb2, int M, int B, int N,
                                int D, void* stream) {
  return adam_entry<kSparseRoute>(x, dxh, code, nrm, d_raw, mu, mu_scale, mu_tier, nu, nu_scale, nu_tier,
                                  g_bias, l1_over_b, bc, seed, seed_tile, lr, b1, b2, eps, omb1, omb2, M,
                                  B, N, D, stream);
}

// K3 on the code's non-zeros: the arguments of `sc_tied_sae_bwd_grads`
// (tied_sae_bwd.cu); shape limits as K2's sparse entry.
int sc_tied_sae_bwd_grads_sparse(const void* x, const void* dxh, const void* c, const void* nrm,
                                 const void* dhat_b, void* g_enc, void* g_bias, const void* l1_over_b,
                                 int M, int B, int N, int D, void* stream) {
  BwdArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.dxh = static_cast<const bf16*>(dxh);
  a.code = c;
  a.nrm = static_cast<const float*>(nrm);
  a.dhat_b = static_cast<const bf16*>(dhat_b);
  a.g_enc = static_cast<float*>(g_enc);
  a.g_bias = static_cast<float*>(g_bias);
  a.l1_over_b = static_cast<const float*>(l1_over_b);
  a.B = B, a.N = N, a.D = D;
  return launch_sparse<false, kF32, kF32>(a, M, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
