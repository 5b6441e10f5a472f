"""Where K_s (the scores GEMM and select), K_d (the sparse decode) and K1n
(the pipelined encode -> decode) spend their time, on one NVIDIA H100, and
whether `wgmma` gives `mma.sync`'s bits.

    python scripts/fwd_probe.py [--out probe.json] [--reps 20] [--sections ks,kd,k1,bits]
                                [--ks-first-design PARENT_DIR]

Builds variants of `ops/csrc/topk_fwd.cu` and `ops/csrc/tied_sae_fwd.cu` by
text edits into ``build/fwd_probe/`` (one nvcc each, all at once) and times
each through its C entry with CUDA events, the variants of a kernel in
A, B, ..., B, A turns:
  - K_s at BASELINE config 4 (7 members, k 1..151, B 2048, N 12288, D 768):
    shipped; ks_gemm_alone (the select launch dropped); ks_gemm_no_s_store;
    ks_gemm_no_mma (the TMA ring and the stores alone); ks_gemm_3_stages;
    the select alone on the shipped kernel's scores (`sc_topk_select`), at
    128 threads a row (shipped) and 256; `torch.bmm` alone and `bmm` +
    `topk(151)`. With --ks-first-design, the topk_fwd.cu of that checkout
    (K_s's first design: WMMA scores tiles, a select counting with shared
    atomics) too: as it is, its GEMM alone, without its s store, its select
    alone on given scores, and that select with plain stores in place of
    its first pass's atomics;
  - K_d at config 4: shipped; no_gather (the dictionary rows never loaded:
    the score stream, the mask, the c store and the list only); no_c_store;
    no_gather_no_store (the score stream and list alone);
    gather4_two_blocks (4 dictionary rows in flight a lane at two blocks an
    SM, against the shipped 2 at three); and a byte floor, a torch copy of
    the score tensor into c (the same 704 MB in and out);
  - K1n at BASELINE config 2 (8 members, B 2048, N 4096, D 512): shipped;
    no_decode_mma / no_encode_mma / no_mma (the `wgmma` products dropped,
    the TMA ring, the code's packing and exchange kept); no_exchange (the
    warp pairs' barrier dropped: wrong results, timing only);
  - K1 on the same pipeline (its template with the code store), at the same
    shape: the same variants, and no_code_store (K1's kernel with its
    store dropped).
Only the shipped sources' outputs are right; the variants are for timing
(the probe reports whether the first design's s and thresholds, and the
256-thread select's, equal the shipped kernel's bit for bit). Then a
one-block kernel multiplies the same bf16 operands by a chain of `wgmma`
k16 steps and by a chain of `mma.sync` m16n8k16 steps, both from k = 0 (A
and B from shared memory, K-major; and A from registers, B MN-major, as a
decode), and reports the share of f32 results whose bits differ. Prints
one JSON object with the card's name and power limit; needs a card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "sparse_coding__tpu_torch" / "ops" / "csrc"
WORK = REPO / "build" / "fwd_probe"

NO_GATHER = [("w[g][u] = __ldg(reinterpret_cast<const uint4*>(rp + u * 256));",
              "w[g][u] = make_uint4((uint32_t)lj[e0 + g], 0u, 0u, 0u);")]
NO_C_STORE = [("if (d0 == 0 && col < N) dst[col / 8]", "if (false && col < N) dst[col / 8]")]
DECODE_MMA = ("""      sm90::wgmma_rs<S::kCols, 1>(acc, af[q], sm90::desc(ds + (wg * S::kCols / 64) * S::kPanel + q * 2048, S::kPanel, 1024));
""", "      ;\n")
ENCODE_MMA = ("""        sm90::wgmma_ss<32, 0, 0>(e, sm90::desc(xs + sm90::swz(0, k, kPpRows), 16, 1024),
                                 sm90::desc(ds + sm90::swz(32 * wg, k, kPpNt), 16, 1024));
""", "        ;\n")
NO_EXCHANGE = ("      sm90::bar_sync(1 + (wt >> 5), 64);", "      ;")
NO_CODE_STORE = [("    if constexpr (kStoreCode && kPair) {", "    if constexpr (false) {"),
                 ("    } else if constexpr (kStoreCode) {", "    } else if constexpr (false) {")]
GATHER4_TWO_BLOCKS = [("constexpr int kGather = 2;", "constexpr int kGather = 4;"),
                      ("__launch_bounds__(kDecThreads, 3) decode_kernel", "__launch_bounds__(kDecThreads, 2) decode_kernel")]
VARIANTS = {
    "topk_fwd": {"shipped": [], "no_gather": NO_GATHER, "no_c_store": NO_C_STORE,
                 "no_gather_no_store": NO_GATHER + NO_C_STORE, "gather4_two_blocks": GATHER4_TWO_BLOCKS},
    "tied_sae_fwd": {"shipped": [], "no_decode_mma": [DECODE_MMA], "no_encode_mma": [ENCODE_MMA],
                     "no_mma": [DECODE_MMA, ENCODE_MMA],
                     "no_exchange": [NO_EXCHANGE], "no_code_store": NO_CODE_STORE},
}

# K_s as shipped (a TMA + wgmma GEMM, then a select on fp16 counts), by text
# edits: the GEMM alone (the select launch dropped), without its s store,
# without its products (the TMA ring and the stores alone), with 3 stages;
# the select at 256 threads a row (through `sc_topk_select`)
KS_GEMM_ALONE = ("  if (e != 0) return e;\n  return launch_select(s, k, thresh, M, B, N, st);",
                 "  if (e != 0) return e;\n  return 0;")
KS_NO_S_STORE = ("        if (r < B && tl.n0 + 32 * q < N)\n", "        if (r < B && tl.n0 + 32 * q < N && o[0] == 0x12345678u)\n")
KS_NO_MMA = ("""        sm90::wgmma_ss<kSCols, 0, 0>(acc, sm90::desc(xs + sm90::swz(64 * wg, k, kSRows), 16, 1024),
                                     sm90::desc(ds + sm90::swz(0, k, kSCols), 16, 1024));
""", "        ;\n")
KS_VARIANTS = {
    "ks_gemm_alone": [KS_GEMM_ALONE], "ks_gemm_no_s_store": [KS_GEMM_ALONE, KS_NO_S_STORE],
    "ks_gemm_no_mma": [KS_GEMM_ALONE, KS_NO_MMA],
    "ks_gemm_3_stages": [KS_GEMM_ALONE, ("constexpr int kSStages = 4;", "constexpr int kSStages = 3;")],
    "ks_select_256_threads": [("constexpr int kSelThreads = 128;", "constexpr int kSelThreads = 256;")],
}

# K_s in its first design (two launches: WMMA scores tiles through shared
# memory, then a select block a row counting the radix digits with shared
# atomics), applied to the topk_fwd.cu of the checkout given by
# --ks-first-design (the parent of the redesign): the GEMM alone, the GEMM
# without its s store, the select alone on a given s (the scores launch
# dropped), and that select with plain stores for the first pass's atomics
FIRST_SELECT_OFF = ("  select_kernel<<<dim3(B, M), kSelThreads, sel_smem, st>>>(",
                    "  if (false) select_kernel<<<dim3(B, M), kSelThreads, sel_smem, st>>>(")
FIRST_SCORES_OFF = ("  scores_kernel<<<dim3(N / kBN, B / kBM, M), kThreads, kSmemBytes, st>>>(",
                    "  if (false) scores_kernel<<<dim3(N / kBN, B / kBM, M), kThreads, kSmemBytes, st>>>(")
FIRST_NO_S_STORE = ("    *reinterpret_cast<__nv_bfloat162*>(s + ((size_t)m * B + b0 + r) * N + n0 + cc) =",
                    "    if (Cs[r * kLdC + cc] == 1234.5f) *reinterpret_cast<__nv_bfloat162*>(s + ((size_t)m * B + b0 + r) * N + n0 + cc) =")
FIRST_NO_ATOMICS = ("atomicAdd(&hist[keys[i] >> 8], 1);", "hist[keys[i] >> 8] = i;")
KS_FIRST_DESIGN = {
    "first_design": [], "first_gemm_alone": [FIRST_SELECT_OFF],
    "first_gemm_no_s_store": [FIRST_SELECT_OFF, FIRST_NO_S_STORE],
    "first_select_alone": [FIRST_SCORES_OFF], "first_select_no_atomics": [FIRST_SCORES_OFF, FIRST_NO_ATOMICS],
}

WG_BITS_CU = r"""// Does a chain of wgmma k16 steps give the same f32 bits as a chain of
// mma.sync m16n8k16 steps on the same bf16 operands? C = A . B^T, A [64][K],
// B [128][K] (both K-major), one f32 accumulator per element from k = 0.
// Also the register-A form: C = A . Bt, A [64][K] from registers, Bt [K][128]
// (MN-major), as a decode would run it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include "sm90.cuh"
typedef __nv_bfloat16 bf16;

__global__ void mma_kernel(const bf16* A, const bf16* B, float* C, int K, int b_kmajor) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(A);
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(B);
  float d[16][4] = {};
  for (int k = 0; k < K; k += 16) {
    uint32_t af[4];
    const int r0 = 16 * warp + g;
    auto pa = [&](int r, int c) { return (uint32_t)a16[r * K + c] | ((uint32_t)a16[r * K + c + 1] << 16); };
    af[0] = pa(r0, k + 2 * t4);
    af[1] = pa(r0 + 8, k + 2 * t4);
    af[2] = pa(r0, k + 2 * t4 + 8);
    af[3] = pa(r0 + 8, k + 2 * t4 + 8);
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + g;
      auto pb = [&](int kk) {
        return b_kmajor ? ((uint32_t)b16[n * K + kk] | ((uint32_t)b16[n * K + kk + 1] << 16))
                        : ((uint32_t)b16[kk * 128 + n] | ((uint32_t)b16[(kk + 1) * 128 + n] << 16));
      };
      const uint32_t bf[2] = {pb(k + 2 * t4), pb(k + 2 * t4 + 8)};
      sm90::mma_16816(d[j], af, bf);
    }
  }
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) C[(16 * warp + g + 8 * (e >> 1)) * 128 + 8 * j + 2 * t4 + (e & 1)] = d[j][e];
}

// b_kmajor 1: A and B from shared memory (ss); 0: A from registers, B [K][128] MN-major (rs)
__global__ void wg_kernel(const bf16* A, const bf16* B, float* C, int K, int b_kmajor) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* as = smem;                 // A [64][K] swizzled, K-major
  unsigned char* bs = smem + 64 * K * 2;    // B [128][K] K-major, or [K][128] MN-major
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * K; i += 128) {
    const int r = i / K, c = i % K;
    *reinterpret_cast<bf16*>(as + sm90::swz(r, c, 64)) = A[i];
  }
  for (int i = tid; i < 128 * K; i += 128) {
    if (b_kmajor) {
      const int r = i / K, c = i % K;
      *reinterpret_cast<bf16*>(bs + sm90::swz(r, c, 128)) = B[i];
    } else {
      const int r = i / 128, c = i % 128;  // row k, column n: panels of 64 n, [K][128 B]
      *reinterpret_cast<bf16*>(bs + sm90::swz(r, c, K)) = B[i];
    }
  }
  sm90::fence_proxy_async();
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint32_t a0 = sm90::smem_u32(as), b0 = sm90::smem_u32(bs);
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(A);
  sm90::fence_regs(d);
  for (int k = 0; k < K; k += 16) {
    sm90::wg_fence();
    if (b_kmajor) {
      sm90::wgmma_ss<128, 0, 0>(d, sm90::desc(a0 + sm90::swz(0, k, 64), 16, 1024),
                                sm90::desc(b0 + sm90::swz(0, k, 128), 16, 1024));
    } else {
      const int r0 = 16 * warp + g;
      auto pa = [&](int r, int c) { return (uint32_t)a16[r * K + c] | ((uint32_t)a16[r * K + c + 1] << 16); };
      const uint32_t af[4] = {pa(r0, k + 2 * t4), pa(r0 + 8, k + 2 * t4), pa(r0, k + 2 * t4 + 8),
                              pa(r0 + 8, k + 2 * t4 + 8)};
      sm90::wgmma_rs<128, 1>(d, af, sm90::desc(b0 + k * 128, K * 128, 1024));
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(d);
  }
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) C[(16 * warp + g + 8 * (e >> 1)) * 128 + 8 * j + 2 * t4 + (e & 1)] = d[4 * j + e];
}

extern "C" int run(const void* A, const void* B, void* C1, void* C2, int K, int b_kmajor) {
  mma_kernel<<<1, 128>>>((const bf16*)A, (const bf16*)B, (float*)C1, K, b_kmajor);
  const int smem = 1024 + 64 * K * 2 + 128 * K * 2;
  cudaFuncSetAttribute(wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wg_kernel<<<1, 128, smem>>>((const bf16*)A, (const bf16*)B, (float*)C2, K, b_kmajor);
  return (int)cudaDeviceSynchronize();
}
"""


def _nvcc_all(jobs, flags, nvcc):
    """{name: source path} -> {name: CDLL}, one nvcc each, all at once."""
    procs = {k: subprocess.Popen([nvcc, *flags, f"-I{SRC}", "-o", str(WORK / f"lib{k}.so"), str(p)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, p in jobs.items()}
    libs = {}
    for k, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {k}:\n{log}")
        libs[k] = ctypes.CDLL(str(WORK / f"lib{k}.so"))
    return libs


def _edited(jobs, src_dir: Path, stem: str, kinds, prefix: str = "") -> None:
    """Write ``stem``.cu of ``src_dir`` with each variant's edits into WORK."""
    text = (src_dir / f"{stem}.cu").read_text()
    for name, edits in kinds.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {stem}/{name}: the edit no longer applies to {src_dir}")
            src = src.replace(old, new)
        path = WORK / f"{prefix}{stem}.{name}.cu"
        path.write_text(src)
        jobs[f"{stem}.{name}"] = path


def build(flags, nvcc, variants=True, ks_first_design=None, sections=("ks", "kd", "k1")):
    """The variants of the kernels ``sections`` time (unless ``variants`` is
    false), the first design's K_s variants when ``ks_first_design`` names a
    checkout, and the bit probe: {name: CDLL}."""
    WORK.mkdir(parents=True, exist_ok=True)
    jobs = {}
    topk = {"shipped": [], **(VARIANTS["topk_fwd"] if "kd" in sections else {}),
            **(KS_VARIANTS if "ks" in sections else {})}
    wanted = {"topk_fwd": topk, "tied_sae_fwd": VARIANTS["tied_sae_fwd"] if "k1" in sections else {}}
    for stem, kinds in wanted.items() if variants else ():
        _edited(jobs, SRC, stem, kinds)
    if ks_first_design:
        _edited(jobs, Path(ks_first_design) / "sparse_coding__tpu_torch" / "ops" / "csrc", "topk_fwd",
                KS_FIRST_DESIGN, prefix="first.")
    (WORK / "wg_bits.cu").write_text(WG_BITS_CU)
    jobs["wg_bits"] = WORK / "wg_bits.cu"
    return _nvcc_all(jobs, flags, nvcc)


def wgmma_bits(torch, lib, depths=(64, 128, 256, 512), seed=12):
    """Per depth and form, the share of f32 results whose bits differ between
    the `wgmma` chain and the `mma.sync` chain on the same bf16 operands."""
    lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.run.restype = ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for K in depths:
        for kmajor in (1, 0):
            a = torch.randn((64, K), generator=g, device=dev)
            a = (a if kmajor else torch.relu(a)).to(torch.bfloat16)
            b = torch.randn((128, K) if kmajor else (K, 128), generator=g, device=dev).to(torch.bfloat16)
            c1, c2 = torch.empty((64, 128), device=dev), torch.empty((64, 128), device=dev)
            rc = lib.run(a.data_ptr(), b.data_ptr(), c1.data_ptr(), c2.data_ptr(), K, kmajor)
            ref = a.float() @ (b.float().t() if kmajor else b.float())
            out.append({"K": K, "form": "ss, K-major" if kmajor else "rs, B MN-major", "rc": rc,
                        "share_of_bits_differing": float((c1.view(torch.int32) != c2.view(torch.int32)).float().mean()),
                        "max_abs_mma_vs_f32": float((c1 - ref).abs().max()),
                        "max_abs_wgmma_vs_f32": float((c2 - ref).abs().max())})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON here")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sections", default="ks,kd,k1,bits",
                    help="comma list of: ks (K_s), kd (K_d), k1 (K1n and K1), bits (wgmma vs mma.sync)")
    ap.add_argument("--ks-first-design", metavar="DIR",
                    help="a checkout whose topk_fwd.cu holds K_s's first design: time its variants too")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    import torch

    if not torch.cuda.is_available():
        print("fwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from sparse_coding__tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(_build.NVCC_FLAGS, _build._nvcc(), sections=sections,
                 ks_first_design=args.ks_first_design if "ks" in sections else None)
    for lib in libs.values():
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    st = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.reps

    def turns(fns):
        names = list(fns)
        ms = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                ms[n].append(timed(fns[n]))
        return {n: {"ms": v, "median_ms": statistics.median(v)} for n, v in ms.items()}

    out = {}
    # K_s and K_d, config 4
    M, B, N, D = 7, 2048, 12288, 768
    d_raw = torch.randn((M, N, D), generator=g, device=dev)
    db = (d_raw / d_raw.norm(dim=-1, keepdim=True)).to(bf16)
    del d_raw
    xb = torch.randn((B, D), generator=g, device=dev).to(bf16)
    k = torch.tensor([1, 11, 31, 61, 91, 121, 151], dtype=torch.int32, device=dev)
    # the shipped K_s's scores and thresholds (through the probe's own build
    # of the source: no other library is built)
    s = torch.empty((M, B, N), dtype=bf16, device=dev)
    th = torch.empty((M, B), device=dev)
    libs["topk_fwd.shipped"].sc_topk_scores(xb.data_ptr(), db.data_ptr(), k.data_ptr(), s.data_ptr(), th.data_ptr(),
                                            M, B, N, D, st)
    if "ks" in sections:
        out["topk_scores"] = ks_section(torch, libs, xb, db, k, s, th, turns, st)
    c = torch.empty_like(s)
    dxh = torch.empty((M, B, D), dtype=bf16, device=dev)
    lr = torch.empty((M, B), device=dev)

    def kd(lib):
        return lambda: lib.sc_topk_decode(xb.data_ptr(), db.data_ptr(), s.data_ptr(), th.data_ptr(), c.data_ptr(),
                                          dxh.data_ptr(), lr.data_ptr(), M, B, N, D, 2.0 / (B * D), st)

    if "kd" in sections:
        fns = {n: kd(libs[f"topk_fwd.{n}"]) for n in VARIANTS["topk_fwd"]}
        fns["copy_s_to_c"] = lambda: c.copy_(s)
        out["topk_decode"] = turns(fns)
        kd(libs["topk_fwd.shipped"])()  # c from the shipped source
        out["topk_decode"]["kept_per_row"] = float((c != 0).sum(-1).float().mean())
        out["topk_decode"]["gathered_bytes"] = int((c != 0).sum()) * D * 2
    del s, th, c, dxh, lr, db, xb
    torch.cuda.empty_cache()
    if "k1" in sections:
        k1_sections(torch, libs, g, turns, st, out)
    if "bits" in sections:
        # wgmma against mma.sync, bit for bit
        out["wgmma_vs_mma_sync_bits"] = wgmma_bits(torch, libs["wg_bits"])
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60).stdout.strip()
    text = json.dumps(out)
    if args.out:
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


def ks_section(torch, libs, xb, db, k, s, th, turns, st):
    """K_s at config 4: each variant through its C entry, beside `torch.bmm`
    alone (the GEMM's library call) and `bmm` + `topk(151)`; the select
    variants read the shipped kernel's scores ``s``."""
    M, N, D = db.shape
    B = xb.shape[0]
    s_out, th_out = torch.empty_like(s), torch.empty_like(th)
    xbm, dbt = xb.expand(M, B, D), db.transpose(1, 2)

    def call(lib, s_buf):
        return lambda: lib.sc_topk_scores(xb.data_ptr(), db.data_ptr(), k.data_ptr(), s_buf.data_ptr(),
                                          th_out.data_ptr(), M, B, N, D, st)

    fns = {}
    for name in KS_FIRST_DESIGN:
        lib = libs.get(f"topk_fwd.{name}")
        if lib is not None:  # a select-alone variant reads the given scores in place
            fns[name] = call(lib, s if "select" in name else s_out)
    for name in ("shipped", *KS_VARIANTS):
        lib = libs[f"topk_fwd.{name}"]
        if "select" not in name:
            fns[name] = call(lib, s_out)
        if name in ("shipped", "ks_select_256_threads"):
            fns[f"{name}_select_alone"] = (lambda lib=lib: lib.sc_topk_select(
                s.data_ptr(), k.data_ptr(), th_out.data_ptr(), M, B, N, st))
    fns["bmm"] = lambda: torch.bmm(xbm, dbt)
    fns["bmm_topk151"] = lambda: torch.topk(torch.bmm(xbm, dbt), 151, dim=-1)
    res = turns(fns)
    # the select variant's thresholds against the shipped kernel's
    fns["ks_select_256_threads_select_alone"]()
    torch.cuda.synchronize()
    res["select_256_threads_thresh_bit_equal"] = bool(torch.equal(th_out.view(torch.int32), th.view(torch.int32)))
    # the first design's outputs, where built, against the shipped kernel's
    if "first_design" in fns:
        fns["first_design"]()
        torch.cuda.synchronize()
        res["first_design_s_bit_equal"] = bool(torch.equal(s_out.view(torch.int16), s.view(torch.int16)))
        res["first_design_thresh_bit_equal"] = bool(torch.equal(th_out.view(torch.int32), th.view(torch.int32)))
    return res


def k1_sections(torch, libs, g, turns, st, out):
    bf16 = torch.bfloat16
    dev = torch.device("cuda")

    # K1n, config 2
    M, B, N, D = 8, 2048, 4096, 512
    d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
    bias = torch.randn((M, N), generator=g, device=dev) * 0.01
    xb = torch.randn((B, D), generator=g, device=dev).to(bf16)
    db = (d_raw / d_raw.norm(dim=-1, keepdim=True)).to(bf16)
    dxh = torch.empty((M, B, D), dtype=bf16, device=dev)
    parts = torch.empty((2, M, B // 64), device=dev)

    def k1n(lib):
        return lambda: lib.sc_tied_sae_fwd_nocode(xb.data_ptr(), db.data_ptr(), bias.data_ptr(), dxh.data_ptr(),
                                                  parts[0].data_ptr(), parts[1].data_ptr(), M, B, N, D,
                                                  2.0 / (B * D), st)

    out["tied_sae_fwd_nocode"] = turns({n: k1n(libs[f"tied_sae_fwd.{n}"]) for n in VARIANTS["tied_sae_fwd"]})
    c = torch.empty((M, B, N), dtype=bf16, device=dev)

    def k1(lib):
        return lambda: lib.sc_tied_sae_fwd(xb.data_ptr(), db.data_ptr(), bias.data_ptr(), c.data_ptr(), dxh.data_ptr(),
                                           parts[0].data_ptr(), parts[1].data_ptr(), M, B, N, D, 2.0 / (B * D), st)

    out["tied_sae_fwd"] = turns({n: k1(libs[f"tied_sae_fwd.{n}"]) for n in VARIANTS["tied_sae_fwd"]})


if __name__ == "__main__":
    sys.exit(main())
