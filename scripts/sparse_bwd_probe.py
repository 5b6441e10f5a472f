"""Where the sparse route of K2/K3 spends its time, on one NVIDIA H100.

    python scripts/sparse_bwd_probe.py [--out probe.json]

At BASELINE config 4 (7 members, k 1..151, B 2048, N 12288, D 768, the code
from K_s + K_d) it builds variants of `ops/csrc/tied_sae_bwd_sparse.cu` by
text edits into ``build/sparse_bwd_probe/`` and times each through its C
entries (CUDA events, variants in A, B, ..., B, A turns):
  - shipped: the source as it is;
  - no_epilogue / no_code / no_code_no_epilogue: the epilogue call dropped,
    the code never read (every list empty), or both: the decomposition;
  - prefetch: the next entry's rows gathered while the current one is
    consumed, and the dot product in 4 partial sums;
  - chunk512: 512-row chunks in a 4-stage ring (the shipped 1024 in 2);
then per-block phase stamps (%globaltimer) of the shipped source (start →
first chunk, the chunk loop, the epilogue, by member), a pure read of the
code in the kernel's access pattern at 8, 16, 64 and 512 columns a block,
and byte floors of torch copies of the same tensors. Each variant's K3 is
held to the plain gradient (cosine). Prints one JSON object; needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "sparse_coding__tpu_torch" / "ops" / "csrc"
WORK = REPO / "build" / "sparse_bwd_probe"
KS = [1, 11, 31, 61, 91, 121, 151]
M, N, D, B = 7, 12288, 768, 2048

EPILOGUE = "  epilogue<kAdam, kMu, kNu, kSpThreads>(a, m, n0, Nt, Nt * D, dj_s, g_s, radial_s, amax_s);\n"
NO_CODE = [("    if (chunk < n_chunks) {\n      const int b0", "    if (false) {\n      const int b0"),
           ("const bool nz = __bfloat162float", "const bool nz = false && __bfloat162float")]
PREFETCH = [
    ("""  for (int i = lo; i < hi; ++i) {
    const uint32_t e = list[i];
    RowPart<kP> dr, xr;
    gather(dr, dxh_rows + (size_t)(e >> 16) * D, lane);
    gather(xr, x_rows + (size_t)(e >> 16) * D, lane);
""", """  if (lo >= hi) return;
  uint32_t en = list[lo];
  RowPart<kP> dn, xn;
  gather(dn, dxh_rows + (size_t)(en >> 16) * D, lane);
  gather(xn, x_rows + (size_t)(en >> 16) * D, lane);
  for (int i = lo; i < hi; ++i) {
    const uint32_t e = en;
    const RowPart<kP> dr = dn, xr = xn;
    if (i + 1 < hi) {
      en = list[i + 1];
      gather(dn, dxh_rows + (size_t)(en >> 16) * D, lane);
      gather(xn, x_rows + (size_t)(en >> 16) * D, lane);
    }
"""),
    ("      for (int q = 0; q < 4; ++q) s = fmaf(dv[q], jv[q], s);\n    }\n",
     "      for (int q = 0; q < 4; ++q) s4[q] = fmaf(dv[q], jv[q], s4[q]);\n    }\n"
     "    s = __fadd_rn(__fadd_rn(s4[0], s4[1]), __fadd_rn(s4[2], s4[3]));\n"),
    ("    float s = 0.f;\n#pragma unroll\n    for (int k = 0; k < kP; ++k) {\n      float dv[4], jv[4];",
     "    float s = 0.f, s4[4] = {0.f, 0.f, 0.f, 0.f};\n#pragma unroll\n    for (int k = 0; k < kP; ++k) {\n      float dv[4], jv[4];"),
]
CHUNK512 = [("constexpr int kChunk = 1024;", "constexpr int kChunk = 512; "),
            ("constexpr int kStages = 2; ", "constexpr int kStages = 4; ")]
STAMPS = [
    ('#include "tied_sae_bwd.cuh"\n', '#include "tied_sae_bwd.cuh"\n__device__ unsigned long long g_stamps[8 * 16384];\n'
     '__device__ __forceinline__ unsigned long long gtime() {\n  unsigned long long t;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n'),
    ("  const int n_chunks = (B + kChunk - 1) / kChunk;\n",
     "  const int n_chunks = (B + kChunk - 1) / kChunk;\n  const unsigned long long t_0 = gtime();\n"
     "  unsigned long long* stamp = g_stamps + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"),
    ("    __syncthreads();                     // ... and everyone's (and dj_s is written)\n",
     "    __syncthreads();                     // ... and everyone's (and dj_s is written)\n"
     "    if (t == 0 && tid == 0) stamp[1] = gtime();\n"),
    ("  float* g_row = g_s + warp * ld_f32(D);\n", "  if (tid == 0) stamp[2] = gtime();\n  float* g_row = g_s + warp * ld_f32(D);\n"),
    (EPILOGUE, "  if (tid == 0) stamp[3] = gtime();\n" + EPILOGUE
     + "  __syncthreads();\n  if (tid == 0) {\n    stamp[0] = t_0;\n    stamp[4] = gtime();\n  }\n"),
    ('extern "C" {\n', 'extern "C" {\nint sc_stamps(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)); }\n'),
]
VARIANTS = {
    "shipped": [],
    "no_epilogue": [(EPILOGUE, "")],
    "no_code": NO_CODE,
    "no_code_no_epilogue": [(EPILOGUE, "")] + NO_CODE,
    "prefetch": PREFETCH,
    "chunk512": CHUNK512,
    "stamps": STAMPS,
}
READ_PATTERN = r"""
#include <cuda_runtime.h>
template <int NT>
__global__ void __launch_bounds__(256) read_code(const uint4* __restrict__ c, int B, int N, unsigned* out) {
  const int m = blockIdx.y, n0 = blockIdx.x * NT;
  constexpr int V = NT / 8;
  unsigned acc = 0;
  for (int i = threadIdx.x; i < B * V; i += 256) {
    const uint4 w = __ldcg(c + ((size_t)m * B * N + (size_t)(i / V) * N + n0) / 8 + i % V);
    acc ^= w.x ^ w.y ^ w.z ^ w.w;
  }
  if (acc == 0x12345678u) out[blockIdx.x] = acc;
}
extern "C" int read_code_run(const void* c, int M, int B, int N, int nt, void* out, void* st) {
  cudaStream_t s = (cudaStream_t)st;
  const uint4* p = (const uint4*)c;
  unsigned* o = (unsigned*)out;
  if (nt == 8) read_code<8><<<dim3(N / 8, M), 256, 0, s>>>(p, B, N, o);
  if (nt == 16) read_code<16><<<dim3(N / 16, M), 256, 0, s>>>(p, B, N, o);
  if (nt == 64) read_code<64><<<dim3(N / 64, M), 256, 0, s>>>(p, B, N, o);
  if (nt == 512) read_code<512><<<dim3(N / 512, M), 256, 0, s>>>(p, B, N, o);
  return (int)cudaGetLastError();
}
"""


def build(torch, _build):
    """Every variant (and the read kernel), one nvcc each, all at once."""
    procs = {}
    shipped = (SRC / "tied_sae_bwd_sparse.cu").read_text()
    for name, edits in VARIANTS.items():
        d = WORK / name
        d.mkdir(parents=True, exist_ok=True)
        for h in SRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        s = shipped
        for a, b in edits:
            if s.count(a) != 1:
                raise SystemExit(f"variant {name}: edit does not apply to the shipped source: {a[:60]!r}")
            s = s.replace(a, b)
        (d / "k.cu").write_text(s)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "k.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (WORK / "read_code.cu").write_text(READ_PATTERN)
    procs["read_code"] = subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-o", str(WORK / "read_code.so"), str(WORK / "read_code.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out[-3000:]}")
        if name == "read_code":
            continue
        lib = ctypes.CDLL(str(WORK / name / "lib.so"))
        for fname in ("sc_tied_sae_bwd_grads_sparse", "sc_tied_sae_bwd_adam_sparse"):
            fn = getattr(lib, fname)
            fn.argtypes = _build.SIGNATURES[fname]
            fn.restype = ctypes.c_int
        libs[name] = lib
        regs = re.findall(r"sparse_bwd_kernelILb(\d)ELi(\d)ELi(\d)ELi6E.*?Used (\d+) registers", out, re.S)
        ptxas[name] = sorted({int(r[-1]) for r in regs})
    read = ctypes.CDLL(str(WORK / "read_code.so"))
    read.read_code_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    return libs, read, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sparse_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load()
    libs, read, ptxas = build(torch, _build)

    def time_ms(fn, reps=20):
        fn()
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    g = torch.Generator(device=dev).manual_seed(4321)
    d_raw = torch.randn((M, N, D), generator=g, device=dev)
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    s, th = kk.topk_scores(xb, db, torch.tensor(KS, dtype=torch.int32, device=dev))
    c, dxh, _ = kk.topk_decode(s, th, db, xb, 2.0 / (B * D))
    del s
    zero = torch.zeros_like(c)
    l1b = torch.zeros(M, device=dev)
    g_ref, _ = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
    g_enc, g_bias = torch.empty((M, N, D), device=dev), torch.empty((M, N), device=dev)
    bc = torch.tensor([[0.1, 0.001]] * M, device=dev)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    mu32, nu32 = torch.zeros_like(d_raw), torch.zeros_like(d_raw)
    q8, s8 = torch.zeros((M, N, D), dtype=torch.int8, device=dev), torch.ones((M, N), device=dev)
    nu16 = torch.zeros((M, N, D), dtype=torch.bfloat16, device=dev)
    d_work = d_raw.clone()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k3(lib, code):
        return lambda: lib.sc_tied_sae_bwd_grads_sparse(
            xb.data_ptr(), dxh.data_ptr(), code.data_ptr(), nrm.data_ptr(), db.data_ptr(), g_enc.data_ptr(),
            g_bias.data_ptr(), l1b.data_ptr(), M, B, N, D, stream())

    def k2(lib, tiers):
        mu, mus, mut, nu, nus, nut = ((mu32.data_ptr(), None, 0, nu32.data_ptr(), None, 0) if tiers == "f32"
                                      else (q8.data_ptr(), s8.data_ptr(), 2, nu16.data_ptr(), None, 1))
        return lambda: lib.sc_tied_sae_bwd_adam_sparse(
            xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), d_work.data_ptr(), mu, mus, mut, nu, nus,
            nut, g_bias.data_ptr(), l1b.data_ptr(), bc.data_ptr(), seed.data_ptr(), 128, 1e-3, 0.9, 0.999, 1e-8,
            0.1, 0.001, M, B, N, D, stream())

    timed = [n for n in VARIANTS if n != "stamps"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "shape": f"M={M},B={B},N={N},D={D},k={KS}",
           "code_nonzero_frac": float((c != 0).float().mean()), "registers_d768": ptxas, "variants": {}}
    for name in timed:
        res["variants"][name] = {"k3_ms": [], "k3_zero_code_ms": [], "k2_f32_ms": [], "k2_int8_bf16_ms": []}
    for name in timed + timed[::-1]:
        lib, r = libs[name], res["variants"][name]
        r["k3_ms"].append(time_ms(k3(lib, c)))
        r["k3_zero_code_ms"].append(time_ms(k3(lib, zero)))
        r["k2_f32_ms"].append(time_ms(k2(lib, "f32")))
        r["k2_int8_bf16_ms"].append(time_ms(k2(lib, "int8")))
    for name in timed:
        k3(libs[name], c)()
        torch.cuda.synchronize()
        a, b = g_enc.double().flatten(), g_ref.double().flatten()
        res["variants"][name]["k3_cos_vs_plain"] = float(a @ b / (a.norm() * b.norm() + 1e-300))

    # per-block phase stamps of the shipped source (its "stamps" build)
    lib = libs["stamps"]
    lib.sc_stamps.argtypes = [ctypes.c_void_p]
    blocks = (N // 8) * M
    stamps = {}
    for what, fn in (("k3", k3(lib, c)), ("k2_f32", k2(lib, "f32"))):
        fn()
        torch.cuda.synchronize()
        buf = torch.zeros(8 * 16384, dtype=torch.int64)
        assert lib.sc_stamps(buf.data_ptr()) == 0
        t = buf.view(-1, 8)[:blocks].double()
        t = (t - t[:, 0].min()) / 1e3  # microseconds from the first block's start
        phases = {"start_to_first_chunk": t[:, 1] - t[:, 0], "chunk_loop": t[:, 2] - t[:, 1],
                  "epilogue": t[:, 4] - t[:, 3], "block": t[:, 4] - t[:, 0]}
        per = N // 8
        stamps[what] = {
            "span_us": float(t[:, 4].max()),
            "mean_us": {k: float(v.mean()) for k, v in phases.items()},
            "by_member_mean_us": {k: [round(float(v[m * per:(m + 1) * per].mean()), 2) for m in range(M)]
                                  for k, v in phases.items()},
        }
    res["phase_stamps"] = stamps

    out = torch.zeros(4096, dtype=torch.int32, device=dev)
    res["read_code_ms_by_block_columns"] = {
        nt: time_ms(lambda nt=nt: read.read_code_run(c.data_ptr(), M, B, N, nt, out.data_ptr(), stream()))
        for nt in (8, 16, 64, 512)}
    cc, gg = torch.empty_like(c), torch.empty((M, N, D), device=dev)
    d2, m2, n2 = d_raw.clone(), torch.zeros_like(d_raw), torch.zeros_like(d_raw)
    res["torch_floor_ms"] = {
        "k3_bytes: copy the code, write g": time_ms(lambda: (cc.copy_(c), gg.fill_(0.0))),
        "k2_f32_bytes: rewrite d, mu, nu in place, copy the code": time_ms(
            lambda: (d2.mul_(1.0), m2.mul_(1.0), n2.mul_(1.0), cc.copy_(c))),
    }
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
