"""Where the dense K2/K3's wgmma mainloop spends its time, on one NVIDIA H100.

    python scripts/dense_bwd_probe.py [--reps 20] [--out probe.json]

Builds variants of `ops/csrc/tied_sae_bwd.cuh` by text edits into
``build/dense_bwd_probe/<variant>/`` (one nvcc each, all at once; each
library exports the wgmma mainloop's K3 and K2 with bf16 mu and f32 nu on
the stored code, and K2 with int8 mu and bf16 nu rebuilding the code, at
D 256 and 512) and times them through their C entries with CUDA events (one child process a
variant and turn, every variant and then again in reverse order; a variant
that hangs is cut after 180 s and named), at BASELINE config 2 (M 8, B 2048,
N 4096, D 512: on the stored code a cluster of two blocks splits 128 rows'
columns; rebuilding it a block of 64 rows splits its columns over the two
warpgroups) and at the same shape with D 256 (128-row blocks, no split):
  - shipped: the source as it is;
  - no_gemm1 / no_gemm2 / no_gemms: the dc product, the gradient products,
    or both dropped (their registers stay zero);
  - no_gemms_no_exchange: also without the exchange of dc's depth halves
    (D 512: through distributed shared memory, or shared memory and two
    barriers a tile): what is left is the TMA ring, the mask and the
    epilogue;
  - no_epilogue: the shared epilogue dropped (the gradient stays on chip);
  - stages2 / stages3: the ring capped at 2 or 3 stages (D 256 takes 4).
Each variant's K3 gradient's cosine against the plain version is reported
(a variant that drops work does not compute it). Prints one JSON object with
the card's name and power limit; needs a card and nvcc.
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
WORK = REPO / "build" / "dense_bwd_probe"
CASES = {"config2_d512": (8, 2048, 4096, 512), "d256": (8, 2048, 4096, 256)}

ENTRY = r'''
#include "tied_sae_bwd.cuh"
extern "C" {
int probe_k3(const void* x, const void* dxh, const void* c, const void* nrm, const void* dhat_b, void* g_enc,
             void* g_bias, const void* l1_over_b, int M, int B, int N, int D, void* stream) {
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return D == 512 ? launch_wg<false, kF32, kF32, false, 512>(a, M, st) : launch_wg<false, kF32, kF32, false, 256>(a, M, st);
}
int probe_k2(const void* x, const void* dxh, const void* c, const void* nrm, void* d_raw, void* mu, void* nu,
             void* g_bias, const void* l1_over_b, const void* bc, int M, int B, int N, int D, void* stream) {
  BwdArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.dxh = static_cast<const bf16*>(dxh);
  a.code = c;
  a.nrm = static_cast<const float*>(nrm);
  a.d_raw = static_cast<float*>(d_raw);
  a.mu = mu;
  a.nu = nu;
  a.g_bias = static_cast<float*>(g_bias);
  a.l1_over_b = static_cast<const float*>(l1_over_b);
  a.bc = static_cast<const float*>(bc);
  a.lr = 1e-3f, a.b1 = 0.9f, a.b2 = 0.999f, a.eps = 1e-8f, a.omb1 = 0.1f, a.omb2 = 0.001f;
  a.B = B, a.N = N, a.D = D;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return D == 512 ? launch_wg<true, kBf16, kF32, false, 512>(a, M, st) : launch_wg<true, kBf16, kF32, false, 256>(a, M, st);
}
int probe_k2rc(const void* x, const void* dxh, const void* bias, const void* nrm, void* d_raw, void* mu,
               void* mu_scale, void* nu, void* g_bias, const void* l1_over_b, const void* bc, const void* seed,
               int M, int B, int N, int D, void* stream) {
  BwdArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.dxh = static_cast<const bf16*>(dxh);
  a.code = bias;
  a.nrm = static_cast<const float*>(nrm);
  a.d_raw = static_cast<float*>(d_raw);
  a.mu = mu;
  a.mu_scale = static_cast<float*>(mu_scale);
  a.nu = nu;
  a.g_bias = static_cast<float*>(g_bias);
  a.l1_over_b = static_cast<const float*>(l1_over_b);
  a.bc = static_cast<const float*>(bc);
  a.seed = static_cast<const int*>(seed);
  a.seed_tile = 256;
  a.lr = 1e-3f, a.b1 = 0.9f, a.b2 = 0.999f, a.eps = 1e-8f, a.omb1 = 0.1f, a.omb2 = 0.001f;
  a.B = B, a.N = N, a.D = D;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return D == 512 ? launch_wg<true, kInt8, kBf16, true, 512>(a, M, st) : launch_wg<true, kInt8, kBf16, true, 256>(a, M, st);
}
}
'''


def drop_call(src: str, prefix: str) -> str:
    """Remove the statement that starts with ``prefix`` (a call), through its
    matching parenthesis and semicolon."""
    i = src.index(prefix)
    j = src.index("(", i + len(prefix) - 1)
    depth = 0
    for k in range(j, len(src)):
        depth += {"(": 1, ")": -1}.get(src[k], 0)
        if depth == 0:
            break
    end = src.index(";", k) + 1
    return src[:i] + src[end:]


GEMM1 = "sm90::wgmma_ss<kWgTb, 0, 0>("
GEMM2 = ("sm90::wgmma_ss<kNw, 1, 1>(", "sm90::wgmma_rs<kNw, 1>(")
EXCHANGE = [("if constexpr (kMode == kColSplit) {\n#pragma unroll", "if constexpr (false) {\n#pragma unroll"),
            ("} else if constexpr (kMode == kPairSplit) {\n        float4* slot", "} else if constexpr (false) {\n        float4* slot"),
            ("if constexpr (kMode != kRowSplit) {\n        const float4* other;", "if constexpr (false) {\n        const float4* other;")]
EPILOGUE = "epilogue<kAdam, kMu, kNu, kWgThreads, kBarAll, SwizzledDj>("


def variants(src: str):
    out = {"shipped": src}
    out["no_gemm1"] = drop_call(src, GEMM1)
    g2 = src
    for p in GEMM2:
        g2 = drop_call(g2, p)
    out["no_gemm2"] = g2
    out["no_gemms"] = drop_call(g2, GEMM1)
    v = out["no_gemms"]
    for a, b in EXCHANGE:
        assert a in v, a
        v = v.replace(a, b)
    out["no_gemms_no_exchange"] = v
    out["no_epilogue"] = drop_call(drop_call(src, EPILOGUE), EPILOGUE)  # the producer's and the consumers' calls
    for st in (2, 3):
        v = src.replace("constexpr int kWgMaxStages = 4;", f"constexpr int kWgMaxStages = {st};")
        assert v != src
        out[f"stages{st}"] = v
    return out


def build(nvcc: str, flags) -> list:
    """Compile every variant in parallel; the names built."""
    src = (SRC / "tied_sae_bwd.cuh").read_text()
    procs = {}
    for name, text in variants(src).items():
        d = WORK / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "tied_sae_bwd.cuh").write_text(text)
        (d / "sm90.cuh").write_text((SRC / "sm90.cuh").read_text())
        (d / "probe.cu").write_text(ENTRY)
        procs[name] = subprocess.Popen([nvcc, *flags, "-o", str(d / "libprobe.so"), str(d / "probe.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        print(f"built {name}", file=sys.stderr, flush=True)
    return list(procs)


def time_variant(name: str, reps: int) -> dict:
    """One variant's K3, K2 and rebuilding K2 at each case: ms per launch,
    and the K3 gradient's cosine against the plain version."""
    import torch

    sys.path.insert(0, str(REPO))
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(str(WORK / name / "libprobe.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_k3.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.probe_k2.argtypes = [P] * 10 + [I] * 4 + [P]
    lib.probe_k2rc.argtypes = [P] * 12 + [I] * 4 + [P]
    dev = torch.device("cuda")
    st = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for case, (M, B, N, D) in CASES.items():
        g = torch.Generator(device=dev).manual_seed(3)
        d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
        bias = torch.randn((M, N), generator=g, device=dev) * 0.01
        xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
        nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
        db = (d_raw / nrm[..., None]).to(torch.bfloat16)
        l1b = torch.linspace(1e-4, 1e-2, M, device=dev) / B
        c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
        g_enc, g_bias = torch.empty_like(d_raw), torch.empty_like(nrm)
        mu = (torch.randn((M, N, D), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
        nu = torch.rand((M, N, D), generator=g, device=dev) * 1e-6
        d_k, bc = d_raw.clone(), torch.tensor([[0.1, 0.001]] * M, device=dev)
        q8 = torch.randint(-127, 128, (M, N, D), generator=g, device=dev).to(torch.int8)
        q8_scale = torch.rand((M, N), generator=g, device=dev) * 1e-5 + 1e-6
        nu16 = nu.to(torch.bfloat16)
        seed = torch.ones(1, dtype=torch.int32, device=dev)
        fns = {
            "k3": lambda: lib.probe_k3(xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), db.data_ptr(),
                                       g_enc.data_ptr(), g_bias.data_ptr(), l1b.data_ptr(), M, B, N, D, st),
            "k2": lambda: lib.probe_k2(xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), d_k.data_ptr(),
                                       mu.data_ptr(), nu.data_ptr(), g_bias.data_ptr(), l1b.data_ptr(),
                                       bc.data_ptr(), M, B, N, D, st),
            "k2rc": lambda: lib.probe_k2rc(xb.data_ptr(), dxh.data_ptr(), bias.data_ptr(), nrm.data_ptr(),
                                           d_k.data_ptr(), q8.data_ptr(), q8_scale.data_ptr(), nu16.data_ptr(),
                                           g_bias.data_ptr(), l1b.data_ptr(), bc.data_ptr(), seed.data_ptr(),
                                           M, B, N, D, st),
        }
        assert fns["k3"]() == 0
        gp, _ = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
        cos = float(torch.nn.functional.cosine_similarity(g_enc.flatten().double(), gp.flatten().double(), dim=0))
        out[case] = {"k3_cos_vs_plain": cos}
        for which, fn in fns.items():
            print(f"{case} {which}", file=sys.stderr, flush=True)  # where a hang would be
            for _ in range(2):
                assert fn() == 0
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            out[case][which] = s.elapsed_time(e) / reps
        del d_raw, c, dxh, g_enc, mu, nu, d_k, q8, nu16
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(time_variant(args.child, args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("dense_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from sparse_coding__tpu_torch.ops import _build

    _build.load()  # K1 (the inputs' code and dxh), built once before the children load it
    names = build(_build._nvcc(), _build.NVCC_FLAGS)
    # one child process a variant and turn (a hang is cut by its timeout and
    # named), every variant, then again in reverse order
    turns = {}
    for name in names + names[::-1]:
        try:
            run = subprocess.run([sys.executable, __file__, "--child", name, "--reps", str(args.reps)],
                                 capture_output=True, text=True, timeout=180)
            res = json.loads(run.stdout.strip().splitlines()[-1]) if run.returncode == 0 else {"error": run.stderr[-800:]}
        except subprocess.TimeoutExpired as e:
            # a child that printed its times but did not exit keeps them
            printed = (e.stdout or b"").decode(errors="replace").strip().splitlines()
            res = json.loads(printed[-1]) if printed else {}
            last = (e.stderr or b"").decode(errors="replace").strip().splitlines()[-1:]
            res["error"] = "timed out " + (" after printing its times" if printed else f"at {last}")
        turns.setdefault(name, []).append(res)
        print(f"timed {name}: {res}", file=sys.stderr, flush=True)
    result = {"reps": args.reps, "cases": {}, "turns": turns}
    for case, shape in CASES.items():
        ms = {}
        for name, runs in turns.items():
            good = [r[case] for r in runs if case in r]  # a turn cut before it printed adds nothing
            if good:
                ms[name] = {w: statistics.median(r[w] for r in good) for w in ("k3", "k2", "k2rc")}
                ms[name]["k3_cos_vs_plain"] = good[0]["k3_cos_vs_plain"]
        result["cases"][case] = {"shape": list(shape), "ms": ms}
    result["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, timeout=60).stdout.strip()
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
