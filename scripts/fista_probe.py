"""Where K_f (the one-launch FISTA solve) spends its time on one NVIDIA H100,
and how far another order of its float32 sums moves the codes.

    python scripts/fista_probe.py [--out probe.json] [--iters 50] [--reps 3]
    python scripts/fista_probe.py --order-study [--cpu] [--batch 2048]

Timing (needs a card and nvcc): builds variants of `ops/csrc/fista.cu` by
text edits into ``build/fista_probe/`` (one nvcc each, all at once) and
times each through its C entry with CUDA events, in A, B, ..., B, A turns, at
BASELINE config 3 (M 4, B 2048, N 2048, D 512) cut to ``--iters``
iterations and at row 8's shape (M 2, B 256, N 512, D 128, 100
iterations): shipped; few_products (each thread's FMAs cut to the 1 in 8
on its tile's diagonal: the loads, stages, barriers and epilogues kept);
no_copies (no operand copy into the stages: the products run on whatever
they hold); no_update_io (the second phase's epilogue neither loads nor
stores a and y); no_grid_barrier (the arrive and wait dropped: wrong results, the barriers'
cost only); four_stages (a ring of four stages, three in flight);
deep_stages (stages of twice the depths: half the block barriers);
one_block_an_sm (launch bounds for one block an SM: up to 255 registers);
tile64 (64-row tiles at config 3). Only the shipped source's codes are
right; the variants are for timing.

Order study (``--order-study``, on the card, or on the CPU with ``--cpu``):
the plain loop (`models.fista.fista_codes`) at config 3's widths for 500
iterations against the same loop with its two products computed another
way: the depth summed in two halves, the exact products rounded once
(float64, then float32), and 3xTF32 splitting (the emulation of
`tests/test_torch_fista_tf32.py`). Reports, for each, the largest code
difference, the share of codes whose support (> 0) flips, per member too,
and the relative difference of ‖x − â·D‖². Prints one JSON object with the
device's name (and on a card its power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "sparse_coding__tpu_torch" / "ops" / "csrc"
WORK = REPO / "build" / "fista_probe"

FEW_PRODUCTS = [("for (int j = 0; j < 2 * kH; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);",
                 "for (int j = 0; j < 2 * kH; ++j) if (i == j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);")]
NO_GRID_BARRIER = [
    ("    atomicAdd(count, 1u);\n    while (*reinterpret_cast<volatile unsigned*>(count) < target) {\n    }\n", "")]
NO_COPIES = [("if (in_k && row0 + o < rows) cp16(", "if (true) {} else if (false) cp16("),
             ("if (in_k && col0 + o < cols) cp16(", "if (true) {} else if (false) cp16(")]
NO_UPDATE_IO = [("float4 av = __ldcg(reinterpret_cast<const float4*>(am + off));",
                 "float4 av = make_float4(0.f, 0.f, 0.f, 0.f);"),
                ("float4 yv = __ldcg(reinterpret_cast<const float4*>(ym + off));", "float4 yv = av;"),
                ("*reinterpret_cast<float4*>(am + off) = av;", ""), ("*reinterpret_cast<float4*>(ym + off) = yv;", "")]
ONE_BLOCK_AN_SM = [("__launch_bounds__(kThreads, 2) solve_kernel", "__launch_bounds__(kThreads, 1) solve_kernel")]
FOUR_STAGES = [("constexpr int kStages = 2;", "constexpr int kStages = 4;")]
DEEP_STAGES = [("static constexpr int kDepth = 2048 / kT;", "static constexpr int kDepth = 4096 / kT;")]
TILE64 = [("if (fills(128)) return launch<128>(p, sms, st);", "")]
VARIANTS = {"shipped": [], "few_products": FEW_PRODUCTS, "no_copies": NO_COPIES, "no_update_io": NO_UPDATE_IO,
            "no_grid_barrier": NO_GRID_BARRIER, "four_stages": FOUR_STAGES, "deep_stages": DEEP_STAGES,
            "one_block_an_sm": ONE_BLOCK_AN_SM, "tile64": TILE64}


def build(flags, nvcc):
    """Each variant of fista.cu: {name: CDLL}, one nvcc each, all at once."""
    WORK.mkdir(parents=True, exist_ok=True)
    text = (SRC / "fista.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: the edit no longer applies to the source")
            src = src.replace(old, new)
        path = WORK / f"fista.{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen([nvcc, *flags, f"-I{SRC}", "-o", str(WORK / f"lib{name}.so"), str(path)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(WORK / f"lib{name}.so"))
    return libs


def problem(torch, M, B, N, D, seed, dev):
    """`chip_smoke.fista_problem`'s draws (the same seed gives the same
    problem), placed on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((M, N, D), generator=g)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    mask = torch.rand((B, N), generator=g) < 0.01
    codes = (0.5 + torch.rand((B, N), generator=g)) * mask
    x = codes @ d[0] + 0.01 * torch.randn((B, D), generator=g)
    c0 = torch.relu(torch.randn((M, B, N), generator=g)) * 0.05
    l1 = torch.tensor([1e-4, 3e-4, 1e-3, 3e-3][:M])
    return x.to(dev), d.to(dev), c0.to(dev), l1.to(dev)


def order_study(torch, dev, batch, iters=500):
    from sparse_coding__tpu_torch.models import fista as tf

    spec = importlib.util.spec_from_file_location("tf32_emulation", REPO / "tests" / "test_torch_fista_tf32.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)

    def two_halves(a, b):
        k = a.shape[-1] // 2
        return torch.matmul(a[..., :k], b[..., :k, :]) + torch.matmul(a[..., k:], b[..., k:, :])

    def rounded_once(a, b):
        return torch.matmul(a.double(), b.double()).float()

    def codes_with(mm, x, d, eta, l1, c0):
        mom = tf.momentum_table(iters)
        eta3, thr3, dt = eta.reshape(-1, 1, 1), (eta * l1).reshape(-1, 1, 1), d.transpose(1, 2)

        def update(ahat, y, i):
            res = x - mm(y, d)
            y = y + eta3 * mm(res, dt)
            an = torch.clamp_min(y - thr3, 0.0)
            return an, an + (an - ahat) * float(mom[i])

        return tf.run_fista_iterations(update, c0, iters, 0.0, eta)[0]

    x, d, c0, l1 = problem(torch, 4, batch, 2048, 512, 12, dev)
    eta = tf.default_eta(d)
    plain, _ = tf.fista_codes(x, d, eta, l1, c0, iters)
    out = {"shape": f"M=4,B={batch},N=2048,D=512,iters={iters}",
           "code_nonzero_share": float((plain > 0).float().mean())}
    for name, mm in (("depth_in_two_halves", two_halves), ("products_rounded_once", rounded_once),
                     ("3xtf32", emu.mm_3xtf32)):
        a = codes_with(mm, x, d, eta, l1, c0)
        flips = (a > 0) != (plain > 0)
        ra, rp = [float(((x - torch.matmul(t, d)) ** 2).sum()) for t in (a, plain)]
        out[name] = {"max_abs_diff": float((a - plain).abs().max()), "support_flip_share": float(flips.float().mean()),
                     "support_flip_share_per_member": flips.float().mean(dim=(1, 2)).tolist(),
                     "res_sq_rel_diff": abs(ra - rp) / rp}
    return out


def timing(torch, args):
    from sparse_coding__tpu_torch.models import fista as tf
    from sparse_coding__tpu_torch.ops import _build

    libs = build(_build.NVCC_FLAGS, _build._nvcc())
    for lib in libs.values():
        lib.sc_fista_solve.argtypes = _build.SIGNATURES["sc_fista_solve"]
        lib.sc_fista_solve.restype = ctypes.c_int
    dev = torch.device("cuda")
    st = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for label, (M, B, N, D, iters, seed) in {
        f"config 3, {args.iters} iterations": (4, 2048, 2048, 512, args.iters, 12),
        "row 8, 100 iterations": (2, 256, 512, 128, 100, 11),
    }.items():
        x, d, c0, l1 = problem(torch, M, B, N, D, seed, dev)
        eta = tf.default_eta(d)
        mom = torch.from_numpy(tf.momentum_table(iters).copy()).to(dev)
        # the kernel's layouts: the batch fastest, the dictionary's transpose
        x_t, d_t, c0_t = x.t().contiguous(), d.transpose(1, 2).contiguous(), c0.transpose(1, 2).contiguous()
        a, y = c0_t.clone(), c0_t.clone()
        res = torch.empty((M, D, B), device=dev)
        sync = torch.zeros(1, dtype=torch.int32, device=dev)

        def solve(lib):
            def run():
                a.copy_(c0_t)
                y.copy_(c0_t)
                sync.zero_()
                rc = lib.sc_fista_solve(x_t.data_ptr(), d.data_ptr(), d_t.data_ptr(), eta.data_ptr(), l1.data_ptr(),
                                        mom.data_ptr(), None, None, a.data_ptr(), y.data_ptr(), res.data_ptr(),
                                        sync.data_ptr(), M, B, N, D, iters, st)
                if rc:
                    raise RuntimeError(f"sc_fista_solve: CUDA error {rc}")
            return run

        def timed(fn):
            fn()
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(args.reps):
                fn()
            e.record()
            e.synchronize()
            return s.elapsed_time(e) / args.reps

        fns = {n: solve(lib) for n, lib in libs.items()}
        ms = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                ms[n].append(timed(fns[n]))
        fns["shipped"]()
        plain, _ = tf.fista_codes(x, d, eta, l1, c0, iters)
        torch.cuda.synchronize()
        out[label] = {n: {"ms": v, "median_ms": statistics.median(v)} for n, v in ms.items()}
        out[label]["shipped_bit_equal_to_plain"] = bool(torch.equal(a.transpose(1, 2), plain))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON here")
    ap.add_argument("--iters", type=int, default=50, help="K_f's iterations at config 3 (timing)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--order-study", action="store_true", help="the code study instead of the timing")
    ap.add_argument("--cpu", action="store_true", help="run the order study on the CPU")
    ap.add_argument("--batch", type=int, default=2048, help="the order study's batch rows")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, str(REPO))
    if not args.cpu and not torch.cuda.is_available():
        print("fista_probe: no CUDA device (pass --order-study --cpu for the CPU study)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.order_study:
        dev = torch.device("cpu" if args.cpu else "cuda")
        out = {"order_study": order_study(torch, dev, args.batch)}
    else:
        out = {"timing": timing(torch, args)}
    if args.cpu:
        out["device"] = "cpu"
    else:
        out["device"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                       capture_output=True, text=True, timeout=60).stdout.strip()
    text = json.dumps(out)
    if args.out:
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
