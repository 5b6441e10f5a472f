"""Thousands of launches of every instantiation of the dense K2/K3's wgmma mainloop, on one card.

    timeout 900 python scripts/dense_bwd_stress.py [--launches 2000] [--out stress.json]

At M 8, B 2048, N 4096 and each width the wgmma mainloop takes (D 128, 256
and 512; D 512 is BASELINE config 2), for K3, K2 on the stored code and K2
rebuilding it, the latter two in each of the nine moment tiers (mu, nu each
f32, bf16 or int8): runs a chain of launches through the public wrappers,
each K2 updating its encoder and moments in place, twice from the same
start, and checks that the two chains end on the same bits and finite
values. The tiers the tied paths run (K3; K2 stored with bf16 mu and f32
nu; K2 rebuilding with int8 mu and bf16 nu) take ``--launches`` launches a
chain, the others a quarter of that. Each instantiation is named on stderr
before it starts, so a launch that never ends (the run cut by ``timeout``)
names its instantiation. Prints one JSON object: per instantiation its
launches, seconds and verdict, with the card's name and power limit; exits
1 if any chain disagrees or is not finite. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
M, B, N = 8, 2048, 4096
TIERS = ("float32", "bfloat16", "int8")
PATH_TIERS = {(False, "bfloat16", "float32"), (True, "int8", "bfloat16")}  # tied, tied-capacity
HP = (1e-3, 0.9, 0.999, 1e-8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=2000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dense_bwd_stress: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))  # _torch_moments: the moment helpers the CUDA tests share
    from _torch_moments import adam_moments, clone_moment, moment_parts, same_bits
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    runs, ok = {}, True
    for D in (128, 256, 512):
        g = torch.Generator(device=dev).manual_seed(D)
        d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
        bias = torch.randn((M, N), generator=g, device=dev) * 0.01
        xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
        nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
        db = (d_raw / nrm[..., None]).to(torch.bfloat16)
        l1b = torch.linspace(1e-4, 1e-2, M, device=dev) / B
        bc = torch.tensor([[0.1, 0.001]] * M, device=dev)
        c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
        variants = ["grads"] + [(rb, mu_t, nu_t) for rb in (False, True) for mu_t in TIERS for nu_t in TIERS]
        for variant in variants:
            if variant == "grads":
                name, n = f"d{D} K3", args.launches

                def chain(n):
                    out = None
                    for _ in range(n):
                        out = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
                    return out
            else:
                rb, mu_t, nu_t = variant
                name = f"d{D} K2 {'rebuilt' if rb else 'stored'} mu {mu_t} nu {nu_t}"
                n = args.launches if variant in PATH_TIERS else args.launches // 4
                mu0, nu0 = adam_moments(d_raw, mu_t, nu_t, torch.Generator(device=dev).manual_seed(D + 1))

                def chain(n, rb=rb, mu0=mu0, nu0=nu0):
                    d, mu, nu = d_raw.clone(), clone_moment(mu0), clone_moment(nu0)
                    for step in range(n):
                        d, mu, nu, gb = tk.tied_sae_bwd_adam(xb, dxh, None if rb else c, nrm, d, mu, nu, l1b, bc,
                                                             *HP, seed=step + 1, bias=bias if rb else None)
                    return d, mu, nu, gb
            print(f"{name}: {2 * n} launches", file=sys.stderr, flush=True)
            t0 = time.perf_counter()
            first = chain(n)
            second = chain(n)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            same = all(same_bits(a, b) for a, b in zip(first, second))
            finite = all(bool(torch.isfinite(t.float()).all()) for o in first for t in moment_parts(o))
            ok &= same and finite
            runs[name] = {"launches": 2 * n, "seconds": seconds, "same_bits": same, "finite": finite}
            print(f"  {runs[name]}", file=sys.stderr, flush=True)
        del d_raw, c, dxh
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"shape": {"M": M, "B": B, "N": N}, "launches": sum(r["launches"] for r in runs.values()),
              "ok": ok, "card": card, "runs": runs}
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
