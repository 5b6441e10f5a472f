"""Where the time of the catalog's ablation steps goes on the card, by kernel.

    python scripts/ablation_profile.py [--steps 10] [--out ablation_profile.json]

Builds each of the four ablation builders' ensembles at the catalog's width
(`run_sweep_synthetic`'s: D 512, batch 1024; `dict_ratio_experiment` in f32
and in bf16 compute) and the `signatures` phase's DirectCoef and residual
ensembles (`chip_smoke.signature_models`: N 2048, 8 members), captures each
step (`Ensemble.step_scan`), then traces ``--steps`` graph replays with
`torch.profiler` and prints one JSON line an ensemble: the CUDA-event ms a
step, the device ms a step by kernel class (GEMMs, elementwise, reductions,
copies and casts) and the ten largest kernels, and the device's idle share
(1 - kernel time / event time). Needs a CUDA device; every step is the
autograd route (no hand-written kernel).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CLASSES = (("gemm", ("gemm", "xmma", "cutlass", "sm90_", "ampere_", "cublas")),
           ("reduction", ("reduce", "norm")),
           ("copy_cast", ("copy", "cast", "fill")),
           ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "clamp", "relu", "abs", "mul", "add")))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_ensemble(torch, ens, width: int, batch: int, steps: int, label: str):
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(0)
    xs = torch.randn((steps, batch, width), generator=g, device="cuda")
    ens.step_scan(xs[:3])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        ens.step_scan(xs)
        end.record()
        end.synchronize()
    step_ms = start.elapsed_time(end) / steps
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type.name == "CUDA":
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / steps
    total = sum(kernels.values())
    by_class = {}
    for k, v in kernels.items():
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + v
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    return {"ensemble": label, "sig": ens.sig.__name__, "members": ens.n_models,
            "compute_dtype": None if ens.compute_dtype is None else str(ens.compute_dtype), "steps": steps,
            "ms_per_step": step_ms, "kernel_ms_per_step": total, "device_idle_share": max(0.0, 1 - total / step_ms),
            "by_class_ms": by_class, "top_kernels_ms": top, "route": ens._route(batch, False, False)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablation_profile: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.train import experiments as ex
    from sparse_coding__tpu_torch.utils.config import SyntheticEnsembleArgs

    width, batch = cs.EXPERIMENTS["width"], cs.EXPERIMENTS["batch"]
    runs = [(name, dtype) for name, dtype in cs.EXPERIMENTS["builders"]
            if name in ("residual_denoising_experiment", "thresholding_experiment", "dict_ratio_experiment",
                        "run_positive_experiment")]
    lines = []
    for name, dtype in runs:
        cfg = SyntheticEnsembleArgs(activation_width=width, batch_size=batch, dtype=dtype)
        for ens, _args, ens_name in getattr(ex, name)(cfg, device="cuda")[0]:
            lines.append(profile_ensemble(torch, ens, width, batch, args.steps, f"{name}/{ens_name}/{dtype}"))
            print(json.dumps(lines[-1]), flush=True)
            del ens
            torch.cuda.empty_cache()
    S = cs.SIGNATURES
    for name, sig, common, hparams in cs.signature_models(pkg, S["width"], S["n_dict"], S["members"]):
        if name not in ("DirectCoefOptimizer", "FunctionalResidualDenoisingSAE"):
            continue
        ens = pkg.build_ensemble(sig, 11, hparams, optimizer_kwargs={"learning_rate": cs.LR}, device="cuda",
                                 **common)
        lines.append(profile_ensemble(torch, ens, S["width"], S["batch"], args.steps, f"signatures/{name}"))
        print(json.dumps(lines[-1]), flush=True)
        del ens
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
