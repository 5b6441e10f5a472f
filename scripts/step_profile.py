"""Where the time of one fused training step goes on the card, by kernel.

    python scripts/step_profile.py [--steps 20] [--out step_profile.json]

For each fused path that `chip_smoke.py` drives (tied, tied-capacity, TopK,
TopK-capacity, at their full widths), builds the ensemble, captures its step
(`Ensemble.step_scan`), then traces ``--steps`` graph replays with
`torch.profiler` and prints one JSON line a path: the CUDA-event time per
step, the device time per step of each kernel (the port's hand-written ones
and PyTorch's elementwise and reduction kernels), their sum, and the
device's idle share of the step (1 - kernel time / event time). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def profile_path(torch, pkg, cfg, steps: int):
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    ens = cs.build_path(pkg, cfg, 1)
    x = torch.randn((cfg["batch"], cfg["width"]), device="cuda")
    xs = x.unsqueeze(0).expand(steps, *x.shape)
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
    return {"path": cfg["path"], "steps": steps, "ms_per_step": step_ms, "kernel_ms_per_step": total,
            "device_idle_share": max(0.0, 1 - total / step_ms), "captures": ens.captures,
            "kernels_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import sparse_coding__tpu_torch as pkg

    lines = []
    for cfg in (cs.TIED, cs.TIED_CAPACITY, cs.TOPK, cs.TOPK_CAPACITY):
        line = profile_path(torch, pkg, cfg, args.steps)
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
