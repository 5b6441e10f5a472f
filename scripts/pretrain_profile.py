"""Where a subject-LM pretraining step spends its time on the card.

    python scripts/pretrain_profile.py [--out pretrain_profile.json]

Pythia-70M's widths (`lm.model.config_for("pythia-70m")`) from a seeded
random init, on the trigram corpus `chip_smoke.py` pretrains on (4096 x 128
tokens), batch 32, bf16 compute, AdamW under the warm-up + cosine schedule:
the step of `lm.pretrain.make_pretrain_scan_step`, its three parts timed
apart by CUDA events (loss forward, `autograd.grad`, the AdamW update), the
host's wall per step beside them, then `torch.profiler` over a few steps:
device time by kernel name, the number of kernels a step and the device's
idle share (of the traced steps' wall, which the profiler lengthens). Prints one JSON object (and writes it to ``--out``). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--profile-steps", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pretrain_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from sparse_coding__tpu_torch.data.synthetic_text import TrigramLanguage
    from sparse_coding__tpu_torch.lm import model as lm_model
    from sparse_coding__tpu_torch.lm.pretrain import _unflatten
    from sparse_coding__tpu_torch.utils import optim

    dev = torch.device("cuda")
    cfg = lm_model.config_for("pythia-70m")
    corpus = torch.from_numpy(TrigramLanguage(cfg.vocab_size, seed=7).sample(4096, 128, seed=11)).to(dev)
    params = lm_model.init_params(0, cfg, device=dev)
    tx = optim.adamw(optim.warmup_cosine_decay_schedule(0.0, 3e-4, 30, 300), weight_decay=0.01)
    state = tx.init(lm_model.tree_leaves(params))
    rng = np.random.default_rng(0)
    events = {k: [] for k in ("loss", "grad", "update")}

    def step(params, state, timed):
        toks = corpus[torch.from_numpy(rng.integers(0, corpus.shape[0], 32)).to(dev)]
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if timed else None
        if timed:
            marks[0].record()
        leaves = {k: v.detach().requires_grad_(True) for k, v in lm_model.tree_leaves(params).items()}
        loss = lm_model.lm_loss(lm_model.cast_params(_unflatten(params, leaves), torch.bfloat16), toks, cfg)
        if timed:
            marks[1].record()
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if timed:
            marks[2].record()
        with torch.no_grad():
            flat = {k: v.detach() for k, v in leaves.items()}
            updates, state = tx.update(grads, state, flat)
            params = _unflatten(params, optim.apply_updates(flat, updates))
        if timed:
            marks[3].record()
            for k, (a, b) in zip(events, zip(marks[:-1], marks[1:])):
                events[k].append((a, b))
        return params, state

    for _ in range(4):
        params, state = step(params, state, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, state = step(params, state, True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    parts = {k: sum(a.elapsed_time(b) for a, b in v) / len(v) for k, v in events.items()}

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            params, state = step(params, state, False)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0)
        if dt and e.device_type.name == "CUDA":
            kernels[e.key] = (dt / 1e3 / args.profile_steps, e.count / args.profile_steps)
    busy = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi, model="pythia-70m", batch=32, seq=128,
        compute_dtype="bfloat16", steps=args.steps, wall_ms_per_step=wall_ms, parts_ms=parts,
        profiled_steps=args.profile_steps, profiled_wall_ms_per_step=prof_wall_ms / args.profile_steps,
        device_busy_ms_per_step=busy, idle_share=1 - busy / (prof_wall_ms / args.profile_steps),
        kernels_per_step=sum(v[1] for v in kernels.values()),
        top_kernels=[{"name": k[:120], "ms_per_step": v[0], "per_step": v[1]} for k, v in top],
    )
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
