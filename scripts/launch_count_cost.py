"""What the on-card launch counters cost a step.

    python scripts/launch_count_cost.py [--reps 20] [--rounds 3] [--out f.json]

Every wrapper of a hand-written kernel enqueues one ``+1`` kernel beside its
launch (`ops/_wrap.py::LaunchCounts.count`), which a captured step's CUDA
graph records too. For the tied and TopK main paths of `chip_smoke.py`
(``TIED``, ``TOPK``) and the experiment catalog's N 256 stacks (``EXP_TIED``,
``EXP_TOPK``: 32 tied members, 16 TopK members with k 1..151, D 512, B 1024),
this builds two ensembles from one seed: one steps with the counters, the
other with ``count`` a no-op, which is what the wrappers enqueued before the
counters (a host-side increment, nothing on the card). Then in turns (off,
on, on, off, ...) it times the eager step (`step_batch`) and the graph step
(`step_scan` over ``--reps`` batches, after a call that captured it) with
CUDA events. Prints one JSON line a path (ms a step, each round's and the
medians, and on - off), then the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


@contextlib.contextmanager
def counters(on: bool):
    """The wrappers' counters as shipped, or (``on`` False) a no-op."""
    from sparse_coding__tpu_torch.ops._wrap import LaunchCounts

    real = LaunchCounts.count
    if not on:
        LaunchCounts.count = lambda self, name, dev: None
    try:
        yield
    finally:
        LaunchCounts.count = real


def paths(pkg, cs):
    """name -> (a builder of the path's ensemble, batch, width)."""
    import numpy as np

    exp_kw = dict(optimizer_kwargs={"learning_rate": cs.LR}, compute_dtype="bfloat16")
    m, b, n, d = cs.EXP_TIED
    mk, bk, nk, dk = cs.EXP_TOPK
    return {
        "tied": (lambda: cs.build_path(pkg, cs.TIED, 0), cs.TIED["batch"], cs.TIED["width"]),
        "topk": (lambda: cs.build_path(pkg, cs.TOPK, 0), cs.TOPK["batch"], cs.TOPK["width"]),
        "catalog_tied_n256": (lambda: pkg.build_ensemble(
            pkg.FunctionalTiedSAE, 0, [{"l1_alpha": float(a)} for a in np.logspace(-4, -2, m)],
            activation_size=d, n_dict_components=n, **exp_kw), b, d),
        "catalog_topk_n256": (lambda: pkg.build_ensemble(
            pkg.TopKEncoderApprox, 0, [{"sparsity": min(k, nk)} for k in cs.EXP_KS[:mk]],
            d_activation=dk, n_features=nk, sparsity_cap=min(max(cs.EXP_KS[:mk]), nk), **exp_kw), bk, dk),
    }


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(torch, name, build, batch, width, reps: int, rounds: int):
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    x = torch.randn((batch, width), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    xs = x.unsqueeze(0).expand(reps, batch, width)
    ens = {}
    for on in (False, True):
        with counters(on):
            ens[on] = build()
            ens[on].step_batch(x)
            ens[on].step_scan(xs[:3])  # an eager first step, then the capture
    replayed = {}
    for on in (False, True):
        tk.reset_launches()
        kk.reset_launches()
        ens[on].step_scan(xs)
        replayed[on] = sum({**tk.LAUNCHES, **kk.LAUNCHES}.values())
    if replayed[False] != 0 or replayed[True] == 0:
        raise AssertionError(f"{name}: launches counted in replays, off {replayed[False]}, on {replayed[True]}")
    ms = {"eager": {"off": [], "on": []}, "graph": {"off": [], "on": []}}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            key = "on" if on else "off"
            with counters(on):
                ms["eager"][key].append(time_ms(torch, lambda: ens[on].step_batch(x), reps))
                ms["graph"][key].append(time_ms(torch, lambda: ens[on].step_scan(xs), 1) / reps)
    if any(e.captures != 1 for e in ens.values()):
        raise AssertionError(f"{name}: captures {[e.captures for e in ens.values()]}")
    row = {"path": name, "members": ens[True].n_models, "batch": batch, "width": width, "reps": reps,
           "counts_a_graph_step": replayed[True] // reps}
    for kind, v in ms.items():
        med = {k: statistics.median(vals) for k, vals in v.items()}
        row[kind] = {"ms_off": v["off"], "ms_on": v["on"], "median_off": med["off"], "median_on": med["on"],
                     "on_minus_off_ms": med["on"] - med["off"],
                     "on_minus_off_share": (med["on"] - med["off"]) / med["off"]}
    del ens
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("launch_count_cost: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke as cs
    import sparse_coding__tpu_torch as pkg

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for name, (build, batch, width) in paths(pkg, cs).items():
        row = measure(torch, name, build, batch, width, args.reps, args.rounds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                                              "paths": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
