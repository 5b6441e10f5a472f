"""Does a profiler trace count every kernel a replayed CUDA graph runs?

    python scripts/graph_launch_probe.py [--rounds 50] [--replays 100] [--out f.json]

For three routes of the step (tied fused Adam: K1 + K2; tied with a
learning-rate schedule: K1 + K3; TopK: K_s + K_d + the sparse K2), at D 128,
N 512, batch 256, 2 members, builds the ensemble, captures its step, then
``--rounds`` times traces (`tests/_torch_trace.py::traced`) 4 steps of
`Ensemble.step_scan`, and ``--rounds`` times a bare loop of ``--replays``
`CUDAGraph.replay()` calls. Each round's trace count of every kernel is held
against the number of replays, and beside it the wrappers' `LAUNCHES`
delta over the same round (what the step's capture recorded, added at each
replay). Prints one JSON line a route, and the rounds whose trace came up
short. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

ROUTES = {
    "tied_fused_adam": ("tied", {"learning_rate": 1e-3}),
    "tied_schedule": ("tied", "schedule"),
    "topk": ("topk", {"learning_rate": 1e-3}),
}


def build(kind, opt, dev):
    from sparse_coding__tpu_torch import FunctionalTiedSAE, TopKEncoderApprox, build_ensemble
    from sparse_coding__tpu_torch.utils.optim import linear_schedule

    if opt == "schedule":
        opt = {"learning_rate": linear_schedule(0.0, 1e-3, 3)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the schedule's fused-Adam refusal
        if kind == "tied":
            return build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
                                  optimizer_kwargs=opt, compute_dtype="bfloat16", device=dev,
                                  activation_size=128, n_dict_components=512)
        return build_ensemble(TopKEncoderApprox, 0, [{"sparsity": 7}, {"sparsity": 31}], optimizer_kwargs=opt,
                              compute_dtype="bfloat16", device=dev, d_activation=128, n_features=512,
                              sparsity_cap=31)


def launches():
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    return {**tk.LAUNCHES, **kk.LAUNCHES}


def reset():
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    tk.reset_launches()
    kk.reset_launches()


def probe(torch, name, rounds: int, replays: int):
    from _torch_trace import traced

    dev = torch.device("cuda")
    kind, opt = ROUTES[name]
    ens = build(kind, opt, dev)
    xs = torch.randn((5, 256, 128), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    ens.step_scan(xs[:1])  # eager first step, then the capture
    (graph,) = ens._graphs.values()
    out = {"route": name, "captures": ens.captures}
    for section, n, fn in (
        ("step_scan", 4, lambda: ens.step_scan(xs[1:])),
        ("bare_replay", replays, lambda: [graph.graph.replay() for _ in range(replays)]),
    ):
        short, kernels, counted = [], None, None
        for r in range(rounds):
            reset()
            _, ran = traced(torch, fn)
            ran = {k: v for k, v in ran.items() if v}
            kernels = kernels or sorted(ran)
            counted = {k: v for k, v in launches().items() if v}
            if set(ran) != set(kernels) or any(v != n for v in ran.values()):
                short.append({"round": r, "trace": ran, "launches": counted})
        out[section] = {"replays_a_round": n, "rounds": rounds, "kernels": kernels,
                        "launches_last_round": counted, "rounds_off": len(short), "off": short[:10]}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_launch_probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--replays", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = []
    for name in ROUTES:
        row = probe(torch, name, args.rounds, args.replays)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": torch.cuda.get_device_name(0), "routes": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
