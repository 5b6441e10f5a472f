"""Kernel executions counted from a `torch.profiler` trace of the card.

A wrapper's `LAUNCHES` counts the launches it makes itself; the replays of a
CUDA graph that recorded a launch call no wrapper. A trace sees every
execution of a kernel on the card, inside graph replays too. `traced` counts
those of each hand-written kernel by the demangled name of its device
function (`SYMBOLS`); where a wrapper also launches a kernel of its own
(K_s's select, K1's WMMA decode), only the first is counted, so a count is
one per wrapper call. Needs a CUDA device.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

# wrapper name (each ops module's `LAUNCHES` key) -> its device function,
# by its demangled name (ops/csrc/*.cu, all in an anonymous namespace)
SYMBOLS = {
    "tied_sae_fwd": r"::(pp_fwd_kernel<\d+, true>|encode_kernel\()",
    "tied_sae_fwd_nocode": r"::(pp_fwd_kernel<\d+, false>|nocode_kernel<)",
    "tied_sae_bwd_adam": r"::(wg_)?bwd_kernel<true\b",
    "tied_sae_bwd_grads": r"::(wg_)?bwd_kernel<false\b",
    "tied_sae_bwd_adam_sparse": r"::sparse_bwd_kernel<true\b",
    "tied_sae_bwd_grads_sparse": r"::sparse_bwd_kernel<false\b",
    "topk_scores": r"::scores_kernel\(",
    "topk_decode": r"::decode_kernel<",
    "fista_solve": r"::solve_kernel<\d+>\(",
}


def kernel_counts(names: Dict[str, int]) -> Dict[str, int]:
    """Executions of each wrapper's kernel among ``names`` (kernel name ->
    executions); raises when one name matches two wrappers."""
    counts = {w: 0 for w in SYMBOLS}
    for name, n in names.items():
        hits = [w for w, pat in SYMBOLS.items() if re.search(pat, name)]
        if len(hits) > 1:
            raise AssertionError(f"kernel {name!r} matches {hits}")
        if hits:
            counts[hits[0]] += n
    return counts


def traced(torch, fn: Callable) -> Tuple[object, Dict[str, int]]:
    """``(fn(), counts)``: ``counts[wrapper]`` is the number of times the
    card ran that wrapper's kernel while ``fn`` ran (the card drained before
    the trace ends)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names: Dict[str, int] = {}
    for evt in prof.key_averages():
        if evt.device_type.name == "CUDA":
            names[evt.key] = names.get(evt.key, 0) + evt.count
    return out, kernel_counts(names)
