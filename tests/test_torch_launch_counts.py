"""The wrappers' launch counts (`ops/_wrap.py::LaunchCounts`) as a mapping:
each `count` adds one to its kernel's slot of a tensor on the launch's
device (on the card beside the launch, so a CUDA graph's replays count
too), `reset` zeroes every slot, and the counts read, compare and print as
a dict of ints. On the CPU a tensor on the CPU stands in for the card's."""

import torch

from sparse_coding__tpu_torch.ops import fista_kernel as fk
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops import topk_kernel as kk
from sparse_coding__tpu_torch.ops._wrap import LaunchCounts


def test_launch_counts_count_reset_and_read_as_a_dict():
    counts = LaunchCounts(("k1", "k2"))
    assert counts == {"k1": 0, "k2": 0} and len(counts) == 2 and list(counts) == ["k1", "k2"]
    cpu = torch.device("cpu")
    for name in ("k1", "k2", "k1"):
        counts.count(name, cpu)
    assert counts["k1"] == 2 and {**counts} == {"k1": 2, "k2": 1} and repr(counts) == "{'k1': 2, 'k2': 1}"
    counts.reset()
    assert dict(counts) == {"k1": 0, "k2": 0}
    counts.count("k2", cpu)
    assert sum(counts.values()) == 1


def test_every_ops_module_counts_its_kernels_by_name():
    """The names the tests, the smoke and the trace table key on; on the
    CPU nothing has launched."""
    assert list(tk.LAUNCHES) == ["tied_sae_fwd", "tied_sae_fwd_nocode", "tied_sae_bwd_adam", "tied_sae_bwd_grads",
                                 "tied_sae_bwd_adam_sparse", "tied_sae_bwd_grads_sparse"]
    assert list(kk.LAUNCHES) == ["topk_scores", "topk_decode"] and list(fk.LAUNCHES) == ["fista_solve"]
    for mod in (tk, kk, fk):
        mod.reset_launches()
        assert sum(mod.LAUNCHES.values()) == 0
