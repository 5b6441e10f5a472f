"""Fixture: SC003 clean twin (torch) — the same syncs sanctioned both ways
the port sanctions them (an allowed_transfer() block, an allow comment),
and host values that are no sync at all."""

import numpy as np
import torch

__sclint_hot_entries__ = ("train", "report")


def train(ens, batches, allowed_transfer):
    total = 0.0
    for x in batches:
        losses, _ = ens.step_batch(x)
        with allowed_transfer():
            total += losses["loss"].sum().item()
            total += float(losses["loss"].mean())
        n = int(x.shape[0]) + x.numel() + x.size(1)
        total += float(n) + len(batches)
    # sclint: allow(SC003) one barrier at the end of the run, not a step
    torch.cuda.synchronize()
    return total


def report(sizes):
    arr = np.asarray(sizes)
    step = int(len(sizes))
    return bool(arr.any()) and step > 0
