"""Fixture: SC003 violations (torch) — host syncs inside a declared hot
loop and the same-module function it calls.

Never imported; parsed by tests/test_torch_analysis.py, which pins each
finding to the marker-comment line.
"""

import numpy as np
import torch

__sclint_hot_entries__ = ("train",)


def train(ens, batches, stream):
    total = 0.0
    for x in batches:
        losses, _ = ens.step_batch(x)
        total += losses["loss"].sum().item()  # VIOLATION
        host = losses["loss"].cpu()  # VIOLATION
        rows = losses["loss"].tolist()  # VIOLATION
        total += float(losses["loss"].mean())  # VIOLATION
        stream.synchronize()  # VIOLATION
        report(x, host, rows)
    torch.cuda.synchronize()  # VIOLATION
    return total


def report(x, host, rows):
    codes = torch.relu(x)
    dense = np.asarray(codes)  # VIOLATION
    arr = codes.numpy()  # VIOLATION
    if bool(codes.any()):  # VIOLATION
        return int(codes.sum()) + len(rows) + dense.size + arr.size  # VIOLATION
    return 0
