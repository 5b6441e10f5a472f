"""Fixture: SC004 violations (torch, the CUDA-graph form) — bare
parameters sizing tensors inside a capture block and in the same-module
function the block calls."""

import torch


def capture(graph, x, rows, k):
    with torch.cuda.graph(graph):
        buf = torch.zeros(rows, x.shape[1], device=x.device)  # VIOLATION
        out = select(x, k) + buf[:1]
    return out


def select(x, k):
    flat = x.reshape(-1, x.shape[-1])
    return flat.topk(k).values  # VIOLATION
