"""Fixture: SC004 clean twin (the compile form) — shapes from the input
itself, and an lru_cache'd builder that bakes the size into a closure."""

import functools

import torch


@torch.compile
def rows_view(x):
    return x.view(x.shape[0], -1)


@functools.lru_cache(maxsize=None)
def ramp_for(steps):
    def ramp(x):
        return x + torch.arange(steps, device=x.device)

    return torch.compile(ramp)
