"""Fixture: SC004 violations (torch, the compile form) — a parameter of a
torch.compile'd function sizes a tensor: a recompile per value."""

import torch


@torch.compile
def rows_view(x, n):
    return x.view(n, -1)  # VIOLATION


def ramp(x, steps):
    return x + torch.arange(steps, device=x.device)  # VIOLATION


compiled_ramp = torch.compile(ramp)
