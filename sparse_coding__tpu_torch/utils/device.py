"""Where the port's entry points run: on the CUDA card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device=None`` means ``cuda``; with no CUDA device that raises rather
    than carrying on on the CPU. Pass ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
