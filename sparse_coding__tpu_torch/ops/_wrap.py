"""What the kernel wrappers (`tied_sae_kernel`, `topk_kernel`) share: the
argument checks made before a launch, and the shapes the CUDA sources are
written for.

`FWD_ROWS` x `FWD_COLS` is the output tile of the forward kernels
(``kBM`` x ``kBN`` in `csrc/wmma_tile.cuh`). `MAX_SMEM` is the shared memory
one block may take on sm_90; `_build` passes it to nvcc as ``SC_MAX_SMEM``,
so the CUDA sources read it from here.
"""

from __future__ import annotations

import torch

FWD_ROWS, FWD_COLS = 64, 128  # the forward kernels' output tiles (batch rows, dict/width cols)
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90 (227 KB)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(name: str, **tensors) -> torch.device:
    """Every tensor on one CUDA device, contiguous and 16-byte aligned."""
    dev = None
    for key, t in tensors.items():
        require(t.is_cuda, f"{name}: {key} is on {t.device}, the others on CUDA")
        require(t.is_contiguous(), f"{name}: {key} must be contiguous")
        require(t.data_ptr() % 16 == 0, f"{name}: {key} must be 16-byte aligned")
        dev = dev or t.device
        require(t.device == dev, f"{name}: {key} is on {t.device}, expected {dev}")
    return dev


def check_dtype(name: str, t: torch.Tensor, key: str, dtype) -> None:
    require(t.dtype == dtype, f"{name}: {key} must be {dtype}, got {t.dtype}")


def stream(dev: torch.device) -> int:
    """The handle of the current CUDA stream on ``dev``, for a launch."""
    return torch.cuda.current_stream(dev).cuda_stream
