"""What the kernel wrappers (`tied_sae_kernel`, `topk_kernel`, `fista_kernel`) share: the
argument checks made before a launch, their launch counts (`LaunchCounts`),
and the shapes the CUDA sources are written for.

`FWD_ROWS` x `FWD_COLS` is the output tile of the WMMA forward kernels
(``kBM`` x ``kBN`` in `csrc/wmma_tile.cuh`), whose multiples every forward
still takes (``kFwdRows`` x ``kFwdCols`` in `csrc/topk_fwd.cu`). `MAX_SMEM` is the shared memory
one block may take on sm_90; `_build` passes it to nvcc as ``SC_MAX_SMEM``,
so the CUDA sources read it from here.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Sequence

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


class LaunchCounts(Mapping):
    """Launches of each kernel of one ops module since the last `reset`:
    a read-only mapping kernel name -> count (plain-version calls on CPU
    tensors do not count).

    The count lives on the card: where a wrapper launches its kernel it also
    enqueues ``+1`` to the kernel's slot of an int64 tensor on the same
    stream (`count`). So every execution of the launch counts, also where
    the launch was recorded into a CUDA graph and runs at each of the
    graph's replays, and nothing else counts: the replays call no wrapper.
    Reading a count waits for the card."""

    def __init__(self, names: Sequence[str]):
        self.names = tuple(names)
        self._slot = {n: i for i, n in enumerate(self.names)}
        self._dev: Dict[torch.device, torch.Tensor] = {}

    def count(self, name: str, dev: torch.device) -> None:
        """``+1`` to ``name``'s count, enqueued on the current stream of
        ``dev`` right after the kernel's launch (recorded with it under
        capture). The counter is made at the first launch on ``dev``, which
        is never under capture: a step is captured after an eager step."""
        t = self._dev.get(dev)
        if t is None:
            require(dev.type != "cuda" or not torch.cuda.is_current_stream_capturing(),
                    f"first launch of {name} on {dev} under CUDA graph capture: run it once eagerly first")
            t = self._dev[dev] = torch.zeros(len(self.names), dtype=torch.int64, device=dev)
        t[self._slot[name]].add_(1)

    def reset(self) -> None:
        """Every count to 0 (enqueued: launches already enqueued still count)."""
        for t in self._dev.values():
            t.zero_()

    def _totals(self):
        totals = [0] * len(self.names)
        for t in self._dev.values():
            totals = [a + b for a, b in zip(totals, t.tolist())]
        return totals

    def __getitem__(self, name: str) -> int:
        return self._totals()[self._slot[name]]

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

    def __repr__(self) -> str:
        return repr(dict(zip(self.names, self._totals())))
