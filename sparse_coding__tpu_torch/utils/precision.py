"""Mixed-precision policy for dictionary-model losses.

Counterpart of `sparse_coding__tpu/utils/precision.py`. Params and Adam
moments stay float32; matmul operands (dictionary, batch, code tensor) are
cast to the compute dtype; loss reductions accumulate in float32. ``None``
(the default) is exact float32 throughout. The policy is a context:
`Ensemble` runs each step's loss inside ``with compute(dtype)``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_STACK: list = [None]


def as_dtype(dtype) -> Optional[torch.dtype]:
    """``None``, a `torch.dtype`, or a name such as ``"bfloat16"``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", dtype)  # numpy dtypes carry a name
    return getattr(torch, str(name))


def current() -> Optional[torch.dtype]:
    """The active compute dtype, or None for full fp32."""
    return _STACK[-1]


@contextlib.contextmanager
def compute(dtype):
    """Activate a matmul compute dtype (e.g. ``torch.bfloat16``) for the block."""
    dtype = as_dtype(dtype)
    _STACK.append(dtype)
    try:
        yield dtype
    finally:
        _STACK.pop()


def cast_in(x: torch.Tensor) -> torch.Tensor:
    """Cast a matmul operand to the active compute dtype (no-op when off).
    Only floating inputs are cast."""
    dt = current()
    if dt is None or not x.is_floating_point():
        return x
    return x.to(dt)


def acc_f32(x: torch.Tensor) -> torch.Tensor:
    """Promote to fp32 before a reduction (no-op for fp32 inputs)."""
    return x.float() if x.dtype != torch.float32 else x
