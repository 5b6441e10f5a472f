"""Comparison helpers shared by the PyTorch-port tests (tests/test_torch_*.py)."""

import numpy as np
import torch


def to_np(t) -> np.ndarray:
    """torch or jax array -> float32-or-native numpy (bf16 -> float32)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def bf16_bits(a) -> np.ndarray:
    """int32 bit patterns of a bf16 array (torch bf16 or float32 values that are
    exactly bf16)."""
    f = to_np(a).astype(np.float32)
    return (f.view(np.uint32) >> 16).astype(np.int32)


def bf16_close(a, b):
    """(fraction of elements that differ, every difference within 1 bf16 ulp
    or, where f32 summation order moves a value across zero, within 1e-5 of
    the tensor's largest magnitude)."""
    fa, fb = to_np(a).astype(np.float32), to_np(b).astype(np.float32)
    ia, ib = bf16_bits(fa), bf16_bits(fb)
    same_sign = (ia >= 0x8000) == (ib >= 0x8000)
    near_zero = np.abs(fa - fb) <= 1e-5 * np.abs(fb).max()
    ok = (ia == ib) | (same_sign & (np.abs(ia - ib) <= 1)) | near_zero
    return float((ia != ib).mean()), bool(ok.all())


def assert_grads_close(a, b, what: str, min_cos: float = 0.9999, max_rel: float = 1e-2):
    """Gradient-style agreement: cosine and max error relative to the max.
    Both are scaled to b's largest magnitude first, so the guards against a
    zero norm stay negligible at any scale (Adam's nu is ~1e-16 an element)."""
    a = to_np(a).astype(np.float64).ravel()
    b = to_np(b).astype(np.float64).ravel()
    s = np.abs(b).max() or 1.0
    a, b = a / s, b / s
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
    rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-30)
    assert cos > min_cos and rel < max_rel, f"{what}: cos {cos}, max rel {rel}"


def jax_to_torch(a) -> torch.Tensor:
    """A jax/numpy array on the CPU as a torch tensor (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))
