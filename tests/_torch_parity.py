"""Comparison helpers shared by the PyTorch-port tests (tests/test_torch_*.py)."""

import numpy as np
import torch

from _torch_moments import store_moment


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


def moment_pair(a: np.ndarray, tier: str):
    """An f32 numpy Adam moment [M, N, D] in a storage tier as (the JAX
    package's value, the port's), the same on both sides (`store_moment`)."""
    import jax.numpy as jnp
    from sparse_coding__tpu.utils.optim import QuantMoment as JaxQuantMoment

    got = store_moment(torch.from_numpy(np.array(a, dtype=np.float32)), tier)
    if tier == "int8":
        return JaxQuantMoment(q=jnp.asarray(got.q.numpy()), scale=jnp.asarray(got.scale.numpy())), got
    j = jnp.asarray(a).astype(jnp.bfloat16 if tier == "bfloat16" else jnp.float32)
    return j, jax_to_torch(j)


def assert_moment_tracks(got, ref, what: str, min_equal: float = 0.99, bf16_stochastic: bool = True,
                         scale_rtol: float = 1e-3, max_code_diff: int = 1):
    """A port moment against the JAX package's after the same step on the
    same stochastic-store bits: int8 codes equal in >= ``min_equal`` of the
    elements and never more than ``max_code_diff`` codes apart, scales
    within ``scale_rtol`` (after one step from the same state: one code and
    1e-3; chained steps let the params, so the rows' absmax, drift apart); bf16 bit patterns equal in >= ``min_equal`` when stored
    stochastically (nu; independent streams agree on about half — a bf16
    mu rounds to nearest and has no stream to match); every tier's values
    gradient-close (the two sides' f32 sums differ, which moves a few
    roundings and codes)."""
    if hasattr(ref, "q"):
        qa, qb = to_np(got.q).astype(np.int32), np.asarray(ref.q).astype(np.int32)
        eq = float((qa == qb).mean())
        assert eq >= min_equal, f"{what}: {eq} of the int8 codes equal"
        worst = np.abs(qa - qb).max()
        assert worst <= max_code_diff, f"{what}: codes {worst} steps apart"
        np.testing.assert_allclose(to_np(got.scale), np.asarray(ref.scale), rtol=scale_rtol, err_msg=what)
        # dequantized: within the codes' envelope of each row's scale
        row = np.maximum(to_np(got.scale), np.asarray(ref.scale))[..., None]
        gap = np.abs(to_np(got.dequant()) - np.asarray(ref.dequant())) / row
        assert gap.max() <= max_code_diff + 0.5, f"{what}: dequantized {gap.max()} row steps apart"
        return eq
    ra = to_np(ref)
    if got.dtype == torch.bfloat16:
        eq = float((bf16_bits(got) == bf16_bits(ra)).mean())
        assert not bf16_stochastic or eq >= min_equal, f"{what}: {eq} of the bf16 values equal"
    else:
        eq = float((to_np(got) == ra).mean())
    assert_grads_close(got, ra, what)
    return eq
