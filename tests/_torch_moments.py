"""Adam-moment helpers of the PyTorch port's card checks, shared by
tests/test_torch_kernels_cuda.py, tests/_torch_parity.py and chip_smoke.py.
Torch only: nothing here imports the JAX package (chip_smoke.py must not)."""

import torch


def store_moment(v: torch.Tensor, tier: str):
    """An f32 Adam moment [..., D] in a storage tier ("float32", "bfloat16"
    or "int8"): int8 as a `QuantMoment` of per-row absmax codes rounded to
    nearest (an all-zero row gets scale 1, as the JAX package's)."""
    from sparse_coding__tpu_torch.utils.optim import QuantMoment

    if tier == "int8":
        s = v.abs().amax(-1) / 127.0
        s = torch.where(s > 0, s, torch.ones_like(s))
        return QuantMoment(q=torch.round(v / s[..., None]).clamp(-127, 127).to(torch.int8), scale=s)
    return v.to(getattr(torch, tier))


def adam_moments(d_raw: torch.Tensor, mu_tier: str, nu_tier: str, gen: torch.Generator):
    """(mu, nu) at the scales of a few Adam steps in, shaped and placed like
    ``d_raw``, in storage tiers (`store_moment`)."""
    mu = torch.randn(d_raw.shape, generator=gen, device=d_raw.device) * 1e-3
    nu = torch.rand(d_raw.shape, generator=gen, device=d_raw.device) * 1e-6
    return store_moment(mu, mu_tier), store_moment(nu, nu_tier)


def moment_parts(m):
    """A moment's tensors: (q, scale) of an int8 `QuantMoment`, else (m,)."""
    return (m.q, m.scale) if hasattr(m, "q") else (m,)


def clone_moment(m):
    return type(m)(*(t.clone() for t in moment_parts(m))) if hasattr(m, "q") else m.clone()


def same_bits(a, b) -> bool:
    """Two moments (or tensors) bit for bit, codes and scales included."""
    for ta, tb in zip(moment_parts(a), moment_parts(b)):
        if ta.dtype == torch.bfloat16:
            ta, tb = ta.view(torch.int16), tb.view(torch.int16)
        if not torch.equal(ta, tb):
            return False
    return True


def stored_agreement(got, want):
    """(share of equal stored elements, largest difference in int8 codes,
    bf16 ulps or f32 ulps, largest relative scale difference) of a kernel
    moment against the plain version's."""
    rel = 0.0
    if hasattr(got, "q"):
        rel = float(((got.scale - want.scale).abs() / want.scale.abs()).max())
        a, b = got.q.int(), want.q.int()
    elif got.dtype == torch.bfloat16:
        a, b = got.view(torch.int16).int(), want.view(torch.int16).int()
    else:
        a, b = got.view(torch.int32).long(), want.view(torch.int32).long()
    return float((a == b).float().mean()), int((a - b).abs().max()), rel


def store_error_steps(got, v: torch.Tensor) -> torch.Tensor:
    """A stored moment's error against the f32 moment ``v`` it stores, in
    units of each element's storage step (the row's scale for int8, the bf16
    spacing at ``v`` — not at the stored value, which may have rounded up
    into the next binade), as float64."""
    from sparse_coding__tpu_torch.utils.optim import dequant

    if hasattr(got, "q"):
        step = got.scale[..., None]
    else:
        lo = v.view(torch.int32) & -65536
        step = (lo + 65536).view(torch.float32) - lo.view(torch.float32)
    return ((dequant(got) - v) / step).double()
