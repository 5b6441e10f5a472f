"""The port's baseline learned dicts against the JAX package's, on the CPU:
exports cross in both directions (the JAX loader verifying the port's
sidecar), and each dict encodes, decodes and predicts as the JAX class does
on the same arrays (rtol 1e-5, atol 1e-6: f32 matmuls summing in another
order). `AddedNoise` draws from the port's own stream, so its noise is held
to its statistics (mean within 4 standard errors of 0, variance within 3%
of the magnitude squared at 65,536 draws), not to JAX's bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu.models import learned_dict as jld
from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load
from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save
from sparse_coding__tpu_torch.models import learned_dict as tld
from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

D, N = 16, 24
CLASSES = ["Identity", "IdentityReLU", "RandomDict", "ReverseSAE", "ThresholdingSAE_export", "AddedNoise", "Rotation"]


def _port(name: str):
    """A port instance of each baseline, from seeded numpy arrays."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    if name == "Identity":
        return tld.Identity(D, device="cpu")
    if name == "IdentityReLU":
        return tld.IdentityReLU(D, bias=0.1 * t(D))
    if name == "RandomDict":
        return tld.RandomDict(D, N, key=3, device="cpu")
    if name == "ReverseSAE":
        return tld.ReverseSAE(t(N, D), 0.1 * t(N), norm_encoder=True)
    if name == "ThresholdingSAE_export":
        return tld.ThresholdingSAE_export({"encoder": t(N, D), "activation_scale": 1.0 + 0.1 * t(N),
                                           "activation_gain": 0.1 * t(N), "centering": 0.1 * t(D)})
    if name == "AddedNoise":
        return tld.AddedNoise(0.25, D, key=7, device="cpu")
    return tld.Rotation(torch.linalg.qr(t(D, D))[0])


def _arrays(ld):
    """A dict's registered array fields as numpy (a dict field flattened)."""
    fields = (jld.LEARNED_DICT_REGISTRY if type(ld).__module__.startswith("sparse_coding__tpu.")
              else tld.LEARNED_DICT_REGISTRY)[type(ld)][0]
    out = {}
    for f in fields:
        v = getattr(ld, f)
        for k, a in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f + k] = to_np(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return out


def _same_math(j, t, x):
    """The JAX dict and the port dict encode, decode and predict alike."""
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    kw = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(t.get_learned_dict()), np.asarray(j.get_learned_dict()), **kw)
    if isinstance(t, tld.AddedNoise):
        return
    code = np.asarray(j.encode(jx))
    np.testing.assert_allclose(to_np(t.encode(tx)), code, **kw)
    np.testing.assert_allclose(to_np(t.decode(torch.from_numpy(code))), np.asarray(j.decode(jnp.asarray(code))), **kw)
    np.testing.assert_allclose(to_np(t.predict(tx)), np.asarray(j.predict(jx)), **kw)


@pytest.mark.parametrize("name", CLASSES)
def test_baseline_exports_cross_both_ways_and_compute_alike(name, tmp_path):
    """The port's export loads in JAX with ``verify=True`` as JAX's class with
    the same arrays and statics, and computes there as here; JAX's export of
    that dict loads back in the port, equal."""
    t = _port(name)
    x = np.random.default_rng(1).standard_normal((40, D)).astype(np.float32)
    hp = {"baseline": name}
    save_learned_dicts(tmp_path / "port.pkl", [(t, hp)])
    [(j, jhp)] = jax_load(tmp_path / "port.pkl", verify=True)
    assert type(j) is getattr(jld, name) and jhp == hp
    assert (j.n_feats, j.activation_size) == (t.n_feats, t.activation_size)
    a_t, a_j = _arrays(t), _arrays(j)
    assert sorted(a_t) == sorted(a_j)
    for k in a_t:
        assert a_t[k].dtype == a_j[k].dtype and np.array_equal(a_t[k], a_j[k]), k
    _same_math(j, t, x)
    jax_save(tmp_path / "jax.pkl", [(j, hp)])
    [(back, bhp)] = load_learned_dicts(tmp_path / "jax.pkl", verify=True, device="cpu")
    assert type(back) is type(t) and bhp == hp
    a_b = _arrays(back)
    assert all(np.array_equal(a_b[k], a_t[k]) for k in a_t)
    _same_math(j, back, x)


def test_added_noise_statistics_and_key_stream():
    """The noise has mean 0 and variance ``noise_mag²``; the same key gives
    the same noise, and each keyless encode moves the key on (fresh noise),
    as JAX's split does; a given generator is used as it is."""
    a, b = tld.AddedNoise(0.25, D, key=7, device="cpu"), tld.AddedNoise(0.25, D, key=7, device="cpu")
    x = torch.zeros((4096, D))
    n1 = a.encode(x)
    assert torch.equal(n1, b.encode(x)) and a._key.dtype == torch.uint32
    n2 = a.encode(x)
    assert not torch.equal(n1, n2)
    assert torch.equal(n2, b.encode(x)) and torch.equal(a._key, b._key)
    flat = n1.flatten().double()
    assert abs(float(flat.mean())) < 4 * 0.25 / flat.numel() ** 0.5
    assert abs(float(flat.var()) / 0.25**2 - 1) < 0.03
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    key = a._key.clone()
    assert torch.equal(a.encode(x, generator=g1), a.encode(x, generator=g2)) and torch.equal(a._key, key)
    assert jld.AddedNoise(0.25, D, key=jax.random.PRNGKey(7))._key.tolist() == tld.AddedNoise(
        0.25, D, key=7, device="cpu")._key.tolist()


def test_random_dict_takes_a_generator_or_a_seed():
    """``key`` as a seed or as a generator seeded alike gives the same
    gaussian encoder; another seed another one; zero bias."""
    a = tld.RandomDict(D, N, key=3, device="cpu")
    b = tld.RandomDict(D, N, key=torch.Generator().manual_seed(3))
    c = tld.RandomDict(D, key=4, device="cpu")
    assert torch.equal(a.encoder, b.encoder) and a.encoder.shape == (N, D) and c.encoder.shape == (D, D)
    assert not torch.equal(a.encoder[:D], c.encoder) and not a.encoder_bias.any()
