"""`models/direct_coef.py` against the JAX package's basis pursuit, on the
CPU: the codes of the 100-step momentum search, its objective, and the
convention at the kink of ``|c|`` (``jax.grad(jnp.abs)(0.)`` is 1, torch's
``abs`` backward gives 0 there).

Tolerances, and why: the search's codes rtol 1e-4 with an atol of 1e-6 of
their largest value (100 chained steps of f32 products summing in another
order); the objective rtol 1e-5. The torch-convention search is held to
differ by more than 100 times that atol: the convention is what the test
sees, not noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu.models import DirectCoefOptimizer as JaxDC
from sparse_coding__tpu_torch.models.direct_coef import MOMENTUM, DirectCoefOptimizer, DirectCoefSearch
from sparse_coding__tpu_torch.models.learned_dict import _norm_rows

D, N, B = 16, 32, 64


def _problem(seed=0, members=2, l1=(1e-3, 1e-2), lr=(1e-2, 3e-2)):
    rng = np.random.default_rng(seed)
    decoder = rng.standard_normal((members, N, D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    buffers = {"l1_alpha": np.asarray(l1, np.float32), "lr": np.asarray(lr, np.float32)}
    return {"decoder": decoder}, buffers, x


def _jax_codes(params, buffers, x, n_iters=100):
    f = jax.vmap(lambda p, b: JaxDC.basis_pursuit(p, b, jnp.asarray(x), n_iters=n_iters))
    return np.asarray(f(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, buffers)))


def _port_codes(params, buffers, x, n_iters=100):
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    return to_np(DirectCoefOptimizer.basis_pursuit(t(params), t(buffers), torch.from_numpy(x), n_iters=n_iters))


def _torch_abs_codes(params, buffers, x, n_iters=100):
    """The same search with the gradient taken by torch's autograd of the
    objective: ``abs``'s derivative 0 at 0."""
    nd = _norm_rows(torch.from_numpy(params["decoder"]))
    l1 = torch.from_numpy(buffers["l1_alpha"])
    lr = torch.from_numpy(buffers["lr"])[:, None, None]
    xb = torch.from_numpy(x)
    c = torch.zeros((nd.shape[0], B, N))
    v = torch.zeros_like(c)
    for _ in range(n_iters):
        cg = c.clone().requires_grad_(True)
        total = DirectCoefOptimizer.objective(cg, nd, xb, l1)[0].sum()
        (g,) = torch.autograd.grad(total, [cg])
        v = MOMENTUM * v - lr * g
        c = torch.relu(c + v)
    return to_np(c)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("n_iters", [1, 10, 100])
def test_search_codes_follow_jax(n_iters):
    params, buffers, x = _problem()
    want = _jax_codes(params, buffers, x, n_iters)
    _close(_port_codes(params, buffers, x, n_iters), want)
    assert (want > 0).any() and (want == 0).any()


def test_search_fails_with_torchs_abs_gradient_at_zero():
    """The search starts at c = 0, where JAX's ``|c|`` has derivative 1:
    every zero code gets ``l1 / B`` in its gradient. torch's autograd (0
    there) gives other codes, which the tolerance of
    `test_search_codes_follow_jax` refuses; the port's written-out gradient
    gives JAX's."""
    params, buffers, x = _problem(seed=3)
    want = _jax_codes(params, buffers, x)
    wrong = _torch_abs_codes(params, buffers, x)
    atol = 1e-6 * float(np.abs(want).max())
    assert np.abs(wrong - want).max() > 100 * atol
    with pytest.raises(AssertionError):
        _close(wrong, want)
    _close(_port_codes(params, buffers, x), want)


def test_objective_and_its_gradient_match_jax():
    """The lasso objective and the written-out gradient against ``jax.grad``
    at a point with zero, positive and negative codes."""
    params, buffers, x = _problem(seed=5)
    rng = np.random.default_rng(6)
    c = np.maximum(rng.standard_normal((2, B, N)).astype(np.float32), 0) - 0.1 * (rng.random((2, B, N)) < 0.1)
    c = c.astype(np.float32)
    nd = np.array(jax.vmap(lambda d: d / jnp.linalg.norm(d, axis=-1, keepdims=True))(params["decoder"]))

    def jobj(cc):
        return jax.vmap(lambda a, d, l: JaxDC.objective(a, d, jnp.asarray(x), l)[0])(
            cc, jnp.asarray(nd), jnp.asarray(buffers["l1_alpha"])).sum()

    jval, jg = jax.value_and_grad(jobj)(jnp.asarray(c))
    tnd, tl1 = torch.from_numpy(nd), torch.from_numpy(buffers["l1_alpha"])
    tval = DirectCoefOptimizer.objective(torch.from_numpy(c), tnd, torch.from_numpy(x), tl1)[0].sum()
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    tg = DirectCoefOptimizer.objective_grad(torch.from_numpy(c), tnd, torch.from_numpy(x), tl1)
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), rtol=1e-5, atol=1e-7 * float(np.abs(jg).max()))


def test_loss_gradient_reaches_the_decoder_through_the_final_decode_only():
    """The decoder's gradient equals JAX's (the search is stop-gradient) and
    equals the gradient of the decode at the fixed codes."""
    params, buffers, x = _problem(seed=7)

    def jloss(p):
        return jax.vmap(lambda q, b: JaxDC.loss(q, b, jnp.asarray(x))[0])(p, jax.tree.map(jnp.asarray, buffers)).sum()

    jg = np.asarray(jax.grad(jloss)({"decoder": jnp.asarray(params["decoder"])})["decoder"])
    dec = torch.from_numpy(params["decoder"]).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in buffers.items()}
    total, (_, aux) = DirectCoefOptimizer.loss({"decoder": dec}, tb, torch.from_numpy(x))
    (tg,) = torch.autograd.grad(total.sum(), [dec])
    np.testing.assert_allclose(to_np(tg), jg, rtol=1e-4, atol=1e-6 * float(np.abs(jg).max()))
    assert not aux["c"].requires_grad


def test_search_view_encodes_one_member_as_jax():
    """`DirectCoefSearch.encode` (one member, unstacked) is JAX's search."""
    params, buffers, x = _problem(seed=9)
    p1 = {"decoder": params["decoder"][1]}
    b1 = {k: v[1] for k, v in buffers.items()}
    want = np.asarray(JaxDC.basis_pursuit(jax.tree.map(jnp.asarray, p1), jax.tree.map(jnp.asarray, b1),
                                          jnp.asarray(x)))
    ld = DirectCoefSearch({"decoder": torch.from_numpy(p1["decoder"])},
                          {k: torch.from_numpy(np.array(v)) for k, v in b1.items()})
    _close(to_np(ld.encode(torch.from_numpy(x))), want)
