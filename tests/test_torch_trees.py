"""The port's param trees (`utils.tree`: nested dicts, lists and
dataclasses) against JAX's pytrees, and the tree-walking runtime pieces
(stacking, the optimizers, `state_from_jax_numpy`) on nested params, on the
CPU. Leaves go in JAX's order: sorted dict keys, list order. The Adam and
SGD states and updates on a nested tree are held bit-equal to optax's moments
and to one f32 ulp on the updates, as `tests/test_torch_optim.py` holds them
on flat dicts; every structural check is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu.ensemble import stack_pytrees as jax_stack
from sparse_coding__tpu.ensemble import unstack_pytree as jax_unstack
from sparse_coding__tpu_torch.ensemble import _map_tensors, _member, stack_pytrees, unstack_pytree
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.utils import optim
from sparse_coding__tpu_torch.utils.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

M = 3


def _tree(seed, lead=()):
    """A LISTA-and-semilinear-like nested tree of f32 leaves (keys out of
    sorted order on purpose)."""
    rng = np.random.default_rng(seed)
    a = lambda *s: (0.01 * rng.standard_normal(lead + s)).astype(np.float32)  # noqa: E731
    return {"zeta": a(4), "encoder_layers": {"W": a(2, 5, 4), "theta": a(2, 5), "rho": a(2)},
            "layers": [{"weight": a(6, 4), "bias": a(6)}, {"weight": a(5, 6), "bias": a(5)}], "decoder": a(5, 4)}


TREES = {
    "nested": _tree(0),
    "flat": {"encoder_bias": np.zeros(3, np.float32), "encoder": np.ones((3, 2), np.float32),
             "decoder": np.full((3, 2), 2.0, np.float32)},
    "with_none": {"b": None, "a": [np.ones(2, np.float32), (np.zeros(1, np.float32), None)]},
}


@pytest.mark.parametrize("name", list(TREES))
def test_leaves_come_in_jax_order_and_round_trip(name):
    tree = TREES[name]
    got = tree_leaves(tree)
    want = jax.tree.leaves(tree)
    assert len(got) == len(want) and all(g is w for g, w in zip(got, want))
    mapped = tree_map(lambda a: a + 1, tree)
    assert jax.tree.structure(mapped) == jax.tree.structure(tree)
    assert list(mapped) == list(tree)  # a mapped dict keeps its own key order
    back = tree_unflatten(tree, [2 * a for a in got])
    for g, w in zip(jax.tree.leaves(back), want):
        np.testing.assert_array_equal(g, 2 * w)
    with pytest.raises(ValueError):
        tree_unflatten(tree, got + [got[0]])
    paths = [p for p, _ in tree_paths(tree)]
    assert len(paths) == len(set(paths)) == len(got)


def test_stack_unstack_and_member_follow_jax_on_nested_trees():
    members = [_tree(s) for s in range(M)]
    stacked = stack_pytrees([tree_map(torch.from_numpy, t) for t in members])
    jstacked = jax_stack([jax.tree.map(jnp.asarray, t) for t in members])
    for (path, a), b in zip(tree_paths(stacked), jax.tree.leaves(jstacked)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b), err_msg=str(path))
    for i, (u, ju) in enumerate(zip(unstack_pytree(stacked, M), jax_unstack(jstacked, M))):
        for a, b in zip(tree_leaves(u), jax.tree.leaves(ju)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
        one = _member(stacked, i)
        assert all(t.shape[0] == 1 for t in tree_leaves(one))
    copied = _map_tensors(stacked, torch.clone)
    assert isinstance(copied["layers"], list) and copied["layers"][1]["bias"] is not stacked["layers"][1]["bias"]


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adam_on_a_nested_tree_matches_optax(mu_dtype):
    params = _tree(0, (M,))
    tx = optax.adam(1e-3, mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = jax.vmap(tx.init)(j_params)
    opt = optim.adam(1e-3, mu_dtype=mu_dtype)
    t_params = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    t_state = opt.init(t_params)
    for step in range(3):
        g = _tree(10 + step, (M,))
        j_upd, j_state = jax.vmap(tx.update)(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, j_upd)
        t_upd, t_state = opt.update(tree_map(torch.from_numpy, g), t_state, t_params)
        t_params = optim.apply_updates(t_params, t_upd)
        for got, want in ((t_state.mu, j_state[0].mu), (t_state.nu, j_state[0].nu)):
            assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(jax.device_get(want))]
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(to_np(a), to_np(b))
        for a, b in zip(tree_leaves(t_upd), jax.tree.leaves(j_upd)):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=2.4e-7, atol=0)
    assert isinstance(t_params["layers"], list)


def test_sgd_and_adamw_walk_nested_trees():
    params = _tree(1, (M,))
    g = _tree(2, (M,))
    tp, tg = tree_map(torch.from_numpy, params), tree_map(torch.from_numpy, g)
    upd, _ = optim.sgd(0.1).update(tg, optim.sgd(0.1).init(tp))
    j_upd, _ = optax.sgd(0.1).update(jax.tree.map(jnp.asarray, g), optax.sgd(0.1).init(params))
    for a, b in zip(tree_leaves(upd), jax.tree.leaves(j_upd)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    one, gone = _tree(3), _tree(4)
    tx = optax.adamw(1e-3, weight_decay=1e-2)
    j_upd, _ = tx.update(jax.tree.map(jnp.asarray, gone), tx.init(one), jax.tree.map(jnp.asarray, one))
    opt = optim.adamw(1e-3, weight_decay=1e-2)
    t1 = tree_map(torch.from_numpy, one)
    t_upd, st = opt.update(tree_map(torch.from_numpy, gone), opt.init(t1), t1)
    assert isinstance(st.mu["layers"], list)
    for a, b in zip(tree_leaves(t_upd), jax.tree.leaves(j_upd)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=2.4e-7, atol=0)


def test_state_from_jax_numpy_carries_nested_int8_moments():
    """The JAX package's compressed Adam on a nested tree (int8 mu: 2-D-or-
    larger member leaves become `QuantMoment` nodes) carried across: the
    codes and scales exactly, at the params' places."""
    from sparse_coding__tpu.utils.optim import adam as jax_adam

    params = jax.tree.map(jnp.asarray, _tree(0, (M,)))
    tx = jax_adam(1e-3, mu_dtype="int8")
    st = jax.vmap(tx.init)(params)
    st = jax.vmap(tx.update)(jax.tree.map(jnp.asarray, _tree(5, (M,))), st, params)[1]
    adam = jax.device_get(st[0])
    state = state_from_jax_numpy(jax.device_get(params), {"l1_alpha": np.zeros(M, np.float32)},
                                 {"count": np.asarray(adam.count), "mu": adam.mu, "nu": adam.nu}, device="cpu")
    mu = state.opt_state.mu
    assert isinstance(mu["encoder_layers"]["W"], optim.QuantMoment)
    assert isinstance(mu["layers"][0]["weight"], optim.QuantMoment)
    assert isinstance(mu["layers"][0]["bias"], torch.Tensor)  # 1-D member leaves stay f32
    np.testing.assert_array_equal(mu["encoder_layers"]["W"].q.numpy(), np.asarray(adam.mu["encoder_layers"]["W"].q))
    np.testing.assert_array_equal(mu["layers"][1]["weight"].scale.numpy(),
                                  np.asarray(adam.mu["layers"][1]["weight"].scale))
    # the port's Adam takes the carried state on
    g = tree_map(torch.from_numpy, _tree(6, (M,)))
    upd, new = optim.adam(1e-3, mu_dtype="int8").update(g, state.opt_state, state.params)
    assert isinstance(new.mu["decoder"], optim.QuantMoment) and all(
        bool(torch.isfinite(u).all()) for u in tree_leaves(upd))
