"""The signatures of slice A8a (`models/sae.py`'s five remaining ones,
`models/{lista,positive,semilinear,rica,direct_coef}.py`) against the JAX
package's, on the CPU, from the same numpy params (`tests/_torch_zoo.py`:
D 16, N 32, B 64, two members each).

Tolerances, and why:
  - f32 losses and loss parts rtol 1e-5; gradients rtol 1e-5 with an atol
    of 1e-6 of the tensor's largest magnitude (matmuls summing in another
    order; an element that cancels to ~0 keeps only that noise);
  - under the bf16 policy the signatures that apply it (the tied-centred,
    thresholding, masked and reverse SAEs) are held as the bf16 slice is:
    losses rtol 1e-3, gradients cosine > 0.9999 / max rel 1e-2
    (`assert_grads_close`); the others compute in f32 in both packages and
    keep the f32 bounds;
  - three Adam steps through both packages' `Ensemble` from one state: the
    losses rtol 1e-5 and the params within 1e-2 lr a step (the f32 slice's
    bounds), except where a gradient is f32 cancellation noise, which Adam
    scales to ~lr in either package (`RESYNC`);
  - the inference views on the same arrays: rtol 1e-5 (atol 1e-6);
  - exports across the packages: the arrays exactly, the encodes rtol 1e-5;
  - a resumed ensemble of every signature: bit-equal to the one that kept
    running.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_coding__tpu_torch.models as T
from _torch_parity import assert_grads_close, to_np
from _torch_zoo import BY_NAME, NAMES, batch, jax_ensemble, jax_members, np_tree, port_of, to_torch
from sparse_coding__tpu.utils import precision as jpx
from sparse_coding__tpu_torch import Ensemble
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.tree import tree_leaves, tree_map, tree_paths, tree_unflatten


def _jax_loss_grads(jsig, params, buffers, x, dtype):
    def f(p):
        with jpx.compute(None if dtype is None else jnp.bfloat16):
            total, (ld, aux) = jax.vmap(jsig.loss, in_axes=(0, 0, None))(p, buffers, jnp.asarray(x))
        return total.sum(), (ld, aux)

    (_, (ld, aux)), g = jax.value_and_grad(f, has_aux=True)(params)
    return np_tree(ld), np_tree(aux), np_tree(g)


def _port_loss_grads(tsig, params, buffers, x, dtype):
    tp = tree_map(lambda t: t.requires_grad_(True), to_torch(params))
    with px.compute(dtype):
        total, (ld, aux) = tsig.loss(tp, to_torch(buffers), torch.from_numpy(x))
    g = tree_unflatten(tp, torch.autograd.grad(total.sum(), tree_leaves(tp)))
    return ld, aux, g


def _assert_f32(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-6 * float(np.abs(want).max() or 1.0),
                               err_msg=what)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_parts_and_grads_match_jax(name, dtype):
    _, jsig, tsig, _, _, policy = BY_NAME[name]
    jp, jb = jax_members(name)
    x = batch()
    jl, jaux, jg = _jax_loss_grads(jsig, jp, jb, x, dtype)
    tl, taux, tg = _port_loss_grads(tsig, jp, jb, x, dtype)
    assert set(tl) == set(jl)
    low = dtype is not None and policy
    for k in jl:
        np.testing.assert_allclose(to_np(tl[k]), jl[k], rtol=1e-3 if low else 1e-5, err_msg=f"{name} {k}")
    assert to_np(taux["c"]).shape == jaux["c"].shape
    jpaths = tree_paths(jg)
    assert [p for p, _ in tree_paths(tg)] == [p for p, _ in jpaths]
    for (path, want), got in zip(jpaths, tree_leaves(tg)):
        if low:
            assert_grads_close(got, want, f"{name} {path}")
        else:
            _assert_f32(got, want, f"{name} {path}")


# signatures with a param whose true gradient cancels to 0 on part of the
# data: the thresholding SAE's code is ``s + g`` (no ``activation_scale``)
# on rows past its ramp, so a feature active only there gets a scale
# gradient of f32 rounding noise (~1e-8 against ~0.1), which Adam turns into
# a step of up to ~lr either way in either package. Its steps are compared
# one at a time from JAX's state, the noise elements held to Adam's bound.
RESYNC = {"FunctionalThresholdingSAE"}
NOISE = 1e-6  # |g| at most this share of the leaf's largest: cancellation noise
ADAM_BOUND = 0.1 / 0.001 ** 0.5  # (1 - b1) / sqrt(1 - b2): the largest Adam step, in lr


@pytest.mark.parametrize("name", NAMES)
def test_adam_steps_match_jax_ensemble(name):
    """Three steps of both packages' `Ensemble` (f32 autograd + Adam) from
    one state carried across with `state_from_jax_numpy`: the nested trees
    (LISTA's stacked layers, the semi-linear SAE's list) go through the
    stack, the optimizer and the in-place copy. Chained, except the
    `RESYNC` signatures (see there)."""
    lr = 3e-3
    jsig = BY_NAME[name][1]
    jens = jax_ensemble(name, lr)
    ens = port_of(jens, name, lr)
    assert ens._route(64, False, False) == "autograd"
    xs = [batch(10 + k) for k in range(3)]
    noisy = None
    for k, x in enumerate(xs):
        if name in RESYNC:
            ens = port_of(jens, name, lr)
            st = jax.device_get(jens.state)
            before = np_tree(st.params)
            jg = _jax_loss_grads(jsig, st.params, st.buffers, x, None)[2]
            noisy = [np.abs(g) <= NOISE * np.abs(g).max() for g in jax.tree.leaves(jg)]
        jl, _ = jens.step_batch(jnp.asarray(x))
        tl, aux = ens.step_batch(torch.from_numpy(x))
        for key in jl:
            np.testing.assert_allclose(to_np(tl[key]), np.asarray(jl[key]), rtol=1e-5, err_msg=f"{name} {key}")
        assert aux["c"].shape[:2] == (ens.n_models, 64)
        jp = np_tree(jens.state.params)
        paths, steps = tree_paths(jp), 1 if name in RESYNC else k + 1
        for i, ((path, want), got) in enumerate(zip(paths, tree_leaves(ens.state.params))):
            diff = np.abs(to_np(got) - want)
            if noisy is not None:
                moved = np.abs(to_np(got) - jax.tree.leaves(before)[i])
                assert moved[noisy[i]].max(initial=0) <= ADAM_BOUND * lr * 1.0001, (name, path)
                diff = np.where(noisy[i], 0.0, diff)
            assert diff.max() <= 1e-2 * lr * steps, (name, path, float(diff.max()))
    # the moments follow the params' tree
    assert [p for p, _ in tree_paths(ens.state.opt_state.mu)] == [p for p, _ in tree_paths(jp)]


@pytest.mark.parametrize("name", NAMES)
def test_learned_dict_views_match_jax(name):
    """`to_learned_dict` of member 1 in both packages from the same arrays:
    the same class, dictionary, encode, decode and prediction."""
    _, jsig, tsig, *_ = BY_NAME[name]
    jp, jb = jax_members(name)
    member = lambda t: jax.tree.map(lambda a: a[1], t)  # noqa: E731
    jld = jsig.to_learned_dict(member(jp), member(jb))
    tld = tsig.to_learned_dict(to_torch(np_tree(member(jp))), to_torch(np_tree(member(jb))))
    assert type(tld).__name__ == type(jld).__name__
    x = batch(5, 48)
    for what, got, want in (("dict", tld.get_learned_dict(), jld.get_learned_dict()),
                            ("encode", tld.encode(torch.from_numpy(x)), jld.encode(jnp.asarray(x))),
                            ("predict", tld.predict(torch.from_numpy(x)), jld.predict(jnp.asarray(x)))):
        _assert_f32(got, np.asarray(want), f"{name} {what}")
    c = np.array(jld.encode(jnp.asarray(x)))
    _assert_f32(tld.decode(torch.from_numpy(c)), np.asarray(jld.decode(jnp.asarray(c))), f"{name} decode")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("name", NAMES)
def test_exports_load_across_packages(name, direction, tmp_path):
    """An export written by either package loads in the other with
    ``verify=True``: the same class, every array leaf of its nested fields
    bit-equal, the same encode."""
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load
    from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save
    from sparse_coding__tpu_torch.models.learned_dict import dict_leaves
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

    _, jsig, tsig, *_ = BY_NAME[name]
    jp, jb = jax_members(name)
    member = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
    jld = jsig.to_learned_dict(member(jp), member(jb))
    tld = tsig.to_learned_dict(to_torch(np_tree(member(jp))), to_torch(np_tree(member(jb))))
    path = tmp_path / "dicts.pkl"
    if direction == "port_to_jax":
        save_learned_dicts(path, [(tld, {"l1_alpha": 1e-3})])
        (back, hp), = jax_load(path, verify=True)
        src, got_leaves = tld, [np.asarray(v) for v in jax.tree.leaves(back)]
        want_leaves = [to_np(t) for _, _, t in dict_leaves(tld)]
    else:
        jax_save(path, [(jld, {"l1_alpha": 1e-3})])
        (back, hp), = load_learned_dicts(path, verify=True, device="cpu")
        src, got_leaves = jld, [to_np(t) for _, _, t in dict_leaves(back)]
        want_leaves = [np.asarray(v) for v in jax.tree.leaves(jld)]
    assert hp == {"l1_alpha": 1e-3} and type(back).__name__ == type(src).__name__
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    x = batch(6, 32)
    enc = back.encode(torch.from_numpy(x) if direction == "jax_to_port" else jnp.asarray(x))
    _assert_f32(np.asarray(to_np(enc)), np.asarray(jld.encode(jnp.asarray(x))), f"{name} encode")


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_resumes_bit_for_bit(name):
    """`Ensemble.from_state` finds every new signature by name (no ``sig``
    given) and the clone steps on bit-equal to the original."""
    ens = port_of(jax_ensemble(name), name)
    x = torch.from_numpy(batch(20))
    ens.step_batch(x)
    clone = Ensemble.from_state(ens.state_dict(), device="cpu")
    assert clone.sig is ens.sig
    la, lb = ens.step_batch(x)[0], clone.step_batch(x)[0]
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ens.state.params), tree_leaves(clone.state.params)))


@pytest.mark.parametrize("name", NAMES)
def test_build_ensemble_draws_members_of_the_jax_shapes(name):
    """`build_ensemble` on the CPU makes the JAX init's tree: the same paths,
    shapes and dtypes of params and buffers (the values are the port's own
    draws); LISTA's orthogonal matrices have orthonormal columns."""
    _, jsig, tsig, common, members, _ = BY_NAME[name]
    from sparse_coding__tpu_torch import build_ensemble

    ens = build_ensemble(tsig, 0, members, device="cpu", **common)
    jp, jb = jax_members(name, perturb=0.0)
    for got, want in ((ens.state.params, jp), (ens.state.buffers, jb)):
        g, w = tree_paths(got), tree_paths(np_tree(want))
        assert [(p, tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in g] == [
            (p, a.shape, str(a.dtype)) for p, a in w]
    if name in ("FunctionalLISTADenoisingSAE", "FunctionalResidualDenoisingSAE"):
        for w in (ens.state.params["decoder"], ens.state.params["encoder_layers"]["W"].flatten(0, 1)):
            eye = torch.eye(w.shape[-1]).expand(w.shape[0], -1, -1)
            torch.testing.assert_close(w.transpose(-2, -1) @ w, eye, rtol=0, atol=1e-5)


def test_thresholding_clip_edges_take_jax_gradient():
    """A code exactly at the relu6's lower edge (``60 (c - 0.9) = 0``: a zero
    row of the batch, gain 0.9, scale 1): `jnp.clip`'s gradient there is 0.5,
    `torch.clamp`'s 1. The port follows JAX: the gain's gradient on that
    feature is JAX's, and half what `torch.clamp` would give."""
    from sparse_coding__tpu.models import FunctionalThresholdingSAE as JaxThr

    params = {"encoder": np.eye(4, 8, dtype=np.float32)[None], "activation_scale": np.ones((1, 4), np.float32),
              "activation_gain": np.full((1, 4), 0.9, np.float32), "centering": np.zeros((1, 8), np.float32)}
    x = np.zeros((2, 8), np.float32)

    def jf(p):
        return jax.vmap(JaxThr.encode, in_axes=(0, None, 0))(p, jnp.asarray(x), p["encoder"]).sum()

    jg = np.asarray(jax.grad(jf)(jax.tree.map(jnp.asarray, params))["activation_gain"])
    tp = tree_map(lambda a: torch.from_numpy(a).requires_grad_(True), params)
    T.FunctionalThresholdingSAE.encode(tp, torch.from_numpy(x), tp["encoder"]).sum().backward()
    np.testing.assert_array_equal(to_np(tp["activation_gain"].grad), jg)
    # relu6's edge: 60 × 0.5 / 6 = 5 a row (torch's clamp: 10); relu(c - 1) is off
    np.testing.assert_array_equal(jg, np.full((1, 4), 10.0, np.float32))


def test_dict_leaves_walk_nested_fields_in_jax_order():
    """`dict_leaves` of a LISTA view: the JAX package's ``jax.tree.leaves``
    order (sorted keys inside ``params``); `with_leaves` puts values back by
    the same walk."""
    from sparse_coding__tpu_torch.models.learned_dict import dict_leaves, with_leaves

    jp, jb = jax_members("FunctionalLISTADenoisingSAE")
    member = jax.tree.map(lambda a: a[0], jp)
    jld = BY_NAME["FunctionalLISTADenoisingSAE"][1].to_learned_dict(member, None)
    tld = T.FunctionalLISTADenoisingSAE.to_learned_dict(to_torch(np_tree(member)), None)
    leaves = dict_leaves(tld)
    assert [(f, p) for f, p, _ in leaves] == [("params", ("decoder",)), ("params", ("encoder_layers", "W")),
                                              ("params", ("encoder_layers", "rho")),
                                              ("params", ("encoder_layers", "theta"))]
    for (_, _, t), a in zip(leaves, jax.tree.leaves(jld)):
        np.testing.assert_array_equal(to_np(t), np.asarray(a))
    doubled = with_leaves(tld, [2 * t for _, _, t in leaves])
    assert torch.equal(doubled.params["encoder_layers"]["theta"], 2 * tld.params["encoder_layers"]["theta"])
    assert doubled.params is not tld.params and tld.params["decoder"] is leaves[0][2]


def _standalone_pair(kind):
    """A view no signature's `to_learned_dict` makes, in both packages from
    the same arrays: (JAX, port)."""
    from sparse_coding__tpu.models import pca as jpca
    from sparse_coding__tpu.models import positive as jpos
    from sparse_coding__tpu_torch.models import pca as tpca
    from sparse_coding__tpu_torch.models import positive as tpos

    rng = np.random.default_rng(3)
    enc, dec = rng.standard_normal((2, 32, 16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32) - 0.3).astype(np.float32)
    t = torch.from_numpy
    if kind == "TiedPositiveSAE":
        return jpos.TiedPositiveSAE(jnp.asarray(enc), jnp.asarray(bias), True), tpos.TiedPositiveSAE(
            t(enc), t(bias), True)
    if kind == "UntiedPositiveSAE":
        return (jpos.UntiedPositiveSAE(jnp.asarray(enc), jnp.asarray(bias), jnp.asarray(dec)),
                tpos.UntiedPositiveSAE(t(enc), t(bias), t(dec)))
    return jpca.PCAEncoder(jnp.asarray(enc[:16]), 3), tpca.PCAEncoder(t(enc[:16].copy()), 3)


@pytest.mark.parametrize("kind", ["TiedPositiveSAE", "UntiedPositiveSAE", "PCAEncoder"])
def test_standalone_views_match_jax_and_export_both_ways(kind, tmp_path):
    """The positive SAEs' own views (``|encoder|`` at construction) and
    `PCAEncoder` (signed top-k by magnitude): the same dictionary and
    encode, and an export of each package loading in the other with
    ``verify=True`` to the same arrays and encode."""
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load
    from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save
    from sparse_coding__tpu_torch.models.learned_dict import dict_leaves
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

    jld, tld = _standalone_pair(kind)
    x = batch(8, 40)
    want = np.asarray(jld.encode(jnp.asarray(x)))
    _assert_f32(tld.encode(torch.from_numpy(x)), want, f"{kind} encode")
    _assert_f32(tld.get_learned_dict(), np.asarray(jld.get_learned_dict()), f"{kind} dict")
    save_learned_dicts(tmp_path / "t.pkl", [(tld, {"k": 1})])
    jax_save(tmp_path / "j.pkl", [(jld, {"k": 1})])
    (jback, _), = jax_load(tmp_path / "t.pkl", verify=True)
    (tback, _), = load_learned_dicts(tmp_path / "j.pkl", verify=True, device="cpu")
    # each loaded record holds the arrays its writer held
    for a, (_, _, b) in zip(jax.tree.leaves(jback), dict_leaves(tld)):
        np.testing.assert_array_equal(np.asarray(a), to_np(b))
    for (_, _, a), b in zip(dict_leaves(tback), jax.tree.leaves(jld)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    _assert_f32(np.asarray(jback.encode(jnp.asarray(x))), want, f"{kind} JAX-loaded encode")
    _assert_f32(tback.encode(torch.from_numpy(x)), want, f"{kind} port-loaded encode")
