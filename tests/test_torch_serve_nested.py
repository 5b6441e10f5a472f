"""Serving dictionaries whose arrays are nested trees (`LISTADenoisingSAE`'s
stacked layers, `SemiLinearSAE_export`'s list of layers) through the port's
`DictRegistry` + `EncodeEngine`, on the CPU.

The A7a contract, bit for bit: each lane equals its stack of one
(`encode_naive`) at its bucket, the eager dispatch equals the drainer's;
int8 residency quantizes the leaves JAX's registry quantizes (every 2-D
floating leaf of the flattened tree: ``q``, scales and the dequantized
weights bit-equal to JAX's); the JAX engine's lanes agree within rtol 1e-5
and an atol of 1e-6 of the largest code (LISTA's momentum output
``x + m (x - x_prev)`` keeps the rounding of the larger terms).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_zoo import BY_NAME, jax_members, np_tree, to_torch
from sparse_coding__tpu.serve import engine as jengine
from sparse_coding__tpu.serve import registry as jregistry
from sparse_coding__tpu_torch.models.learned_dict import dict_leaves
from sparse_coding__tpu_torch.serve.engine import EncodeEngine, _Stack
from sparse_coding__tpu_torch.serve.registry import DictRegistry
from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

pytestmark = pytest.mark.serve

KINDS = ["FunctionalLISTADenoisingSAE", "SemiLinearSAE"]
RTOL = 1e-5


def _pairs(name, seeds=(0, 1)):
    """Dicts of ``name`` in both packages from the same arrays: [(JAX, port)]."""
    _, jsig, tsig, *_ = BY_NAME[name]
    out = []
    for seed in seeds:
        jp, jb = jax_members(name, seed=seed)
        for i in range(2):
            p = jax.tree.map(lambda a: a[i], jp)
            out.append((jsig.to_learned_dict(p, None), tsig.to_learned_dict(to_torch(np_tree(p)), None)))
    return out


def _rows(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 16)).astype(np.float32)


@pytest.mark.parametrize("name", KINDS)
def test_exported_nested_dicts_serve_each_lane_as_its_stack_of_one(name, tmp_path):
    """Four dicts of one nested class, exported and loaded back through the
    checkpoint format, registered into one group: every bucket's drainer
    dispatch, eager dispatch and stack of one agree bit for bit, dense and
    top-k."""
    path = tmp_path / "dicts.pkl"
    save_learned_dicts(path, [(t, {"i": i}) for i, (_, t) in enumerate(_pairs(name))])
    reg = DictRegistry(device="cpu")
    for i, (ld, hp) in enumerate(load_learned_dicts(path, verify=True, device="cpu")):
        reg.add(f"d{i}", ld, hyperparams=hp)
    assert len({reg.get(f"d{i}").group_key for i in range(4)}) == 1
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=1.0).start()
    try:
        for n in (1, 5, 13, 64):
            X = _rows(n, n)
            for did in ("d0", "d3"):
                dense = eng.compare_routes(did, X)
                np.testing.assert_array_equal(dense["graph"], dense["eager"])
                np.testing.assert_array_equal(dense["graph"], dense["naive"])
                sparse = eng.compare_routes(did, X, top_k=5)
                for route in ("eager", "naive"):
                    for a, b in zip(sparse["graph"], sparse[route]):
                        np.testing.assert_array_equal(a, b)
        X = _rows(3, 7)
        reqs = [eng.submit(f"d{i}", X) for i in range(4)]
        for i, r in enumerate(reqs):
            np.testing.assert_array_equal(r.result(30), eng.encode_naive(f"d{i}", X, bucket=8))
        assert eng.stats["errors"] == 0
    finally:
        eng.stop()


@pytest.mark.parametrize("name", KINDS)
def test_nested_lanes_match_the_jax_engine(name):
    pairs = _pairs(name)
    jreg, reg = jregistry.DictRegistry(), DictRegistry(device="cpu")
    for i, (j, t) in enumerate(pairs):
        jreg.add(f"d{i}", j)
        reg.add(f"d{i}", t)
    jeng = jengine.EncodeEngine(jreg, max_batch=64, max_wait_ms=20.0).start()
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=20.0).start()
    try:
        X = _rows(4, 11)
        jreqs = [jeng.submit(f"d{i}", X) for i in range(4)]
        reqs = [eng.submit(f"d{i}", X) for i in range(4)]
        for jr, r in zip(jreqs, reqs):
            want = np.asarray(jr.result(60))
            np.testing.assert_allclose(r.result(60), want, rtol=RTOL, atol=1e-6 * np.abs(want).max())
    finally:
        jeng.stop()
        eng.stop()


@pytest.mark.parametrize("name", KINDS)
def test_int8_residency_quantizes_the_leaves_jax_quantizes(name):
    """The quantized leaves are JAX's (the 2-D floating ones of the tree in
    its flatten order: LISTA's decoder and ``theta`` [K, N], not ``W``
    [K, N, D] or ``rho``; the semi-linear SAE's weights and decoder), their
    codes, scales and dequantized weights bit-equal; the int8 lanes equal
    their int8 stacks of one."""
    j, t = _pairs(name, seeds=(0,))[0]
    jentry = jregistry.ServedDict("a", j, weights="int8")
    entry = DictRegistry(device="cpu").add("a", t, weights="int8")
    assert [q is None for q in entry.quant_leaves] == [q is None for q in jentry.quant_leaves]
    assert [p for (_, p, _), q in zip(dict_leaves(t), entry.quant_leaves) if q is not None] == (
        [("decoder",), ("encoder_layers", "theta")] if name == "FunctionalLISTADenoisingSAE"
        else [("decoder",), ("encoder_layers", 0, "weight"), ("encoder_layers", 1, "weight")])
    for q, jq in zip(entry.quant_leaves, jentry.quant_leaves):
        if q is not None:
            np.testing.assert_array_equal(q["q"].numpy(), np.asarray(jq["q"]))
            np.testing.assert_array_equal(q["scales"].numpy(), np.asarray(jq["scales"]))
    jstack = jengine._Stack([jentry])
    jw = [np.asarray(v)[0] for v in jax.tree.leaves(jstack.dequant_fn(jstack.quant))]
    stack = _Stack([entry], torch.device("cpu"))
    stack.dequant()
    for w, want in zip(stack.bufs[0], jw):
        np.testing.assert_array_equal(w.numpy(), want)
    reg = DictRegistry(device="cpu")
    for i, (_, ld) in enumerate(_pairs(name)):
        reg.add(f"q{i}", ld, weights="int8")
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=1.0).start()
    try:
        X = _rows(9, 6)
        outs = [r.result(30) for r in [eng.submit(f"q{i}", X) for i in range(4)]]
        for i in range(4):
            np.testing.assert_array_equal(outs[i], eng.encode_naive(f"q{i}", X))
    finally:
        eng.stop()
