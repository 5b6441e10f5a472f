"""The catalog's four ablation builders (ROADMAP A8a: `residual_denoising_
experiment`, `thresholding_experiment`, `dict_ratio_experiment`,
`run_positive_experiment`) against the JAX package's, on the CPU.

Tolerances, and why:
  - the builders' contracts exactly: ensemble names, signatures, member
    counts, args, the param trees' paths and shapes, every buffer value
    (f32 of the same numpy grids, the masked stack's int32 ``dict_size``
    and keep masks) and the hyperparameter names and ranges;
  - the LISTA sweep against the JAX sweep from the JAX builder's initial
    state (f32 autograd, each chunk one batch): params within 0.1 lr a
    step (the three unrolled layers' gradients agree to ~1e-5 relative, and
    Adam's second step divides by moments where successive gradients
    cancel: up to 0.067 lr on ~3% of ``W`` here, every other leaf within
    0.02 lr), the
    export loading in JAX (``verify=True``) to the port's encode rtol 1e-5
    (the f32 slice's bound, as `tests/test_torch_experiments.py`);
  - a preempted `dict_ratio_experiment` sweep resumed: bit-equal to the
    uninterrupted one.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu.train import experiments as jexp
from sparse_coding__tpu.utils.config import EnsembleArgs as JaxEnsembleArgs
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.models.learned_dict import dict_leaves
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train import experiments as texp
from sparse_coding__tpu_torch.train import preemption
from sparse_coding__tpu_torch.utils import faults
from sparse_coding__tpu_torch.utils.config import EnsembleArgs
from sparse_coding__tpu_torch.utils.tree import tree_paths

BUILDERS = ["residual_denoising_experiment", "thresholding_experiment", "dict_ratio_experiment",
            "run_positive_experiment"]
WIDTH = 16


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for k in ("SC_FAULT", "SC_RESUME", "SC_CHUNK_LOSS_BUDGET", "SC_CKPT_VERIFY", "SC_CHUNK_VERIFY"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    preemption.reset()
    yield
    faults.reset()
    preemption.reset()


def _np(v):
    return to_np(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _contract(out):
    """A builder's output as plain values: per ensemble (signature name,
    member count, args, name, param paths and shapes, buffer values), then
    the hyperparameter names and ranges."""
    ensembles, ens_hp, buf_hp, ranges = out
    rows = []
    for ens, args, name in ensembles:
        st = ens.state
        rows.append((
            ens.sig.__name__, ens.n_models, dict(args), name,
            [(p, tuple(_np(v).shape)) for p, v in tree_paths(st.params)],
            [(p, _np(v).dtype.kind, _np(v).shape, _np(v).tolist()) for p, v in tree_paths(st.buffers)],
            ens.l1_warmup_steps,
        ))
    return rows, list(ens_hp), list(buf_hp), {k: [float(x) for x in v] for k, v in ranges.items()}


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_keep_the_jax_contract(name):
    kw = dict(activation_width=WIDTH, batch_size=32)
    got = _contract(getattr(texp, name)(EnsembleArgs(**kw), device="cpu"))
    want = _contract(getattr(jexp, name)(JaxEnsembleArgs(**kw)))
    assert got == want


@pytest.mark.parametrize("dtype,want", [("float32", None), ("bfloat16", torch.bfloat16)])
def test_dict_ratio_stack_computes_in_the_configs_dtype_by_autograd(dtype, want):
    """The masked stack has no fused route: bf16 compute takes the autograd
    step under the precision policy, as in the JAX package."""
    cfg = EnsembleArgs(activation_width=WIDTH, batch_size=32, dtype=dtype)
    ens = texp.dict_ratio_experiment(cfg, device="cpu")[0][0][0]
    assert ens.compute_dtype == want and not ens.fused and ens._route(32, False, False) == "autograd"


def _common(tmp_path, **kw):
    return {**dict(activation_width=WIDTH, n_ground_truth_components=32, feature_num_nonzero=4, gen_batch_size=64,
                   chunk_size_gb=64 * WIDTH * 2 / 1024**3, n_chunks=2, batch_size=32,
                   dataset_folder=str(tmp_path / "store")), **kw}


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_train_through_run_sweep_synthetic(name, tmp_path):
    """`run_sweep_synthetic(builder, device="cpu")` at width 16: the export
    has one dict a member with the JAX builder's hyperparams (the masked
    stack's ``dict_size`` a Python int from its int32 buffer), finite
    encodes, and loads in the JAX package with ``verify=True``."""
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load

    lds = texp.run_sweep_synthetic(getattr(texp, name), device="cpu", output_folder=str(tmp_path / "out"),
                                   **_common(tmp_path))
    ens_out = getattr(jexp, name)(JaxEnsembleArgs(activation_width=WIDTH, batch_size=32))
    members = sum(e.n_models for e, _, _ in ens_out[0])
    assert len(lds) == members
    hps = [hp for _, hp in lds]
    if name == "dict_ratio_experiment":
        sizes = [int(512 * x) for x in np.linspace(1, 5, 8)] * 12
        assert [type(hp["dict_size"]) for hp in hps] == [int] * 96
        assert hps == [{"l1_alpha": pytest.approx(1e-3), "dict_size": s} for s in sizes]
        assert [ld.n_feats for ld, _ in lds] == sizes
    else:
        assert sorted(hps[0]) == ["dict_size", "l1_alpha"]
    x = torch.randn((8, WIDTH), generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(ld.encode(x)).all()) for ld, _ in lds)
    loaded = jax_load(tmp_path / "out" / "_1" / "learned_dicts.pkl", verify=True)
    assert [type(ld).__name__ for ld, _ in loaded] == [type(ld).__name__ for ld, _ in lds]
    assert [hp for _, hp in loaded] == hps


def test_lista_sweep_matches_the_jax_sweep(tmp_path):
    """`residual_denoising_experiment` through both packages' sweeps on one
    JAX-written store, the port's builder started from the JAX builder's
    initial state: the nested LISTA layers step alike and the port's export
    encodes in JAX as it does in the port."""
    import jax.numpy as jnp

    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load

    common = _common(tmp_path, batch_size=64)
    start = {}

    def jax_builder(cfg, mesh=None):
        out = jexp.residual_denoising_experiment(cfg, mesh)
        for ens, _, name in out[0]:
            st = jax.device_get(ens.state)
            adam = st.opt_state[0]
            start[name] = (st.params, st.buffers, {"count": np.asarray(adam.count), "mu": adam.mu, "nu": adam.nu})
        return out

    def port_builder(cfg, **kw):
        out = texp.residual_denoising_experiment(cfg, **kw)
        for ens, _, name in out[0]:
            ens.state = state_from_jax_numpy(*start[name], device="cpu")
        return out

    jlds = jexp.run_sweep_synthetic(jax_builder, output_folder=str(tmp_path / "jax"), **common)
    tlds = texp.run_sweep_synthetic(port_builder, device="cpu", output_folder=str(tmp_path / "torch"), **common)
    assert [hp for _, hp in tlds] == [hp for _, hp in jlds]
    steps = 2  # two chunks of 64 rows, one batch each
    for (t, _), (j, _) in zip(tlds, jlds):
        for (path, a), b in zip([(p, v) for _, p, v in dict_leaves(t)], jax.tree.leaves(j)):
            diff = float(np.abs(to_np(a) - np.asarray(b)).max())
            assert diff <= 0.1 * 1e-3 * steps, (path, diff)
    loaded = jax_load(tmp_path / "torch" / "_1" / "learned_dicts.pkl", verify=True)
    x = np.random.default_rng(1).standard_normal((40, WIDTH)).astype(np.float32)
    for (t, _), (j, _) in zip(tlds, loaded):
        want = np.asarray(j.encode(jnp.asarray(x)))
        np.testing.assert_allclose(to_np(t.encode(torch.from_numpy(x))), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_dict_ratio_sweep_preempted_and_resumed_is_bit_equal(tmp_path, monkeypatch):
    """A SIGTERM at position 1 (``SC_FAULT=sigterm:chunk=1``) commits a
    checkpoint of the 96-member masked stack (its int32 ``dict_size``
    buffers included) and raises `Preempted`; the resumed run restores it
    through `Ensemble.from_state` and exports what the uninterrupted run
    exports, bit for bit."""
    common = _common(tmp_path, n_chunks=3)
    ref = texp.run_sweep_synthetic(texp.dict_ratio_experiment, device="cpu", output_folder=str(tmp_path / "a"),
                                   **common)
    monkeypatch.setenv("SC_FAULT", "sigterm:chunk=1")
    faults.reset()
    with pytest.raises(preemption.Preempted):
        texp.run_sweep_synthetic(texp.dict_ratio_experiment, device="cpu", output_folder=str(tmp_path / "b"),
                                 **common)
    assert ckpt_lib.latest_checkpoint(tmp_path / "b").name == "ckpt_1"
    tree = ckpt_lib.restore_ensemble_checkpoint(tmp_path / "b" / "ckpt_1")
    size = tree["ensembles"]["dict_ratio"]["state"].buffers["dict_size"]
    assert size.dtype == torch.int32 and size.shape == (96,)
    monkeypatch.delenv("SC_FAULT")
    monkeypatch.setenv("SC_RESUME", "1")
    faults.reset()
    preemption.reset()
    got = texp.run_sweep_synthetic(texp.dict_ratio_experiment, device="cpu", output_folder=str(tmp_path / "b"),
                                   **common)
    assert len(got) == len(ref) == 96
    for (g, hg), (r, hr) in zip(got, ref):
        assert hg == hr
        assert all(torch.equal(a, b) for (_, _, a), (_, _, b) in zip(dict_leaves(g), dict_leaves(r)))
