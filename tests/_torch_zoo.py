"""The signatures of the JAX package's model zoo that slice A8a ports, with
the helpers their parity tests share: both packages' members from one JAX
init, carried across as numpy (tests/test_torch_model_zoo.py,
tests/test_torch_ablations.py, tests/test_torch_serve_nested.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sparse_coding__tpu.models as J
import sparse_coding__tpu_torch.models as T
from sparse_coding__tpu.ensemble import stack_pytrees as jax_stack
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.utils.tree import tree_map

D, N, B = 16, 32, 64
MASKED = dict(activation_size=D, n_components_stack=N)
L1 = [{"l1_alpha": 1e-4}, {"l1_alpha": 1e-3, "bias_decay": 0.05}]
L1_ONLY = [{"l1_alpha": 1e-4}, {"l1_alpha": 1e-3}]

# (name, JAX signature, port signature, common init kwargs, member kwargs,
#  whether the signature applies the precision policy)
ZOO = [
    ("FunctionalTiedCenteredSAE", J.FunctionalTiedCenteredSAE, T.FunctionalTiedCenteredSAE,
     dict(activation_size=D, n_dict_components=N), L1_ONLY, True),
    ("FunctionalThresholdingSAE", J.FunctionalThresholdingSAE, T.FunctionalThresholdingSAE,
     dict(activation_size=D, n_dict_components=N), L1_ONLY, True),
    ("FunctionalMaskedTiedSAE", J.FunctionalMaskedTiedSAE, T.FunctionalMaskedTiedSAE, MASKED,
     [{"l1_alpha": 1e-4, "n_dict_components": 16}, {"l1_alpha": 1e-3, "n_dict_components": 24}], True),
    ("FunctionalMaskedSAE", J.FunctionalMaskedSAE, T.FunctionalMaskedSAE, MASKED,
     [{"l1_alpha": 1e-4, "n_dict_components": 16}, {"l1_alpha": 1e-3, "n_dict_components": 24}], True),
    ("FunctionalReverseSAE", J.FunctionalReverseSAE, T.FunctionalReverseSAE,
     dict(activation_size=D, n_dict_components=N), L1, True),
    ("FunctionalLISTADenoisingSAE", J.FunctionalLISTADenoisingSAE, T.FunctionalLISTADenoisingSAE,
     dict(d_activation=D, n_features=N, n_hidden_layers=3), L1_ONLY, False),
    ("FunctionalResidualDenoisingSAE", J.FunctionalResidualDenoisingSAE, T.FunctionalResidualDenoisingSAE,
     dict(d_activation=D, n_features=N, n_hidden_layers=3), L1_ONLY, False),
    ("FunctionalPositiveTiedSAE", J.FunctionalPositiveTiedSAE, T.FunctionalPositiveTiedSAE,
     dict(activation_size=D, n_dict_components=N), L1, False),
    ("SemiLinearSAE", J.SemiLinearSAE, T.SemiLinearSAE, dict(activation_size=D, n_dict_components=N),
     L1_ONLY, False),
    ("DirectCoefOptimizer", J.DirectCoefOptimizer, T.DirectCoefOptimizer, dict(d_activation=D, n_features=N),
     [{"l1_alpha": 1e-3}, {"l1_alpha": 1e-2}], False),
    ("RICA", J.RICA, T.RICA, dict(activation_size=D, n_dict_components=N),
     [{"sparsity_coef": 0.1}, {"sparsity_coef": 0.1, "sparsity_loss": "l1"}], False),
]
NAMES = [z[0] for z in ZOO]
BY_NAME = {z[0]: z for z in ZOO}


def np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def jax_members(name, seed=0, perturb=0.02):
    """The stacked JAX params and buffers of ``name``'s members, every float
    param moved by seeded noise of scale ``perturb`` (so zero biases, unit
    scales and zero gains sit off their special values)."""
    _, jsig, _, common, members, _ = BY_NAME[name]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(members))
    models = [jsig.init(k, **common, **hp) for k, hp in zip(keys, members)]
    params, buffers = jax_stack([p for p, _ in models]), jax_stack([b for _, b in models])
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(lambda a: a + perturb * jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)
    return params, buffers


def batch(seed=1, rows=B):
    return np.random.default_rng(seed).standard_normal((rows, D)).astype(np.float32)


def jax_ensemble(name, lr=3e-3, seed=0):
    """The JAX `Ensemble` of ``name``'s members (Adam at ``lr``), from the
    perturbed members."""
    from sparse_coding__tpu import Ensemble as JaxEnsemble

    _, jsig, *_ = BY_NAME[name]
    params, buffers = jax_members(name, seed)
    n = jax.tree.leaves(params)[0].shape[0]
    models = [(jax.tree.map(lambda a: a[i], params), jax.tree.map(lambda a: a[i], buffers)) for i in range(n)]
    return JaxEnsemble(models, jsig, optimizer_kwargs={"learning_rate": lr})


def port_of(jens, name, lr=3e-3):
    """A port `Ensemble` at the JAX ensemble's state (params, buffers, Adam
    moments and step, through `state_from_jax_numpy`)."""
    from sparse_coding__tpu_torch import Ensemble
    from sparse_coding__tpu_torch.ensemble import unstack_pytree

    st = jax.device_get(jens.state)
    adam = st.opt_state[0]
    state = state_from_jax_numpy(st.params, st.buffers, {"count": np.asarray(adam.count), "mu": adam.mu,
                                                         "nu": adam.nu}, step=int(st.step), device="cpu")
    n = jens.n_models
    ens = Ensemble(list(zip(unstack_pytree(state.params, n), unstack_pytree(state.buffers, n))), BY_NAME[name][2],
                   optimizer_kwargs={"learning_rate": lr})
    ens.state = state
    return ens
