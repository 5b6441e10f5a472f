"""The subject LMs: a hook-capable GPT-NeoX / GPT-2 forward, HF weight
conversion and in-image pretraining (counterpart of `sparse_coding__tpu/lm`;
its ring/Ulysses attention is not ported yet — ROADMAP A5 (ring attention))."""

from sparse_coding__tpu_torch.lm.convert import config_from_hf, load_model, params_from_hf
from sparse_coding__tpu_torch.lm.model import (
    LMConfig,
    config_for,
    dense_attention,
    forward,
    get_activation_size,
    init_params,
    lm_loss,
    make_tensor_name,
    run_with_cache,
    run_with_hooks,
)

__all__ = [
    "LMConfig", "config_for", "dense_attention", "forward", "get_activation_size", "init_params", "lm_loss",
    "make_tensor_name", "run_with_cache", "run_with_hooks", "config_from_hf", "load_model", "params_from_hf",
]
