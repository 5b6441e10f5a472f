"""The subject LMs: a hook-capable GPT-NeoX / GPT-2 forward, the blockwise
long-context attention, the sequence-parallel forward (ring and Ulysses
attention over a mesh axis), HF weight conversion and in-image pretraining
(counterpart of `sparse_coding__tpu/lm`)."""

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
from sparse_coding__tpu_torch.lm.ring_attention import (
    blockwise_attention,
    make_sequence_parallel_fn,
    ring_attention,
    sequence_parallel_forward,
    ulysses_attention,
)

__all__ = [
    "LMConfig", "config_for", "dense_attention", "forward", "get_activation_size", "init_params", "lm_loss",
    "make_tensor_name", "run_with_cache", "run_with_hooks", "config_from_hf", "load_model", "params_from_hf",
    "blockwise_attention", "make_sequence_parallel_fn", "ring_attention", "sequence_parallel_forward",
    "ulysses_attention",
]
