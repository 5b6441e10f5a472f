"""HF transformers → the port's subject-LM param tree.

Counterpart of `sparse_coding__tpu/lm/convert.py`, in the same layout:
  - NeoX fused QKV rows are per-head [q|k|v] blocks: reshape ``[H·3·Dh, d]``
    → ``[H, 3, Dh, d]`` → permute to ``[3, H, Dh, d]``;
  - GPT-2's ``Conv1D`` stores weights as ``[in, out]`` (transposed against
    ``nn.Linear``).
Works on any local `GPTNeoXForCausalLM` / `GPT2LMHeadModel` (or a checkpoint
folder saved with ``save_pretrained``); a hub name needs the network.
``transformers`` is imported inside `load_model` only: the card's machine
does not have it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from sparse_coding__tpu_torch.lm.model import LMConfig
from sparse_coding__tpu_torch.utils.device import resolve_device


def config_from_hf(hf_config) -> LMConfig:
    t = hf_config.model_type
    if t == "gpt_neox":
        return LMConfig(
            arch="neox",
            n_layers=hf_config.num_hidden_layers,
            d_model=hf_config.hidden_size,
            n_heads=hf_config.num_attention_heads,
            d_mlp=hf_config.intermediate_size,
            vocab_size=hf_config.vocab_size,
            n_ctx=hf_config.max_position_embeddings,
            rotary_pct=hf_config.rotary_pct,
            rotary_base=getattr(hf_config, "rotary_emb_base", 10000.0),
            parallel_residual=hf_config.use_parallel_residual,
            layer_norm_eps=hf_config.layer_norm_eps,
            tie_word_embeddings=hf_config.tie_word_embeddings,
        )
    if t == "gpt2":
        return LMConfig(
            arch="gpt2",
            n_layers=hf_config.n_layer,
            d_model=hf_config.n_embd,
            n_heads=hf_config.n_head,
            d_mlp=4 * hf_config.n_embd,
            vocab_size=hf_config.vocab_size,
            n_ctx=hf_config.n_positions,
            layer_norm_eps=hf_config.layer_norm_epsilon,
            tie_word_embeddings=True,
        )
    raise ValueError(f"Unsupported HF model type: {t}")


def params_from_hf(hf_model, dtype=torch.float32, device=None) -> Dict[str, Any]:
    """An HF causal-LM module's weights as the port's param tree on ``device``
    (None = cuda)."""
    device = resolve_device(device)
    cfg = config_from_hf(hf_model.config)
    H, Dh, d = cfg.n_heads, cfg.d_head, cfg.d_model
    sd = dict(hf_model.state_dict())

    def g(name):
        return sd[name].detach().to(device=device, dtype=dtype).contiguous()

    if cfg.arch == "neox":
        params: Dict[str, Any] = {
            "embed": g("gpt_neox.embed_in.weight"),
            "ln_f": {"w": g("gpt_neox.final_layer_norm.weight"), "b": g("gpt_neox.final_layer_norm.bias")},
            "unembed": g("embed_out.weight"),
            "blocks": [],
        }
        for i in range(cfg.n_layers):
            pre = f"gpt_neox.layers.{i}."
            w_qkv = g(pre + "attention.query_key_value.weight")  # [H*3*Dh, d]
            b_qkv = g(pre + "attention.query_key_value.bias")  # [H*3*Dh]
            params["blocks"].append({
                "ln1": {"w": g(pre + "input_layernorm.weight"), "b": g(pre + "input_layernorm.bias")},
                "ln2": {"w": g(pre + "post_attention_layernorm.weight"),
                        "b": g(pre + "post_attention_layernorm.bias")},
                "attn": {
                    "w_qkv": w_qkv.reshape(H, 3, Dh, d).permute(1, 0, 2, 3).contiguous(),
                    "b_qkv": b_qkv.reshape(H, 3, Dh).permute(1, 0, 2).contiguous(),
                    "w_o": g(pre + "attention.dense.weight").reshape(d, H, Dh),
                    "b_o": g(pre + "attention.dense.bias"),
                },
                "mlp": {
                    "w_in": g(pre + "mlp.dense_h_to_4h.weight"),
                    "b_in": g(pre + "mlp.dense_h_to_4h.bias"),
                    "w_out": g(pre + "mlp.dense_4h_to_h.weight"),
                    "b_out": g(pre + "mlp.dense_4h_to_h.bias"),
                },
            })
        return params

    # gpt2
    params = {
        "embed": g("transformer.wte.weight"),
        "pos_embed": g("transformer.wpe.weight"),
        "ln_f": {"w": g("transformer.ln_f.weight"), "b": g("transformer.ln_f.bias")},
        "blocks": [],
    }
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}."
        c_attn_w = g(pre + "attn.c_attn.weight")  # Conv1D: [d, 3d], columns [q|k|v]
        c_proj_w = g(pre + "attn.c_proj.weight")  # Conv1D: [d(in=H*Dh), d(out)]
        params["blocks"].append({
            "ln1": {"w": g(pre + "ln_1.weight"), "b": g(pre + "ln_1.bias")},
            "ln2": {"w": g(pre + "ln_2.weight"), "b": g(pre + "ln_2.bias")},
            "attn": {
                "w_qkv": c_attn_w.T.reshape(3, H, Dh, d).contiguous(),
                "b_qkv": g(pre + "attn.c_attn.bias").reshape(3, H, Dh),
                "w_o": c_proj_w.T.reshape(d, H, Dh).contiguous(),
                "b_o": g(pre + "attn.c_proj.bias"),
            },
            "mlp": {
                "w_in": g(pre + "mlp.c_fc.weight").T.contiguous(),  # [d_mlp, d]
                "b_in": g(pre + "mlp.c_fc.bias"),
                "w_out": g(pre + "mlp.c_proj.weight").T.contiguous(),  # [d, d_mlp]
                "b_out": g(pre + "mlp.c_proj.bias"),
            },
        })
    return params


def load_model(model_name: str, dtype=torch.float32, device=None):
    """``(cfg, params)`` for a model name or a local checkpoint folder (a
    name without ``/`` is looked up under its canonical hub name, which
    needs the local HF cache or the network)."""
    import transformers

    device = resolve_device(device)
    name = model_name if "/" in model_name else _canonical_hf_name(model_name)
    hf = transformers.AutoModelForCausalLM.from_pretrained(name)
    return config_from_hf(hf.config), params_from_hf(hf, dtype, device)


def _canonical_hf_name(model_name: str) -> str:
    if model_name.startswith("pythia"):
        return f"EleutherAI/{model_name}"
    return model_name
