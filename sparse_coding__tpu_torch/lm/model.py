"""Hook-capable decoder-only transformer (the "subject LM"), in PyTorch.

Counterpart of `sparse_coding__tpu/lm/model.py`: the same config registry,
hook names, param layout and numerics, so a JAX param tree carried across
(`interop.lm_params_from_jax`) gives the same activations at every hook point.
Two architectures: GPT-NeoX (the Pythia family; parallel residual, partial
rotary) and GPT-2 (learned positions, tied unembedding).

Params are a plain tree of tensors (dicts and a list of blocks), in the JAX
layout: ``w_qkv [3, H, Dh, d]``, ``w_o [d, H, Dh]``, ``w_in [d_mlp, d]``,
``w_out [d, d_mlp]``. `forward` is a function of that tree, as in JAX.

Numerics kept from the JAX package (and not from HF's torch modules):
  - both architectures run the tanh GELU (`jax.nn.gelu` defaults to
    ``approximate=True``; HF's GPT-NeoX uses the exact one);
  - layer norm divides by the population variance (ddof 0);
  - attention scores are a product in the compute dtype, then scaled, masked
    with -1e30 and softmaxed in f32, and the probabilities cast back to the
    compute dtype before the ``v`` product.

Attention is dense unless ``attn_impl`` says otherwise
(`lm.ring_attention.blockwise_attention`, the single-card long-context
recurrence, or its ring and Ulysses attentions over a mesh axis);
`positions` are the global positions of a sequence-parallel shard.

Hook names (transformer_lens-compatible, as in JAX):
  blocks.{i}.hook_resid_post       residual after block i          ("residual")
  blocks.{i}.mlp.hook_post         MLP hidden post-activation      ("mlp")
  blocks.{i}.hook_mlp_out          MLP output in residual basis    ("mlpout")
  blocks.{i}.attn.hook_z           per-head attn out, flattened    ("attn")
  hook_embed, blocks.{i}.attn.hook_{q,k,v,pattern}, blocks.{i}.hook_attn_out,
  blocks.{i}.hook_resid_mid, blocks.{i}.mlp.hook_pre.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.tree import tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch: str  # "neox" | "gpt2"
    n_layers: int
    d_model: int
    n_heads: int
    d_mlp: int
    vocab_size: int
    n_ctx: int = 2048
    rotary_pct: float = 0.25  # neox
    rotary_base: float = 10000.0
    parallel_residual: bool = True  # neox (Pythia uses parallel residual)
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False  # gpt2 ties; pythia does not

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


# -- model registry (offline metadata for the reference's model names) --------

_PYTHIA = {
    # name: (n_layers, d_model, n_heads)
    "pythia-14m": (6, 128, 4),
    "pythia-70m": (6, 512, 8),
    "pythia-160m": (12, 768, 12),
    "pythia-410m": (24, 1024, 16),
    "pythia-1b": (16, 2048, 8),
    "pythia-1.4b": (24, 2048, 16),
    "pythia-2.8b": (32, 2560, 32),
    "pythia-6.9b": (32, 4096, 32),
}
_GPT2 = {
    "gpt2": (12, 768, 12),
    "gpt2-medium": (24, 1024, 16),
    "gpt2-large": (36, 1280, 20),
    "gpt2-xl": (48, 1600, 25),
}


def config_for(model_name: str) -> LMConfig:
    """Offline LMConfig for the model names the reference uses (pythia-*,
    optionally '-deduped' and EleutherAI/-prefixed; the gpt2 family)."""
    name = model_name.split("/")[-1].replace("-deduped", "")
    if name in _PYTHIA:
        L, d, h = _PYTHIA[name]
        return LMConfig(arch="neox", n_layers=L, d_model=d, n_heads=h, d_mlp=4 * d, vocab_size=50304,
                        n_ctx=2048, rotary_pct=0.25, parallel_residual=True)
    if name in _GPT2:
        L, d, h = _GPT2[name]
        return LMConfig(arch="gpt2", n_layers=L, d_model=d, n_heads=h, d_mlp=4 * d, vocab_size=50257,
                        n_ctx=1024, tie_word_embeddings=True)
    raise ValueError(f"Unknown model name: {model_name}")


def get_activation_size(model_name_or_cfg, layer_loc: str, seq_len: Optional[int] = None) -> int:
    """Width of a registered hook location. ``"pattern"`` rows are as wide
    as the harvested sequence, so they need ``seq_len``; an unregistered
    location raises (the harvest sizes those by a probe on the meta device)."""
    cfg = model_name_or_cfg if isinstance(model_name_or_cfg, LMConfig) else config_for(model_name_or_cfg)
    if layer_loc in ("residual", "mlpout", "attn_out", "resid_mid"):
        return cfg.d_model
    if layer_loc in ("mlp", "mlp_pre"):
        return cfg.d_mlp
    if layer_loc in ("attn", "attn_q", "attn_k", "attn_v"):
        return cfg.n_heads * cfg.d_head
    if layer_loc == "pattern" and seq_len is not None:
        return seq_len
    raise ValueError(f"Layer location {layer_loc} has no registered size; harvest sizes "
                     "unregistered qualified names by a probe on the meta device")


# every per-block hook point `forward` emits, by shorthand (the JAX package's)
HOOK_TEMPLATES = {
    "residual": "blocks.{layer}.hook_resid_post",
    "mlp": "blocks.{layer}.mlp.hook_post",
    "mlpout": "blocks.{layer}.hook_mlp_out",
    "attn": "blocks.{layer}.attn.hook_z",
    "mlp_pre": "blocks.{layer}.mlp.hook_pre",
    "attn_out": "blocks.{layer}.hook_attn_out",
    "attn_q": "blocks.{layer}.attn.hook_q",
    "attn_k": "blocks.{layer}.attn.hook_k",
    "attn_v": "blocks.{layer}.attn.hook_v",
    "pattern": "blocks.{layer}.attn.hook_pattern",
    "resid_mid": "blocks.{layer}.hook_resid_mid",
}


def make_tensor_name(layer: int, layer_loc: str) -> str:
    """A shorthand from `HOOK_TEMPLATES`, a template containing ``{layer}``,
    or a fully-qualified hook name (used as it is)."""
    if layer_loc in HOOK_TEMPLATES:
        return HOOK_TEMPLATES[layer_loc].format(layer=layer)
    if "{layer}" in layer_loc:
        return layer_loc.format(layer=layer)
    if layer_loc.startswith(("blocks.", "hook_")):
        return layer_loc
    raise ValueError(f"Layer location {layer_loc} not supported")


# -- init ---------------------------------------------------------------------

def init_params(generator, cfg: LMConfig, dtype=torch.float32, device=None) -> Pytree:
    """Random-init params, N(0, 0.02²) weights, unit norms, zero biases (real
    weights come from `lm.convert.params_from_hf`). ``generator``: a
    `torch.Generator` on ``device``, or an int seed. The draws are the
    port's own, not JAX's PRNG stream. On the ``meta`` device nothing is
    drawn (shape probes)."""
    device = resolve_device(device)
    if device.type == "meta":
        generator = None
    elif not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    scale = 0.02

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def norm():
        return {"w": torch.ones((cfg.d_model,), dtype=dtype, device=device), "b": zeros(cfg.d_model)}

    H, Dh, d = cfg.n_heads, cfg.d_head, cfg.d_model
    params: Dict[str, Any] = {"embed": normal(cfg.vocab_size, d), "ln_f": norm(), "blocks": []}
    if cfg.arch == "gpt2":
        params["pos_embed"] = normal(cfg.n_ctx, d)
    if not cfg.tie_word_embeddings:
        params["unembed"] = normal(cfg.vocab_size, d)
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1": norm(),
            "ln2": norm(),
            "attn": {"w_qkv": normal(3, H, Dh, d), "b_qkv": zeros(3, H, Dh), "w_o": normal(d, H, Dh),
                     "b_o": zeros(d)},
            "mlp": {"w_in": normal(cfg.d_mlp, d), "b_in": zeros(cfg.d_mlp), "w_out": normal(d, cfg.d_mlp),
                    "b_out": zeros(d)},
        })
    return params


def tree_leaves(tree: Pytree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree's tensors by dotted path (``blocks.0.attn.w_qkv``), in
    insertion order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(tree_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def cast_params(params: Pytree, dtype) -> Pytree:
    """The floating leaves of a param tree cast to ``dtype`` (None: as they are)."""
    if dtype is None:
        return params
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


# -- building blocks ----------------------------------------------------------

def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * p["w"] + p["b"]


def _rope(x: torch.Tensor, positions: torch.Tensor, rotary_dims: int, base: float) -> torch.Tensor:
    """Rotary embedding on the first ``rotary_dims`` of the head dim (NeoX
    style: rotate-half pairing). The angles are f32; a bf16 ``x`` is promoted
    to f32 by the products and cast back, as in JAX."""
    if rotary_dims == 0:
        return x
    rot, rest = x[..., :rotary_dims], x[..., rotary_dims:]
    half = rotary_dims // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) * 2.0 / rotary_dims)
    angles = positions[:, None].to(torch.float32) * freqs[None, :]  # [S, half]
    cos = torch.cos(angles)[None, :, None, :]  # [1, S, 1, half]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = rot[..., :half], rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([rotated, rest], dim=-1)


def dense_attention(q, k, v, causal: bool = True, pattern_cb: Optional[Callable] = None):
    """``[B, S, H, Dh]`` attention with an f32 softmax. ``pattern_cb``
    intercepts (and may replace) the ``[B, H, Q, K]`` probabilities."""
    # 1 / sqrt(Dh) rounded in f32 as jnp computes it (exact in a python float)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        S, K = scores.shape[-2], scores.shape[-1]
        mask = torch.tril(torch.ones((S, K), dtype=torch.bool, device=q.device))
        scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if pattern_cb is not None:
        probs = pattern_cb(probs)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _gelu_new(x):
    """GPT-2's tanh-approximated GELU, written out as the JAX package does."""
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))


def _gelu_tanh(x):
    """`jax.nn.gelu` at its default ``approximate=True`` (the NeoX MLP's)."""
    return F.gelu(x, approximate="tanh")


def attention_block(p, x_normed, cfg: LMConfig, attn_impl: Callable = dense_attention,
                    positions: Optional[torch.Tensor] = None, hook: Optional[Callable] = None,
                    pattern_needed: bool = False):
    """``(attn_out [B, S, d], z [B, S, H·Dh])``. ``positions`` are global
    token positions; ``hook(suffix, tensor)`` intercepts ``attn.hook_{q,k,v}``
    (post-rotary, flattened) and, with ``pattern_needed``,
    ``attn.hook_pattern`` (dense attention only: another ``attn_impl`` never
    materializes the ``[B, H, Q, K]`` pattern, so asking for it raises)."""
    qkv = torch.einsum("thdm,bsm->tbshd", p["w_qkv"], x_normed) + p["b_qkv"][:, None, None]
    q, k, v = qkv[0], qkv[1], qkv[2]
    if cfg.arch == "neox":
        rotary_dims = int(cfg.rotary_pct * cfg.d_head)
        if positions is None:
            positions = torch.arange(x_normed.shape[1], device=x_normed.device)
        q = _rope(q, positions, rotary_dims, cfg.rotary_base)
        k = _rope(k, positions, rotary_dims, cfg.rotary_base)
    if hook is not None:
        def flat(t):
            return t.reshape(*t.shape[:2], -1)

        q = hook("attn.hook_q", flat(q)).reshape(q.shape)
        k = hook("attn.hook_k", flat(k)).reshape(k.shape)
        v = hook("attn.hook_v", flat(v)).reshape(v.shape)
    if pattern_needed:
        if attn_impl is not dense_attention:
            raise ValueError("hook_pattern needs dense attention — the blockwise and sequence-parallel "
                             "impls never materialize the full [B,H,Q,K] pattern")
        z = dense_attention(q, k, v, pattern_cb=lambda pr: hook("attn.hook_pattern", pr))
    else:
        z = attn_impl(q, k, v)  # [B, S, H, Dh]
    z_flat = z.reshape(*z.shape[:2], -1)
    out = torch.einsum("mhd,bshd->bsm", p["w_o"], z) + p["b_o"]
    return out, z_flat


def mlp_act(cfg: LMConfig) -> Callable:
    """The arch → MLP nonlinearity mapping: tanh GELU for both, as JAX."""
    return _gelu_new if cfg.arch == "gpt2" else _gelu_tanh


def mlp_pre(p, x_normed):
    """MLP hidden pre-activation ("mlp_pre" hook point)."""
    return torch.einsum("fm,bsm->bsf", p["w_in"], x_normed) + p["b_in"]


def mlp_hidden(p, x_normed, cfg: LMConfig):
    """MLP hidden post-activation ("mlp" hook point)."""
    return mlp_act(cfg)(mlp_pre(p, x_normed))


# -- forward with hooks -------------------------------------------------------

HookFn = Callable[[torch.Tensor], torch.Tensor]


def forward(
    params: Pytree,
    tokens: torch.Tensor,
    cfg: LMConfig,
    hooks: Optional[Dict[str, HookFn]] = None,
    cache_names: Optional[Sequence[str]] = None,
    stop_at_layer: Optional[int] = None,
    attn_impl: Optional[Callable] = None,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """Run the model on int token ids ``[B, S]``. Returns (logits, or the
    residual at ``stop_at_layer``, cache). ``hooks[name]`` replaces the
    tensor at hook point ``name``; ``cache_names`` lists the points to
    capture; ``stop_at_layer=n`` runs blocks ``[0, n)``; ``attn_impl``
    (None: `dense_attention`) computes each block's attention."""
    attn_impl = dense_attention if attn_impl is None else attn_impl
    hooks = hooks or {}
    want = set(cache_names or [])
    cache: Dict[str, torch.Tensor] = {}
    needed = hooks.keys() | want

    def at_hook(name: str, tensor: torch.Tensor) -> torch.Tensor:
        if name in hooks:
            tensor = hooks[name](tensor)
        if name in want:
            cache[name] = tensor
        return tensor

    x = at_hook("hook_embed", F.embedding(tokens, params["embed"]))
    if cfg.arch == "gpt2":
        pos = positions if positions is not None else torch.arange(tokens.shape[1], device=tokens.device)
        x = x + params["pos_embed"][pos][None]

    n_blocks = cfg.n_layers if stop_at_layer is None else min(stop_at_layer, cfg.n_layers)
    parallel = cfg.arch == "neox" and cfg.parallel_residual
    for i in range(n_blocks):
        p = params["blocks"][i]
        pfx = f"blocks.{i}"
        attn_out, z = attention_block(
            p["attn"], layer_norm(x, p["ln1"], cfg.layer_norm_eps), cfg, attn_impl, positions,
            hook=lambda sfx, t, _pfx=pfx: at_hook(f"{_pfx}.{sfx}", t),
            pattern_needed=f"{pfx}.attn.hook_pattern" in needed,
        )
        z = at_hook(f"{pfx}.attn.hook_z", z)
        attn_out = at_hook(f"{pfx}.hook_attn_out", attn_out)
        if not parallel:  # serial (gpt2, non-parallel neox): attn lands first
            x = at_hook(f"{pfx}.hook_resid_mid", x + attn_out)
        pre = mlp_pre(p["mlp"], layer_norm(x, p["ln2"], cfg.layer_norm_eps))
        pre = at_hook(f"{pfx}.mlp.hook_pre", pre)
        h = at_hook(f"{pfx}.mlp.hook_post", mlp_act(cfg)(pre))
        mlp_out = torch.einsum("mf,bsf->bsm", p["mlp"]["w_out"], h) + p["mlp"]["b_out"]
        mlp_out = at_hook(f"{pfx}.hook_mlp_out", mlp_out)
        x = x + attn_out + mlp_out if parallel else x + mlp_out
        x = at_hook(f"{pfx}.hook_resid_post", x)

    if stop_at_layer is not None:
        return x, cache

    x = layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    unembed = params["embed"] if cfg.tie_word_embeddings else params["unembed"]
    logits = torch.einsum("vm,bsm->bsv", unembed, x)
    return logits, cache


def run_with_cache(params, tokens, cfg, names: Sequence[str], stop_at_layer: Optional[int] = None,
                   attn_impl: Optional[Callable] = None):
    """transformer_lens-style capture: (output, {name: tensor})."""
    return forward(params, tokens, cfg, cache_names=names, stop_at_layer=stop_at_layer, attn_impl=attn_impl)


def run_with_hooks(params, tokens, cfg, hooks: Dict[str, HookFn], attn_impl: Optional[Callable] = None):
    """transformer_lens-style intervention: the logits with ``hooks`` applied."""
    logits, _ = forward(params, tokens, cfg, hooks=hooks, attn_impl=attn_impl)
    return logits


def lm_loss(params, tokens, cfg: LMConfig, attn_impl: Optional[Callable] = None) -> torch.Tensor:
    """Mean next-token cross-entropy, the log-softmax in f32."""
    logits, _ = forward(params, tokens, cfg, attn_impl=attn_impl)
    logprobs = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    targets = tokens[:, 1:].long()
    ll = torch.gather(logprobs, -1, targets[..., None])[..., 0]
    return -ll.mean()
