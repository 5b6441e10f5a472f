"""Long-context attention for the subject LM: the blockwise (flash-style)
recurrence on one card, and exact sequence-parallel attention over a mesh
axis, ring and all-to-all.

Counterpart of `sparse_coding__tpu/lm/ring_attention.py`, with its names and
arithmetic. Every strategy is exactly dense causal attention:

  `blockwise_attention` — one card; an online softmax over KV blocks keeps
  one score tile live.

  `ring_attention` — each rank holds a ``[B, S/p, H, Dh]`` block of Q/K/V;
  the K/V blocks go round the ring (`parallel.mesh.Mesh.ring_shift`, JAX's
  ``ppermute``) while each rank accumulates its queries' attention with the
  same online softmax. Memory stays O(S/p) a rank.

  `ulysses_attention` — DeepSpeed-Ulysses: one all-to-all swaps the sequence
  shard for a head shard (Q/K/V stacked into one exchange), each rank runs
  dense attention over the FULL sequence for H/p heads, and a second
  all-to-all swaps back. Needs ``n_heads % p == 0``.

A torch rank has no ``axis_index`` to read, so the two sequence-parallel
attentions take the mesh (`parallel.make_mesh`) explicitly:
``ring_attention("data", mesh=mesh)``, or bound once in
`make_sequence_parallel_fn(cfg, mesh, "data", attn="ring")`, which runs the
LM forward on this rank's slice of the sequence at its global positions.
Every rank holds the same tokens and gets back its own shard of the output
and of every cache entry (``[B, S/p, ...]``): JAX's "born distributed"
layout, held by the rank. These steps hold collectives, so they run eagerly
(never in a CUDA graph).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparse_coding__tpu_torch.lm import model as lm_model


def blockwise_attention(q_block: int = 512, kv_block: int = 512) -> Callable:
    """Single-card long-context attention: an online softmax over KV blocks
    with f32 ``m`` / ``l`` / ``o`` accumulators, the JAX package's
    recurrence term for term.

    Dense attention materializes the ``[B, H, S, S]`` scores; this keeps one
    ``[B, H, q_block, kv_block]`` score tile live: the q blocks are taken one
    at a time (JAX's ``lax.map``), and for each the KV blocks in order (its
    ``lax.scan``). The sequence is padded up to a block multiple and masked
    by absolute position, so padded keys are never attended. Under causal
    masking a KV block wholly after the q block is skipped: its scores are
    all masked, so JAX's step leaves ``m``, ``l`` and ``o`` as they are
    (``alpha`` 1, ``probs`` 0), and skipping it gives the same values.

    Returns an ``attn_impl(q, k, v, causal=True)`` for `lm.model.forward`,
    on ``[B, S, H, Dh]`` tensors."""

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
        B, S, H, Dh = q.shape
        qb, kb = min(q_block, S), min(kv_block, S)
        pad_q, pad_k = (-S) % qb, (-S) % kb
        scale = _f32_scale(Dh)
        qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        nq, nk = qp.shape[1] // qb, kp.shape[1] // kb
        out = torch.empty((B, nq * qb, H, Dh), dtype=q.dtype, device=q.device)
        q_ar = torch.arange(qb, device=q.device)
        k_ar = torch.arange(kb, device=q.device)
        for qi in range(nq):
            qblk = qp[:, qi * qb:(qi + 1) * qb]
            q_pos = qi * qb + q_ar
            m = torch.full((B, H, qb), -torch.inf, dtype=torch.float32, device=q.device)
            l = torch.zeros((B, H, qb), dtype=torch.float32, device=q.device)
            o = torch.zeros((B, qb, H, Dh), dtype=torch.float32, device=q.device)
            # causal: the last KV block holding a key at or before this q block's last row
            last = min(nk, ((qi + 1) * qb - 1) // kb + 1) if causal else nk
            for ki in range(last):
                kblk, vblk = kp[:, ki * kb:(ki + 1) * kb], vp[:, ki * kb:(ki + 1) * kb]
                k_pos = ki * kb + k_ar
                scores = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).to(torch.float32) * scale
                mask = (k_pos < S)[None, :]  # padded keys never attended
                if causal:
                    mask = mask & (q_pos[:, None] >= k_pos[None, :])
                scores = torch.where(mask[None, None], scores, -torch.inf)
                m_new = torch.maximum(m, scores.amax(dim=-1))
                # a row with every key so far masked: exp(-inf - -inf) would be NaN
                m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -torch.inf))
                probs = torch.exp(scores - m_safe[..., None])
                l = l * alpha + probs.sum(dim=-1)
                o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
                    "bhqk,bkhd->bqhd", probs, vblk.to(torch.float32))
                m = m_new
            l_safe = torch.clamp_min(l, 1e-30)
            out[:, qi * qb:(qi + 1) * qb] = (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
        return out[:, :S]

    return attn



def _f32_scale(dh: int) -> float:
    """``1 / sqrt(Dh)`` rounded in f32 as jnp computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _axis(mesh, axis_name: str, what: str) -> Tuple[int, int]:
    """(this rank's index along the axis, the axis' size)."""
    if mesh is None:
        raise ValueError(f"{what} runs over a mesh axis: pass mesh= (parallel.make_mesh), or build it through "
                         "make_sequence_parallel_fn(cfg, mesh, ...)")
    return int(mesh.coords[axis_name]), int(mesh.shape[axis_name])


def ring_attention(axis_name: str, mesh=None) -> Callable:
    """An ``attn_impl(q, k, v, causal=True)`` running ring attention over
    ``mesh``'s axis ``axis_name``, on this rank's ``[B, S/p, H, Dh]``
    sequence block.

    JAX's step term for term: f32 ``m`` / ``l`` / ``o`` accumulators, the
    masked-row guard ``m_safe``, ``l_safe = max(l, 1e-30)``, K/V shifted to
    the next rank after each of the first p − 1 steps, step t holding block
    ``(idx − t) mod p`` and the causal mask taken by global position. A
    block wholly after this rank's queries leaves ``m``, ``l`` and ``o`` as
    they are in JAX's step (``alpha`` 1, ``probs`` 0): its arithmetic is
    skipped, its shift is not."""
    idx, p = _axis(mesh, axis_name, "ring_attention")

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
        B, S_local, H, Dh = q.shape
        scale = _f32_scale(Dh)
        ar = torch.arange(S_local, device=q.device)
        q_pos = idx * S_local + ar
        m = torch.full((B, H, S_local), -torch.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, S_local), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, S_local, H, Dh), dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])  # one exchange a step shifts both
        for t in range(p):
            blk_idx = (idx - t) % p
            if not (causal and blk_idx > idx):
                k_blk, v_blk = kv[0], kv[1]
                k_pos = blk_idx * S_local + ar
                scores = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).to(torch.float32) * scale
                if causal:
                    mask = q_pos[:, None] >= k_pos[None, :]
                    scores = torch.where(mask[None, None], scores, -torch.inf)
                m_new = torch.maximum(m, scores.amax(dim=-1))
                # a row with every key so far masked: exp(-inf - -inf) would be NaN
                m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -torch.inf))
                probs = torch.exp(scores - m_safe[..., None])
                l = l * alpha + probs.sum(dim=-1)
                o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
                    "bhqk,bkhd->bqhd", probs, v_blk.to(torch.float32))
                m = m_new
            if t < p - 1:
                kv = mesh.ring_shift(kv, axis_name)
        l_safe = torch.clamp_min(l, 1e-30)
        return (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)

    return attn


def ulysses_attention(axis_name: str, mesh=None) -> Callable:
    """An ``attn_impl(q, k, v, causal=True)`` running all-to-all (Ulysses)
    sequence parallelism over ``mesh``'s axis ``axis_name``; needs
    ``H % p == 0``.

    Q/K/V arrive sequence-sharded ``[B, S/p, H, Dh]`` with rotary already
    applied at global positions, so after the head-scatter all-to-all the
    full-sequence blocks are the dense layout restricted to H/p heads, and
    `lm.model.dense_attention` runs on them."""
    _, p = _axis(mesh, axis_name, "ulysses_attention")

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
        B, S_local, H, Dh = q.shape
        if H % p != 0:
            raise ValueError(
                f"ulysses attention needs n_heads ({H}) divisible by the "
                f"sequence axis size ({p}); use ring attention instead"
            )
        # sequence shard -> head shard in ONE exchange: Q/K/V stacked, the
        # head axis split p ways, the full sequence gathered in axis order
        qg, kg, vg = mesh.all_to_all(torch.stack([q, k, v]), axis_name, split_dim=3, concat_dim=2)
        out = lm_model.dense_attention(qg, kg, vg, causal=causal)
        # head shard -> sequence shard
        return mesh.all_to_all(out.to(q.dtype), axis_name, split_dim=1, concat_dim=2)

    return attn


ATTN_IMPLS = {"ring": ring_attention, "ulysses": ulysses_attention}


def make_sequence_parallel_fn(
    cfg: lm_model.LMConfig,
    mesh,
    axis_name: str = "data",
    cache_names: Optional[Sequence[str]] = None,
    hooks: Optional[Dict[str, Callable]] = None,
    stop_at_layer: Optional[int] = None,
    attn: str = "ring",
) -> Callable:
    """Build once a reusable ``fn(params, tokens) -> (out, cache)`` running
    the sequence-sharded forward on this rank (``attn``: ``"ring"`` |
    ``"ulysses"``). Every rank of the axis calls it with the same ``[B, S]``
    tokens; each runs `lm.model.forward` on its ``[B, S/p]`` slice at global
    positions ``idx·S/p + arange(S/p)`` and returns its shard of the output
    and of every cache entry. Hooks run on the local shards."""
    cache_names = tuple(cache_names or ())
    if attn not in ATTN_IMPLS:
        raise ValueError(f"unknown attn {attn!r}, expected one of {sorted(ATTN_IMPLS)}")
    attn_impl = ATTN_IMPLS[attn](axis_name, mesh=mesh)
    idx, n_shards = _axis(mesh, axis_name, "make_sequence_parallel_fn")

    def fn(params, tokens: torch.Tensor):
        if tokens.shape[1] % n_shards != 0:
            raise ValueError(
                f"sequence length {tokens.shape[1]} not divisible by {n_shards} shards"
            )
        S_local = tokens.shape[1] // n_shards
        tok_shard = tokens[:, idx * S_local:(idx + 1) * S_local]
        positions = idx * S_local + torch.arange(S_local, device=tokens.device)
        return lm_model.forward(params, tok_shard, cfg, hooks=hooks, cache_names=cache_names,
                                stop_at_layer=stop_at_layer, attn_impl=attn_impl, positions=positions)

    return fn


def sequence_parallel_forward(
    params,
    tokens: torch.Tensor,
    cfg: lm_model.LMConfig,
    mesh,
    axis_name: str = "data",
    cache_names: Optional[Sequence[str]] = None,
    hooks: Optional[Dict[str, Callable]] = None,
    stop_at_layer: Optional[int] = None,
    attn: str = "ring",
):
    """One-shot `make_sequence_parallel_fn`: this rank's shard ``[B, S/p,
    ...]`` of the output and of every hook tensor. For repeated calls (a
    harvest loop), build the fn once."""
    fn = make_sequence_parallel_fn(cfg, mesh, axis_name, cache_names, hooks, stop_at_layer, attn)
    return fn(params, tokens)
