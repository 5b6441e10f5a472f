"""Long-context attention for the subject LM: the blockwise (flash-style)
recurrence on one card.

Counterpart of `sparse_coding__tpu/lm/ring_attention.py`. `blockwise_attention`
is ported; the sequence-parallel strategies of that module (`ring_attention`,
`ulysses_attention`, `make_sequence_parallel_fn`, `sequence_parallel_forward`)
shard the sequence over a mesh and wait for the multi-card port (ROADMAP
A6b): they raise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


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
        # 1 / sqrt(Dh) rounded in f32 as jnp computes it
        scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))
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


def _refuse(what: str):
    raise NotImplementedError(f"{what} shards the sequence over a mesh and is not ported yet — ROADMAP A6b; "
                              "use blockwise_attention() on one card")


def ring_attention(axis_name: str) -> Callable:
    """Ring attention over a mesh axis: not ported yet (ROADMAP A6b)."""
    _refuse("ring_attention")


def ulysses_attention(axis_name: str) -> Callable:
    """All-to-all (Ulysses) attention over a mesh axis: not ported yet (ROADMAP A6b)."""
    _refuse("ulysses_attention")


def make_sequence_parallel_fn(*args, **kwargs) -> Callable:
    """The sequence-sharded forward: not ported yet (ROADMAP A6b)."""
    _refuse("make_sequence_parallel_fn")


def sequence_parallel_forward(*args, **kwargs):
    """The sequence-sharded forward: not ported yet (ROADMAP A6b)."""
    _refuse("sequence_parallel_forward")
