"""Structured synthetic token corpus: a hashed sparse-trigram language.

A copy of `sparse_coding__tpu/data/synthetic_text.py` (numpy only): the same
seed gives the same language and the same corpus, bit for bit, in both
packages. No weights or text can be downloaded, so subject LMs are
pretrained on this language (`lm.pretrain`) and harvested on held-out
samples of it:

  - a Zipfian unigram marginal over a shuffled vocabulary;
  - a deterministic hashed trigram transition table: context (a, b) hashes
    to one of `n_ctx_slots` slots, each with `k_succ` successors and
    Dirichlet-like weights, so the entropy per token is at most log(k_succ)
    nats, far below the uniform log(vocab).

Sampling is vectorized across rows (one categorical draw per position over
all rows at once).
"""

from __future__ import annotations

import numpy as np

_P1, _P2 = 1_000_003, 998_244_353  # context-hash multipliers (coprime, large)


class TrigramLanguage:
    """A fixed synthetic language over `vocab_size` tokens."""

    def __init__(
        self,
        vocab_size: int,
        n_ctx_slots: int = 65_536,
        k_succ: int = 8,
        zipf_a: float = 1.1,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.vocab_size = int(vocab_size)
        self.n_ctx_slots = int(n_ctx_slots)
        self.k_succ = int(k_succ)
        # Zipfian marginal over a shuffled vocab (rank != token id)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._marginal = p / p.sum()
        self._perm = rng.permutation(vocab_size)
        # per-slot successor sets drawn FROM the marginal (frequent tokens
        # appear in many contexts, like real text) + Dirichlet weights
        self.succ = self._perm[
            _sample_categorical(rng, self._marginal, (n_ctx_slots, k_succ))
        ].astype(np.int32)
        w = rng.gamma(0.5, size=(n_ctx_slots, k_succ))
        self.succ_cum = np.cumsum(w / w.sum(axis=1, keepdims=True), axis=1)
        # float cumsum can end below 1.0; a uniform draw in that gap would
        # index past k_succ (same guard as _sample_categorical)
        self.succ_cum[:, -1] = 1.0

    def _slot(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (a.astype(np.int64) * _P1 + b.astype(np.int64) * _P2) % self.n_ctx_slots

    def sample(self, n_rows: int, seq_len: int, seed: int = 1) -> np.ndarray:
        """`[n_rows, seq_len]` int32 token rows. Vectorized across rows."""
        rng = np.random.default_rng(seed)
        out = np.empty((n_rows, seq_len), np.int32)
        out[:, 0] = self._perm[_sample_categorical(rng, self._marginal, (n_rows,))]
        out[:, 1] = self._perm[_sample_categorical(rng, self._marginal, (n_rows,))]
        for t in range(2, seq_len):
            slot = self._slot(out[:, t - 2], out[:, t - 1])
            u = rng.random(n_rows)
            idx = (u[:, None] > self.succ_cum[slot]).sum(axis=1)
            out[:, t] = self.succ[slot, idx]
        return out

    @property
    def per_token_entropy_bound(self) -> float:
        """Upper bound on achievable next-token loss (nats): log(k_succ)."""
        return float(np.log(self.k_succ))


def _sample_categorical(rng, p: np.ndarray, shape) -> np.ndarray:
    """Vectorized draws from a single categorical `p` (searchsorted on cdf)."""
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    return np.searchsorted(cdf, rng.random(shape)).astype(np.int64)
