"""Scripted equivalents of the reference's analysis notebooks.

Counterpart of `sparse_coding__tpu/experiments/case_studies.py`; each
analysis is a function over ``(LearnedDict, hyperparams)`` exports and the
subject LM:

  dict_compare            — Hungarian-matched MCS between two dictionaries
  dict_across_time        — each training save point matched against the
                            final dictionary
  inter_layer_mcs         — mean matched MCS between every pair of layers'
                            dictionaries
  inter_dict_connections  — the correlation matrix of two dicts' codes on
                            shared inputs, and the top connections
  feature_case_study      — one feature's top-activating fragments with
                            per-token activations and its top output-logit
                            tokens

The similarities, codes and the capture forwards run where the dicts and
params live (the card, unless they are on the CPU); the Hungarian matching
(scipy) and the correlations run on the host in float64, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.lm import model as lm_model
from sparse_coding__tpu_torch.metrics.standard import mmcs


def _as_matrix(d) -> torch.Tensor:
    return d.get_learned_dict() if hasattr(d, "get_learned_dict") else torch.as_tensor(d)


def _matched_sims(small: torch.Tensor, large: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Hungarian 1:1 matching of the smaller dict's atoms into the larger:
    ``(sims, assignment)``, both in small-atom order (``sims[k]`` is atom
    k's matched cosine, ``assignment[k]`` the large-dict atom it matched)."""
    from scipy.optimize import linear_sum_assignment

    cos = torch.einsum("sd,ld->sl", small, large).float().cpu().numpy()
    rows, cols = linear_sum_assignment(-cos)  # rows == arange(n_small), sorted
    return cos[rows, cols], cols


def _small_large(a: torch.Tensor, b: torch.Tensor):
    return (a, b) if a.shape[0] <= b.shape[0] else (b, a)


def dict_compare(dict_a, dict_b, threshold: float = 0.9) -> Dict[str, Any]:
    """Hungarian-matched comparison of two dictionaries: ``matched_sims`` /
    ``assignment`` in the smaller dict's atom order, the share and count
    above ``threshold`` ("shared features") and plain MMCS both ways."""
    a, b = _as_matrix(dict_a), _as_matrix(dict_b)
    sims, assignment = _matched_sims(*_small_large(a, b))
    return {
        "matched_sims": sims,
        "assignment": assignment,
        "frac_shared": float((sims > threshold).mean()),
        "n_shared": int((sims > threshold).sum()),
        "mmcs_a_to_b": float(mmcs(a, b)),
        "mmcs_b_to_a": float(mmcs(b, a)),
    }


def dict_across_time(save_points: Dict[int, Any], threshold: float = 0.9) -> List[Dict[str, Any]]:
    """Feature stability over training: each save point's dictionary matched
    against the final one, one row a save point."""
    if not save_points:
        return []
    final = _as_matrix(save_points[max(save_points)])
    rows = []
    for k in sorted(save_points):
        sims, _ = _matched_sims(*_small_large(_as_matrix(save_points[k]), final))
        rows.append({"save_point": k, "mean_matched_mcs": float(sims.mean()),
                     "frac_shared": float((sims > threshold).mean())})
    return rows


def inter_layer_mcs(dicts_by_layer: Dict[int, Any]) -> Tuple[np.ndarray, List[int]]:
    """Mean matched MCS between every pair of layers' dictionaries:
    ``(symmetric [L, L] float64 matrix, layer order)``."""
    layers = sorted(dicts_by_layer)
    mats = [_as_matrix(dicts_by_layer[l]) for l in layers]
    n = len(layers)
    out = np.eye(n, dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            sims, _ = _matched_sims(*_small_large(mats[i], mats[j]))
            out[i, j] = out[j, i] = float(sims.mean())
    return out, layers


def inter_dict_connections(dict_up, dict_down, acts_up, acts_down, top_k: int = 10,
                           eps: float = 1e-8) -> Dict[str, Any]:
    """Correlation of two dictionaries' feature activations on the same
    datapoints (``acts_up`` / ``acts_down``, row-aligned, at the two hook
    points): the ``[n_up, n_down]`` Pearson matrix (float64, on the host)
    and the ``top_k`` strongest ``(upstream, downstream, r)``."""
    if acts_up.shape[0] != acts_down.shape[0]:
        raise ValueError("row-aligned inputs required")
    with torch.inference_mode():
        cu = dict_up.encode(dict_up.center(acts_up)).cpu().numpy().astype(np.float64)
        cd = dict_down.encode(dict_down.center(acts_down)).cpu().numpy().astype(np.float64)
    cu = (cu - cu.mean(0)) / (cu.std(0) + eps)
    cd = (cd - cd.mean(0)) / (cd.std(0) + eps)
    corr = cu.T @ cd / cu.shape[0]
    flat = np.argsort(-np.abs(corr), axis=None)[:top_k]
    ups, downs = np.unravel_index(flat, corr.shape)
    return {"correlation": corr, "top_connections": [(int(u), int(d), float(corr[u, d])) for u, d in zip(ups, downs)]}


def feature_activations(params, lm_cfg, learned_dict, layer: int, layer_loc: str, fragments: np.ndarray,
                        feature: int, batch_size: int = 32) -> np.ndarray:
    """The device half of `feature_case_study`: one feature's per-token
    activations ``[n_fragments, fragment_len]`` (encode ∘ center of the
    hook point's capture), on the device of the params. The fragments are
    padded with zero rows to whole batches; one host read."""
    if not 0 <= feature < learned_dict.n_feats:
        raise ValueError(f"feature {feature} out of range for a {learned_dict.n_feats}-feature dict")
    name = lm_model.make_tensor_name(layer, layer_loc)
    device = params["embed"].device
    n_frags, frag_len = fragments.shape
    tokens = torch.as_tensor(np.asarray(fragments)).to(device)
    pad = (-n_frags) % batch_size
    if pad:
        tokens = torch.cat([tokens, torch.zeros((pad, frag_len), dtype=tokens.dtype, device=device)])
    parts = []
    with torch.inference_mode():
        for start in range(0, tokens.shape[0], batch_size):
            _, cache = lm_model.forward(params, tokens[start:start + batch_size], lm_cfg, cache_names=[name],
                                        stop_at_layer=layer + 1)
            acts = cache[name]
            B, L, C = acts.shape
            c = learned_dict.encode(learned_dict.center(acts.reshape(B * L, C)))
            parts.append(c.reshape(B, L, -1)[:, :, feature])
        return torch.cat(parts)[:n_frags].float().cpu().numpy()


def feature_case_study(
    params,
    lm_cfg,
    learned_dict,
    layer: int,
    layer_loc: str,
    fragments: np.ndarray,
    decode_tokens: Callable[[Sequence[int]], List[str]],
    feature: int,
    n_top_fragments: int = 5,
    n_top_logits: int = 10,
    batch_size: int = 32,
) -> Dict[str, Any]:
    """One feature's story: the top-activating fragments with per-token
    activations (`feature_activations`), and for residual-stream dicts the
    feature direction's top output-logit tokens (direction @ unembed; the
    embedding for tied-embedding models). Returns ``{"fragments": [(tokens,
    activations), ...], "top_logit_tokens": [(token_id, logit), ...] or
    None}``."""
    per_tok = feature_activations(params, lm_cfg, learned_dict, layer, layer_loc, fragments, feature, batch_size)
    order = np.argsort(-per_tok.max(axis=1))[:n_top_fragments]
    frags = [(decode_tokens(fragments[i]), [float(a) for a in per_tok[i]]) for i in order]

    top_logits: Optional[List[Tuple[int, float]]] = None
    if layer_loc == "residual":
        unembed = params.get("embed") if getattr(lm_cfg, "tie_word_embeddings", False) else params.get("unembed")
        if unembed is not None:
            direction = learned_dict.get_learned_dict()[feature]
            with torch.inference_mode():
                logits = (unembed @ direction.to(unembed.dtype)).float().cpu().numpy()
            top_ids = np.argsort(-logits)[:n_top_logits]
            top_logits = [(int(t), float(logits[t])) for t in top_ids]
    return {"fragments": frags, "top_logit_tokens": top_logits}


def render_case_study(study: Dict[str, Any], decode_token: Optional[Callable[[int], str]] = None) -> str:
    """Plain-text rendering of a `feature_case_study`: tokens annotated with
    their activations where above a tenth of the fragment's peak."""
    lines = []
    for toks, acts in study["fragments"]:
        peak = max(acts) or 1.0
        lines.append(" ".join(f"[{t}|{a:.1f}]" if a > 0.1 * peak else t for t, a in zip(toks, acts)))
    if study["top_logit_tokens"]:
        shown = [decode_token(t) if decode_token else str(t) for t, _ in study["top_logit_tokens"]]
        lines.append("top output tokens: " + ", ".join(shown))
    return "\n".join(lines)
