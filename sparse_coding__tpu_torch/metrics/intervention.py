"""Model-intervention metrics: run the subject LM with dictionary-mediated
edits at a hook point.

Counterpart of `sparse_coding__tpu/metrics/intervention.py`:
`cache_all_activations`, the feature-ablation graphs (positional and
non-positional), `perplexity_under_reconstruction` and
`calculate_perplexity` over ``(LearnedDict, hyperparams)`` lists.
Interventions are plain hook functions into `lm.model.forward`; everything
here runs under `torch.inference_mode()` on ``device`` (None = cuda; the
params live there, token rows are moved there).

Execution model:
  - a forward that only caches hook points stops after the last block it
    needs (`forward(stop_at_layer=)`; the cached tensors are the full
    forward's bits), as the JAX package's compiled forward drops what its
    outputs do not read;
  - an ablation sweep (one ablation site, many features) keeps the ablated
    feature's index in a device tensor, so no feature needs a host read:
    each feature's edited forward reduces straight to its row of edge
    weights in a device ``[F, n_targets]`` buffer, read once a site, and
    only the unedited codes are kept (never F activation caches). On CUDA
    tensors the edited forward and its reduction are one captured CUDA
    graph, replayed once a feature (the index and the row are read and
    written through a device counter); on CPU tensors the same function
    runs once a feature;
  - `calculate_perplexity` scores each dict alone and reads every dict's
    losses to the host at once, whatever ``vmapped`` says (the JAX package
    stacks like dicts into one vmapped forward instead).

A `Location` is ``(layer, layer_loc)`` with ``layer_loc`` one of
residual|mlp|mlpout|attn.
"""

from __future__ import annotations

from itertools import product
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.lm import model as lm_model
from sparse_coding__tpu_torch.utils.device import resolve_device

Location = Tuple[int, str]


def get_model_tensor_name(location: Location) -> str:
    return lm_model.make_tensor_name(location[0], location[1])


def _index(v, n: int, device) -> torch.Tensor:
    """A feature or position index into an axis of size ``n`` as a
    1-element long tensor, a negative one counted from the end as JAX
    indexing does: a device tensor stays one (no host read), an int becomes
    one."""
    if isinstance(v, torch.Tensor):
        v = v.reshape(1).long()
        return torch.where(v < 0, v + n, v)
    v = int(v)
    return torch.tensor([v + n if v < 0 else v], device=device)


def replace_with_reconstruction_hook(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """Hook: tensor [B, L, C] → the dict's reconstruction of it."""

    def hook(tensor: torch.Tensor) -> torch.Tensor:
        B, L, C = tensor.shape
        return model.predict(tensor.reshape(B * L, C)).reshape(B, L, C)

    return hook


def ablate_feature_intervention(model, feature: Tuple[int, int]) -> Callable:
    """Positional ablation: subtract feature ``idx``'s dictionary direction,
    scaled by its activation, at sequence position ``pos`` only.
    ``feature`` is ``(pos, idx)``: ints, or a device tensor [2]."""
    pos, idx = feature

    def hook(tensor: torch.Tensor) -> torch.Tensor:
        B, L, C = tensor.shape
        learned = model.get_learned_dict()
        p, i = _index(pos, L, tensor.device), _index(idx, learned.shape[0], tensor.device)
        acts = model.encode(tensor.reshape(B * L, C)).reshape(B, L, -1)
        direction = learned.index_select(0, i)
        delta = acts.index_select(1, p).index_select(2, i).reshape(B, 1) * direction
        # the JAX package's out-of-place `tensor.at[:, pos, :].add(-delta)`
        return tensor.index_copy(1, p, tensor.index_select(1, p) + (-delta)[:, None, :])

    return hook


def ablate_feature_intervention_non_positional(model, feature_idx: int) -> Callable:
    """Ablate feature ``feature_idx`` (an int or a device tensor) at every
    position."""

    def hook(tensor: torch.Tensor) -> torch.Tensor:
        B, L, C = tensor.shape
        learned = model.get_learned_dict()
        i = _index(feature_idx, learned.shape[0], tensor.device)
        acts = model.encode(tensor.reshape(B * L, C))
        ablation = acts.index_select(1, i) * learned.index_select(0, i)
        return tensor - ablation.reshape(B, L, C)

    return hook


def _encode_cache(models: Dict[Location, Any], cache: Dict[str, torch.Tensor]):
    out = {}
    for location, model in models.items():
        tensor = cache[get_model_tensor_name(location)]
        B, L, C = tensor.shape
        out[location] = model.encode(tensor.reshape(B * L, C)).reshape(B, L, -1)
    return out


def _stop_layer(names: Sequence[str]) -> int:
    """The blocks a forward must run to reach every hook point in ``names``
    (``hook_embed`` needs none)."""
    return max((int(n.split(".")[1]) + 1 if n.startswith("blocks.") else 0) for n in names)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens).to(device)


def _cache_forward(params, lm_cfg, tokens, names, hooks=None) -> Dict[str, torch.Tensor]:
    _, cache = lm_model.forward(params, tokens, lm_cfg, hooks=hooks, cache_names=list(names),
                                stop_at_layer=_stop_layer(names))
    return cache


def cache_all_activations(
    params,
    lm_cfg: lm_model.LMConfig,
    models: Dict[Location, Any],
    tokens,
    hooks: Optional[Dict[str, Callable]] = None,
    device=None,
) -> Dict[Location, torch.Tensor]:
    """Per-location dictionary codes over the token batch: ``{location: [B,
    L, n_feats]}``. ``hooks`` edits the forward first."""
    device = resolve_device(device)
    names = tuple(get_model_tensor_name(loc) for loc in models)
    with torch.inference_mode():
        cache = _cache_forward(params, lm_cfg, _tokens(tokens, device), names, hooks)
        return _encode_cache(models, cache)


def _read_feature_positional(acts, t):
    """acts [S, B, L, n], targets [T, 2] -> [S, B, T]."""
    return acts[:, :, t[:, 0], t[:, 1]]


def _read_feature_non_positional(acts, t):
    """acts [S, B, L, n], targets [T] -> [S, B, T] (L2 over positions)."""
    return torch.linalg.vector_norm(acts[:, :, :, t], dim=2)


def _edge_row(params, lm_cfg, tokens, models, location, names, target_arrs, base_reads, make_hook, read_feature):
    """``feature -> [n_targets]``: one feature's edited forward reduced to
    its row of edge weights (mean |Δ| of each target's read)."""
    hook_name = get_model_tensor_name(location)

    def row(feature):
        cache = _cache_forward(params, lm_cfg, tokens, names, {hook_name: make_hook(models[location], feature)})
        weights = []
        for loc_, t in target_arrs.items():
            tensor = cache[get_model_tensor_name(loc_)]
            B, L, C = tensor.shape
            acts = models[loc_].encode(tensor.reshape(B * L, C)).reshape(B, L, -1)
            diff = torch.abs(base_reads[loc_] - read_feature(acts[None], t))[0]
            weights.append(diff.mean(dim=tuple(range(diff.ndim - 1))))
        return torch.cat(weights)

    return row


def _sweep(row, feats: torch.Tensor, n_targets: int) -> torch.Tensor:
    """Every feature's row [F, n_targets], on the features' device. CUDA: the
    first feature runs eagerly on a side stream (it also warms what capture
    must not meet), then one captured graph of ``row`` reads its feature and
    writes its row through a device counter and is replayed for the rest.
    CPU: ``row`` once a feature."""
    F = feats.shape[0]
    out = torch.empty((F, n_targets), dtype=torch.float32, device=feats.device)
    if not feats.is_cuda:
        for k in range(F):
            out[k] = row(feats[k])
        return out
    counter = torch.zeros(1, dtype=torch.long, device=feats.device)
    main = torch.cuda.current_stream(feats.device)
    side = torch.cuda.Stream(feats.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out.index_copy_(0, counter, row(feats.index_select(0, counter)[0])[None])
        counter.fill_(1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out.index_copy_(0, counter, row(feats.index_select(0, counter)[0])[None])
            counter.add_(1)
    main.wait_stream(side)
    for _ in range(1, F):
        graph.replay()
    return out


def _graph_from_ablations(
    base_acts, models, params, lm_cfg, tokens, features_to_ablate, all_features,
    make_hook, read_feature,
):
    """Per ablation location, one sweep over its features (`_sweep`), read
    to the host once; the edge dict in the JAX package's key order, self
    edges left out."""
    names = tuple(get_model_tensor_name(loc) for loc in models)
    locs = tuple(models.keys())
    unknown = {l for (l, _) in all_features} - set(locs)
    if unknown:
        raise ValueError(
            f"feature locations {sorted(unknown)} have no dict in `models` "
            f"(locations: {sorted(locs)})"
        )
    targets_by_loc = {loc: [f for (l, f) in all_features if l == loc] for loc in locs}
    target_arrs = {loc: torch.as_tensor(t, device=tokens.device) for loc, t in targets_by_loc.items() if t}
    base_reads = {loc: read_feature(base_acts[loc][None], t) for loc, t in target_arrs.items()}
    n_targets = sum(len(t) for t in targets_by_loc.values())
    graph = {}
    for location in models:
        feats = list(features_to_ablate.get(location, []))
        if not feats:
            continue
        row = _edge_row(params, lm_cfg, tokens, models, location, names, target_arrs, base_reads, make_hook,
                        read_feature)
        w = _sweep(row, torch.as_tensor(feats, device=tokens.device), n_targets).cpu().numpy()

        col = 0
        for loc_ in locs:
            targets = targets_by_loc[loc_]
            if not targets:
                continue
            for j, feature_ in enumerate(targets):
                for i, feature in enumerate(feats):
                    if loc_ == location and feature_ == feature:
                        continue
                    graph[((location, feature), (loc_, feature_))] = float(w[i, col + j])
            col += len(targets)
    return graph


def _ablation_graph(params, lm_cfg, models, tokens, features_to_ablate, target_features, make_hook, read_feature,
                    device):
    device = resolve_device(device)
    tokens = _tokens(tokens, device)
    merged = {**features_to_ablate, **(target_features or {})}
    all_features = [(loc, f) for loc, feats in merged.items() for f in feats]
    with torch.inference_mode():
        base = _encode_cache(models, _cache_forward(params, lm_cfg, tokens, [get_model_tensor_name(l) for l in models]))
        return _graph_from_ablations(base, models, params, lm_cfg, tokens, features_to_ablate, all_features,
                                     make_hook, read_feature)


def build_ablation_graph(
    params,
    lm_cfg: lm_model.LMConfig,
    models: Dict[Location, Any],
    tokens,
    features_to_ablate: Optional[Dict[Location, List[Tuple[int, int]]]] = None,
    target_features: Optional[Dict[Location, List[Tuple[int, int]]]] = None,
    device=None,
):
    """Positional ablation graph: edge weight = mean |Δ activation| of a
    (pos, feat) under ablating another. By default every (position,
    feature) of every dict is ablated: L × N edited forwards a dict."""
    B, L = tokens.shape
    if not features_to_ablate:
        features_to_ablate = {
            loc: list(product(range(L), range(m.get_learned_dict().shape[0])))
            for loc, m in models.items()
        }
    return _ablation_graph(params, lm_cfg, models, tokens, features_to_ablate, target_features,
                           ablate_feature_intervention, _read_feature_positional, device)


def build_ablation_graph_non_positional(
    params,
    lm_cfg: lm_model.LMConfig,
    models: Dict[Location, Any],
    tokens,
    features_to_ablate: Optional[Dict[Location, List[int]]] = None,
    target_features: Optional[Dict[Location, List[int]]] = None,
    device=None,
):
    """Non-positional variant: edge weight = mean L2 over positions of the
    feature-activation change."""
    if not features_to_ablate:
        features_to_ablate = {
            loc: list(range(m.get_learned_dict().shape[0])) for loc, m in models.items()
        }
    return _ablation_graph(params, lm_cfg, models, tokens, features_to_ablate, target_features,
                           ablate_feature_intervention_non_positional, _read_feature_non_positional, device)


def _reconstruction_loss(params, lm_cfg, model, location, tokens) -> torch.Tensor:
    name = get_model_tensor_name(location)
    logits, _ = lm_model.forward(params, tokens, lm_cfg, hooks={name: replace_with_reconstruction_hook(model)})
    logprobs = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    ll = torch.gather(logprobs, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return -ll.mean()


def perplexity_under_reconstruction(
    params, lm_cfg: lm_model.LMConfig, model, location: Location, tokens, device=None
) -> torch.Tensor:
    """LM loss with the hook tensor replaced by its dictionary
    reconstruction (the log-softmax in f32), a 0-d tensor on ``device``."""
    device = resolve_device(device)
    with torch.inference_mode():
        return _reconstruction_loss(params, lm_cfg, model, location, _tokens(tokens, device))


def _batch_losses(params, lm_cfg, ld, location, batches) -> torch.Tensor:
    """The edited-forward loss of each token batch [n_batches], on the
    batches' device (no host read)."""
    return torch.stack([_reconstruction_loss(params, lm_cfg, ld, location, b) for b in batches])


def _host_mean(losses: np.ndarray) -> float:
    """The mean of per-batch f32 losses in float64 (the JAX package's
    ``np.mean`` of Python floats)."""
    return float(np.mean(losses.astype(np.float64)))


def mean_reconstruction_loss(params, lm_cfg, ld, location, batches, device=None) -> float:
    """Mean edited-forward LM loss over token batches (shared by
    `calculate_perplexity` and the PCA-perplexity experiment); one host
    read."""
    device = resolve_device(device)
    with torch.inference_mode():
        losses = _batch_losses(params, lm_cfg, ld, location, [_tokens(b, device) for b in batches])
        return _host_mean(losses.cpu().numpy())


def calculate_perplexity(
    params,
    lm_cfg: lm_model.LMConfig,
    learned_dicts: Sequence[Tuple[Any, Dict[str, Any]]],
    location: Location,
    tokens,
    batch_size: int = 16,
    vmapped: bool = True,
    device=None,
) -> Tuple[float, List[Tuple[Dict[str, Any], float]]]:
    """Baseline LM loss + the loss under each dict's reconstruction, over
    the whole batches of ``tokens`` (the last partial batch dropped).

    Each dict is scored alone, and every dict's losses come to the host in
    one read. ``vmapped`` is kept for the JAX package's signature and has no
    effect: that package stacks like dicts into one vmapped forward, which
    here was slower on the card and not bit-stable (ROADMAP §C)."""
    device = resolve_device(device)
    if tokens.shape[0] == 0:
        raise ValueError(f"no token rows to evaluate (tokens.shape={tuple(tokens.shape)})")
    batch_size = min(batch_size, tokens.shape[0])
    n = (tokens.shape[0] // batch_size) * batch_size
    batches = _tokens(tokens[:n], device).reshape(-1, batch_size, tokens.shape[1])

    with torch.inference_mode():
        base = _host_mean(torch.stack([lm_model.lm_loss(params, b, lm_cfg) for b in batches]).cpu().numpy())
        if learned_dicts:
            per_dict = torch.stack([_batch_losses(params, lm_cfg, ld, location, batches)
                                    for ld, _hp in learned_dicts]).cpu().numpy()  # [n_dicts, n_batches]
    results = [(hp, _host_mean(per_dict[i])) for i, (_ld, hp) in enumerate(learned_dicts)]
    return base, results
