"""Autointerp pipeline: activation dataframe → explain → simulate → score.

Counterpart of `sparse_coding__tpu/interp/pipeline.py`: build a per-feature
activation table over text fragments, select top + random activation
records per feature, generate an explanation, simulate it, and score by
correlation, saving per-feature folders (``scored_simulation.pkl`` /
``neuron_record.pkl`` / ``explanation.txt``; the pickles under the JAX
package's class paths, `utils.pickles`, so either package reads them).

Two halves:
  - the device half (`_fragment_codes`) runs on ``device`` (None = cuda):
    one capture forward of the subject LM per fragment batch (stopping at
    the hook's block), then every dict's encode of it, sliced to the kept
    features; only ``[n_fragments, L, n_kept]`` per dict crosses to the
    host, in one read a dict;
  - the frames and files are built on the host. pandas (and pyarrow for
    the parquet cache) is imported inside the functions that build or read
    frames, so the device half imports on a machine without pandas.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from sparse_coding__tpu_torch.interp.clients import InterpClient, default_client
from sparse_coding__tpu_torch.interp.records import (
    ActivationRecord,
    NeuronRecord,
    OPENAI_FRAGMENT_LEN,
    ScoredSimulation,
    SequenceSimulation,
    TOTAL_EXAMPLES,
    aggregate_scored_sequence_simulations,
    calculate_max_activation,
)
from sparse_coding__tpu_torch.lm import model as lm_model
from sparse_coding__tpu_torch.utils import pickles
from sparse_coding__tpu_torch.utils.device import resolve_device


def make_feature_activation_dataset(
    params,
    lm_cfg: lm_model.LMConfig,
    learned_dict,
    layer: int,
    layer_loc: str,
    fragments: np.ndarray,
    decode_tokens: Callable[[Sequence[int]], List[str]],
    max_features: int = 0,
    batch_size: int = 32,
    device=None,
) -> pd.DataFrame:
    """Per-fragment, per-feature activation table.

    `fragments` is `[n, fragment_len]` int tokens; `decode_tokens` maps a row
    to per-token strings. Columns: `fragment_token_strs`,
    `feature_{i}_activation_{j}`, `feature_{i}_max`, `feature_{i}_mean`.
    """
    return make_feature_activation_datasets(
        params, lm_cfg, [learned_dict], layer, layer_loc, fragments,
        decode_tokens, max_features=max_features, batch_size=batch_size, device=device,
    )[0]


def _codes_to_dataframe(codes: np.ndarray, token_strs: list, frag_len: int) -> pd.DataFrame:
    """One wide block → DataFrame in a single construction: the per-feature
    activation columns are one ``[n_frags, n_feats*frag_len]`` reshape."""
    import pandas as pd

    n_frags, _, n_feats = codes.shape
    # feature-major layout: feature_i_activation_j for all j, then
    # feature_i_max/mean appended below
    acts = np.transpose(codes, (0, 2, 1)).reshape(n_frags, n_feats * frag_len)
    columns = [
        f"feature_{i}_activation_{j}" for i in range(n_feats) for j in range(frag_len)
    ]
    df = pd.DataFrame(acts, columns=columns, copy=False)
    maxes = codes.max(axis=1)  # [n_frags, n_feats]
    means = codes.mean(axis=1)
    df = pd.concat(
        [
            pd.Series(token_strs, name="fragment_token_strs"),
            df,
            pd.DataFrame(maxes, columns=[f"feature_{i}_max" for i in range(n_feats)]),
            pd.DataFrame(means, columns=[f"feature_{i}_mean" for i in range(n_feats)]),
        ],
        axis=1,
    )
    return df


def _fragment_codes(
    params,
    lm_cfg: lm_model.LMConfig,
    learned_dicts: Sequence,
    layer: int,
    layer_loc: str,
    fragments: np.ndarray,
    max_features: int = 0,
    batch_size: int = 32,
    device=None,
) -> List[np.ndarray]:
    """The device half of `make_feature_activation_datasets`: each dict's
    codes ``[n_fragments, fragment_len, n_kept]`` on the host. The fragments
    are padded with zero rows to whole batches on the device; one capture
    forward a batch, every dict's encode of it, one host read a dict."""
    device = resolve_device(device)
    name = lm_model.make_tensor_name(layer, layer_loc)
    n_kept = [ld.n_feats if not max_features else min(max_features, ld.n_feats) for ld in learned_dicts]
    n_frags, frag_len = fragments.shape
    tokens = torch.as_tensor(np.asarray(fragments)).to(device)
    pad = (-n_frags) % batch_size
    if pad:
        tokens = torch.cat([tokens, torch.zeros((pad, frag_len), dtype=tokens.dtype, device=device)])
    blocks: List[List[torch.Tensor]] = [[] for _ in learned_dicts]
    with torch.inference_mode():
        for start in range(0, tokens.shape[0], batch_size):
            _, cache = lm_model.forward(params, tokens[start : start + batch_size], lm_cfg, cache_names=[name],
                                        stop_at_layer=layer + 1)
            acts = cache[name]
            B, L, C = acts.shape
            for d, ld in enumerate(learned_dicts):
                blocks[d].append(ld.encode(acts.reshape(B * L, C)).reshape(B, L, -1)[:, :, : n_kept[d]])
        return [torch.cat(b)[:n_frags].cpu().numpy() for b in blocks]


def make_feature_activation_datasets(
    params,
    lm_cfg: lm_model.LMConfig,
    learned_dicts: Sequence,
    layer: int,
    layer_loc: str,
    fragments: np.ndarray,
    decode_tokens: Callable[[Sequence[int]], List[str]],
    max_features: int = 0,
    batch_size: int = 32,
    device=None,
) -> List[pd.DataFrame]:
    """Activation tables for MANY dicts at one hook point, sharing one LM
    forward per fragment batch: the hook tensor is captured once, then
    encoded with every dict."""
    codes = _fragment_codes(params, lm_cfg, learned_dicts, layer, layer_loc, fragments,
                            max_features=max_features, batch_size=batch_size, device=device)
    token_strs = [decode_tokens(fragments[b]) for b in range(fragments.shape[0])]
    return [_codes_to_dataframe(c, token_strs, fragments.shape[1]) for c in codes]


def get_df(
    feature_dict,
    params,
    lm_cfg,
    layer: int,
    layer_loc: str,
    fragments: np.ndarray,
    decode_tokens,
    n_feats: int,
    save_loc,
    force_refresh: bool = False,
    **kwargs,
) -> pd.DataFrame:
    """Parquet-cached activation dataframe (``device`` among ``kwargs``)."""
    import pandas as pd

    save_loc = Path(save_loc)
    save_loc.mkdir(parents=True, exist_ok=True)
    df_loc = save_loc / "activation_df.parquet"
    if df_loc.exists() and not force_refresh:
        base_df = pd.read_parquet(df_loc)
        if f"feature_{n_feats - 1}_activation_0" in base_df.columns:
            return base_df
        print("Cached dataframe lacks requested features, remaking")
    base_df = make_feature_activation_dataset(
        params, lm_cfg, feature_dict, layer, layer_loc, fragments, decode_tokens,
        max_features=n_feats, **kwargs,
    )
    base_df.to_parquet(df_loc)
    return base_df


def select_records(df: pd.DataFrame, feat_n: int, fragment_len: int, seed: int = 0):
    """Top-activating + nonzero-random records for one feature. Returns None
    if too few activating fragments exist (the caller writes a placeholder
    folder)."""
    cols = [f"feature_{feat_n}_activation_{i}" for i in range(fragment_len)]
    required = ["fragment_token_strs", f"feature_{feat_n}_max", *cols]
    if not all(c in df.columns for c in required):
        return None
    sub = df[required]
    top = sub.sort_values(by=f"feature_{feat_n}_max", ascending=False).head(TOTAL_EXAMPLES)
    top_records = [
        ActivationRecord(list(row["fragment_token_strs"]), [row[c] for c in cols])
        for _, row in top.iterrows()
    ]
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(sub))
    random_records: List[ActivationRecord] = []
    for i in order:
        if len(random_records) >= TOTAL_EXAMPLES:
            break
        row = sub.iloc[int(i)]
        if row[f"feature_{feat_n}_max"] == 0:
            continue
        random_records.append(
            ActivationRecord(list(row["fragment_token_strs"]), [row[c] for c in cols])
        )
    if len(random_records) < TOTAL_EXAMPLES:
        return None
    return NeuronRecord(feat_n, top_records, random_records)


def interpret(
    base_df: pd.DataFrame,
    save_folder,
    n_feats_to_explain: int,
    client: Optional[InterpClient] = None,
    fragment_len: int = OPENAI_FRAGMENT_LEN,
    max_concurrent: int = 1,
):
    """Explain + simulate + score each feature; save per-feature folders.
    Skips features whose folder is complete (resume).

    `max_concurrent` > 1 runs features on a thread pool, for API-bound
    clients (per-feature folders make the writes independent). The default
    stays serial: the offline client is CPU-bound and deterministic ordering
    keeps logs readable."""
    client = client or default_client()
    save_folder = Path(save_folder)

    def one(feat_n: int):
        folder = save_folder / f"feature_{feat_n}"
        # complete = explanation written, or an explicit no-data placeholder;
        # a bare folder from a crashed run is retried
        if (folder / "explanation.txt").exists() or (folder / "no_data").exists():
            print(f"Feature {feat_n} already exists, skipping")
            return
        record = select_records(base_df, feat_n, fragment_len)
        if record is None:
            folder.mkdir(parents=True, exist_ok=True)
            (folder / "no_data").touch()  # placeholder = don't recompute
            print(f"Skipping feature {feat_n} due to lack of activating examples")
            return

        train = record.train_records()
        valid = record.valid_records()
        explanation = client.explain(train, calculate_max_activation(train))

        sims = [
            SequenceSimulation(
                tokens=r.tokens,
                true_activations=r.activations,
                simulated_activations=client.simulate(explanation, r.tokens),
            )
            for r in valid
        ]
        scored = ScoredSimulation(explanation, sims)
        score = scored.get_preferred_score()
        top_only = aggregate_scored_sequence_simulations(sims[: len(sims) // 2])
        random_only = aggregate_scored_sequence_simulations(sims[len(sims) // 2 :])
        print(f"Feature {feat_n}, score={score:.2f}, top={top_only:.2f}, random={random_only:.2f}")

        folder.mkdir(parents=True, exist_ok=True)
        with open(folder / "scored_simulation.pkl", "wb") as f:
            pickles.dump(scored, f)
        with open(folder / "neuron_record.pkl", "wb") as f:
            pickles.dump(record, f)
        with open(folder / "explanation.txt", "w") as f:
            f.write(
                f"{explanation}\nScore: {score:.2f}\n"
                f"Top only score: {top_only:.2f}\nRandom only score: {random_only:.2f}\n"
            )

    if max_concurrent <= 1:
        for feat_n in range(n_feats_to_explain):
            one(feat_n)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max_concurrent) as pool:
        # list() surfaces worker exceptions instead of dropping them
        list(pool.map(one, range(n_feats_to_explain)))


def read_results(save_folder) -> pd.DataFrame:
    """Collect per-feature scores back into a dataframe (the violins are
    `batch.read_results`')."""
    import pandas as pd

    records = []
    for folder in sorted(Path(save_folder).glob("feature_*")):
        exp_file = folder / "explanation.txt"
        if not exp_file.exists():
            continue
        lines = exp_file.read_text().splitlines()
        rec = {"feature": int(folder.name.split("_")[1]), "explanation": lines[0]}
        for line in lines[1:]:
            if ":" in line:
                k, _, v = line.partition(":")
                try:
                    rec[k.strip().lower().replace(" ", "_")] = float(v)
                except ValueError:
                    pass
        records.append(rec)
    return pd.DataFrame(records)


def read_transform_scores(save_folder, score_mode: str = "all"):
    """Per-feature autointerp scores from a results folder: (feature_indices,
    scores) with `score_mode` selecting the aggregate ("all"), top-fragment
    ("top") or random-fragment ("random") score."""
    col = {"all": "score", "top": "top_only_score", "random": "random_only_score"}[score_mode]
    df = read_results(save_folder)
    if df.empty or col not in df.columns:
        return [], []
    df = df.dropna(subset=[col])
    return df["feature"].astype(int).tolist(), df[col].astype(float).tolist()


def run(feature_dict, cfg, params, lm_cfg, fragments, decode_tokens,
        client: Optional[InterpClient] = None, device=None):
    """End-to-end autointerp for one dict."""
    assert cfg.df_n_feats >= cfg.n_feats_explain
    df = get_df(
        feature_dict, params, lm_cfg, cfg.layer, cfg.layer_loc,
        fragments, decode_tokens, n_feats=cfg.df_n_feats, save_loc=cfg.save_loc, device=device,
    )
    interpret(df, cfg.save_loc, cfg.n_feats_explain, client=client,
              fragment_len=fragments.shape[1],
              max_concurrent=cfg.max_concurrent)
    return read_results(cfg.save_loc)
