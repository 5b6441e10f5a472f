"""Batch autointerp: run the explain/simulate/score pipeline over a sweep's
worth of dictionaries.

Counterpart of `sparse_coding__tpu/interp/batch.py`: the folder, group,
sweep, baseline and chunk batch modes. Dicts are batched through ONE shared
subject-LM forward (`pipeline.make_feature_activation_datasets`) on
``ctx.device`` (None = cuda): the LM compute is paid once per fragment
batch, not once per dict. Dictionary files of either package load
(`train.checkpoint.load_learned_dicts`, else `utils.pickles`).

Folder-name / tag conventions are kept verbatim so the JAX package's tooling
parses these outputs: `make_tag_name`, `parse_folder_name`
("tied_residual_l2_r4"). The violin plots of `read_results` need
`plotting`, which is not ported yet (ROADMAP A8c).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from sparse_coding__tpu_torch.interp import pipeline
from sparse_coding__tpu_torch.interp.clients import InterpClient
from sparse_coding__tpu_torch.utils import pickles
from sparse_coding__tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class InterpContext:
    """Everything `pipeline.run` needs besides the dictionary itself;
    ``device`` is where the params live and the dicts load (None = cuda)."""

    params: Any
    lm_cfg: Any
    fragments: Any  # [n, fragment_len] int tokens
    decode_tokens: Callable[[Sequence[int]], List[str]]
    client: Optional[InterpClient] = None
    device: Any = None


def make_tag_name(hparams: Dict[str, Any]) -> str:
    """A dict's tag from its hyperparams (tied, dict size, l1, bias decay)."""
    tag = ""
    if "tied" in hparams:
        tag += f"tied_{hparams['tied']}"
    if "dict_size" in hparams:
        tag += f"dict_size_{hparams['dict_size']}"
    if "l1_alpha" in hparams:
        tag += f"l1_alpha_{hparams['l1_alpha']:.2}"
    if "bias_decay" in hparams:
        tag += "0.0" if hparams["bias_decay"] == 0 else f"{hparams['bias_decay']:.1}"
    return tag


def parse_folder_name(folder_name: str) -> Tuple[str, str, int, float, str]:
    """Parse "tied_residual_l5_r8[_extra]" into (tied, layer_loc, layer,
    ratio, extra) (ratio 0 means 0.5)."""
    tied, layer_loc, layer_str, ratio_str, *extras = folder_name.split("_")
    layer = int(layer_str[1:])
    ratio = float(ratio_str[1:])
    if ratio == 0:
        ratio = 0.5
    return tied, layer_loc, layer, ratio, "_".join(extras)


def _load_dict_file(path, device=None) -> List[Tuple[Any, Dict[str, Any]]]:
    """Load a dictionary file of either package in either on-disk format: a
    `save_learned_dicts` record list, or a plain pickle of one LearnedDict /
    one `(LearnedDict, hyperparams)` tuple (the baselines-runner format), on
    ``device``. The file is read through `utils.pickles` first, so a JAX
    package's class path never imports JAX."""
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts

    with open(path, "rb") as f:
        obj = pickles.load_raw(f)
    if isinstance(obj, list) and obj and isinstance(obj[0], dict) and "class" in obj[0]:
        return load_learned_dicts(path, device=device)
    obj = pickles.to_tensors(obj, resolve_device(device))
    if isinstance(obj, tuple) and len(obj) == 2 and isinstance(obj[1], dict):
        return [obj]
    return [(obj, {})]


def run_many(
    named_dicts: Sequence[Tuple[str, Any]],
    cfg,
    ctx: InterpContext,
    group_size: int = 8,
) -> List[Path]:
    """Autointerp every (name, dict); results land in `cfg.save_loc/<name>`.

    Dicts are processed in groups that share one LM forward; `group_size` bounds host memory for the activation
    tables. Per-dict results are resumable exactly like `pipeline.run`."""
    save_root = Path(cfg.save_loc)
    out_folders = []
    todo: List[Tuple[str, Any]] = []

    def flush():
        if not todo:
            return
        names = [n for n, _ in todo]
        dicts = [d for _, d in todo]
        dfs = pipeline.make_feature_activation_datasets(
            ctx.params, ctx.lm_cfg, dicts, cfg.layer, cfg.layer_loc,
            ctx.fragments, ctx.decode_tokens, max_features=cfg.df_n_feats, device=ctx.device,
        )
        for name, df in zip(names, dfs):
            loc = save_root / name
            loc.mkdir(parents=True, exist_ok=True)
            df.to_parquet(loc / "activation_df.parquet")
            pipeline.interpret(
                df, loc, cfg.n_feats_explain, client=ctx.client,
                fragment_len=ctx.fragments.shape[1],
                max_concurrent=cfg.max_concurrent,
            )
        todo.clear()

    for name, ld in named_dicts:
        loc = save_root / name
        out_folders.append(loc)
        cached = loc / "activation_df.parquet"
        if cached.exists():
            import pandas as pd

            df = pd.read_parquet(cached)
            want = min(cfg.df_n_feats, ld.n_feats)
            # same coverage check as get_df: a stale narrower dataframe would
            # otherwise mark features beyond its width as permanent no_data
            if f"feature_{want - 1}_activation_0" in df.columns:
                # df already harvested: just (re)score features missing outputs
                pipeline.interpret(
                    df, loc, cfg.n_feats_explain,
                    client=ctx.client, fragment_len=ctx.fragments.shape[1],
                    max_concurrent=cfg.max_concurrent,
                )
                continue
            print(f"{name}: cached dataframe lacks requested features, remaking")
        todo.append((name, ld))
        if len(todo) >= group_size:
            flush()
    flush()
    return out_folders


def run_folder(cfg, ctx: InterpContext) -> List[Path]:
    """Autointerp every dict file in `cfg.load_interpret_autoencoder`."""
    base = Path(cfg.load_interpret_autoencoder)
    named = []
    for file in sorted(os.listdir(base)):
        if not (file.endswith(".pkl") or file.endswith(".pt")):
            continue
        for i, (ld, hp) in enumerate(_load_dict_file(base / file, device=ctx.device)):
            suffix = f"_{make_tag_name(hp) or i}" if i else ""
            named.append((Path(file).stem + suffix, ld))
    print(f"Found {len(named)} dicts in {base}")
    return run_many(named, cfg, ctx)


def run_from_grouped(cfg, ctx: InterpContext, results_loc, out_dir=None) -> List[Path]:
    """Split a sweep's `learned_dicts.pkl` into per-dict files tagged by
    hyperparams, then run the folder."""
    from sparse_coding__tpu_torch.train.checkpoint import (
        load_learned_dicts,
        save_learned_dicts,
    )

    results = load_learned_dicts(results_loc, device=ctx.device)
    if out_dir is None:
        out_dir = Path(cfg.results_base) / datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for ld, hp in results:
        save_learned_dicts(out_dir / (make_tag_name(hp) + ".pkl"), [(ld, hp)])
    cfg.load_interpret_autoencoder = str(out_dir)
    return run_folder(cfg, ctx)


def _match_l1(
    dicts: List[Tuple[Any, Dict[str, Any]]], l1_val: float, tol: float = 1e-4
) -> Optional[Any]:
    matching = [ld for ld, hp in dicts if abs(hp.get("l1_alpha", 1e9) - l1_val) < tol]
    if len(matching) != 1:
        print(f"Found {len(matching)} encoders matching l1={l1_val}")
    return matching[0] if matching else None


def interpret_across_big_sweep(
    l1_val: float,
    cfg,
    ctx: InterpContext,
    base_dir,
    save_dir=None,
    tied: str = "tied",
    ratio: float = 2.0,
    n_chunks_training: int = 10,
) -> List[Path]:
    """One dict (the l1 match) per layer folder of a big sweep. Sweep
    folders must parse as `parse_folder_name` and contain
    `_{n_chunks_training - 1}/learned_dicts.pkl`."""
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts

    save_dir = Path(save_dir if save_dir is not None else cfg.results_base)
    named = []
    layer_cfgs = []
    for folder in sorted(os.listdir(base_dir)):
        try:
            f_tied, layer_loc, layer, f_ratio, extra = parse_folder_name(folder)
        except (ValueError, IndexError):
            continue
        if layer_loc != cfg.layer_loc or f_tied != tied or f_ratio != ratio or extra:
            continue
        dicts_path = (
            Path(base_dir) / folder / f"_{n_chunks_training - 1}" / "learned_dicts.pkl"
        )
        if not dicts_path.exists():
            continue
        ld = _match_l1(load_learned_dicts(dicts_path, device=ctx.device), l1_val)
        if ld is None:
            continue
        named.append((f"l{layer}_{layer_loc}/{f_tied}_r{f_ratio:g}_l1a{l1_val:.2}", ld))
        layer_cfgs.append(layer)
    out = []
    # layers differ per entry → group by layer so the shared forward is valid
    for layer in sorted(set(layer_cfgs)):
        sub_cfg = dataclasses.replace(cfg, layer=layer, save_loc=str(save_dir))
        group = [nd for nd, l in zip(named, layer_cfgs) if l == layer]
        out.extend(run_many(group, sub_cfg, ctx))
    return out


def interpret_across_chunks(
    l1_val: float,
    cfg,
    ctx: InterpContext,
    base_dir,
    save_dir=None,
    chunk_counts: Sequence[int] = (1, 4, 16, 32),
) -> List[Path]:
    """The l1-matched dict at several training save points — feature
    stability over training."""
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts

    save_dir = Path(save_dir if save_dir is not None else cfg.results_base)
    named = []
    for folder in sorted(os.listdir(base_dir)):
        try:
            tied, layer_loc, layer, ratio, _extra = parse_folder_name(folder)
        except (ValueError, IndexError):
            continue
        if layer != cfg.layer or layer_loc != cfg.layer_loc:
            continue
        for n_chunks in chunk_counts:
            dicts_path = Path(base_dir) / folder / f"_{n_chunks - 1}" / "learned_dicts.pkl"
            if not dicts_path.exists():
                continue
            ld = _match_l1(load_learned_dicts(dicts_path, device=ctx.device), l1_val)
            if ld is None:
                continue
            named.append(
                (f"l{layer}_{layer_loc}/{tied}_r{ratio:g}_nc{n_chunks}_l1a{l1_val:.2}", ld)
            )
    sub_cfg = dataclasses.replace(cfg, save_loc=str(save_dir))
    return run_many(named, sub_cfg, ctx)


def interpret_across_baselines(
    cfg, ctx: InterpContext, baselines_dir, save_dir=None, skip: Sequence[str] = ("nmf",)
) -> List[Path]:
    """Every baseline dict of every `l{layer}_{loc}` folder (nmf skipped by
    default)."""
    save_dir = Path(save_dir if save_dir is not None else cfg.results_base)
    out = []
    for folder in sorted(os.listdir(baselines_dir)):
        try:
            layer_str, layer_loc = folder.split("_", 1)
            layer = int(layer_str[1:])
        except (ValueError, IndexError):
            continue
        if layer_loc != cfg.layer_loc:
            continue
        named = []
        for file in sorted(os.listdir(Path(baselines_dir) / folder)):
            if not file.endswith(".pkl") or any(s in file for s in skip):
                continue
            for i, (ld, hp) in enumerate(_load_dict_file(Path(baselines_dir) / folder / file, device=ctx.device)):
                # multi-dict files: disambiguate like run_folder, else later
                # dicts would silently reuse the first's cached dataframe
                suffix = f"_{make_tag_name(hp) or i}" if i else ""
                named.append((f"{folder}/{Path(file).stem}{suffix}", ld))
        sub_cfg = dataclasses.replace(cfg, layer=layer, save_loc=str(save_dir))
        out.extend(run_many(named, sub_cfg, ctx))
    return out


# -- score reading -------------------------------------------------------------

def read_scores(
    results_folder, score_mode: str = "top"
) -> Dict[str, Tuple[List[int], List[float]]]:
    """{transform_name: (feature_ndxs, scores)} over every transform subfolder
    ("sparse_coding" sorts first, at the head of the violin plot)."""
    assert score_mode in ("top", "random", "top_random", "all")
    mode = {"top": "top", "random": "random", "top_random": "all", "all": "all"}[score_mode]
    results_folder = Path(results_folder)
    transforms = sorted(
        [p.name for p in results_folder.iterdir() if p.is_dir()],
        key=lambda t: (t != "sparse_coding", t),
    )
    scores = {}
    for transform in transforms:
        ndxs, s = pipeline.read_transform_scores(results_folder / transform, mode)
        if ndxs:
            scores[transform] = (ndxs, s)
    return scores


def read_results(
    activation_name: str, score_mode: str, results_base="auto_interp_results"
) -> Optional[Path]:
    """Violin plot + means of every transform's scores for one activation
    folder. The plot needs `plotting`, which is not ported yet: with scores
    to plot this raises naming ROADMAP A8c."""
    results_folder = Path(results_base) / activation_name
    scores = read_scores(results_folder, score_mode)
    if not scores:
        print(f"No scores found for {activation_name}")
        return None
    raise NotImplementedError("the autointerp violin plots need `plotting`, which is not ported yet — ROADMAP A8c")
