"""CLI: `python -m sparse_coding__tpu_torch.interp <mode> [--flags] [--device D]`.

The JAX package's CLI (`sparse_coding__tpu/interp/__main__.py`), on
``--device`` (default cuda; ``cpu`` to run on the CPU). Modes:
  (default)      run one dict file, or every dict in a folder
  read_results   violin plots of saved scores (InterpGraphArgs)
  run_group      split a learned_dicts.pkl into tagged files and run them
  big_sweep      l1-matched dict per layer of a sweep output tree
  all_baselines  every baseline dict per layer folder
  chunks         l1-matched dict across training save points

Context inputs come from InterpArgs: `--lm_params` (a pickle of
`(params, LMConfig)` written by either package, read through
`utils.pickles`), `--fragments` (.npy int tokens `[n, fragment_len]`),
`--token_strs` (json list: token id → string). When unset, the subject model
and openwebtext fragments are pulled from the HF cache (network-free only if
already cached). `read_results` draws violin plots (`plotting`: needs
matplotlib). The explainer/simulator client
is auto-selected (`clients.default_client`): OpenAI when a key is configured,
the offline lexicon client otherwise.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from sparse_coding__tpu_torch.interp import batch as batch_mod
from sparse_coding__tpu_torch.interp.records import OPENAI_FRAGMENT_LEN
from sparse_coding__tpu_torch.utils import pickles
from sparse_coding__tpu_torch.utils.config import InterpArgs, InterpGraphArgs
from sparse_coding__tpu_torch.utils.device import resolve_device

DEFAULT_L1 = 8.577e-4  # the 8e-4 of logspace(-4, -2, 16)


def build_context(cfg: InterpArgs, device=None) -> batch_mod.InterpContext:
    """The subject, fragments and token strings ``cfg`` names; the params on
    ``device`` (None = cuda)."""
    device = resolve_device(device)
    if cfg.lm_params:
        with open(cfg.lm_params, "rb") as f:
            params, lm_cfg = pickles.load(f, device=device)
    else:
        from sparse_coding__tpu_torch.lm.convert import load_model

        lm_cfg, params = load_model(cfg.model_name, device=device)

    if cfg.fragments:
        fragments = np.load(cfg.fragments)
    else:
        import transformers

        from sparse_coding__tpu_torch.data.activations import setup_token_data

        tokenizer = transformers.AutoTokenizer.from_pretrained(cfg.model_name)
        fragments = setup_token_data(
            cfg.dataset_name, tokenizer, max_length=OPENAI_FRAGMENT_LEN
        )

    if cfg.token_strs:
        with open(cfg.token_strs) as f:
            vocab = json.load(f)
        decode_tokens = lambda row: [vocab[int(t)] for t in row]
    else:
        import transformers

        tokenizer = transformers.AutoTokenizer.from_pretrained(cfg.model_name)
        decode_tokens = lambda row: [tokenizer.decode([int(t)]) for t in row]

    return batch_mod.InterpContext(params, lm_cfg, fragments, decode_tokens, device=device)


def _pop_device(argv):
    """``--device D`` / ``--device=D`` taken out of ``argv`` (None when
    absent)."""
    for i, a in enumerate(argv):
        if a == "--device":
            device = argv[i + 1]
            del argv[i : i + 2]
            return device
        if a.startswith("--device="):
            del argv[i]
            return a.split("=", 1)[1]
    return None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = argv.pop(0) if argv and not argv[0].startswith("-") else ""
    device = _pop_device(argv)

    if mode == "read_results":
        gcfg = InterpGraphArgs.from_cli(argv)
        score_modes = (
            ["top", "random", "top_random"]
            if gcfg.score_mode == "all"
            else [gcfg.score_mode]
        )
        base = Path(gcfg.results_base)
        if gcfg.run_all:
            names = sorted(p.name for p in base.iterdir() if p.is_dir())
        else:
            # this pipeline's writers lay results out as l{layer}_{loc}
            names = [f"l{gcfg.layer}_{gcfg.layer_loc}"]
        for name in names:
            for score_mode in score_modes:
                batch_mod.read_results(name, score_mode, results_base=base)
        return

    if mode not in ("", "run_group", "big_sweep", "all_baselines", "chunks"):
        # validate BEFORE building the context (which may hit the HF cache)
        raise SystemExit(
            f"unknown mode {mode!r}; expected one of: read_results, run_group, "
            "big_sweep, all_baselines, chunks (or no mode for a single file/folder)"
        )

    cfg = InterpArgs.from_cli(argv)
    if not cfg.save_loc:
        # every dict-running mode writes where read_results will look
        cfg.save_loc = str(Path(cfg.results_base) / f"l{cfg.layer}_{cfg.layer_loc}")
    ctx = build_context(cfg, device=device)

    if mode == "run_group":
        batch_mod.run_from_grouped(cfg, ctx, cfg.load_interpret_autoencoder)
    elif mode == "big_sweep":
        batch_mod.interpret_across_big_sweep(
            DEFAULT_L1, cfg, ctx, cfg.load_interpret_autoencoder
        )
    elif mode == "all_baselines":
        batch_mod.interpret_across_baselines(cfg, ctx, cfg.load_interpret_autoencoder)
    elif mode == "chunks":
        batch_mod.interpret_across_chunks(
            DEFAULT_L1, cfg, ctx, cfg.load_interpret_autoencoder
        )
    elif mode == "":
        target = Path(cfg.load_interpret_autoencoder)
        if target.is_dir():
            batch_mod.run_folder(cfg, ctx)
        else:
            named = [
                (target.stem if i == 0 else f"{target.stem}_{i}", ld)
                for i, (ld, _hp) in enumerate(batch_mod._load_dict_file(target, device=ctx.device))
            ]
            batch_mod.run_many(named, cfg, ctx)
    else:  # unreachable unless the guard tuple above drifts from this chain
        raise AssertionError(f"mode {mode!r} passed validation but has no handler")


if __name__ == "__main__":
    main()
