"""Subprocess worker for the port's harvest kill/resume test
(tests/test_torch_harvest.py).

Harvests a deterministic tiny subject's layer-1 residual into one folder on
the CPU with the port (`sparse_coding__tpu_torch.data.activations`). The
parent test sets ``SC_FAULT`` (``kill:chunk_pair:chunk=2`` SIGKILLs the
process after chunk 2's bytes land, before its manifest) and passes
``--resume`` for the verified-cursor resume. The subject lives here alone,
so the worker and the test's in-process control and repair passes run the
same seeded forward.

Usage: python tests/_torch_harvest_worker.py <dataset_folder> [--resume] [--only K]
"""

import sys
from pathlib import Path

N_CHUNKS = 4
BATCH = 8
SEQ = 16


def build_subject():
    """The seeded tiny subject (port params) and its int32 token rows."""
    import numpy as np

    from sparse_coding__tpu_torch.lm import LMConfig, init_params

    cfg = LMConfig(arch="neox", n_layers=2, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32,
                   rotary_pct=0.25)
    params = init_params(7, cfg, device="cpu")
    tokens = np.random.default_rng(8).integers(0, 64, (64, SEQ)).astype(np.int32)
    return cfg, params, tokens


def harvest(dataset_folder, resume: bool = False, only_chunks=None):
    from sparse_coding__tpu_torch.data.activations import make_activation_dataset

    cfg, params, tokens = build_subject()
    chunk_gb = BATCH * SEQ * cfg.d_model * 2 / 1024**3  # exactly one batch a chunk
    return make_activation_dataset(params, cfg, tokens, dataset_folder, layers=[1], layer_locs=["residual"],
                                   batch_size=BATCH, chunk_size_gb=chunk_gb, n_chunks=N_CHUNKS,
                                   single_folder=True, resume=resume, only_chunks=only_chunks, device="cpu")


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    only = [int(sys.argv[sys.argv.index("--only") + 1])] if "--only" in sys.argv[2:] else None
    harvest(sys.argv[1], resume="--resume" in sys.argv[2:], only_chunks=only)


if __name__ == "__main__":
    main()
