"""A small port sweep on the CPU, as a process of its own (for the kill and
resume tests; imports no JAX, so it starts fast).

    python tests/_torch_sweep_worker.py <store> <output> [--resume]

Two ensembles over a 3-chunk store, 2 epochs: an Adam l1 sweep and an SGD
ensemble with a warmup schedule. ``SC_FAULT`` in the environment injects
faults (``sigterm:chunk=1`` preempts it at position 1: exit 75).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble  # noqa: E402
from sparse_coding__tpu_torch.train.sweep import sweep  # noqa: E402
from sparse_coding__tpu_torch.utils.config import EnsembleArgs  # noqa: E402
from sparse_coding__tpu_torch.utils.optim import linear_schedule  # noqa: E402

D, N = 16, 32
L1 = [1e-3, 3e-3]


def init(cfg):
    kw = dict(activation_size=D, n_dict_components=N, device="cpu")
    adam = build_ensemble(FunctionalTiedSAE, cfg.seed, [{"l1_alpha": a} for a in L1],
                          optimizer_kwargs={"learning_rate": cfg.lr}, **kw)
    sgd = build_ensemble(FunctionalTiedSAE, cfg.seed + 1, [{"l1_alpha": 1e-3}], optimizer="sgd",
                         optimizer_kwargs={"learning_rate": linear_schedule(0.0, 1e-2, 4)}, **kw)
    args = {"batch_size": cfg.batch_size, "dict_size": N}
    return [(adam, args, "adam"), (sgd, args, "sgd")], ["dict_size"], ["l1_alpha"], {"l1_alpha": L1, "dict_size": [N]}


def main() -> int:
    torch.set_num_threads(1)  # the same reduction order in every process
    store, out = sys.argv[1], sys.argv[2]
    cfg = EnsembleArgs(dataset_folder=store, output_folder=out, batch_size=64, n_epochs=2, activation_width=D)
    sweep(init, cfg, resume="--resume" in sys.argv[3:], device="cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
