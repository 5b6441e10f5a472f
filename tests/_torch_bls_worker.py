"""A small port `basic_l1_sweep` on the CPU, as a process of its own (for the
kill and resume test; imports no JAX, so it starts fast).

    python tests/_torch_bls_worker.py <store> <output> [--resume]

Two members, D 16, dictionary 32, 30 FISTA iterations, batch 64, 2 epochs,
a checkpoint at every chunk. ``SC_FAULT`` in the environment injects faults
(``sigterm:chunk=0:epoch=1`` preempts it after epoch 1's first chunk: exit
75).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep  # noqa: E402

KW = dict(activation_width=16, l1_values=[1e-4, 1e-3], dict_ratio=2, batch_size=64, fista_iters=30, n_epochs=2,
          checkpoint_every=1, device="cpu")


def main() -> int:
    torch.set_num_threads(1)  # the same reduction order in every process
    basic_l1_sweep(sys.argv[1], sys.argv[2], resume="--resume" in sys.argv[3:], **KW)
    return 0


if __name__ == "__main__":
    sys.exit(main())
