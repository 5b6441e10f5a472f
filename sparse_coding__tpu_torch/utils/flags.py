"""The ``SC_*`` environment flags the port reads.

Counterpart of `sparse_coding__tpu/utils/flags.py`, cut to the flags the port
uses; each keeps the JAX package's name, default and parse.
"""

from __future__ import annotations

import os


def recompute_code() -> bool:
    """``SC_RECOMPUTE_CODE``: the fused tied-SAE step rebuilds each code tile
    in the backward instead of storing the [M, B, N] code tensor. On only for
    the literal ``"1"`` (default ``"0"``). Read when an ensemble is built."""
    return os.environ.get("SC_RECOMPUTE_CODE", "0") == "1"
