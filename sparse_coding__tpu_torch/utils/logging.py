"""Buffered metric logging: wandb when available, JSONL otherwise.

Counterpart of `sparse_coding__tpu/utils/logging.py`. `MetricLogger.log`
keeps the step's loss tensors where they are (no ``.item()``, no sync);
`flush` copies the whole window to the host in one transfer and writes one
record per member and metric::

    {"step": int, "series": str, "metric": str, "value": float, "ts": float}

to ``<out_dir>/<run_name>_metrics.jsonl``, the JAX package's schema. wandb
is used when ``use_wandb=True`` and it imports; otherwise (as when it is not
installed) the JSONL file is written. `log_image` logs a matplotlib figure
(a wandb image, or a PNG under ``<out_dir>/images/``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def format_hyperparam_val(val) -> str:
    return f"{val:.2E}".replace("+", "") if isinstance(val, float) else str(val)


def make_hyperparam_name(hyperparam_values: Dict[str, Any]) -> str:
    """Stable per-model series name, e.g. ``l1_alpha_1.00E-03``."""
    return "_".join(f"{k}_{format_hyperparam_val(hyperparam_values[k])}" for k in sorted(hyperparam_values))


def _to_host(trees: List[Dict[str, Any]]) -> List[Dict[str, np.ndarray]]:
    """Every tensor of ``trees`` to numpy float32 in one copy per device
    (one in practice): the leaves are flattened, concatenated where they
    live, copied, and split again. Non-tensor values pass through numpy."""
    leaves = [(i, k, v) for i, t in enumerate(trees) for k, v in t.items() if isinstance(v, torch.Tensor)]
    out: List[Dict[str, np.ndarray]] = [{k: np.asarray(v, dtype=np.float32) for k, v in t.items()
                                         if not isinstance(v, torch.Tensor)} for t in trees]
    by_device: Dict[torch.device, list] = {}
    for leaf in leaves:
        by_device.setdefault(leaf[2].device, []).append(leaf)
    from sparse_coding__tpu_torch.telemetry.audit import allowed_transfer

    for group in by_device.values():
        # the flush boundary: the one sanctioned copy of a window (telemetry.audit)
        with allowed_transfer():
            flat = torch.cat([v.detach().reshape(-1).float() for _, _, v in group]).cpu().numpy()
        pos = 0
        for i, k, v in group:
            n = v.numel()
            out[i][k] = flat[pos:pos + n].reshape(tuple(v.shape))
            pos += n
    return [{k: o[k] for k in t} for t, o in zip(trees, out)]


class MetricLogger:
    """Buffered, sync-free metric logger: `log(step, tree)` keeps the
    tensors, `flush()` brings the window to the host at once.

    ``on_flush(steps, trees)`` receives each window's host values after they
    are written (the JAX package plugs its anomaly guard in here)."""

    def __init__(self, out_dir: Optional[str] = None, run_name: str = "run", use_wandb: bool = False,
                 wandb_project: str = "sparse_coding__tpu", model_names: Optional[List[str]] = None,
                 on_flush: Optional[Callable[[List[int], List[Dict[str, Any]]], None]] = None):
        self.model_names = model_names
        self.on_flush = on_flush
        self._buffer: List = []
        self._wandb = None
        self._jsonl = None
        self._out_dir = None if out_dir is None else Path(out_dir)
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=run_name)
            except Exception:  # not installed or no login: the JSONL file instead
                self._wandb = None
        if self._wandb is None and out_dir is not None:
            path = Path(out_dir)
            path.mkdir(parents=True, exist_ok=True)
            # a world of several ranks writes one file per rank on the shared
            # run dir (interleaved appends would tear lines)
            from sparse_coding__tpu_torch.telemetry.multihost import process_info

            idx, count = process_info()
            stem = f"{run_name}_p{idx}" if count > 1 else run_name
            self._jsonl = open(path / f"{stem}_metrics.jsonl", "a")

    def log_image(self, step: int, name: str, fig) -> Optional[Path]:
        """Log a matplotlib figure: a wandb image when wandb is live, else a
        PNG ``<out_dir>/images/<name>_<step>.png`` (the in-training
        dashboard channel, as in the JAX package). Returns the written path
        (None on the wandb path or without an ``out_dir``). The caller owns
        the figure."""
        if self._wandb is not None:
            import wandb

            # the chunk index rides alongside: images arrive per chunk, scalars per step
            self._wandb.log({name: wandb.Image(fig), f"{name}_chunk": int(step)})
            return None
        if self._out_dir is None:
            return None
        img_dir = self._out_dir / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        path = img_dir / f"{name}_{int(step)}.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        return path

    def log(self, step: int, tree: Dict[str, Any]):
        """Queue a dict of [n_models] tensors (or numbers). No host sync."""
        self._buffer.append((step, tree))

    def flush(self):
        if not self._buffer:
            return
        steps = [s for s, _ in self._buffer]
        trees = _to_host([t for _, t in self._buffer])
        now = time.time()
        for step, tree in zip(steps, trees):
            for metric, values in tree.items():
                for m, v in enumerate(np.reshape(values, -1)):
                    series = (self.model_names[m] if self.model_names and m < len(self.model_names)
                              else f"model_{m}")
                    if self._wandb is not None:
                        self._wandb.log({f"{series}_{metric}": float(v)}, step=int(step))
                    if self._jsonl is not None:
                        rec = {"step": int(step), "series": series, "metric": metric, "value": float(v), "ts": now}
                        self._jsonl.write(json.dumps(rec) + "\n")
        if self._jsonl is not None:
            self._jsonl.flush()
        self._buffer.clear()
        if self.on_flush is not None:
            self.on_flush(steps, trees)

    def close(self):
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
