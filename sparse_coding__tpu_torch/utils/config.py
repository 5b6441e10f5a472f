"""Validated run configs: dataclasses with CLI flags and YAML export.

Counterpart of `BaseArgs`, `TrainArgs`, `EnsembleArgs` and
`SyntheticEnsembleArgs` of `sparse_coding__tpu/utils/config.py`, field for
field, so one ``config.yaml`` describes a run of either package. Dtype
fields stay names (``"float32"``); `DTYPES` maps them to torch dtypes
(`BaseArgs.torch_dtype`). The other Args classes come with the slices that
use them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from sparse_coding__tpu_torch.lm.model import HOOK_TEMPLATES

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def _layer_loc_ok(layer_loc) -> bool:
    """`make_tensor_name`'s surface: a shorthand, a ``{layer}`` template, or a
    fully-qualified hook name."""
    if not isinstance(layer_loc, str):
        return False
    if layer_loc in HOOK_TEMPLATES:
        return True
    if "{layer}" in layer_loc:
        try:
            layer_loc.format(layer=0)
        except (KeyError, IndexError, ValueError):
            return False
        return True
    return layer_loc.startswith(("blocks.", "hook_"))


def _cli_type(hint, default):
    """Parser for a CLI flag from the resolved annotation (Optional unwrapped)."""
    if typing.get_origin(hint) is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        hint = args[0] if args else str
    if hint is bool or isinstance(default, bool):
        return lambda s: s.lower() in ("1", "true", "yes")
    if isinstance(hint, type) and hint is not type(None):
        return hint
    return type(default) if default is not None else str


@dataclass
class BaseArgs:
    """Validation + explicit CLI overlay + (de)serialization."""

    def __post_init__(self):
        self.validate()

    def validate(self):
        """Subclass invariants; run at construction and after overlays."""

    @classmethod
    def from_cli(cls, argv: Optional[list] = None, **overrides) -> "BaseArgs":
        """Defaults + keyword overrides + command-line flags."""
        self = cls(**overrides)
        hints = typing.get_type_hints(cls)
        parser = argparse.ArgumentParser(description=cls.__name__)
        for f in fields(self):
            parser.add_argument(f"--{f.name}", type=_cli_type(hints[f.name], getattr(self, f.name)), default=None)
        self.update(parser.parse_args(argv))
        return self

    def update(self, args: Any):
        """Overlay the non-None attributes of ``args`` (a namespace or dict)."""
        src = vars(args) if not isinstance(args, dict) else args
        unknown = set(src) - {f.name for f in fields(self)}
        if unknown:
            raise ValueError(f"Unknown arguments: {unknown}")
        for key, value in src.items():
            if value is not None:
                print(f"From command line, setting {key} to {value}")
                setattr(self, key, value)
        self.validate()

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save_yaml(self, path):
        """The config as YAML (sorted keys). Where PyYAML is not installed,
        the same mapping as JSON, which every YAML 1.2 reader loads."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        try:
            import yaml
        except ImportError:
            yaml = None
        with open(path, "w") as f:
            if yaml is not None:
                yaml.safe_dump(self.as_dict(), f, sort_keys=True)
            else:
                json.dump(self.as_dict(), f, sort_keys=True, indent=2)

    @classmethod
    def load_yaml(cls, path) -> "BaseArgs":
        text = Path(path).read_text()
        try:
            import yaml
        except ImportError:
            return cls(**json.loads(text))
        return cls(**yaml.safe_load(text))

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[getattr(self, "dtype", "float32")]


@dataclass
class TrainArgs(BaseArgs):
    """Sweep/training config."""

    layer: int = 2
    layer_loc: str = "residual"
    model_name: str = "EleutherAI/pythia-70m-deduped"
    dataset_name: str = "openwebtext"
    dataset_folder: str = ""
    tied_ae: bool = False
    seed: int = 0
    learned_dict_ratio: float = 1.0
    output_folder: str = "outputs"
    dtype: str = "float32"
    center_dataset: bool = False
    n_chunks: int = 30
    chunk_size_gb: float = 2.0
    batch_size: int = 256
    use_wandb: bool = False
    wandb_images: bool = False
    lr: float = 1e-3
    l1_alpha: float = 1e-3
    save_every: int = 5
    n_epochs: int = 1
    n_repetitions: Optional[int] = None  # None → use n_epochs
    center_activations: bool = False
    harvest_compute_dtype: Optional[str] = None
    harvest_store_dtype: str = "float16"
    # multi-epoch sweeps whose dataset fits the card: upload chunks once
    hbm_cache_chunks: bool = False
    l1_warmup_steps: int = 0

    def validate(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {self.dtype}")
        if self.harvest_compute_dtype is not None and self.harvest_compute_dtype not in DTYPES:
            raise ValueError(f"harvest_compute_dtype must be one of {sorted(DTYPES)} or None, "
                             f"got {self.harvest_compute_dtype}")
        if self.harvest_store_dtype not in ("float16", "int8", "int4"):
            raise ValueError(f"harvest_store_dtype must be 'float16', 'int8' or 'int4', got {self.harvest_store_dtype}")
        if not _layer_loc_ok(self.layer_loc):
            raise ValueError(f"unknown layer_loc {self.layer_loc!r}")
        if self.batch_size <= 0 or self.n_chunks <= 0:
            raise ValueError("batch_size and n_chunks must be positive")


@dataclass
class EnsembleArgs(TrainArgs):
    activation_width: int = 512
    use_synthetic_dataset: bool = False
    bias_decay: float = 0.0
    topk_recall: Optional[float] = None


@dataclass
class SyntheticEnsembleArgs(EnsembleArgs):
    noise_magnitude_scale: float = 0.0
    feature_prob_decay: float = 0.99
    feature_num_nonzero: int = 10
    gen_batch_size: int = 4096
    dataset_folder: str = "activation_data"
    n_ground_truth_components: int = 512
    correlated_components: bool = False
