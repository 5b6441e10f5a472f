"""PyTorch/CUDA port of `sparse_coding__tpu` for the NVIDIA H100.

The JAX package stays the reference; this package mirrors its module paths.
Imports `torch` and numpy only — never `jax`, nor anything of
`sparse_coding__tpu`. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; the hand-written kernels under `ops/csrc` are built
at their first CUDA launch, never at import.
"""

from sparse_coding__tpu_torch.ensemble import (
    Ensemble,
    EnsembleState,
    build_ensemble,
)
from sparse_coding__tpu_torch.models.fista import Fista, FunctionalFista
from sparse_coding__tpu_torch.models.sae import FunctionalTiedSAE
from sparse_coding__tpu_torch.models.topk import TopKEncoder, TopKEncoderApprox, TopKLearnedDict

__all__ = [
    "Ensemble", "EnsembleState", "build_ensemble", "FunctionalTiedSAE",
    "TopKEncoder", "TopKEncoderApprox", "TopKLearnedDict", "Fista", "FunctionalFista",
]
