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
from sparse_coding__tpu_torch.models import (
    RICA,
    DirectCoefOptimizer,
    DirectCoefSearch,
    Fista,
    FunctionalFista,
    FunctionalLISTADenoisingSAE,
    FunctionalMaskedSAE,
    FunctionalMaskedTiedSAE,
    FunctionalPositiveTiedSAE,
    FunctionalResidualDenoisingSAE,
    FunctionalReverseSAE,
    FunctionalSAE,
    FunctionalThresholdingSAE,
    FunctionalTiedCenteredSAE,
    FunctionalTiedSAE,
    SemiLinearSAE,
    TopKEncoder,
    TopKEncoderApprox,
    TopKLearnedDict,
)

__all__ = [
    "Ensemble", "EnsembleState", "build_ensemble", "FunctionalSAE", "FunctionalTiedSAE",
    "TopKEncoder", "TopKEncoderApprox", "TopKLearnedDict", "Fista", "FunctionalFista",
    "FunctionalTiedCenteredSAE", "FunctionalThresholdingSAE", "FunctionalMaskedTiedSAE", "FunctionalMaskedSAE",
    "FunctionalReverseSAE", "FunctionalLISTADenoisingSAE", "FunctionalResidualDenoisingSAE",
    "FunctionalPositiveTiedSAE", "SemiLinearSAE", "RICA", "DirectCoefOptimizer", "DirectCoefSearch",
]
