"""The dictionary models: training signatures and their inference views.

Counterpart of `sparse_coding__tpu/models/__init__.py`, with the same names,
less the solve `fista`, whose name stays the submodule's. The host-side
sklearn baselines `ICAEncoder` and `NMFEncoder` import sklearn only when
one is made.
"""

from sparse_coding__tpu_torch.models.learned_dict import (
    AddedNoise,
    Identity,
    IdentityReLU,
    LearnedDict,
    RandomDict,
    ReverseSAE,
    Rotation,
    ThresholdingSAE_export,
    TiedSAE,
    UntiedSAE,
)
from sparse_coding__tpu_torch.models.sae import (
    FunctionalMaskedSAE,
    FunctionalMaskedTiedSAE,
    FunctionalReverseSAE,
    FunctionalSAE,
    FunctionalThresholdingSAE,
    FunctionalTiedCenteredSAE,
    FunctionalTiedSAE,
)
from sparse_coding__tpu_torch.models.topk import TopKEncoder, TopKEncoderApprox, TopKLearnedDict
# the solve `fista` is not re-exported: that name is the `models.fista`
# submodule's (``from sparse_coding__tpu_torch.models import fista``)
from sparse_coding__tpu_torch.models.fista import (
    Fista,
    FunctionalFista,
    dictionary_update,
    power_iteration_max_eig,
    quadratic_basis_update,
)
from sparse_coding__tpu_torch.models.lista import (
    FunctionalLISTADenoisingSAE,
    FunctionalResidualDenoisingSAE,
    LISTADenoisingSAE,
    LISTALayer,
    ResidualDenoisingLayer,
    ResidualDenoisingSAE,
)
from sparse_coding__tpu_torch.models.positive import (
    FunctionalPositiveTiedSAE,
    TiedPositiveSAE,
    UntiedPositiveSAE,
)
from sparse_coding__tpu_torch.models.semilinear import FFLayer, SemiLinearSAE, SemiLinearSAE_export
from sparse_coding__tpu_torch.models.direct_coef import DirectCoefOptimizer, DirectCoefSearch
from sparse_coding__tpu_torch.models.pca import (
    BatchedMean,
    BatchedPCA,
    PCAEncoder,
    calc_mean,
    calc_pca,
)
from sparse_coding__tpu_torch.models.ica import ICAEncoder
from sparse_coding__tpu_torch.models.nmf import NMFEncoder
from sparse_coding__tpu_torch.models.rica import RICA, RICADict
