"""Evaluation metrics (counterpart of `sparse_coding__tpu/metrics`): the
dictionary metrics of `standard`, the LM-side `intervention` metrics and the
host-side `clustering` diagnostics, with the JAX package's names."""

from sparse_coding__tpu_torch.metrics.standard import (
    batched_calc_feature_n_ever_active,
    calc_feature_kurtosis,
    calc_feature_mean,
    calc_feature_n_active,
    calc_feature_skew,
    calc_feature_variance,
    calc_moments_streaming,
    capacity_per_feature,
    evaluate_dicts,
    fraction_variance_unexplained,
    fraction_variance_unexplained_top_activating,
    group_stackable_dicts,
    hungarian_matched_mcs,
    interference_capacity,
    logistic_regression_auroc,
    mcs_duplicates,
    mcs_to_fixed,
    mean_nonzero_activations,
    mmcs,
    mmcs_from_list,
    mmcs_to_fixed,
    neurons_per_feature,
    r_squared,
    representedness,
    ridge_regression_auroc,
    sparsity_l0,
)
from sparse_coding__tpu_torch.metrics.intervention import (
    Location,
    build_ablation_graph,
    build_ablation_graph_non_positional,
    cache_all_activations,
    calculate_perplexity,
    get_model_tensor_name,
    perplexity_under_reconstruction,
    replace_with_reconstruction_hook,
)
from sparse_coding__tpu_torch.metrics.clustering import (
    cluster_vectors,
    hierarchical_cluster_vectors,
)
