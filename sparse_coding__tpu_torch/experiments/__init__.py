"""One-off analysis experiments (the paper's analysis deliverables).

Counterpart of `sparse_coding__tpu/experiments`, with its names: each
experiment is a runnable module (``python -m
sparse_coding__tpu_torch.experiments.<name> ... --device cpu``) whose device
half computes the scores where the params and dicts live (the card unless
asked for the CPU) and whose entry point then writes the CSV/JSON and the
figure. matplotlib is imported only where a figure is drawn, so the device
halves import and run where it is missing; an entry point that draws a
figure raises `ImportError` naming it there.
"""

from sparse_coding__tpu_torch.experiments.case_studies import (
    dict_across_time,
    dict_compare,
    feature_activations,
    feature_case_study,
    inter_dict_connections,
    inter_layer_mcs,
    render_case_study,
)
from sparse_coding__tpu_torch.experiments.check_l0_tokens import embedding_cosine_scores, run_embedding_cosine_check
from sparse_coding__tpu_torch.experiments.interp_moment_corrs import run_moment_corrs
from sparse_coding__tpu_torch.experiments.investigate import (
    investigate_scores,
    random_feature_diversity,
    run_investigate,
)
from sparse_coding__tpu_torch.experiments.pca_perplexity import pca_perplexity_scores, run_pca_perplexity

__all__ = [
    "run_pca_perplexity",
    "pca_perplexity_scores",
    "run_embedding_cosine_check",
    "embedding_cosine_scores",
    "run_moment_corrs",
    "run_investigate",
    "investigate_scores",
    "random_feature_diversity",
    "dict_compare",
    "dict_across_time",
    "inter_layer_mcs",
    "inter_dict_connections",
    "feature_activations",
    "feature_case_study",
    "render_case_study",
]
