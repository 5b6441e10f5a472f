"""Figures (counterpart of `sparse_coding__tpu/plotting`); needs
matplotlib, imported with this package."""

from sparse_coding__tpu_torch.plotting.plots import (
    autointerp_across_chunks,
    autointerp_across_size,
    autointerp_violins,
    autointerp_vs_baselines,
    autointerp_vs_topk_baselines,
    bottleneck_plot,
    convergence_trajectories,
    fista_comparison_plot,
    fvu_sparsity_pareto,
    grid_heatmap,
    grouped_score_bars,
    histogram,
    kl_div_plot,
    n_active_over_time,
    n_active_plot,
    read_layer_scores,
    save_figure,
    sweep_scatter_grid,
)
