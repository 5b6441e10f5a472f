"""The port's figures (`plotting/plots.py`, the sweep's image dashboards,
`interp.batch.read_results`' violins) against the JAX package's, on the
CPU, on the same inputs (JAX-drawn dictionaries' arrays carried across).

Each figure is compared by its data read back from its `Axes`, not by
pixels: titles, axis labels and scales, tick labels, every line's x/y
data and label, every collection's offsets and path vertices (scatters,
violins, error bars), every bar's position, height and width, every
image's array, texts and legend entries. Strings exactly; numbers within
rtol 1e-5 (atol 1e-6) of JAX's: the plotted metrics are f32 sums in
another order.
"""

import importlib

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from sparse_coding__tpu.interp import batch as jbatch
from sparse_coding__tpu.models.learned_dict import TiedSAE as JaxTied
from sparse_coding__tpu.plotting import plots as jplots
from sparse_coding__tpu_torch.interp import batch as tbatch
from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
from sparse_coding__tpu_torch.plotting import plots as tplots
from sparse_coding__tpu_torch.train import sweep as tsweep

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# the JAX package's `train` names its `sweep` function over the module
jsweep = importlib.import_module("sparse_coding__tpu.train.sweep")
D = 16


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _pair(n, seed, bias=0.0):
    rows = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    b = np.full((n,), bias, np.float32)
    return (JaxTied(jnp.asarray(rows), jnp.asarray(b), norm_encoder=True),
            TiedSAE(torch.from_numpy(rows), torch.from_numpy(b.copy()), norm_encoder=True))


@pytest.fixture(scope="module")
def sweep_dicts():
    """(jax list, port list) of (dict, hyperparams) over two sizes and three l1s."""
    jl, tl = [], []
    for i, (size, l1) in enumerate([(s, l) for s in (24, 48) for l in (1e-4, 1e-3, 1e-2)]):
        j, t = _pair(size, i, bias=-0.1 * i)
        hp = {"dict_size": size, "l1_alpha": l1}
        jl.append((j, hp))
        tl.append((t, dict(hp)))
    batch = np.random.default_rng(9).standard_normal((256, D)).astype(np.float32)
    return jl, tl, batch


def _collection_data(c):
    parts = [np.asarray(c.get_offsets(), float).ravel()]
    for p in c.get_paths():
        parts.append(np.asarray(p.vertices, float).ravel())
    return np.concatenate(parts) if parts else np.zeros(0)


def figure_data(fig):
    """Everything a figure plots, read back from its Axes."""
    fig.canvas.draw()
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "scales": (ax.get_xscale(), ax.get_yscale()),
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
            "lines": [(ln.get_label(), np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float))
                      for ln in ax.lines],
            "collections": [_collection_data(c) for c in ax.collections],
            "patches": [np.asarray([p.get_x(), p.get_y(), p.get_width(), p.get_height()], float)
                        for p in ax.patches if hasattr(p, "get_width")],
            "images": [np.asarray(im.get_array(), float) for im in ax.images],
            "texts": [(t.get_text(), np.asarray(t.get_position(), float)) for t in ax.texts],
            "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        })
    return out


def assert_same(got, want, path="fig"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True, err_msg=path)
    else:
        assert got == want, (path, got, want)


def _same_figures(got_fig, want_fig):
    assert_same(figure_data(got_fig), figure_data(want_fig))


def test_metric_figures_match_jax(sweep_dicts):
    jl, tl, batch = sweep_dicts
    jb, tb = jnp.asarray(batch), torch.from_numpy(batch)
    (jbase, tbase) = _pair(16, 20)
    _same_figures(tplots.fvu_sparsity_pareto(tl, tb, baselines={"pca": tbase}),
                  jplots.fvu_sparsity_pareto(jl, jb, baselines={"pca": jbase}))
    for metrics in (("fvu", "l0"), ("l0",)):
        _same_figures(tplots.sweep_scatter_grid(tl, tb, metrics=metrics), jplots.sweep_scatter_grid(jl, jb,
                                                                                                     metrics=metrics))
    _same_figures(tplots.n_active_plot(tl, tb), jplots.n_active_plot(jl, jb))
    _same_figures(tplots.fista_comparison_plot(tl[:3], tl[3:], tb), jplots.fista_comparison_plot(jl[:3], jl[3:], jb))
    _same_figures(tplots.n_active_over_time({1: tl[:3], 4: tl[3:]}, tb, threshold=2),
                  jplots.n_active_over_time({1: jl[:3], 4: jl[3:]}, jb, threshold=2))


def test_data_figures_match_jax():
    rng = np.random.default_rng(1)
    scores = {"sparse_coding": list(rng.random(20)), "pca": list(rng.random(15)), "empty": []}
    _same_figures(tplots.autointerp_violins(scores, title="t"), jplots.autointerp_violins(scores, title="t"))
    kl = {"a": 0.5, "b": 1.25, "c": 0.1}
    _same_figures(tplots.kl_div_plot(kl), jplots.kl_div_plot(kl))
    arr = rng.random((2, 10))
    _same_figures(tplots.bottleneck_plot(arr, ["x", "y"]), jplots.bottleneck_plot(arr, ["x", "y"]))
    grid = rng.random((3, 2))
    kw = dict(x_tick_labels=[48, 96], y_tick_labels=[1e-4, 1e-3, 1e-2], x_label="dict size", y_label="l1_alpha",
              vmin=0.0, vmax=1.0)
    _same_figures(tplots.grid_heatmap(grid, **kw), jplots.grid_heatmap(grid, **kw))
    vals = rng.standard_normal(200)
    _same_figures(tplots.histogram(vals, "v", bins=15), jplots.histogram(vals, "v", bins=15))
    counts = {"a": rng.integers(0, 100, 48), "b": rng.integers(0, 100, 48)}
    _same_figures(tplots.feature_activity_overlay(counts, 100), jplots.feature_activity_overlay(counts, 100))
    traj = {"r1": [{"epoch": i, "mean_fvu": 1.0 / (i + 1)} for i in range(5)],
            "r0": [{"epoch": i, "mean_fvu": 0.5 / (i + 1)} for i in range(4)]}
    _same_figures(tplots.convergence_trajectories(traj, log_y=True), jplots.convergence_trajectories(traj, log_y=True))


def _results_base(root):
    """``l{layer}_residual/<transform>/feature_*/explanation.txt`` for the
    autointerp comparison figures."""
    rng = np.random.default_rng(3)
    transforms = ["sparse_coding", "tied_r2_nc1", "tied_r2_nc4", "tied_r4", "tied_r0.5", "pca", "ica",
                  "identity_relu", "pca_topk", "random"]
    for layer in (0, 1):
        for t in transforms:
            for f in range(int(rng.integers(2, 6))):
                folder = root / f"l{layer}_residual" / t / f"feature_{f:04d}"
                folder.mkdir(parents=True)
                s = rng.random(3)
                folder.joinpath("explanation.txt").write_text(
                    f"expl\nScore: {s[0]:.2f}\nTop only score: {s[1]:.2f}\nRandom only score: {s[2]:.2f}\n")
    return root


def test_autointerp_comparison_figures_match_jax(tmp_path):
    base = _results_base(tmp_path / "results")
    kw = dict(layers=[0, 1, 2], score_mode="top_random")
    assert tplots.read_layer_scores(base, [0, 1, 2], "residual", "top") == jplots.read_layer_scores(
        base, [0, 1, 2], "residual", "top")
    for name in ("autointerp_across_chunks", "autointerp_across_size", "autointerp_vs_baselines",
                 "autointerp_vs_topk_baselines"):
        _same_figures(getattr(tplots, name)(base, **kw), getattr(jplots, name)(base, **kw))
    scores, labels = tplots.read_layer_scores(base, [0, 1], "residual", "all")
    _same_figures(tplots.grouped_score_bars(scores, ["pca", "ica"], labels, title="g"),
                  jplots.grouped_score_bars(scores, ["pca", "ica"], labels, title="g"))
    out = tplots.save_figure(tplots.kl_div_plot({"a": 1.0}), tmp_path / "figs" / "kl.png")
    assert out.stat().st_size > 0


class _CaptureLogger:
    """A logger that keeps each logged image's plotted data (both packages'
    `log_sweep_metrics` call ``log``, ``flush`` and ``log_image``)."""

    def __init__(self):
        self.images = {}

    def log(self, step, tree):
        pass

    def flush(self):
        pass

    def log_image(self, step, name, fig):
        self.images[(step, name)] = figure_data(fig)


def test_sweep_dashboards_match_jax(sweep_dicts):
    jl, tl, batch = sweep_dicts
    ranges = {"dict_size": [24, 48], "l1_alpha": [1e-4, 1e-3, 1e-2]}
    chunk = np.random.default_rng(4).standard_normal((512, D)).astype(np.float32)
    jlog, tlog = _CaptureLogger(), _CaptureLogger()
    want = jsweep.log_sweep_metrics(jl, jnp.asarray(chunk), 3, ranges, jlog, n_samples=300)
    got = tsweep.log_sweep_metrics(tl, torch.from_numpy(chunk), 3, ranges, tlog, n_samples=300, images=True)
    assert sorted(tlog.images) == sorted(jlog.images) == [(3, "feature_activity"), (3, "mmcs_grid_default")]
    for key in jlog.images:
        assert_same(tlog.images[key], jlog.images[key], str(key))
    np.testing.assert_allclose(got["mmcs_grids"]["default"], want["mmcs_grids"]["default"], rtol=1e-5)
    # without ``images`` nothing is drawn (the card's machine has no matplotlib)
    quiet = _CaptureLogger()
    tsweep.log_sweep_metrics(tl, torch.from_numpy(chunk), 3, ranges, quiet, n_samples=300)
    assert quiet.images == {}


def test_the_port_logger_writes_dashboard_pngs(tmp_path):
    from sparse_coding__tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(out_dir=str(tmp_path), run_name="r")
    fig = tplots.kl_div_plot({"a": 1.0})
    assert logger.log_image(7, "kl", fig) == tmp_path / "images" / "kl_7.png"
    assert (tmp_path / "images" / "kl_7.png").stat().st_size > 0
    assert MetricLogger(out_dir=None).log_image(7, "kl", fig) is None
    logger.close()


def test_read_results_violins_match_jax(tmp_path, monkeypatch):
    base = _results_base(tmp_path / "results")
    figs = {}

    def capture(pkg):
        def save(fig, path):
            figs[pkg] = (figure_data(fig), path)
            return path

        return save

    monkeypatch.setattr(tplots, "save_figure", capture("port"))
    monkeypatch.setattr(jplots, "save_figure", capture("jax"))
    got = tbatch.read_results("l0_residual", "top", results_base=base)
    want = jbatch.read_results("l0_residual", "top", results_base=base)
    assert got == want == base / "l0_residual" / "top_means_and_violin.png"
    assert_same(figs["port"][0], figs["jax"][0])
    (base / "l9_residual").mkdir()
    assert tbatch.read_results("l9_residual", "top", results_base=base) is None


def test_the_sweep_draws_its_dashboards_with_wandb_images(tmp_path):
    """``cfg.wandb_images``: the sweep renders the feature-activity overlay
    every 10 chunks into ``<output>/images`` (chunk 0 here)."""
    from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.data.chunks import save_chunk
    from sparse_coding__tpu_torch.utils.config import EnsembleArgs

    rng = np.random.default_rng(0)
    for i in range(2):
        save_chunk(tmp_path / "store", i, rng.standard_normal((128, D)).astype(np.float32))

    def init(cfg):
        ens = build_ensemble(FunctionalTiedSAE, cfg.seed, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
                             activation_size=D, n_dict_components=32, device="cpu")
        return [(ens, {"batch_size": cfg.batch_size, "dict_size": 32}, "e")], ["dict_size"], ["l1_alpha"], {
            "l1_alpha": [1e-3, 3e-3], "dict_size": [32]}

    cfg = EnsembleArgs(dataset_folder=str(tmp_path / "store"), output_folder=str(tmp_path / "out"), batch_size=64,
                       activation_width=D, wandb_images=True)
    lds = tsweep.sweep(init, cfg, device="cpu")
    assert len(lds) == 2
    assert [p.name for p in sorted((tmp_path / "out" / "images").iterdir())] == ["feature_activity_0.png"]
