"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless asked for the CPU (no silent fallback)."""

import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "sparse_coding__tpu_torch"
SLICE_MODULES = [
    "sparse_coding__tpu_torch",
    "sparse_coding__tpu_torch.data",
    "sparse_coding__tpu_torch.data.activations",
    "sparse_coding__tpu_torch.data.chunks",
    "sparse_coding__tpu_torch.data.integrity",
    "sparse_coding__tpu_torch.data.ioi",
    "sparse_coding__tpu_torch.data.scrub",
    "sparse_coding__tpu_torch.data.synthetic",
    "sparse_coding__tpu_torch.data.synthetic_text",
    "sparse_coding__tpu_torch.ensemble",
    "sparse_coding__tpu_torch.experiments",
    "sparse_coding__tpu_torch.experiments._figures",
    "sparse_coding__tpu_torch.experiments.case_studies",
    "sparse_coding__tpu_torch.experiments.check_l0_tokens",
    "sparse_coding__tpu_torch.experiments.interp_moment_corrs",
    "sparse_coding__tpu_torch.experiments.investigate",
    "sparse_coding__tpu_torch.experiments.pca_perplexity",
    "sparse_coding__tpu_torch.features",
    "sparse_coding__tpu_torch.interop",
    "sparse_coding__tpu_torch.interp",
    "sparse_coding__tpu_torch.interp.__main__",
    "sparse_coding__tpu_torch.interp.batch",
    "sparse_coding__tpu_torch.interp.clients",
    "sparse_coding__tpu_torch.interp.pipeline",
    "sparse_coding__tpu_torch.interp.records",
    "sparse_coding__tpu_torch.lineage",
    "sparse_coding__tpu_torch.lm",
    "sparse_coding__tpu_torch.lm.convert",
    "sparse_coding__tpu_torch.lm.model",
    "sparse_coding__tpu_torch.lm.pretrain",
    "sparse_coding__tpu_torch.lm.ring_attention",
    "sparse_coding__tpu_torch.metrics",
    "sparse_coding__tpu_torch.monitor",
    "sparse_coding__tpu_torch.metrics.clustering",
    "sparse_coding__tpu_torch.metrics.intervention",
    "sparse_coding__tpu_torch.metrics.standard",
    "sparse_coding__tpu_torch.models",
    "sparse_coding__tpu_torch.models.direct_coef",
    "sparse_coding__tpu_torch.models.fista",
    "sparse_coding__tpu_torch.models.ica",
    "sparse_coding__tpu_torch.models.learned_dict",
    "sparse_coding__tpu_torch.models.lista",
    "sparse_coding__tpu_torch.models.nmf",
    "sparse_coding__tpu_torch.models.pca",
    "sparse_coding__tpu_torch.models.positive",
    "sparse_coding__tpu_torch.models.rica",
    "sparse_coding__tpu_torch.models.sae",
    "sparse_coding__tpu_torch.models.semilinear",
    "sparse_coding__tpu_torch.models.topk",
    "sparse_coding__tpu_torch.parallel",
    "sparse_coding__tpu_torch.perfdiff",
    "sparse_coding__tpu_torch.parallel.distributed",
    "sparse_coding__tpu_torch.parallel.mesh",
    "sparse_coding__tpu_torch.ops._build",
    "sparse_coding__tpu_torch.ops._wrap",
    "sparse_coding__tpu_torch.ops.fista_kernel",
    "sparse_coding__tpu_torch.ops.tied_sae_kernel",
    "sparse_coding__tpu_torch.ops.topk_kernel",
    "sparse_coding__tpu_torch.plotting",
    "sparse_coding__tpu_torch.plotting.plots",
    "sparse_coding__tpu_torch.report",
    "sparse_coding__tpu_torch.scrub",
    "sparse_coding__tpu_torch.serve",
    "sparse_coding__tpu_torch.serve.engine",
    "sparse_coding__tpu_torch.serve.loadgen",
    "sparse_coding__tpu_torch.serve.registry",
    "sparse_coding__tpu_torch.serve.replicaset",
    "sparse_coding__tpu_torch.serve.router",
    "sparse_coding__tpu_torch.serve.server",
    "sparse_coding__tpu_torch.serve.wire",
    "sparse_coding__tpu_torch.slo",
    "sparse_coding__tpu_torch.supervise",
    "sparse_coding__tpu_torch.telemetry",
    "sparse_coding__tpu_torch.telemetry.anomaly",
    "sparse_coding__tpu_torch.telemetry.audit",
    "sparse_coding__tpu_torch.telemetry.events",
    "sparse_coding__tpu_torch.telemetry.feature_stats",
    "sparse_coding__tpu_torch.telemetry.goodput",
    "sparse_coding__tpu_torch.telemetry.health",
    "sparse_coding__tpu_torch.telemetry.metrics_http",
    "sparse_coding__tpu_torch.telemetry.monitor",
    "sparse_coding__tpu_torch.telemetry.multihost",
    "sparse_coding__tpu_torch.telemetry.profiling",
    "sparse_coding__tpu_torch.telemetry.provenance",
    "sparse_coding__tpu_torch.telemetry.report",
    "sparse_coding__tpu_torch.telemetry.slo",
    "sparse_coding__tpu_torch.telemetry.spans",
    "sparse_coding__tpu_torch.telemetry.tower",
    "sparse_coding__tpu_torch.telemetry.tracing",
    "sparse_coding__tpu_torch.timeline",
    "sparse_coding__tpu_torch.tower",
    "sparse_coding__tpu_torch.trace",
    "sparse_coding__tpu_torch.train",
    "sparse_coding__tpu_torch.train.baselines",
    "sparse_coding__tpu_torch.train.basic_l1_sweep",
    "sparse_coding__tpu_torch.train.big_batch",
    "sparse_coding__tpu_torch.train.checkpoint",
    "sparse_coding__tpu_torch.train.experiments",
    "sparse_coding__tpu_torch.train.loop",
    "sparse_coding__tpu_torch.train.preemption",
    "sparse_coding__tpu_torch.train.sweep",
    "sparse_coding__tpu_torch.train.toy_models",
    "sparse_coding__tpu_torch.utils.config",
    "sparse_coding__tpu_torch.utils.device",
    "sparse_coding__tpu_torch.utils.faults",
    "sparse_coding__tpu_torch.utils.flags",
    "sparse_coding__tpu_torch.utils.logging",
    "sparse_coding__tpu_torch.utils.manifest",
    "sparse_coding__tpu_torch.utils.optim",
    "sparse_coding__tpu_torch.utils.pickles",
    "sparse_coding__tpu_torch.utils.precision",
    "sparse_coding__tpu_torch.utils.sync",
    "sparse_coding__tpu_torch.utils.trace",
    "sparse_coding__tpu_torch.utils.tree",
]


def test_import_leaves_jax_and_the_jax_package_out():
    """In a fresh interpreter: the test process itself already holds jax."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparse_coding__tpu' or m.startswith('sparse_coding__tpu.') or m == 'ml_dtypes')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_name_jax_or_the_jax_package():
    """Catches lazy imports the subprocess check cannot see."""
    pattern = re.compile(r"^\s*(import jax|from jax)|sparse_coding__tpu\.", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tests" / "_torch_moments.py",
                                          REPO / "tests" / "_torch_harvest_worker.py",
                                          REPO / "tests" / "_torch_mp_worker.py"]
    assert len(files) > 10
    offenders = [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())]
    assert offenders == []


def test_no_port_module_imports_ml_dtypes():
    """The card's machine has no ml_dtypes: bf16 crosses the host boundary as
    a torch tensor (the wire carries its uint16 bits)."""
    pattern = re.compile(r"^\s*(import ml_dtypes|from ml_dtypes)|importlib\.import_module\(.ml_dtypes", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())] == []


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.data.chunks import ChunkStore
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator
    from sparse_coding__tpu_torch.data.activations import harvest_to_device, make_activation_dataset
    from sparse_coding__tpu_torch.lm import LMConfig, init_params
    from sparse_coding__tpu_torch.lm.pretrain import pretrain_lm
    from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep

    lm_cfg = LMConfig(arch="neox", n_layers=1, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32)
    lm_params = init_params(0, lm_cfg, device="cpu")
    tokens = np.zeros((8, 16), np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, lm_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain_lm(lm_params, lm_cfg, tokens, n_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_activation_dataset(lm_params, lm_cfg, tokens, tmp_path / "acts", [0], ["residual"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(harvest_to_device(lm_params, lm_cfg, tokens, [0], ["residual"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}], activation_size=32, n_dict_components=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RandomDatasetGenerator(32, 64, 16, 4, 0.99, False, key=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChunkStore(tmp_path).load(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        basic_l1_sweep(str(tmp_path), str(tmp_path / "out"), activation_width=32)
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}], activation_size=32,
                         n_dict_components=64, device="cpu")
    assert ens.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_ablation_builders_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    """The catalog's A8a builders draw their members on the card unless
    given ``device="cpu"`` (no silent fallback)."""
    from sparse_coding__tpu_torch.train import experiments as texp
    from sparse_coding__tpu_torch.utils.config import EnsembleArgs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EnsembleArgs(activation_width=8, batch_size=16)
    for builder in (texp.residual_denoising_experiment, texp.thresholding_experiment, texp.run_positive_experiment,
                    texp.dict_ratio_experiment):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            builder(cfg)


def test_evaluation_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """The slice's evaluation, toy models, baselines and autointerp run on
    the card unless given ``device="cpu"`` (no silent fallback)."""
    from sparse_coding__tpu_torch.interp import InterpContext, run_many
    from sparse_coding__tpu_torch.interp import pipeline
    from sparse_coding__tpu_torch.lm import LMConfig, init_params
    from sparse_coding__tpu_torch.metrics import intervention as iv
    from sparse_coding__tpu_torch.models import ICAEncoder, NMFEncoder
    from sparse_coding__tpu_torch.models.learned_dict import Identity
    from sparse_coding__tpu_torch.train import baselines, toy_models
    from sparse_coding__tpu_torch.utils import pickles
    from sparse_coding__tpu_torch.utils.config import InterpArgs, ToyArgs

    cfg = LMConfig(arch="neox", n_layers=1, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32)
    params = init_params(0, cfg, device="cpu")
    ld = Identity(16, device="cpu")
    tokens = np.zeros((4, 8), np.int32)
    models = {(0, "residual"): ld}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: iv.cache_all_activations(params, cfg, models, tokens),
        lambda: iv.perplexity_under_reconstruction(params, cfg, ld, (0, "residual"), tokens),
        lambda: iv.mean_reconstruction_loss(params, cfg, ld, (0, "residual"), [tokens]),
        lambda: iv.calculate_perplexity(params, cfg, [(ld, {})], (0, "residual"), tokens),
        lambda: iv.build_ablation_graph(params, cfg, models, tokens, {(0, "residual"): [(0, 1)]}),
        lambda: iv.build_ablation_graph_non_positional(params, cfg, models, tokens, {(0, "residual"): [1]}),
        lambda: toy_models.run_single_go(ToyArgs(activation_dim=8, n_ground_truth_components=16, batch_size=8)),
        lambda: toy_models.run_toy_grid(ToyArgs(activation_dim=8, n_ground_truth_components=16, batch_size=8)),
        lambda: ICAEncoder(8),
        lambda: NMFEncoder(8),
        lambda: baselines.run_layer_baselines(0, ["residual"], str(tmp_path), str(tmp_path / "out")),
        lambda: pickles.loads(pickle.dumps({"a": np.zeros(2)})),
        lambda: pipeline.make_feature_activation_datasets(params, cfg, [ld], 0, "residual", tokens, str),
        lambda: run_many([("a", ld)], InterpArgs(layer=0, save_loc=str(tmp_path / "i")),
                         InterpContext(params, cfg, tokens, str)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_interp_device_half_imports_without_pandas():
    """The card's machine may lack pandas: the pipeline's device half imports
    and runs with pandas made unimportable (only the frames need it)."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        "from sparse_coding__tpu_torch.interp import pipeline\n"
        "import sparse_coding__tpu_torch.interp, sparse_coding__tpu_torch.interp.batch\n"
        "from sparse_coding__tpu_torch.lm import LMConfig, init_params\n"
        "from sparse_coding__tpu_torch.models.learned_dict import Identity\n"
        "cfg = LMConfig(arch='neox', n_layers=1, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32)\n"
        "codes = pipeline._fragment_codes(init_params(0, cfg, device='cpu'), cfg, [Identity(16, device='cpu')], 0,\n"
        "                                 'residual', np.zeros((5, 8), np.int32), batch_size=4, device='cpu')\n"
        "assert codes[0].shape == (5, 8, 16)\n"
        "try:\n"
        "    pipeline._codes_to_dataframe(codes[0], [['a'] * 8] * 5, 8)\n"
        "except ImportError:\n"
        "    sys.exit(0)\n"
        "sys.exit(1)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_long_context_big_batch_and_experiments_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """The blockwise harvest, the big-batch trainer, its store input and the
    experiments' device halves and CLIs run on the card unless given the
    CPU (no silent fallback)."""
    from sparse_coding__tpu_torch import experiments as ex
    from sparse_coding__tpu_torch.data.activations import harvest_to_device, make_activation_dataset
    from sparse_coding__tpu_torch.data.chunks import load_store_dataset, save_chunk
    from sparse_coding__tpu_torch.experiments import check_l0_tokens, interp_moment_corrs, investigate, pca_perplexity
    from sparse_coding__tpu_torch.lm import LMConfig, init_params
    from sparse_coding__tpu_torch.models import FunctionalTiedSAE
    from sparse_coding__tpu_torch.train.big_batch import train_big_batch

    cfg = LMConfig(arch="neox", n_layers=1, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32)
    params = init_params(0, cfg, device="cpu")
    tokens = np.zeros((4, 8), np.int32)
    save_chunk(tmp_path / "store", 0, np.zeros((8, 16), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = dict(activation_size=16, n_dict_components=32, l1_alpha=1e-3)
    calls = [
        lambda: make_activation_dataset(params, cfg, tokens, tmp_path / "h", [0], ["residual"], attn="blockwise"),
        lambda: next(harvest_to_device(params, cfg, tokens, [0], ["residual"], attn="blockwise")),
        lambda: train_big_batch(FunctionalTiedSAE, hp, np.zeros((8, 16), np.float32), 4, 1, 0),
        lambda: train_big_batch(FunctionalTiedSAE, hp, tmp_path / "store", 4, 1, 0),
        lambda: load_store_dataset(tmp_path / "store"),
        lambda: ex.pca_perplexity_scores(params, cfg, (0, "residual"), tokens, np.zeros((8, 16)), {}),
        lambda: ex.random_feature_diversity(tmp_path / "r", n=8, d=4),
        lambda: pca_perplexity.main(["--dicts", "a", "--labels", "a", "--chunk", "c", "--tokens", "t",
                                     "--lm-params", "p", "--layer", "0"]),
        lambda: check_l0_tokens.main(["--lm-params", "p", "--dicts", "0:1:a"]),
        lambda: investigate.main(["--smaller", "a:0", "--larger", "b:0"]),
        lambda: interp_moment_corrs.main(["--entries", "a:0:c:r"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_the_port_and_its_device_halves_import_without_matplotlib():
    """The card's machine has no matplotlib: the package, the experiments'
    device halves, the big-batch trainer and the sweep import and run with
    matplotlib made unimportable; an entry point that draws a figure, and
    `plotting` itself, raise `ImportError` naming it."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np, torch\n"
        "import sparse_coding__tpu_torch, sparse_coding__tpu_torch.train.big_batch\n"
        "import sparse_coding__tpu_torch.train.sweep, sparse_coding__tpu_torch.interp.batch\n"
        "from sparse_coding__tpu_torch import experiments as ex\n"
        "from sparse_coding__tpu_torch.models.learned_dict import Rotation\n"
        "d = Rotation(torch.eye(4))\n"
        "params = {'embed': torch.randn(10, 4), 'unembed': torch.randn(10, 4)}\n"
        "assert len(ex.embedding_cosine_scores(params, {0: [('1', d)]})[0]) == 1\n"
        "assert ex.investigate_scores(d, d)[0].shape == (4,)\n"
        "for fn in (lambda: ex.run_embedding_cosine_check(params, {0: [('1', d)]}, 'unused'),\n"
        "           lambda: ex.run_investigate(d, d, 'unused'),\n"
        "           lambda: __import__('sparse_coding__tpu_torch.plotting')):\n"
        "    try:\n"
        "        fn()\n"
        "    except ImportError as e:\n"
        "        assert 'matplotlib' in str(e), e\n"
        "    else:\n"
        "        sys.exit(1)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
