"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless asked for the CPU (no silent fallback)."""

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
    "sparse_coding__tpu_torch.ensemble",
    "sparse_coding__tpu_torch.interop",
    "sparse_coding__tpu_torch.data.activations",
    "sparse_coding__tpu_torch.data.chunks",
    "sparse_coding__tpu_torch.data.integrity",
    "sparse_coding__tpu_torch.data.synthetic",
    "sparse_coding__tpu_torch.data.synthetic_text",
    "sparse_coding__tpu_torch.lm",
    "sparse_coding__tpu_torch.lm.convert",
    "sparse_coding__tpu_torch.lm.model",
    "sparse_coding__tpu_torch.lm.pretrain",
    "sparse_coding__tpu_torch.metrics.standard",
    "sparse_coding__tpu_torch.models",
    "sparse_coding__tpu_torch.models.direct_coef",
    "sparse_coding__tpu_torch.models.fista",
    "sparse_coding__tpu_torch.models.learned_dict",
    "sparse_coding__tpu_torch.models.lista",
    "sparse_coding__tpu_torch.models.pca",
    "sparse_coding__tpu_torch.models.positive",
    "sparse_coding__tpu_torch.models.rica",
    "sparse_coding__tpu_torch.models.sae",
    "sparse_coding__tpu_torch.models.semilinear",
    "sparse_coding__tpu_torch.models.topk",
    "sparse_coding__tpu_torch.ops._build",
    "sparse_coding__tpu_torch.ops._wrap",
    "sparse_coding__tpu_torch.ops.fista_kernel",
    "sparse_coding__tpu_torch.ops.tied_sae_kernel",
    "sparse_coding__tpu_torch.ops.topk_kernel",
    "sparse_coding__tpu_torch.serve",
    "sparse_coding__tpu_torch.serve.engine",
    "sparse_coding__tpu_torch.serve.loadgen",
    "sparse_coding__tpu_torch.serve.registry",
    "sparse_coding__tpu_torch.serve.replicaset",
    "sparse_coding__tpu_torch.serve.router",
    "sparse_coding__tpu_torch.serve.server",
    "sparse_coding__tpu_torch.serve.wire",
    "sparse_coding__tpu_torch.supervise",
    "sparse_coding__tpu_torch.telemetry",
    "sparse_coding__tpu_torch.telemetry.anomaly",
    "sparse_coding__tpu_torch.telemetry.events",
    "sparse_coding__tpu_torch.telemetry.feature_stats",
    "sparse_coding__tpu_torch.telemetry.health",
    "sparse_coding__tpu_torch.telemetry.metrics_http",
    "sparse_coding__tpu_torch.telemetry.profiling",
    "sparse_coding__tpu_torch.telemetry.provenance",
    "sparse_coding__tpu_torch.telemetry.spans",
    "sparse_coding__tpu_torch.telemetry.tracing",
    "sparse_coding__tpu_torch.train.basic_l1_sweep",
    "sparse_coding__tpu_torch.train.checkpoint",
    "sparse_coding__tpu_torch.train.experiments",
    "sparse_coding__tpu_torch.train.loop",
    "sparse_coding__tpu_torch.train.preemption",
    "sparse_coding__tpu_torch.trace",
    "sparse_coding__tpu_torch.train.sweep",
    "sparse_coding__tpu_torch.utils.config",
    "sparse_coding__tpu_torch.utils.device",
    "sparse_coding__tpu_torch.utils.faults",
    "sparse_coding__tpu_torch.utils.flags",
    "sparse_coding__tpu_torch.utils.logging",
    "sparse_coding__tpu_torch.utils.manifest",
    "sparse_coding__tpu_torch.utils.optim",
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
                                          REPO / "tests" / "_torch_harvest_worker.py"]
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
