"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless asked for the CPU (no silent fallback)."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "sparse_coding__tpu_torch"
SLICE_MODULES = [
    "sparse_coding__tpu_torch",
    "sparse_coding__tpu_torch.ensemble",
    "sparse_coding__tpu_torch.interop",
    "sparse_coding__tpu_torch.data.chunks",
    "sparse_coding__tpu_torch.data.synthetic",
    "sparse_coding__tpu_torch.metrics.standard",
    "sparse_coding__tpu_torch.models.learned_dict",
    "sparse_coding__tpu_torch.models.sae",
    "sparse_coding__tpu_torch.models.topk",
    "sparse_coding__tpu_torch.ops._build",
    "sparse_coding__tpu_torch.ops._wrap",
    "sparse_coding__tpu_torch.ops.tied_sae_kernel",
    "sparse_coding__tpu_torch.ops.topk_kernel",
    "sparse_coding__tpu_torch.train.checkpoint",
    "sparse_coding__tpu_torch.train.loop",
    "sparse_coding__tpu_torch.utils.device",
    "sparse_coding__tpu_torch.utils.manifest",
    "sparse_coding__tpu_torch.utils.optim",
    "sparse_coding__tpu_torch.utils.precision",
]


def test_import_leaves_jax_and_the_jax_package_out():
    """In a fresh interpreter: the test process itself already holds jax."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparse_coding__tpu' or m.startswith('sparse_coding__tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_name_jax_or_the_jax_package():
    """Catches lazy imports the subprocess check cannot see."""
    pattern = re.compile(r"^\s*(import jax|from jax)|sparse_coding__tpu\.", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tests" / "_torch_moments.py"]
    assert len(files) > 10
    offenders = [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())]
    assert offenders == []


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.data.chunks import ChunkStore
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}], activation_size=32, n_dict_components=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RandomDatasetGenerator(32, 64, 16, 4, 0.99, False, key=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChunkStore(tmp_path).load(0)
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
