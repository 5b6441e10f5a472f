"""The port's public surface against the JAX package's, module by module.

Each JAX module's ``__all__`` (else its public top-level defs, read by AST)
must be found in the port's counterpart module (its top-level bindings, its
``__all__`` and the lazy exports that lists), except the names `OWED_NOTHING`
excuses, each with its reason. Modules the port owes nothing are listed in
`MODULES_OWED_NOTHING`. The names this check made the port add are then held
to the JAX package's on the CPU: the two Args classes field for field, the
synthetic sampler's draws, the chunk manifest byte layout and the flags'
docs helpers.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "sparse_coding__tpu"
PORT_PKG = REPO / "sparse_coding__tpu_torch"

MODULES_OWED_NOTHING = {
    "ops/fista_pallas.py": "the Pallas FISTA solve; its port is ops/fista_kernel.py + ops/csrc/fista.cu",
    "utils/bench_common.py": "the TPU peak table of the JAX bench.py; the port's H100 bounds live in chip_smoke.py",
    "utils/compile_cache.py": "XLA's persistent compile cache; the port compiles its kernels with nvcc per run",
}

OWED_NOTHING = {
    # the jit cost bridge: XLA's compile and cost listeners have no torch
    # counterpart; a captured step's cost is `Ensemble.step_cost`
    "telemetry/__init__.py": {"compiled_cost_fields", "jit_cost_fields", "tracked_jit"},
    "telemetry/events.py": {"tracked_jit"},
    "telemetry/profiling.py": {"compiled_cost_fields", "jit_cost_fields", "monitoring_suppressed",
                               # jax device.memory_stats(); the port reads torch.cuda.memory_stats in hbm_watermarks
                               "device_memory_stats"},
    # the jitted step builders: the port's steps are `Ensemble.step_batch`,
    # `step_scan` and `step_scan_idx`, replayed as CUDA graphs; and a typing
    # Protocol nothing checks against (the port's signatures are classes with
    # the same static methods)
    "ensemble.py": {"make_ensemble_step", "make_ensemble_multi_step", "make_ensemble_multi_step_idx",
                    "DictSignature"},
    # a jax.jit cache of the edited forward; the port runs
    # `mean_reconstruction_loss` eagerly
    "metrics/intervention.py": {"jitted_reconstruction_loss"},
    # the TPU gates (VMEM fits, on_tpu, the accum-kernel switch): the port's
    # counterparts are `shapes_supported`, `fused_batch_supported`, the
    # device of the tensors and `utils.flags.recompute_code`
    "ops/tied_sae_kernel.py": {"recompute_code_default", "on_tpu", "accum_path_supported", "adam_step_supported",
                               "accum_fits", "fused_fits"},
    "ops/topk_kernel.py": {"topk_fwd_fits", "topk_batch_supported"},
    # an optax GradientTransformation; the port's compressed storage lives in
    # `utils.optim.Adam` itself
    "utils/optim.py": {"scale_by_adam_compressed"},
}


def _jax_public(path: Path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _port_bound(path: Path):
    """Every top-level binding of a module (defs, classes, assignments,
    imports, also under ``if``/``try``) and the names its ``__all__`` lists
    (lazy exports resolved by a module ``__getattr__``)."""
    tree = ast.parse(path.read_text())
    out = set()
    for top in tree.body:
        for node in [top] + (list(ast.walk(top)) if isinstance(top, (ast.If, ast.Try)) else []):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                out |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
                if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                    out |= set(ast.literal_eval(node.value))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def test_every_public_jax_name_is_ported_or_excused():
    missing, stale = {}, []
    for jax_path in sorted(JAX_PKG.rglob("*.py")):
        rel = jax_path.relative_to(JAX_PKG).as_posix()
        if "__pycache__" in rel or rel in MODULES_OWED_NOTHING:
            continue
        port_path = PORT_PKG / rel
        assert port_path.exists(), f"{rel}: no port module and not owed nothing"
        names, bound = _jax_public(jax_path), _port_bound(port_path)
        excused = OWED_NOTHING.get(rel, set())
        stale += [f"{rel}::{n}" for n in excused if n in bound or n not in names]
        gap = sorted(names - bound - excused)
        if gap:
            missing[rel] = gap
    assert missing == {}, f"public JAX names the port lacks: {missing}"
    assert stale == [], f"excused names that are ported or gone from JAX: {stale}"
    for rel in MODULES_OWED_NOTHING:
        assert (JAX_PKG / rel).exists() and not (PORT_PKG / rel).exists(), rel


def test_lazy_exports_resolve():
    import sparse_coding__tpu_torch.serve as serve

    for name in serve.__all__:
        assert getattr(serve, name).__name__ == name


@pytest.mark.parametrize("name", ["ErasureArgs", "InvestigateArgs"])
def test_args_classes_match_the_jax_package(name):
    from sparse_coding__tpu.utils import config as jconfig

    from sparse_coding__tpu_torch.utils import config as tconfig

    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    fields = [(f.name, f.default) for f in dataclasses.fields(j)]
    assert [(f.name, f.default) for f in dataclasses.fields(t)] == fields
    assert isinstance(t, tconfig.BaseArgs)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # the CLI overlay of BaseArgs works on them as on the others
    assert type(t).from_cli(["--layer", "3"]).layer == 3


def test_sample_rand_dataset_is_the_generators_draw_and_the_jax_distribution():
    """The port's `sample_rand_dataset` is what `RandomDatasetGenerator`
    draws (the same generator state gives the same bits); against JAX's on
    the same planted features and probabilities its codes fire at the same
    rates and its data has the same moments (the two RNGs differ)."""
    import jax
    import jax.numpy as jnp
    from sparse_coding__tpu.data.synthetic import sample_rand_dataset as jax_sample

    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator, sample_rand_dataset

    gen = RandomDatasetGenerator(16, 64, 4096, 8, 0.99, False, key=3, device="cpu")
    state = gen._gen.get_state()
    batch = next(gen)
    g2 = torch.Generator().set_state(state)
    codes, data = sample_rand_dataset(g2, gen.feats, gen.component_probs, 64, 4096)
    assert torch.equal(data, batch)
    assert codes.shape == (4096, 64) and bool(((codes >= 0) & (codes < 1)).all())
    j_codes, j_data = jax_sample(jax.random.PRNGKey(0), jnp.asarray(gen.feats.numpy()),
                                 jnp.asarray(gen.component_probs.numpy()), 64, 4096)
    rate_t = (codes > 0).float().mean(0).numpy()
    rate_j = np.asarray(j_codes > 0).mean(0)
    np.testing.assert_allclose(rate_t, gen.component_probs.numpy(), atol=0.02)
    np.testing.assert_allclose(rate_j, gen.component_probs.numpy(), atol=0.02)
    np.testing.assert_allclose(data.pow(2).mean().item(), float(jnp.mean(j_data ** 2)), rtol=0.1)


def test_write_chunk_manifest_matches_the_jax_package(tmp_path):
    """The same files give the same manifest, key for key (``created_at``
    aside); each package reads and verifies the other's."""
    from sparse_coding__tpu.data import integrity as jint

    from sparse_coding__tpu_torch.data import integrity as tint

    out = {}
    for name, mod in (("jax", jint), ("port", tint)):
        folder = tmp_path / name
        folder.mkdir()
        np.save(folder / "0.npy", np.arange(12, dtype=np.float16).reshape(3, 4))
        path = mod.write_chunk_manifest(folder, 0, {"0.npy": folder / "0.npy"}, 3, (3, 4), "float16",
                                        provenance={"producer": "test"})
        out[name] = json.loads(Path(path).read_text())
        assert list(out[name]) == ["format", "chunk", "created_at", "rows", "shape", "store_dtype", "files",
                                   "provenance"]
        out[name].pop("created_at")
    assert out["jax"] == out["port"]
    assert jint.verify_chunk(tmp_path / "port", 0, depth="digest") == (True, "ok")
    assert tint.verify_chunk(tmp_path / "jax", 0, depth="digest") == (True, "ok")


def test_flags_docs_helpers(tmp_path, monkeypatch, capsys):
    """The generated table lists the flags JAX's does, with their kinds and
    defaults; the README's copy is current, `update_docs` rewrites a stale
    copy between the markers and the CLI's exit codes are JAX's."""
    from sparse_coding__tpu.utils import flags as jflags

    from sparse_coding__tpu_torch.utils import flags as tflags

    def cells(table):
        rows = [r.split(" | ") for r in table.splitlines()[2:]]
        return [(r[0], r[1], r[2]) for r in rows]

    assert cells(tflags.markdown_table()) == cells(jflags.markdown_table())
    assert tflags.DOCS_BEGIN != jflags.DOCS_BEGIN and tflags.DOCS_END != jflags.DOCS_END
    assert set(tflags.__all__) == set(jflags.__all__)
    assert tflags.check_docs()
    doc = tmp_path / "README.md"
    doc.write_text(f"intro\n{tflags.DOCS_BEGIN}\n| stale |\n{tflags.DOCS_END}\ntail\n")
    monkeypatch.setattr(tflags, "_docs_path", lambda: doc)
    assert not tflags.check_docs()
    assert tflags._main(["--check-docs"]) == 1
    assert tflags.update_docs() and tflags.check_docs()
    assert doc.read_text().startswith("intro\n") and doc.read_text().endswith("\ntail\n")
    assert tflags._main(["--check-docs"]) == 0 and tflags._main(["--update-docs"]) == 0
    assert "already up to date" in capsys.readouterr().out
