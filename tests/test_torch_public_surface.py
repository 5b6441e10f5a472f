"""The port's public surface against the JAX package's, module by module.

Each JAX module's ``__all__`` (else its public top-level defs, read by AST)
must be found in the port's counterpart module (its top-level bindings, its
``__all__`` and the lazy exports that lists), except the names `OWED_NOTHING`
excuses, each with its reason. Modules the port owes nothing are listed in
`MODULES_OWED_NOTHING`. Each package ``__init__``'s re-exports (the names it
imports and assigns) must be bound by the port's, except `INIT_EXCUSED`.
Each public function's parameter names, in order, and each public class's
public methods (its own, inherited within the package, or bound in its
body as ``name = staticmethod(f)``) with theirs, must be the JAX package's,
after the renames and drops every module shares (`JAX_ONLY_PARAMS`,
`PORT_ONLY_PARAMS`, `RENAMED_PARAMS`), except the entries of
`SIGNATURES_EXCUSED`, each with its reason; an excuse that no longer
matches a difference fails the check. The names this check made the port
add are then held to the JAX package's on the CPU: the two Args classes
field for field, the synthetic sampler's draws, the chunk manifest byte
layout and the flags' docs helpers; the re-exports, `TraceTrigger`'s
anomaly keywords, the chunk store's centring, `uncenter`, `to_device` and
the train loop's ``fista_update`` against JAX's functions.
"""

import ast
import dataclasses
import importlib
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


# names a JAX package `__init__` re-exports that the port's does not bind
INIT_EXCUSED = {
    # the jitted step factory and the typing Protocol (as `OWED_NOTHING`'s "ensemble.py")
    "__init__.py": {"DictSignature": "a typing Protocol nothing checks against",
                    "make_ensemble_step": "the jitted step factory; the port steps through `Ensemble`"},
    # JAX binds the FISTA loop over the module's name; the port keeps the
    # module (`from sparse_coding__tpu_torch.models import fista` is the
    # module, as chip_smoke.py and the tests import it), the loop is
    # `models.fista.fista`
    "models/__init__.py": {"fista": "the port keeps `models.fista` the module; the loop is `models.fista.fista`"},
    "ops/__init__.py": {"fista_pallas": "the Pallas solve; its port is K_f behind `fista_solve`",
                        "on_tpu": "the TPU gate; the port's route is the tensors' device",
                        "pallas_fits": "the TPU's VMEM gate; the port's is `ops.fista_kernel.shapes_supported`"},
    "telemetry/__init__.py": {name: "the jit cost bridge (as `OWED_NOTHING`'s telemetry/__init__.py)"
                              for name in ("compiled_cost_fields", "jit_cost_fields", "tracked_jit")},
    # JAX binds the drivers over their modules' names; the port keeps the
    # modules (its docstring says so), the functions are `sweep.sweep` and
    # `basic_l1_sweep.basic_l1_sweep`
    "train/__init__.py": {"sweep": "the port keeps `train.sweep` the module (the function is `sweep.sweep`)",
                          "basic_l1_sweep": "the port keeps `train.basic_l1_sweep` the module"},
}

# parameters every JAX signature may have and the port's lack, with reasons
JAX_ONLY_PARAMS = {
    "interpret": "Pallas interpret mode; the port's plain versions run on CPU tensors",
    "batch_tile": "a Pallas tile size; the CUDA sources fix their tiles",
    "dict_tile": "a Pallas tile size; the CUDA sources fix their tiles",
    "force_accum": "the TPU's batch-tiled accumulating kernel; every K2 block walks the whole batch",
    "donate": "XLA buffer donation",
    "sharding": "a jax Sharding; the port places tensors with `device=`",
    "devices": "a jax device list; the port's mesh is torch.distributed's ranks",
    "install_jax_listeners": "jax.monitoring's compile listeners",
    "use_pallas": "the Pallas or XLA route; the port's route is the tensors' device",
    "create_perfetto_link": "jax.profiler's Perfetto link; torch.profiler writes a Chrome trace",
    "both": "jax.transfer_guard's host-to-device direction; the port audits device-to-host syncs",
}
# parameters the port adds everywhere, with reasons
PORT_ONLY_PARAMS = {
    "device": "the port's entry points run on the card unless the caller passes device='cpu'",
}
# JAX's name -> the port's, wherever it stands
RENAMED_PARAMS = {
    "key": ({"generator", "gen"}, "a jax.random key becomes a torch.Generator"),
}

# "module::qualname": why its signature differs from JAX's (or why the
# port lacks the method)
SIGNATURES_EXCUSED = {
    "ensemble.py::Ensemble.compiled_cost": "the jit cost bridge; a captured step's cost is `Ensemble.step_cost`",
    "ensemble.py::Ensemble.state_template": "an orbax restore template of live sharded arrays; the port "
                                            "restores with `from_state(sd, mesh=)`",
    "ensemble.py::Ensemble.from_state": "`tx` is an optax transformation (the port rebuilds its optimizer from "
                                        "the recorded name and kwargs); `mesh` and `shard_dict` restore a "
                                        "rank's slice",
    "ensemble.py::Ensemble.step_scan_idx": "`per_model` batches, as `step_scan` takes them",
    "lm/ring_attention.py::ring_attention": "`mesh`: JAX reads the ambient mesh; torch has none",
    "lm/ring_attention.py::ulysses_attention": "`mesh`: JAX reads the ambient mesh; torch has none",
    "telemetry/multihost.py::comparable_fingerprint": "`mesh`: JAX reads the ambient mesh; torch has none",
    "telemetry/multihost.py::check_desync": "`mesh`: JAX reads the ambient mesh; torch has none",
    "train/big_batch.py::make_big_batch_step": "`mesh`: JAX reads the ambient mesh; torch has none",
    "models/fista.py::quadratic_basis_update": "`row_sum`, `n_rows`: the dict-cut shards' sums (JAX's "
                                               "psum inside the mesh)",
    "models/fista.py::dictionary_update": "`row_sum`, `n_rows`: the dict-cut shards' sums (JAX's psum "
                                          "inside the mesh)",
    "models/topk.py::TopKEncoderApprox.bind_static": "specializes JAX's step on the TPU's approximate top-k "
                                                     "recall; the port's selection is exact",
    "serve/engine.py::EncodeEngine.encode_naive": "`bucket`: the padded size a CPU row's bits depend on "
                                                  "(ROADMAP C, serving)",
    "serve/server.py::attach_subject_from_spec": "`tokenize`: the subject's tokenizer, which JAX's loads "
                                                 "from the hub inside",
    "telemetry/profiling.py::roofline_summary": "`peak_tflops`, `hbm_gbps`: the port's peak table is by card",
    "train/checkpoint.py::save_checkpoint_tree": "`shards`: per-rank files of a sharded state",
    "train/sweep.py::log_sweep_metrics": "`images`: the figures, drawn on a host with matplotlib",
    "utils/config.py::BaseArgs.jnp_dtype": "the jnp dtype; the port's is `BaseArgs.torch_dtype`",
    "utils/optim.py::quantize_rows_stochastic": "takes the random bits (the counter hash) for `key`",
    "utils/optim.py::stochastic_round": "takes the random bits (the counter hash) for `key` and rounds to "
                                        "bf16 only",
}


def _params(fn):
    """A def's parameter names in order (``*args``/``**kw`` marked), the
    shared renames applied and the shared drops left out."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += [x.arg for x in a.kwonlyargs] + (["**" + a.kwarg.arg] if a.kwarg else [])
    out = []
    for n in names:
        if n in JAX_ONLY_PARAMS or n in PORT_ONLY_PARAMS:
            continue
        out.append(next((j for j, (ported, _) in RENAMED_PARAMS.items() if n in ported), n))
    return out


class _Package:
    """A package's modules read by AST: each module's top-level defs and
    classes, and the names it imports from the package (resolved to their
    defining module, so inherited methods and ``name = staticmethod(f)``
    bindings are found)."""

    def __init__(self, root: Path, name: str):
        self.root, self.name, self._mods = root, name, {}

    def module(self, rel: str):
        if rel not in self._mods:
            tree = ast.parse((self.root / rel).read_text())
            defs = {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}
            imports = {}
            for n in tree.body:
                if isinstance(n, ast.ImportFrom) and n.module and n.module.startswith(self.name + "."):
                    path = n.module[len(self.name) + 1:].replace(".", "/")
                    for a in n.names:
                        imports[a.asname or a.name] = (f"{path}.py" if (self.root / f"{path}.py").exists()
                                                       else f"{path}/__init__.py", a.name)
            self._mods[rel] = (defs, imports)
        return self._mods[rel]

    def lookup(self, rel: str, name: str):
        defs, imports = self.module(rel)
        if name in defs:
            return rel, defs[name]
        if name in imports and (self.root / imports[name][0]).exists():
            return self.lookup(*imports[name])
        return rel, None

    def methods(self, rel: str, cls: ast.ClassDef):
        """{public method or __init__: its def}, own first, then each base's."""
        out = {}
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                value = node.value
                if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) and value.args:
                    value = value.args[0]  # staticmethod(f) / classmethod(f)
                if isinstance(value, ast.Name):
                    fn = self.lookup(rel, value.id)[1]
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out[node.targets[0].id] = fn
        for base in cls.bases:
            if isinstance(base, ast.Name):
                brel, bcls = self.lookup(rel, base.id)
                if isinstance(bcls, ast.ClassDef):
                    out = {**self.methods(brel, bcls), **out}
        return {k: v for k, v in out.items() if not k.startswith("_") or k == "__init__"}


def _init_exports(path: Path):
    """What a package ``__init__`` binds from its imports and assignments
    (public names and ``__version__``)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_") or n == "__version__"}


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


def test_every_init_reexport_is_ported_or_excused():
    """Each JAX package `__init__`'s imported and assigned public names are
    bound by the port's (an import, an assignment, or a lazy export its
    ``__all__`` lists)."""
    missing, stale = {}, []
    for jax_path in sorted(JAX_PKG.rglob("__init__.py")):
        rel = jax_path.relative_to(JAX_PKG).as_posix()
        names, bound = _init_exports(jax_path), _port_bound(PORT_PKG / rel)
        excused = INIT_EXCUSED.get(rel, {})
        stale += [f"{rel}::{n}" for n in excused if n in bound or n not in names]
        gap = sorted(names - bound - set(excused))
        if gap:
            missing[rel] = gap
    assert missing == {}, f"JAX re-exports the port lacks: {missing}"
    assert stale == [], f"excused re-exports that are ported or gone from JAX: {stale}"


def test_every_public_signature_is_jaxs_or_excused():
    """Each public JAX function and each public method of a public JAX
    class (``__init__`` included): the port's counterpart exists and takes
    the same parameter names in the same order, after the shared renames
    and drops."""
    jax_pkg, port_pkg = _Package(JAX_PKG, "sparse_coding__tpu"), _Package(PORT_PKG, "sparse_coding__tpu_torch")
    differ, seen = {}, set()
    for jax_path in sorted(JAX_PKG.rglob("*.py")):
        rel = jax_path.relative_to(JAX_PKG).as_posix()
        if "__pycache__" in rel or rel in MODULES_OWED_NOTHING:
            continue
        jdefs, _ = jax_pkg.module(rel)
        for name, node in jdefs.items():
            if name.startswith("_") or name in OWED_NOTHING.get(rel, set()):
                continue
            prel, pnode = port_pkg.lookup(rel, name)
            if isinstance(node, ast.ClassDef):
                if not isinstance(pnode, ast.ClassDef):
                    continue  # a class the port binds otherwise: the name test holds it
                pmethods = port_pkg.methods(prel, pnode)
                # the class's own methods (an inherited one is held where it is defined)
                pairs = [(f"{name}.{m}", fn, pmethods.get(m)) for m, fn in jax_pkg.methods(rel, node).items()
                         if fn in node.body]
            elif isinstance(pnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
                pairs = [(name, node, pnode)]
            else:
                continue
            for qual, jfn, pfn in pairs:
                key = f"{rel}::{qual}"
                if pfn is None:
                    differ[key] = "missing"
                elif _params(jfn) != _params(pfn):
                    differ[key] = f"JAX {_params(jfn)}, port {_params(pfn)}"
                seen.add(key)
    unexcused = {k: v for k, v in differ.items() if k not in SIGNATURES_EXCUSED}
    assert unexcused == {}, f"signatures that differ from JAX's: {unexcused}"
    stale = sorted(k for k in SIGNATURES_EXCUSED if k not in differ)
    assert stale == [], f"excused signatures that now match JAX's (or are gone): {stale}"
    assert len(seen) > 400  # the walk saw the packages


def test_reexports_resolve_to_the_port_s_objects():
    """`from … import` of each re-export added for JAX's form gives the
    port's object, and loading `ops` builds or loads no CUDA library."""
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch import ops, train, utils
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops.fista_kernel import fista_solve
    from sparse_coding__tpu_torch.utils import config, logging, trace as trace_fn
    from sparse_coding__tpu_torch.utils.trace import trace

    assert pkg.__version__ == "0.1.0" and pkg.stack_pytrees is __import__(
        "sparse_coding__tpu_torch.ensemble", fromlist=["x"]).stack_pytrees
    assert {"optim_str_to_func", "stack_pytrees", "unstack_pytree"} <= set(pkg.__all__)
    for name in utils.__all__:
        assert getattr(utils, name) is getattr(config if name.endswith("Args") else
                                               logging if name in ("MetricLogger", "format_hyperparam_val",
                                                                   "make_hyperparam_name") else
                                               importlib.import_module("sparse_coding__tpu_torch.utils.trace"),
                                               name)
    assert trace_fn is trace  # as in JAX's package: `utils.trace` is the window, not its module
    assert train.format_hyperparam_val(1e-3) == "1.00E-03" and train.format_hyperparam_val(3) == "3"
    assert ops.fista_solve is fista_solve and _build._LIBS == {}

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
