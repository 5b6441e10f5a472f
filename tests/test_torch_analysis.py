"""The port's sclint (`sparse_coding__tpu_torch.analysis`) against the JAX
package's, and the port's own gate.

- (a) On the JAX package's fixtures (`tests/analysis_fixtures/`) the two
  engines give the same ``(rule, line, col)`` findings and the same exit
  codes for the rules whose contract is the same in both (SC000, SC001,
  SC002, SC005, SC006, SC007): the registries they read agree.
- (b) The rules rewritten for torch (SC003 host syncs, SC004 in its
  CUDA-graph and its compile form) fire exactly at the ``# VIOLATION``
  lines of `tests/torch_analysis_fixtures/*_bad.py`, and their clean twins
  are silent.
- (c) The engine's semantics, as `tests/test_analysis.py` pins JAX's.
- (d) The gate: the port and chip_smoke.py lint clean with no baseline.
- (e) The contracts pass; partition coverage classifies each state the JAX
  contract's way, leaf for leaf.
- (f) The mirrored sanitizer and the span tables are pinned against the
  port's modules.

Exit codes are read from ``main()`` in process; one CLI subprocess checks
the ``-m`` entry itself.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from sparse_coding__tpu_torch.analysis import lint_paths, load_baseline
from sparse_coding__tpu_torch.analysis.__main__ import main
from sparse_coding__tpu_torch.analysis.engine import write_baseline
from sparse_coding__tpu_torch.analysis.rules import RULES

pytestmark = pytest.mark.analysis

REPO = Path(__file__).resolve().parents[1]
JAX_FIXTURES = REPO / "tests" / "analysis_fixtures"
FIXTURES = REPO / "tests" / "torch_analysis_fixtures"
SHARED_RULES = ("sc001", "sc002", "sc005", "sc006", "sc007")


def violation_lines(path: Path):
    return [i for i, line in enumerate(path.read_text().splitlines(), start=1) if "# VIOLATION" in line]


def triples(findings):
    return [(f.rule, f.line, f.col) for f in findings]


def run_main(main_fn, capsys, *args):
    rc = main_fn(list(map(str, args)))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def jax_engine(monkeypatch):
    """The JAX package's ``lint_paths`` and ``main``, every call sharing one
    `RepoContext` (its fault-site scan parses the package once, not once a
    call)."""
    from sparse_coding__tpu.analysis import engine as jax_eng
    from sparse_coding__tpu.analysis.__main__ import main as jax_main

    shared = _JAX_CONTEXT.setdefault("ctx", jax_eng.RepoContext())
    monkeypatch.setattr(jax_eng, "RepoContext", lambda: shared)
    return jax_eng.lint_paths, jax_main


_JAX_CONTEXT = {}


# -- (a) the same findings as the JAX engine on its fixtures -------------------

@pytest.mark.parametrize("fixture", [f"{r}_{kind}" for r in SHARED_RULES for kind in ("bad", "clean")] + ["sc000"])
def test_shared_rules_match_the_jax_engine_on_its_fixtures(fixture, tmp_path, capsys, jax_engine):
    jax_lint_paths, jax_main = jax_engine
    if fixture == "sc000":
        path = tmp_path / "broken.py"
        path.write_text("def f(:\n")
    else:
        path = JAX_FIXTURES / f"{fixture}.py"
    got, n = lint_paths([path])
    want, n_jax = jax_lint_paths([path])
    assert triples(got) == triples(want) and n == n_jax == 1
    if fixture.endswith("_bad"):
        assert {f.rule for f in got} == {fixture[:5].upper()}
        assert sorted({f.line for f in got}) == violation_lines(path)
    elif fixture == "sc000":
        assert [f.rule for f in got] == ["SC000"]
    else:
        assert got == []
    rc, _, _ = run_main(main, capsys, path)
    rc_jax, _, _ = run_main(jax_main, capsys, path)
    assert rc == rc_jax == (0 if fixture.endswith("_clean") else 1)


# -- (b) the torch rules on their own fixtures ----------------------------------

@pytest.mark.parametrize("form", ["sc003", "sc004_graph", "sc004_compile"])
def test_torch_rule_fires_exactly_at_its_marked_lines(form, capsys):
    bad = FIXTURES / f"{form}_bad.py"
    expected = violation_lines(bad)
    assert expected, f"{bad} has no # VIOLATION marker"
    findings, _ = lint_paths([bad])
    assert {f.rule for f in findings} == {form[:5].upper()}
    assert [f.line for f in findings] == expected  # one finding a marked line
    assert run_main(main, capsys, bad)[0] == 1


@pytest.mark.parametrize("form", ["sc003", "sc004_graph", "sc004_compile"])
def test_torch_rule_clean_twin_is_silent(form, capsys):
    clean = FIXTURES / f"{form}_clean.py"
    findings, n = lint_paths([clean])
    assert findings == [] and n == 1
    assert run_main(main, capsys, clean)[0] == 0


def test_rule_registry_matches_the_jax_package():
    from sparse_coding__tpu.analysis.rules import RULES as JAX_RULES

    assert sorted(RULES) == sorted(JAX_RULES) == [f"SC00{i}" for i in range(1, 8)]
    for rid, spec in RULES.items():
        assert spec.doc, f"{rid} has no docstring"
        assert spec.scope == JAX_RULES[rid].scope


# -- (c) engine semantics --------------------------------------------------------

def test_suppression_comment_forms(tmp_path):
    # inline, statement-first-line and preceding-comment-line forms all
    # sanction exactly the named rule
    src = tmp_path / "mod.py"
    src.write_text(
        '__sclint_hot_entries__ = ("f",)\n'
        "def f(out):\n"
        "    a = out.sum().item()  # sclint: allow(SC003) inline\n"
        "    # sclint: allow(SC003) preceding comment line\n"
        "    b = out.mean().item()\n"
        "    c = (out.max()\n"
        "         .item())  # sclint: allow(SC001) another rule's allow\n"
        "    d = (  # sclint: allow(SC003) statement's first line\n"
        "        out.min().item())\n"
        "    return a + b + c + d\n"
    )
    findings, _ = lint_paths([src])
    assert triples(findings) == [("SC003", 6, 9)]  # only the unsanctioned sync survives


def test_wrong_rule_in_allow_comment_does_not_suppress(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text(
        '__sclint_hot_entries__ = ("f",)\n'
        "def f(out):\n"
        "    return out.sum().cpu()  # sclint: allow(SC001) wrong rule\n"
    )
    findings, _ = lint_paths([src])
    assert [f.rule for f in findings] == ["SC003"]


def test_allowed_transfer_block_sanctions_its_extent(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text(
        '__sclint_hot_entries__ = ("f",)\n'
        "def f(out, allowed_transfer):\n"
        "    with allowed_transfer():\n"
        "        a = out.sum().item()\n"
        "    return a + out.mean().item()\n"
    )
    assert triples(lint_paths([src])[0]) == [("SC003", 5, 15)]


def test_baseline_round_trip_and_gate_on_new_findings(tmp_path, capsys):
    bad = FIXTURES / "sc003_bad.py"
    findings, _ = lint_paths([bad])
    assert findings
    baseline_file = tmp_path / "baseline.json"
    write_baseline(baseline_file, findings)
    keys = load_baseline(baseline_file)
    assert keys == {f.key for f in findings}
    # grandfathered: the same findings are dropped
    assert lint_paths([bad], baseline=keys)[0] == []
    # but a different finding still fails the gate
    other, _ = lint_paths([FIXTURES / "sc004_graph_bad.py"], baseline=keys)
    assert {f.rule for f in other} == {"SC004"}
    # the CLI's flags: --write-baseline exits 0, --baseline then gates clean
    cli_file = tmp_path / "cli_baseline.json"
    assert run_main(main, capsys, bad, "--write-baseline", cli_file)[0] == 0
    assert load_baseline(cli_file) == keys
    assert run_main(main, capsys, bad, "--baseline", cli_file)[0] == 0
    # the plain-text form: one key a line, comments allowed
    txt = tmp_path / "baseline.txt"
    txt.write_text("# reviewed\n" + "\n".join(sorted(keys)) + "\n")
    assert load_baseline(txt) == keys


def test_cli_json_output(capsys):
    rc, out, _ = run_main(main, capsys, FIXTURES / "sc004_compile_bad.py", "--json")
    assert rc == 1
    doc = json.loads(out)
    assert doc["files_scanned"] == 1 and doc["contracts"] == []
    assert [f["rule"] for f in doc["findings"]] == ["SC004", "SC004"]
    assert all(f["key"].startswith("SC004:") and f["path"].endswith("sc004_compile_bad.py") for f in doc["findings"])


def test_cli_exit_3_when_no_files(tmp_path, capsys):
    assert run_main(main, capsys, tmp_path)[0] == 3


def test_cli_select_limits_rules(capsys):
    bad = JAX_FIXTURES / "sc006_bad.py"
    assert run_main(main, capsys, bad, "--select", "SC006")[0] == 1
    assert run_main(main, capsys, bad, "--select", "SC001")[0] == 0
    assert run_main(main, capsys, bad, "--select", "SC999")[0] == 2


def test_cli_list_rules(capsys):
    rc, out, _ = run_main(main, capsys, "--list-rules")
    assert rc == 0 and [line.split()[0] for line in out.splitlines()] == sorted(RULES)


def test_the_module_entry_point_runs_as_a_subprocess():
    proc = subprocess.run([sys.executable, "-m", "sparse_coding__tpu_torch.analysis", "--select", "SC003",
                           str(FIXTURES / "sc003_bad.py"), "--json"], capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert [f["line"] for f in json.loads(proc.stdout)["findings"]] == violation_lines(FIXTURES / "sc003_bad.py")


# -- (d) the gate ----------------------------------------------------------------

def test_port_and_chip_smoke_are_clean(capsys):
    """The acceptance gate: no finding over the port and chip_smoke.py, with
    no baseline file. A new finding is fixed or sanctioned in place, with
    its reason."""
    rc, out, err = run_main(main, capsys, REPO / "sparse_coding__tpu_torch", REPO / "chip_smoke.py")
    assert rc == 0, out + err
    assert not list(REPO.glob("*baseline*.json"))


def test_a_new_sync_in_the_train_loop_fails_the_gate(tmp_path):
    """SC003 watches `train/loop.py::ensemble_train_loop` by path: a per-step
    ``.item()`` added there is a finding (a copy of the module under the
    same relative path)."""
    src = (REPO / "sparse_coding__tpu_torch" / "train" / "loop.py").read_text()
    marker = "def ensemble_train_loop("
    assert marker in src
    dst = tmp_path / "sparse_coding__tpu_torch" / "train" / "loop.py"
    dst.parent.mkdir(parents=True)
    seeded = src.replace(marker, "def _per_step_probe(losses):\n    return losses.sum().item()\n\n\n" + marker, 1)
    body = seeded.index(marker)
    colon = seeded.index(":\n", seeded.index(")", body)) + 2
    doc_end = seeded.index('"""', seeded.index('"""', colon) + 3) + 3
    seeded = seeded[:doc_end] + "\n    _per_step_probe(torch.zeros(1))" + seeded[doc_end:]
    dst.write_text(seeded)
    findings, _ = lint_paths([dst], select={"SC003"})
    assert [f.rule for f in findings] == ["SC003"]
    assert "ensemble_train_loop" in findings[0].message


# -- (e) the contracts -------------------------------------------------------------

def test_contracts_pass():
    from sparse_coding__tpu_torch.analysis.contracts import run_contracts

    results = {c.name: c for c in run_contracts()}
    assert set(results) == {"partition-coverage", "span-tables", "flags-docs"}
    for c in results.values():
        assert c.ok, c.render()
    n, total = results["partition-coverage"].summary.split(" ")[0].split("/")
    assert n == total  # every leaf of every state classified


def _jax_state(tx):
    """The JAX contract's abstract ensemble state (`jax.eval_shape` of the
    constructors `Ensemble` uses) with optimizer ``tx``."""
    import jax
    import jax.numpy as jnp

    from sparse_coding__tpu import ensemble as jens
    from sparse_coding__tpu.models.sae import FunctionalTiedSAE

    def build(key):
        models = [FunctionalTiedSAE.init(k, 64, 128, l1_alpha=1e-3) for k in jax.random.split(key, 4)]
        params = jens.stack_pytrees([p for p, _ in models])
        buffers = jens.stack_pytrees([b for _, b in models])
        return jens.EnsembleState(params=params, buffers=buffers, opt_state=jax.vmap(tx.init)(params),
                                  step=jnp.zeros((), jnp.int32))

    return jax.eval_shape(build, jax.random.PRNGKey(0))


def _jax_txs():
    import jax.numpy as jnp
    import optax

    from sparse_coding__tpu.utils import optim as joptim

    return {
        "adam": joptim.adam(1e-3),
        "sgd-trace": optax.sgd(1e-2, momentum=0.9),
        "adam-fp16-mu": joptim.adam(1e-3, mu_dtype=jnp.float16),
        "adam-int8-mu": joptim.adam(1e-3, mu_dtype="int8", nu_dtype="bfloat16"),
    }


# leaves one package's state has and the other's has not, and why
PORT_ONLY = {
    # optax.sgd with a constant rate keeps EmptyState (no count); the port's
    # SgdState keeps the step count its schedules read, constant rate or not
    "sgd-trace": {("opt_state", "count")},
}


@pytest.mark.parametrize("label", ["adam", "sgd-trace", "adam-fp16-mu", "adam-int8-mu"])
def test_partition_coverage_classifies_each_state_as_the_jax_contract(label):
    """JAX's contract leaf for leaf (shape, dtype, spec; trailing Nones of a
    spec dropped, as both packages place the same axes). optax's chained
    ``EmptyState`` (the rate's state) has no leaves, so it pairs with
    nothing: the trees differ there in structure, not in leaves."""
    import jax
    from sparse_coding__tpu.analysis import contracts as jc
    from sparse_coding__tpu.parallel import mesh as jmesh

    from sparse_coding__tpu_torch.analysis import contracts as tc

    optimizer, kwargs = tc.OPTIMIZER_STATES[label]
    rows, problems = tc.classify(tc.ensemble_state(optimizer, kwargs), 4)
    assert problems == []
    state = _jax_state(_jax_txs()[label])
    assert [type(s).__name__ for s in state.opt_state][1:] == ["EmptyState"]
    assert jax.tree.leaves(state.opt_state[1]) == []
    specs = dict(jc._leaf_paths_specs(jmesh.infer_state_specs(
        state, 4, jc._FakeMesh({jmesh.MODEL_AXIS: 4, jmesh.DICT_AXIS: 4}), shard_dict=True)))
    jax_rows = [(path, tuple(leaf.shape), str(leaf.dtype), tuple(specs[path])) for path, leaf in jc._leaf_paths(state)]
    port_rows = [(shape, tuple(spec)) for path, shape, spec in rows if path not in PORT_ONLY.get(label, set())]
    assert len(port_rows) == len(jax_rows) == len(rows) - len(PORT_ONLY.get(label, ()))

    def trim(axes):
        axes = list(axes)
        while axes and axes[-1] is None:
            axes.pop()
        return tuple(axes)

    for (shape, spec), (path, jshape, _, jspec) in zip(port_rows, jax_rows):
        assert shape == jshape and trim(spec) == trim(jspec), (label, path, shape, spec, jspec)
    port_state = tc.ensemble_state(optimizer, kwargs)
    from sparse_coding__tpu_torch.utils.tree import tree_leaves

    port_dtypes = [str(getattr(v, "dtype", "int32")).removeprefix("torch.") for v in tree_leaves(port_state)]
    kept = [d for (path, _, _), d in zip(rows, port_dtypes) if path not in PORT_ONLY.get(label, set())]
    assert kept == [d for _, _, d, _ in jax_rows]


# -- (f) mirrors pinned against the port's modules -----------------------------------

def test_sanitize_metric_pinned_against_the_port_metrics_http():
    from sparse_coding__tpu_torch.analysis.context import RepoContext
    from sparse_coding__tpu_torch.telemetry import metrics_http

    for name in ("serve.queue.depth", "a b/c-d", "slo:window", "weirdéname", "ok_1", "io.retry"):
        assert RepoContext.sanitize_metric(name) == metrics_http._NAME_RE.sub("_", name)
    assert metrics_http._NAME_RE.pattern == r"[^a-zA-Z0-9_:]"


def test_span_tables_match_the_port_module():
    from sparse_coding__tpu_torch.analysis.context import RepoContext
    from sparse_coding__tpu_torch.telemetry import spans

    t = RepoContext().span_tables
    for name in ("GOODPUT_CATEGORIES", "BADPUT_CATEGORIES", "DERIVED_CATEGORIES", "INNER_CATEGORIES"):
        assert t[name] == getattr(spans, name), name


def test_fault_sites_are_the_port_grammar_and_call_sites():
    from sparse_coding__tpu_torch.analysis.context import RepoContext
    from sparse_coding__tpu_torch.utils import faults

    sites = RepoContext().fault_sites
    assert {"chunk_loop", "chunk_read", "step_loop", "checkpoint_commit", "chunk_pair", "serve_loop"} <= sites
    assert set(faults._DEFAULT_SITE.values()) <= sites
    assert [s.site for s in RepoContext().parse_fault_spec("kill:chunk_loop:chunk=1:every=2:times=1;"
                                                           "torn_checkpoint;io_error:chunk_read:times=1")] == [
        "chunk_loop", "checkpoint_commit", "chunk_read"]
