"""The port's lineage graph (`telemetry/provenance.py`, the `lineage` shim)
against the JAX package's, on the CPU: `tests/test_lineage.py`'s cases run
against the port, the chaos chain included (corrupt -> scrub quarantine ->
blast names the export and the live generation -> check exits 1 -> exact
repair -> check exits 0), and both packages' graphs are compared whole over
the same roots. Outputs are compared exactly (text and exit codes); the
port's artifacts (a `basic_l1_sweep` run's checkpoints, exports and
events) join the graph by the same digests.
"""

import contextlib
import importlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.data.chunks import chunk_path, generate_synthetic_chunks
from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator
from sparse_coding__tpu_torch.telemetry.provenance import (
    build_graph,
    config_digest,
    export_digest,
    main as lineage_main,
    manifest_files_digest,
    producer_identity,
    verify_graph,
)

REPO = Path(__file__).resolve().parents[1]
GOLDEN_LINEAGE = REPO / "tests" / "golden" / "lineage_run"
TRACE = "feed5eedfeed5eedfeed5eedfeed5eed"  # pinned in the fixture


def _jax(name="telemetry.provenance"):
    return importlib.import_module(f"sparse_coding__tpu.{name}")


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# -- digests & identity --------------------------------------------------------

def test_config_digest_canonical_and_jax_equal():
    assert config_digest({"b": 1, "a": 2}) == config_digest({"a": 2, "b": 1})
    assert config_digest({"a": 1}) != config_digest({"a": 2})
    assert len(config_digest({"a": Path("/x")})) == 16  # default=str leaves
    for cfg in ({"b": 1, "a": 2}, {"a": Path("/x"), "l": [1, 2.5, None]}, {}):
        assert config_digest(cfg) == _jax().config_digest(cfg)


def test_manifest_files_digest_ignores_restamp():
    files = {"0.npy": {"bytes": 10, "sha256": "ab" * 32}}
    assert manifest_files_digest(files) == manifest_files_digest(dict(files))
    assert manifest_files_digest({}) is None
    assert manifest_files_digest(files) == _jax().manifest_files_digest(files)


def test_producer_identity_partial_fields():
    ident = producer_identity(config={"x": 1})
    assert ident["format"] == 1 and "fingerprint" not in ident
    fp = {"git_sha": "g", "jax": "0.6", "backend": "cpu", "device_kind": "cpu", "device_count": 8}
    full = producer_identity(config={"x": 1}, fingerprint=fp, source_checkpoint="c" * 16, run_dir="/r")
    assert full == _jax().producer_identity(config={"x": 1}, fingerprint=fp, source_checkpoint="c" * 16, run_dir="/r")
    # the port's fingerprint names torch where JAX's names jax
    port = producer_identity(fingerprint={"git_sha": "g", "torch": "2.5", "backend": "cuda", "device_kind": "H100"})
    assert port["fingerprint"] == {"git_sha": "g", "torch": "2.5", "backend": "cuda", "device_kind": "H100"}


# -- golden fixture: legacy manifest-only reconstruction -----------------------

@pytest.mark.parametrize("argv,expected", [
    (["explain", TRACE], "expected_explain.md"),
    (["blast", "chunk:store#0"], "expected_blast.md"),
    (["check"], "expected_check.txt"),
])
def test_golden_outputs_byte_pinned(argv, expected):
    rc, out = _run(lineage_main, argv + [str(GOLDEN_LINEAGE)])
    assert rc == 0
    assert out == (GOLDEN_LINEAGE / expected).read_text()


def test_golden_graph_json_schema_and_jax_equal():
    rc, out = _run(lineage_main, ["graph", "--json", str(GOLDEN_LINEAGE)])
    assert rc == 0
    got = json.loads(out)
    types = {n["type"] for n in got["nodes"]}
    assert {"traced-response", "registry-generation", "dict", "export", "checkpoint", "training-run", "store",
            "chunk", "harvest-run"} <= types
    assert {"contains", "derived-from", "resumed-from"} <= {e["kind"] for e in got["edges"]}
    assert _run(lineage_main, ["graph", str(GOLDEN_LINEAGE)]) == _run(_jax().main, ["graph", str(GOLDEN_LINEAGE)])
    assert got == json.loads(_run(_jax().main, ["graph", "--json", str(GOLDEN_LINEAGE)])[1])


def test_cli_exit_codes_for_bad_inputs(tmp_path):
    assert _run(lineage_main, ["check", str(tmp_path / "nope")])[0] == 3
    (tmp_path / "empty").mkdir()
    assert _run(lineage_main, ["check", str(tmp_path / "empty")])[0] == 3
    assert _run(lineage_main, ["explain", "no-such-artifact", str(GOLDEN_LINEAGE)])[0] == 2


def test_resolve_accepts_digest_prefix_and_path():
    g = build_graph([GOLDEN_LINEAGE])
    nid = "export:run/learned_dicts.pkl"
    dig = g.nodes[nid]["digest"]
    assert g.resolve(dig[:10]) == nid
    assert g.resolve(str(GOLDEN_LINEAGE / "run" / "learned_dicts.pkl")) == nid
    assert g.resolve(TRACE) == f"response:{TRACE}"


def test_verify_graph_detects_byte_rot(tmp_path):
    shutil.copytree(GOLDEN_LINEAGE, tmp_path / "t")
    g = build_graph([tmp_path / "t"])
    assert verify_graph(g, "digest") == 0
    pkl = tmp_path / "t" / "run" / "learned_dicts.pkl"
    pkl.write_bytes(pkl.read_bytes()[:-1] + b"X")
    g2 = build_graph([tmp_path / "t"])
    assert verify_graph(g2, "digest") == 1
    assert g2.nodes["export:run/learned_dicts.pkl"]["verify"].startswith("FAIL")
    # the size tier cannot see a same-length flip
    assert verify_graph(build_graph([tmp_path / "t"]), "size") == 0
    with pytest.raises(ValueError, match="unknown verify tier"):
        verify_graph(g, "bits")


# -- a port run: explicit provenance events and manifests ----------------------

def test_a_port_driver_run_joins_export_run_store_and_checkpoints(tmp_path):
    """A tiny `basic_l1_sweep` of the port emits ``provenance`` events and
    producer-identity manifests; both packages' graphs join export -> run ->
    store, the port's ``state.pt`` checkpoints keyed by their manifest."""
    from sparse_coding__tpu_torch.data.chunks import save_chunk
    from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep

    rng = np.random.default_rng(0)
    save_chunk(tmp_path / "chunks", 0, rng.standard_normal((512, 24)).astype(np.float32))
    basic_l1_sweep(str(tmp_path / "chunks"), str(tmp_path / "out"), activation_width=24, l1_values=[1e-3],
                   dict_ratio=2, batch_size=256, fista_iters=10, n_epochs=1, checkpoint_every=1, device="cpu")
    events = [json.loads(line) for line in (tmp_path / "out" / "events.jsonl").open()]
    prov = [e for e in events if e["event"] == "provenance"]
    assert {e["artifact"] for e in prov} == {"export", "checkpoint"}
    pkl = tmp_path / "out" / "epoch_0" / "learned_dicts.pkl"
    sidecar = json.loads(pkl.with_name(pkl.name + ".manifest.json").read_text())
    assert sidecar["provenance"]["config_sha"] and sidecar["provenance"]["run_dir"] == str(tmp_path / "out")
    assert [e for e in prov if e["artifact"] == "export"][-1]["digest"] == export_digest(pkl)

    g = build_graph([tmp_path])
    eid = f"export:out/epoch_0/{pkl.name}"
    up = g.closure(eid, "up")
    assert "run:out" in up and "store:chunks" in up and "chunk:chunks#0" in up
    ckpts = [n for n in g.nodes.values() if n["type"] == "checkpoint"]
    assert ckpts and all(any(f.endswith("state.pt") for f in n["files"]) for n in ckpts)
    assert verify_graph(g, "digest") == 0
    # JAX's graph of the same tree: the same nodes, digests and edges (a run's
    # fingerprint names torch in the port's, which JAX's scan does not read)
    got, want = g.to_json(), _jax().build_graph([tmp_path]).to_json()
    assert got["edges"] == want["edges"]
    key = lambda n: (n["id"], n["type"], n.get("digest"), sorted(n.get("files", {})))  # noqa: E731
    assert [key(n) for n in got["nodes"]] == [key(n) for n in want["nodes"]]
    assert g.nodes["run:out"]["meta"]["fingerprint"]["torch"] == torch.__version__


# -- chaos acceptance: corrupt -> quarantine -> blast -> repair -> clean -------

GEN_KWARGS = dict(activation_dim=16, n_ground_truth_components=32, batch_size=256, feature_num_nonzero=5,
                  feature_prob_decay=0.995, correlated=False)
SPEC = dict(n_chunks=3, chunk_size_gb=256 * 16 * 2 / 1024**3, activation_width=16)


def _fake_serving_estate(root: Path):
    """A port-written store and hand-stamped run/serve event trees
    downstream of it (the JAX test's estate, the store drawn by the port's
    generator on the CPU)."""
    from sparse_coding__tpu_torch.utils.manifest import write_manifest

    store = root / "store"
    generate_synthetic_chunks(RandomDatasetGenerator(**GEN_KWARGS, key=3, device="cpu"), store, **SPEC)
    run = root / "run"
    run.mkdir()
    pkl = run / "learned_dicts.pkl"
    pkl.write_bytes(b"chaos-export\n")
    write_manifest(pkl.with_name(pkl.name + ".manifest.json"), {pkl.name: pkl},
                   extra={"provenance": producer_identity(config={"dataset_folder": "../store"}, run_dir=str(run))})
    ev = [
        {"seq": 1, "ts": 1.0, "event": "run_start", "run_name": "chaos", "config": {"dataset_folder": "../store"}},
        {"seq": 2, "ts": 2.0, "event": "provenance", "artifact": "export", "path": str(pkl),
         "digest": export_digest(pkl), "inputs": [{"kind": "store", "path": "../store"}]},
    ]
    (run / "events.jsonl").write_text("".join(json.dumps(e) + "\n" for e in ev))
    serve = root / "serve"
    serve.mkdir()
    sev = [
        {"seq": 1, "ts": 3.0, "event": "run_start", "run_name": "replica"},
        {"seq": 2, "ts": 4.0, "event": "serve_dict_added", "dict": "d0", "generation": 1,
         "source": "../run/learned_dicts.pkl", "manifest_digest": export_digest(pkl)},
    ]
    (serve / "events.jsonl").write_text("".join(json.dumps(e) + "\n" for e in sev))
    return store


def test_chaos_corrupt_quarantine_blast_repair(tmp_path):
    """The acceptance chain, zero retraining; each step's output is JAX's
    on the same tree, and the repaired chunk is the original bit for bit."""
    from sparse_coding__tpu_torch.data.scrub import main as scrub_main

    store = _fake_serving_estate(tmp_path)
    original = chunk_path(store, 1).read_bytes()
    assert _run(lineage_main, ["check", str(tmp_path)])[0] == 0

    raw = bytearray(original)
    raw[-1] ^= 0xFF
    chunk_path(store, 1).write_bytes(bytes(raw))
    assert _run(scrub_main, [str(store)])[0] == 1

    rc, out = _run(lineage_main, ["blast", "chunk:store#1", str(tmp_path)])
    assert rc == 1
    assert "tainted: quarantined" in out
    assert "export:run/learned_dicts.pkl" in out
    assert "generation:serve#1  (LIVE)" in out
    assert (rc, out) == _run(_jax().main, ["blast", "chunk:store#1", str(tmp_path)])

    rc, summary = _run(lineage_main, ["check", str(tmp_path)])
    assert rc == 1 and "chunk:store#1" in summary and "live" in summary
    assert (rc, summary) == _run(_jax().main, ["check", str(tmp_path)])

    config = {"kind": "synthetic", "generator": {**GEN_KWARGS, "class": "RandomDatasetGenerator", "seed": 3}, **SPEC}
    (tmp_path / "repair.json").write_text(json.dumps(config))
    assert _run(scrub_main, [str(store), "--repair", str(tmp_path / "repair.json")])[0] == 0
    assert chunk_path(store, 1).read_bytes() == original

    # the gate drops back to 0 with the ledger still on disk (history, not taint)
    assert _run(lineage_main, ["check", str(tmp_path)])[0] == 0
    n = build_graph([tmp_path]).nodes["chunk:store#1"]
    assert not n.get("tainted") and n["meta"].get("repaired")
    assert _run(lineage_main, ["graph", str(tmp_path)]) == _run(_jax().main, ["graph", str(tmp_path)])


# -- emitted telemetry ---------------------------------------------------------

def test_verify_sweep_spans_and_counters(tmp_path):
    """`verify_graph` books its wall time under the ``lineage_verify`` badput
    span and publishes ``lineage.*`` counters to the open telemetry;
    ``check`` sets the ``lineage.tainted_artifacts`` gauge."""
    from sparse_coding__tpu_torch.telemetry import RunTelemetry

    shutil.copytree(GOLDEN_LINEAGE, tmp_path / "t")
    tel = RunTelemetry(out_dir=tmp_path / "run", run_name="lineage_test")
    try:
        verify_graph(build_graph([tmp_path / "t"]), "digest")
        _run(lineage_main, ["check", str(tmp_path / "t")])
    finally:
        tel.close()
    events = [json.loads(line) for line in (tmp_path / "run" / "events.jsonl").open()]
    spans = [e for e in events if e["event"] == "span" and e["category"] == "lineage_verify"]
    assert spans and spans[0]["tier"] == "digest"
    assert tel.counters["lineage.verify.checked"] >= 5
    assert "lineage.verify.failures" not in tel.counters
    assert tel.gauges["lineage.tainted_artifacts"] == 0.0


def test_report_and_tower_read_the_graph(tmp_path):
    """The report's Provenance section and a tower incident's tainted list
    over a tree with a quarantined chunk: JAX's."""
    from sparse_coding__tpu_torch.data.scrub import scrub_store
    from sparse_coding__tpu_torch.telemetry import report as treport
    from sparse_coding__tpu_torch.telemetry.tower import Tower

    store = _fake_serving_estate(tmp_path)
    shutil.copytree(store, tmp_path / "run" / "store")
    p = chunk_path(tmp_path / "run" / "store", 2)
    p.write_bytes(p.read_bytes()[:-1] + b"\x00")
    scrub_store(tmp_path / "run" / "store")
    jrep = _jax("telemetry.report")
    got = treport.render_markdown(treport.load_run(tmp_path / "run"))
    want = jrep.render_markdown(jrep.load_run(tmp_path / "run"))
    sec = lambda md: md[md.index("## Provenance"):].split("\n## ")[0]  # noqa: E731
    assert "tainted: 1" in sec(got) and sec(got) == sec(want)
    tower = Tower.__new__(Tower)
    tower.run_dirs = [tmp_path / "run"]
    tainted = Tower._tainted_artifacts(tower)
    assert [t["id"] for t in tainted] == ["chunk:store#2"] and tainted[0]["reason"].startswith("quarantined")
    jt = _jax("telemetry.tower").Tower.__new__(_jax("telemetry.tower").Tower)
    jt.run_dirs = [tmp_path / "run"]
    assert tainted == _jax("telemetry.tower").Tower._tainted_artifacts(jt)
