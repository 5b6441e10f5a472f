"""The port's run tools over ``events.jsonl`` (`telemetry/{goodput,report,
monitor,slo,tower}.py`, the offline half of `telemetry/multihost.py`, the
`timeline` / `report` / `monitor` / `slo` / `tower` / `perfdiff` shims)
against the JAX package's, on the same run directories.

The run dirs are written three ways: synthetic records through the port's
`RunTelemetry` (spans of every category, counters, snapshots, two
generations with a supervisor restart, and two per-process logs with a
clock offset and a straggler), the same records through JAX's
`RunTelemetry`, and one tiny CPU run of the port's sweep; the JAX package's
golden run dirs (`tests/golden/*_run`) are read too. Every output is
compared whole (the port's CLI names read as JAX's), except where the port
renders its own: the fingerprint's framework lines (torch / cuda /
distributed_backend against jax / jaxlib) and the report's cost rows (an
analytic count on the port's peak table, where JAX reads XLA's cost
analysis on its TPU table). The "Provenance" section is the lineage graph's
in both. Nothing sleeps: monitor, tower and SLO take a fixed ``now``.
"""

import contextlib
import importlib
import io
import json
import shutil
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
GOLDEN_RUNS = ["goodput_run", "resumed_run", "pod_run", "serve_run", "router_run", "traced_run", "feature_run",
               "lineage_run", "fleet_run"]
SLO_CFG = json.loads((GOLDEN / "traced_run" / "slo.json").read_text())
SLO_STRICT = json.loads((GOLDEN / "traced_run" / "slo_strict.json").read_text())


def _mods(name):
    """(JAX module, port module) of a dotted name under each package."""
    return (importlib.import_module(f"sparse_coding__tpu.{name}"),
            importlib.import_module(f"sparse_coding__tpu_torch.{name}"))


def _write_run(pkg, out, pod=False):
    """A synthetic run written by ``pkg``'s `RunTelemetry` (``pod``: two
    per-process logs, rank 1 with a clock offset and a straggling chunk;
    else two generations of one process around a supervisor restart)."""
    ev = importlib.import_module(f"{pkg}.telemetry.events")
    mh = importlib.import_module(f"{pkg}.telemetry.multihost")
    sp = importlib.import_module(f"{pkg}.telemetry.spans")
    out = Path(out)
    cfg = {"lr": 1e-3, "members": 2}

    def one(tel, proc, gen, chunk_seconds):
        tel.run_start(config=cfg)
        for cat in sp.GOODPUT_CATEGORIES + sp.BADPUT_CATEGORIES:
            with sp.span(tel, cat, name=f"{cat}_demo", chunk=0):
                pass
        for c in range(3):
            tel.chunk_start(c, epoch=0, position=c)
            tel.counter_inc("train.steps", 4)
            tel.counter_add_float("train.rows", 256.0)
            tel.gauge_set("train.lr", 1e-3)
            tel.hist_observe("serve.latency_ms", 3.0 + c)
            # a fixed window length (the straggler's longer) in place of the measured one
            tel.counter_inc("chunks")
            tel.event("chunk_end", chunk=c, epoch=0, position=c, seconds=chunk_seconds)
            tel.snapshot()
        if pod:
            tel.event("heartbeat", step=3, steps=12, window_seconds=chunk_seconds,
                      window_seconds_by_process=[0.5, 0.9], skew_seconds=0.4,
                      clock_offset_seconds=0.25 if proc else None, clock_uncertainty_seconds=0.01 if proc else None)
        tel.anomaly("nonfinite", model=1, action="warn")
        tel.event("provenance", artifact="export", path=str(out / "learned_dicts.pkl"), digest="0123456789abcdef")
        tel.run_end(status="preempted" if gen == 0 and not pod else "ok", steps=12)
        tel.close()

    real = mh.process_info
    try:
        if pod:
            for proc, secs in ((0, 0.5), (1, 0.9)):
                mh.process_info = lambda proc=proc: (proc, 2)
                one(ev.RunTelemetry(out_dir=str(out), run_name="podrun", config=cfg), proc, 0, secs)
        else:
            one(ev.RunTelemetry(out_dir=str(out), run_name="genrun", config=cfg), 0, 0, 0.5)
            sup = ev.RunTelemetry(out_dir=str(out), run_name="supervisor", file_name="supervisor_events.jsonl")
            sup.run_start()
            sup.event("restart", generation=1, run_dir=str(out), backoff_seconds=0.01, attempt=1, rc=75)
            sup.run_end()
            sup.close()
            one(ev.RunTelemetry(out_dir=str(out), run_name="genrun", config=cfg), 0, 1, 0.5)
    finally:
        mh.process_info = real
    return out


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runtools")
    dirs = {}
    for writer, pkg in (("port", "sparse_coding__tpu_torch"), ("jax", "sparse_coding__tpu")):
        dirs[f"gens_{writer}"] = _write_run(pkg, root / f"gens_{writer}")
        dirs[f"pod_{writer}"] = _write_run(pkg, root / f"pod_{writer}", pod=True)
    from sparse_coding__tpu_torch.train import experiments as texp

    texp.run_sweep_synthetic(texp.tied_vs_not_experiment, device="cpu", activation_width=16, n_chunks=2,
                             gen_batch_size=64, chunk_size_gb=64 * 16 * 2 / 1024**3, batch_size=64,
                             output_folder=str(root / "sweep"), dataset_folder=str(root / "sweep_data"))
    dirs["sweep_port"] = root / "sweep"
    for name in GOLDEN_RUNS:
        dirs[name] = GOLDEN / name
    return dirs


DIRS = ["gens_port", "gens_jax", "pod_port", "pod_jax", "sweep_port"] + GOLDEN_RUNS


def _now(run_dir):
    """A fixed ``now``: five seconds after the run's last record."""
    ts = [r.get("ts", 0) for f in Path(run_dir).rglob("*events*.jsonl") for r in map(json.loads, filter(
        str.strip, f.read_text().splitlines())) if isinstance(r.get("ts"), (int, float))]
    return max(ts) + 5.0


def _dump(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def _as_jax(text):
    """The port's output with its own CLI names (``python -m
    sparse_coding__tpu_torch.timeline``) spelled as JAX's."""
    return text.replace("sparse_coding__tpu_torch.", "sparse_coding__tpu.")


@pytest.mark.parametrize("name", DIRS)
def test_goodput_ledger_render_and_trace_match_jax(run_dirs, name):
    jg, tg = _mods("telemetry.goodput")
    d = run_dirs[name]
    jl, tl = jg.build_ledger(d), tg.build_ledger(d)
    assert _dump(tl) == _dump(jl)
    assert tg.render_ledger(tl) == jg.render_ledger(jl)
    assert _dump(tg.to_chrome_trace(tl)) == _dump(jg.to_chrome_trace(jl))


FRAMEWORK_LINES = ("- **jax**", "- **jaxlib**", "- **torch**", "- **cuda**", "- **distributed_backend**")
PORT_OWN_SECTIONS = ("Performance attribution",)


def _sections(md):
    out, cur = {}, "_head"
    for line in md.splitlines():
        if line.startswith("## "):
            cur = line[3:]
        out.setdefault(cur, []).append(line)
    return out


@pytest.mark.parametrize("name", DIRS)
def test_report_matches_jax_but_for_the_named_lines(run_dirs, name):
    jr, tr = _mods("telemetry.report")
    d = run_dirs[name]
    jmd, tmd = jr.render_markdown(jr.load_run(d)), _as_jax(tr.render_markdown(tr.load_run(d)))
    js, ts = _sections(jmd), _sections(tmd)
    assert list(js) == list(ts)
    for sec in js:
        if sec in PORT_OWN_SECTIONS:
            continue
        keep = lambda lines: [ln for ln in lines if not ln.startswith(FRAMEWORK_LINES)]  # noqa: E731
        assert keep(ts[sec]) == keep(js[sec]), sec
    # without cost rows (none of these runs captured a step graph) the
    # section is JAX's: the HBM table, the trace lines, the empty note
    perf = ts["Performance attribution"]
    assert not any("GFLOP" in ln for ln in js["Performance attribution"] + perf)
    assert perf == js["Performance attribution"]


@pytest.mark.parametrize("name", DIRS)
def test_skew_windows_and_fingerprint_diff_match_jax(run_dirs, name):
    jm, tm = _mods("telemetry.multihost")
    events = importlib.import_module("sparse_coding__tpu_torch.telemetry.report").load_run(run_dirs[name])["events"]
    assert _dump(tm.chunk_skew_windows(events)) == _dump(jm.chunk_skew_windows(events))
    starts = [e for e in events if e.get("event") == "run_start"]
    # the comparable keys differ only in the framework's own fields
    common = set(jm.COMPARABLE_FINGERPRINT_KEYS) & set(tm.COMPARABLE_FINGERPRINT_KEYS) | {"config"}
    jd = {k: v for k, v in jm.fingerprint_diff(starts).items() if k in common}
    td = {k: v for k, v in tm.fingerprint_diff(starts).items() if k in common}
    assert _dump(td) == _dump(jd)
    assert tm.format_bytes(3 * 2**20 + 5) == jm.format_bytes(3 * 2**20 + 5)


@pytest.mark.parametrize("cfg", [SLO_CFG, SLO_STRICT], ids=["slo", "strict"])
@pytest.mark.parametrize("name", DIRS)
def test_slo_over_run_dirs_matches_jax(run_dirs, name, cfg):
    js, ts = _mods("telemetry.slo")
    d = run_dirs[name]
    jr, tr = js.evaluate_run_dir(d, cfg), ts.evaluate_run_dir(d, cfg)
    assert _dump(tr) == _dump(jr)
    assert ts.render_slo(tr) == js.render_slo(jr)


@pytest.mark.parametrize("name", DIRS)
def test_monitor_render_matches_jax(run_dirs, name):
    jmon, tmon = _mods("telemetry.monitor")
    d = run_dirs[name]
    now = _now(d)
    outs = []
    for mod in (jmon, tmon):
        mon = mod.RunMonitor(d)
        mon.poll()
        outs.append(mod.render(mon, now=now))
    assert outs[1] == outs[0]


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [["--goodput-floor", "0"], ["--goodput-floor", "99.9"], ["--json"], ["--trace"]],
                         ids=["floor_ok", "floor_fail", "json", "trace"])
@pytest.mark.parametrize("name", ["gens_port", "pod_port", "sweep_port", "goodput_run", "fleet_run"])
def test_timeline_cli_matches_jax(run_dirs, name, argv, tmp_path):
    jt, tt = _mods("timeline")
    d = str(run_dirs[name])
    got = []
    for mod in (jt, tt):
        extra = [str(tmp_path / "t.json")] if argv == ["--trace"] else []
        rc, out = _cli(mod.main, [d, *argv, *extra])
        trace = json.loads((tmp_path / "t.json").read_text()) if extra else None
        got.append((rc, out, _dump(trace)))
    assert got[1] == got[0]
    rc = got[0][0]
    if name == "fleet_run" and argv[0] == "--goodput-floor":
        assert rc == 3  # the golden fleet run has no spans: no floor can gate it
    else:
        assert rc == (1 if argv == ["--goodput-floor", "99.9"] else 0)


def test_cli_exit_codes_match_jax(run_dirs, tmp_path):
    """Each shim's ``main`` on the same arguments: the same exit code and
    (for the ones that print no fingerprint) the same output."""
    cfg = tmp_path / "slo.json"
    cfg.write_text(json.dumps(SLO_STRICT))
    empty = tmp_path / "empty"
    empty.mkdir()
    cases = [
        ("timeline", [str(empty)]),
        ("slo", [str(run_dirs["traced_run"]), "--config", str(cfg)]),
        ("slo", [str(run_dirs["gens_port"]), "--config", str(GOLDEN / "traced_run" / "slo.json")]),
        ("monitor", [str(run_dirs["pod_port"]), "--once"]),
        ("tower", ["check", str(GOLDEN / "tower_run")]),
        ("tower", ["report", str(GOLDEN / "tower_run")]),
        ("report", [str(run_dirs["sweep_port"])]),
    ]
    for shim, argv in cases:
        (jrc, jout), (trc, tout) = (_cli(m.main, argv) for m in _mods(shim))
        assert trc == jrc, (shim, argv, tout)
        if shim not in ("report", "monitor"):  # the report's framework lines; the monitor's clock
            assert tout == jout, (shim, argv)


def test_tower_alert_replay_and_incidents_match_jax(tmp_path):
    """The golden tower history replayed through each package's
    `AlertManager` at fixed ticks: the same transitions, incidents, report
    and `tower_check` verdict."""
    jt, tt = _mods("telemetry.tower")
    src = GOLDEN / "tower_run"
    got = {}
    for tag, mod in (("jax", jt), ("port", tt)):
        d = tmp_path / tag
        d.mkdir()
        shutil.copy(src / "series.jsonl", d / "series.jsonl")
        shutil.copy(src / "alerts.json", d / "alerts.json")
        store = mod.load_store(d)
        rules = mod.load_rules(d / "alerts.json")
        am = mod.AlertManager(rules["rules"], windows=rules["windows"], tower_dir=d)
        t0, t1 = store.span()
        ticks = [t0 + (t1 - t0) * i / 12 for i in range(13)] + [t1 + 3600.0]
        transitions = [am.evaluate(store, now) for now in ticks]
        got[tag] = dict(transitions=_dump(transitions), summary=_dump(am.summary()),
                        replay=_dump(mod.replay_alert_states(d)), incidents=_dump(mod.read_incidents(d)),
                        report=mod.render_tower_report(d).replace(str(d), "<dir>"),
                        check=mod.tower_check(d, quiet=True))
    assert got["port"] == got["jax"]
    # and the golden dir itself, as the JAX package wrote it
    assert tt.render_tower_report(src) == jt.render_tower_report(src)
    assert _dump(tt.replay_alert_states(src)) == _dump(jt.replay_alert_states(src))
    assert tt.tower_check(src, quiet=True) == jt.tower_check(src, quiet=True)


@pytest.mark.parametrize("cfg", [SLO_CFG, SLO_STRICT], ids=["slo", "strict"])
def test_evaluate_series_and_measured_match_jax(cfg):
    js, ts = _mods("telemetry.slo")
    jt, tt = _mods("telemetry.tower")
    src = GOLDEN / "tower_run"
    assert _dump(ts.evaluate_series(tt.load_store(src), cfg)) == _dump(js.evaluate_series(jt.load_store(src), cfg))
    assert _dump(ts.evaluate_series(src, cfg)) == _dump(js.evaluate_series(src, cfg))
    blob = {"requests": 200, "errors": 1, "p50_ms": 2.0, "p99_ms": 9.5,
            "histogram": [{"le_ms": 1.0, "count": 20}, {"le_ms": 10.0, "count": 170}, {"le_ms": None, "count": 10}]}
    for b in (blob, {k: v for k, v in blob.items() if k != "p99_ms"}):
        jr, tr = js.evaluate_measured(b, cfg), ts.evaluate_measured(b, cfg)
        assert _dump(tr) == _dump(jr) and ts.render_slo(tr) == js.render_slo(jr)


def _bench(scale=1.0, control=1.0):
    return {"encode_rows_per_s": 1000.0 * scale, "encode_rows_per_s_spread": [950.0 * scale, 1050.0 * scale],
            "latency_ms": 5.0 / scale, "latency_ms_spread": [4.5 / scale, 5.5 / scale],
            "control_matmul_tflops": 100.0 * control, "control_matmul_tflops_spread": [99.0 * control, 101.0 * control],
            "mfu": 0.5}


@pytest.mark.parametrize("new", [_bench(), _bench(0.7), _bench(1.4), _bench(0.7, control=0.7),
                                 {"parsed": _bench(1.02)}, {**_bench(), "extra_ms": 1.0,
                                                            "extra_ms_spread": [0.9, 1.1]}],
                         ids=["same", "regressed", "improved", "weather", "envelope", "new_key"])
def test_perfdiff_matches_jax(tmp_path, new):
    jp, tp = _mods("perfdiff")
    old, nw = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(_bench()))
    nw.write_text(json.dumps(new))
    for argv in ([str(old), str(nw)], [str(old), str(nw), "--json"], [str(old), str(nw), "--threshold", "0.5"]):
        assert _cli(tp.main, argv) == _cli(jp.main, argv)


def test_fleet_views_match_jax_on_the_golden_fleet_run(run_dirs):
    """The three fleet views (the goodput ledger's reassignment gaps, the
    monitor's fleet lines, the tower's fleet gauges) on the golden fleet
    run, and on an ordinary run dir (none of them)."""
    (jg, tg), (jm, tm), (jt, tt) = _mods("telemetry.goodput"), _mods("telemetry.monitor"), _mods("telemetry.tower")
    fleet = run_dirs["fleet_run"]
    now = _now(fleet)
    gaps = tg.fleet_reassignment_gaps(fleet)
    assert gaps and _dump(gaps) == _dump(jg.fleet_reassignment_gaps(fleet))
    ledger = tg.build_ledger(fleet)
    assert ledger["reassignment_gaps"] and _dump(ledger) == _dump(jg.build_ledger(fleet))
    lines = tm.fleet_lines(fleet, now)
    assert lines[0].startswith("  fleet: items 2 done") and lines == jm.fleet_lines(fleet, now)
    gauges = tt._fleet_gauges(fleet, now)
    assert gauges["fleet.pending_items"] == 0.0 and gauges == jt._fleet_gauges(fleet, now)
    plain = run_dirs["gens_port"]
    assert tg.fleet_reassignment_gaps(plain) == jg.fleet_reassignment_gaps(plain) == []
    assert tm.fleet_lines(plain, now) == jm.fleet_lines(plain, now) == []
    assert tt._fleet_gauges(plain, now=0.0) == jt._fleet_gauges(plain, now=0.0) == {}


def test_tower_and_scrape_render_read_a_port_metrics_server(tmp_path):
    """One in-process scrape of the port's `metrics_http` server by each
    package's `Tower` and `scrape_render`, at a fixed ``now``."""
    from sparse_coding__tpu_torch.telemetry import metrics_http

    text = metrics_http.render_prometheus(
        counters={"serve.requests": 120.0, "serve.errors": 2.0, "serve.rows": 480.0, "serve.batches": 30.0},
        gauges={"serve.queue_depth": 3.0, "serve.latency_p99_ms": 7.5},
        hists={"serve.latency_ms": {"bounds": [1.0, 5.0, 10.0], "counts": [10, 90, 18, 2], "sum": 600.0,
                                     "count": 120}})
    server = metrics_http.MetricsServer(lambda: text).start()
    try:
        now = time.time()
        (jm, tm), (jt, tt) = _mods("telemetry.monitor"), _mods("telemetry.tower")
        assert tm.scrape_render([server.address], now=now) == jm.scrape_render([server.address], now=now)
        states = {}
        for tag, mod in (("jax", jt), ("port", tt)):
            tw = mod.Tower(tmp_path / tag, targets=[{"url": server.address, "label": "r0"}], resume=False)
            try:
                tw.poll_once(now=now)
                tw.poll_once(now=now + 5.0)
                states[tag] = _dump(tw.pool_state(now + 5.0))
            finally:
                tw.close()
        assert states["port"] == states["jax"]
    finally:
        server.stop()


def test_span_categories_match_jax():
    js, ts = _mods("telemetry.spans")
    for name in ("GOODPUT_CATEGORIES", "BADPUT_CATEGORIES", "DERIVED_CATEGORIES", "INNER_CATEGORIES", "CATEGORIES"):
        assert getattr(ts, name) == getattr(js, name), name


@pytest.mark.parametrize("shim", ["features", "lineage", "scrub"])
def test_the_artifact_cli_shims_answer_help(shim):
    """``python -m sparse_coding__tpu_torch.<shim> --help`` exits 0 (JAX's
    `tests/test_cli_shims.py` guard over the port's new shims)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", f"sparse_coding__tpu_torch.{shim}", "--help"], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"sparse_coding__tpu_torch.{'data.scrub' if shim == 'scrub' else shim}" in res.stdout
