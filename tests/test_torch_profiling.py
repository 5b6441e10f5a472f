"""The port's performance attribution (`telemetry/profiling.py`,
`utils/trace.py`, `Ensemble.step_cost`) against the JAX package's, on the
CPU: `tests/test_profiling.py:158-400`'s cases.

  - the roofline arithmetic equals JAX's `roofline_summary` given the same
    peaks (exact); the port's own peak table names the H100 and gives an
    unknown device the H100 SXM's figures, never a TPU's;
  - the trigger's cases (step window, a window coarser than the boundaries,
    ``from_env``, the first anomaly only, a busy profiler, close) run with a
    stand-in for the profiler window (`tests/_torch_profiler_stub.py`), as
    JAX's tests stub theirs; one real torch.profiler window runs once;
  - a step's cost is the kernels' analytic count (`kernel_work`, the count
    the kernel table's bounds read) on the fused routes and FlopCounterMode
    on the autograd route; ``compile`` records carry it into the report's
    roofline rows and goodput's compile category, which read them as JAX's.
"""

import importlib
import json

import pytest
import torch

from _torch_profiler_stub import stub_profiler
from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.telemetry import (
    AnomalyGuard,
    AnomalyPolicy,
    RunTelemetry,
    TraceTrigger,
    read_events,
    record_hbm_watermarks,
    roofline_summary,
)
from sparse_coding__tpu_torch.telemetry import profiling as tprof

GiB = 1024**3


def _jax_roofline(monkeypatch, tf, bw):
    """JAX's `roofline_summary` with its peak table swapped for (tf, bw)."""
    bc = importlib.import_module("sparse_coding__tpu.utils.bench_common")
    monkeypatch.setattr(bc, "peak_tflops", lambda kind: tf)
    monkeypatch.setattr(bc, "hbm_gbps", lambda kind: bw)
    return importlib.import_module("sparse_coding__tpu.telemetry.profiling").roofline_summary


# -- roofline -----------------------------------------------------------------

@pytest.mark.parametrize("flops,nbytes,seconds", [(1e12, 1e9, None), (1e10, 1e9, None), (1e12, 1e9, 0.01),
                                                   (3.436e11, 1.36e8, 1.7e-3), (5.0, 0.0, None)])
def test_roofline_arithmetic_equals_jax_at_the_same_peaks(monkeypatch, flops, nbytes, seconds):
    kind = "NVIDIA H100 80GB HBM3"
    jax_rl = _jax_roofline(monkeypatch, tprof.peak_tflops(kind), tprof.hbm_gbps(kind))
    assert roofline_summary(flops, nbytes, kind, seconds=seconds) == jax_rl(flops, nbytes, kind, seconds=seconds)


def test_roofline_classification_both_sides_of_the_h100_ridge():
    kind = "NVIDIA H100 80GB HBM3"
    assert (tprof.peak_tflops(kind), tprof.hbm_gbps(kind)) == (989.0, 3350.0)
    hi = roofline_summary(1e12, 1e9, kind)  # intensity 1000 > ridge 295.2
    assert hi["bound"] == "compute" and hi["attainable_tflops"] == pytest.approx(989.0)
    lo = roofline_summary(1e10, 1e9, kind)  # intensity 10
    assert lo["bound"] == "bandwidth" and lo["attainable_tflops"] == pytest.approx(33.5)
    rl = roofline_summary(1e12, 1e9, kind, seconds=1 / 100.0)
    assert rl["achieved_tflops"] == pytest.approx(100.0)
    assert rl["achieved_fraction"] == pytest.approx(100.0 / 989.0, abs=1e-4)
    assert rl["achieved_gbps"] == pytest.approx(100.0)


def test_an_unknown_device_takes_the_stated_default_not_a_tpu():
    rl = roofline_summary(1e12, 1e9, "cpu")
    assert (rl["peak_tflops"], rl["hbm_gbps"]) == tprof.DEFAULT_PEAK[1:] == (989.0, 3350.0)
    assert "TPU" not in json.dumps(tprof.PEAKS) + tprof.DEFAULT_PEAK[0]
    assert roofline_summary(1e12, 1e9, None, peak_tflops=100.0, hbm_gbps=1000.0)["ridge_intensity"] == 100.0


def test_capture_mode_reads_sc_cost_capture():
    for raw, want in ((None, "cost"), ("1", "cost"), ("0", "off"), ("off", "off"), ("full", "full"),
                      ("2", "full"), ("memory", "full")):
        assert tprof.capture_mode({} if raw is None else {"SC_COST_CAPTURE": raw}) == want


# -- device-memory watermarks -------------------------------------------------

def test_watermarks_absent_on_cpu_deterministically(tmp_path):
    assert tprof.hbm_watermarks([torch.device("cpu")]) == {}
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="wm")
    assert record_hbm_watermarks(tel, ["cpu"]) == {}
    tel.run_end()
    tel.close()
    snap = [e for e in read_events(tmp_path / "events.jsonl") if e["event"] == "snapshot"]
    assert all(not k.startswith("hbm.") for k in snap[-1]["gauges"])


def test_watermark_gauges_render_in_the_report(tmp_path, capsys):
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="wm")
    tel.run_start()
    for field, v in (("bytes_in_use", 2 * GiB), ("peak_bytes_in_use", 3 * GiB), ("bytes_limit", 16 * GiB)):
        tel.gauge_set(f"hbm.d0.{field}", float(v))
    tel.run_end()
    tel.close()
    from sparse_coding__tpu_torch.report import main

    assert main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Performance attribution" in out and "3.00 GiB" in out and "13.00 GiB (81.2%)" in out


# -- step cost and the report's roofline rows ----------------------------------

def _tied(dtype=None, health=False, mu_dtype=None):
    kw = {"learning_rate": 1e-3}
    if mu_dtype:
        kw["mu_dtype"] = mu_dtype
    return build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], activation_size=128,
                          n_dict_components=256, compute_dtype=dtype, health=health, optimizer_kwargs=kw,
                          device="cpu")


def test_a_fused_step_costs_its_kernels_work():
    ens = _tied("bfloat16", mu_dtype="bfloat16")
    assert ens.fused and ens.fused_adam is not None
    cost = ens.step_cost((64, 128))
    k1 = tk.kernel_work("tied_sae_fwd", 2, 64, 256, 128)
    k2 = tk.kernel_work("tied_sae_bwd_adam", 2, 64, 256, 128, mu_bytes=2, nu_bytes=4)
    assert (cost["flops"], cost["bytes_accessed"]) == (k1[0] + k2[0], k1[1] + k2[1])
    assert cost["route"] == "fused_adam" and "tied_sae_fwd + tied_sae_bwd_adam" in cost["method"]
    ens.set_update_mask([1, 0])
    k3 = tk.kernel_work("tied_sae_bwd_grads", 2, 64, 256, 128)
    assert ens.step_cost((64, 128))["flops"] == k1[0] + k3[0]


def test_a_captured_cost_counts_the_codes_nonzeros():
    """A capture's cost counts K1 + K2 at its first step's code nnz: the
    non-zero entries of the code K1 writes, counted in row blocks."""
    ens = _tied("bfloat16", mu_dtype="bfloat16")
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(1))
    d, b = ens.state.params["encoder"], ens.state.params["encoder_bias"]
    nnz = ens.sig.code_nnz(ens.state.params, x)
    assert nnz.dim() == 0 and int(tk.code_nnz(d, b, x, rows=16)) == int(nnz)
    nrm = torch.sqrt(torch.sum(d * d, dim=-1))
    c = tk.tied_sae_fwd(x.to(torch.bfloat16), (d / nrm[..., None]).to(torch.bfloat16), b, 1.0)[0]
    nnz = int(nnz)
    assert nnz == int((c != 0).sum()) and 0 < nnz < c.numel()
    cost = ens.step_cost((64, 128), code_nnz=nnz)
    k1 = tk.kernel_work("tied_sae_fwd", 2, 64, 256, 128, nnz)
    k2 = tk.kernel_work("tied_sae_bwd_adam", 2, 64, 256, 128, nnz, mu_bytes=2, nu_bytes=4)
    assert (cost["flops"], cost["bytes_accessed"]) == (k1[0] + k2[0], k1[1] + k2[1])
    assert cost["code_nnz"] == nnz and cost["code_nonzero_frac"] == nnz / c.numel()
    assert cost["flops"] < ens.step_cost((64, 128))["flops"] and "code nnz" in cost["method"]


def test_an_autograd_step_costs_its_counted_flops_and_its_leaves():
    from torch.utils.flop_counter import FlopCounterMode

    ens = _tied(health=True)
    assert not ens.fused and ens.step_cost((64, 128)) is None
    counter = FlopCounterMode(display=False)
    with counter:
        ens.step_batch(torch.randn(64, 128, generator=torch.Generator().manual_seed(0)))
    flops = counter.get_total_flops()
    assert flops >= 3 * 2 * 2 * 64 * 256 * 128  # encode, decode and their gradients' products
    cost = ens.step_cost((64, 128), counted_flops=flops)
    leaves = [ens.state.params, ens.state.buffers, ens.state.opt_state]
    nbytes = sum(t.numel() * t.element_size() for t in importlib.import_module(
        "sparse_coding__tpu_torch.ensemble")._tensors(leaves))
    assert cost == {"flops": float(flops), "bytes_accessed": float(2 * nbytes + 64 * 128 * 4), "route": "autograd",
                    "method": "FlopCounterMode; state leaves read and written once, the batch read once"}


def _cost_run(pkg, out, cost, step_ms=None, device_kind="NVIDIA H100 80GB HBM3"):
    ev = importlib.import_module(f"{pkg}.telemetry.events")
    tel = ev.RunTelemetry(out_dir=str(out), run_name="perf")
    tel.event("run_start", run_name="perf", generation=0, config={}, fingerprint={"device_kind": device_kind})
    tel.compile("ensemble.step_scan", 0.75, cost=cost)
    if step_ms is not None:
        tel.gauge_set("perf.ensemble.step_scan.step_ms", step_ms)
    tel.counter_inc("train.steps", 64)
    tel.run_end()
    tel.close()
    return out


def test_the_report_puts_a_captured_step_on_the_roofline(tmp_path, monkeypatch):
    from sparse_coding__tpu_torch.telemetry import report as treport

    cost = {"flops": 3.436e11, "bytes_accessed": 1.36e8, "route": "fused_adam", "pool_bytes": 3 * 2**20}
    run = _cost_run("sparse_coding__tpu_torch", tmp_path / "port", cost, step_ms=1.7)
    md = treport.render_markdown(treport.load_run(run))
    sec = md[md.index("## Performance attribution"):].split("\n## ")[0]
    row = [ln for ln in sec.splitlines() if ln.startswith("| ensemble.step_scan")]
    kind = "NVIDIA H100 80GB HBM3"
    want = _jax_roofline(monkeypatch, 989.0, 3350.0)(cost["flops"], cost["bytes_accessed"], kind, seconds=1.7e-3)
    cells = [c.strip() for c in row[0].strip("|").split("|")]
    assert cells[0] == "ensemble.step_scan" and cells[4] == want["bound"] == "compute"
    fmt = treport._fmt
    assert cells[3:9] == [fmt(want["arithmetic_intensity"]), want["bound"], fmt(want["attainable_tflops"]),
                          fmt(1.7), fmt(want["achieved_tflops"]), fmt(want["achieved_fraction"])]
    assert cells[1] == fmt(cost["flops"] / 1e9) and cells[9] == "3.00 MiB"
    assert "Roofline peaks for **NVIDIA H100 80GB HBM3**: 989 TFLOP/s bf16, 3350 GB/s HBM" in sec
    # the Compiles section and goodput's compile category read the records as JAX's
    jrep, jgood = (importlib.import_module(f"sparse_coding__tpu.telemetry.{m}") for m in ("report", "goodput"))
    tgood = importlib.import_module("sparse_coding__tpu_torch.telemetry.goodput")
    jmd = jrep.render_markdown(jrep.load_run(run))
    compiles = lambda m: m[m.index("## Compile activity"):].split("\n## ")[0]  # noqa: E731
    assert compiles(md) == compiles(jmd) and "| ensemble.step_scan | 1 | 0.75 |" in compiles(md)
    assert json.dumps(tgood.build_ledger(run), sort_keys=True, default=str) == \
        json.dumps(jgood.build_ledger(run), sort_keys=True, default=str)


# -- TraceTrigger -------------------------------------------------------------

@pytest.fixture()
def fake_profiler(monkeypatch):
    return stub_profiler(monkeypatch)


def _traces(path):
    return [e for e in read_events(path / "events.jsonl") if e["event"] == "trace"]


def test_trace_trigger_step_window(tmp_path, fake_profiler):
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="tt")
    tt = TraceTrigger(telemetry=tel, out_dir=str(tmp_path), start_step=10, stop_step=20)
    for step in (0, 5):
        tt.on_step(step)
    assert not tt.active
    tt.on_step(12)
    assert tt.active
    tt.on_step(18)
    assert tt.active
    tt.on_step(25)
    assert not tt.active
    tt.on_step(12)  # the window fires once a run
    assert not tt.active
    tel.close()
    assert fake_profiler["started"] == [str(tmp_path / "trace_step12")]
    traces = _traces(tmp_path)
    assert [(t["reason"], t["start_step"], t["stop_step"]) for t in traces] == [("step_window", 12, 25)]
    assert tt.last_trace_dir == str(tmp_path / "trace_step12") and tel.counters["trace.captures"] == 1


def test_trace_trigger_window_coarser_than_boundaries(tmp_path, fake_profiler):
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="coarse")
    tt = TraceTrigger(telemetry=tel, out_dir=str(tmp_path), start_step=2, stop_step=4)
    tt.on_step(4)
    assert tt.active
    tt.on_step(8)
    assert not tt.active
    tel.close()
    assert [(t["start_step"], t["stop_step"]) for t in _traces(tmp_path)] == [(4, 8)]


def test_trace_trigger_from_env(tmp_path, fake_profiler):
    env = {"SC_TRACE_WINDOW": "3:5", "SC_TRACE_DIR": str(tmp_path / "custom")}
    tt = TraceTrigger.from_env(out_dir=str(tmp_path), env=env)
    assert (tt.start_step, tt.stop_step) == (3, 5)
    tt.on_step(4)
    assert fake_profiler["started"] == [str(tmp_path / "custom")]
    tt.close()
    with pytest.warns(RuntimeWarning, match="SC_TRACE_WINDOW"):
        tt2 = TraceTrigger.from_env(env={"SC_TRACE_WINDOW": "garbage"})
    assert tt2.start_step is None


def test_anomaly_fires_trace_trigger_once(tmp_path, fake_profiler):
    import numpy as np

    tel = RunTelemetry(out_dir=str(tmp_path), run_name="anom")
    tt = TraceTrigger(telemetry=tel, out_dir=str(tmp_path))
    guard = AnomalyGuard(telemetry=tel, out_dir=str(tmp_path), policy=AnomalyPolicy(action="warn"), trace_trigger=tt)
    with pytest.warns(RuntimeWarning):
        guard.observe([3], [{"loss": np.asarray([np.nan, 1.0])}])
    assert tt.active
    expect_dir = str(tmp_path / "trace_anomaly_step3")
    tt.on_step(4)
    assert not tt.active
    with pytest.warns(RuntimeWarning):
        guard.observe([5], [{"loss": np.asarray([1.0, np.nan])}])
    assert not tt.active
    tel.close()
    events = read_events(tmp_path / "events.jsonl")
    anomalies = [e for e in events if e["event"] == "anomaly"]
    assert anomalies[0]["trace_dir"] == expect_dir
    assert json.load(open(anomalies[0]["bundle"]))["trace_dir"] == expect_dir
    assert [t["dir"] for t in _traces(tmp_path)] == [expect_dir]
    assert fake_profiler["started"] == [expect_dir]


def test_trigger_yields_when_profiler_busy(fake_profiler):
    fake_profiler["active"] = "/somewhere/else"
    tt = TraceTrigger(start_step=1, stop_step=2)
    tt.on_step(1)
    assert not tt.active
    assert tt.fire("anomaly") is None
    assert fake_profiler["started"] == []
    fake_profiler["active"] = None
    assert tt.fire("anomaly") is not None, "a refused fire consumed the anomaly capture"
    assert tt.active


def test_trigger_close_stops_inflight_capture(tmp_path, fake_profiler):
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="close")
    with TraceTrigger(telemetry=tel, out_dir=str(tmp_path), start_step=0, stop_step=100) as tt:
        tt.on_step(1)
        assert tt.active
    assert not tt.active and fake_profiler["stopped"] == 1
    tel.close()
    assert len(_traces(tmp_path)) == 1


def test_a_real_profiler_window_writes_a_chrome_trace(tmp_path):
    """torch.profiler, started and stopped from code; a second start while
    the window is open warns and returns False (one session a process)."""
    from sparse_coding__tpu_torch.utils import trace as ttrace

    assert ttrace.start_trace_safe(str(tmp_path / "w"))
    try:
        assert ttrace.trace_active() == str(tmp_path / "w")
        with pytest.warns(RuntimeWarning, match="already active"):
            assert not ttrace.start_trace_safe(str(tmp_path / "nested"))
        with ttrace.annotate("sc_marked_range"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    finally:
        assert ttrace.stop_trace_safe() == str(tmp_path / "w")
    assert ttrace.stop_trace_safe() is None and ttrace.trace_active() is None
    names = {e.get("name") for e in json.loads((tmp_path / "w" / ttrace.TRACE_FILE).read_text())["traceEvents"]}
    assert "sc_marked_range" in names
