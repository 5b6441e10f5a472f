"""The port's single-process serving tier (`sparse_coding__tpu_torch/serve`)
held against the JAX package's on the same numpy inputs, on the CPU.

Against JAX: the lanes of a 4-dict group (TiedSAE, UntiedSAE, TopK) within
rtol 1e-5 / atol 1e-6, top-k indices equal away from ties, the int8
residency's q, scales and dequantized weights bit for bit, the stacking
partition, ``/features`` of a JAX subject carried over, the serve half of the
feature sketch, the latency histograms and their exposition, the retry
schedule. The port's own contract, bit for bit: every lane equals the
stack-of-one dispatch at the same bucket, the drainer's route equals the
eager one, top-k values are the dense codes at their indices, int8 lanes
equal int8 stacks of one, ``/features`` equals `harvest_to_device` then
encode. Then JAX's `tests/test_serve.py` cases one for one (registry, engine,
HTTP, the SIGTERM drain under load in a subprocess with ``--device cpu``).
"""

import os
import signal
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_coding__tpu.models import learned_dict as jld
from sparse_coding__tpu.models.topk import TopKLearnedDict as JTopK
from sparse_coding__tpu.serve import engine as jengine
from sparse_coding__tpu.serve import registry as jregistry
from sparse_coding__tpu_torch.models.learned_dict import Identity, TiedSAE, UntiedSAE
from sparse_coding__tpu_torch.models.topk import TopKLearnedDict
from sparse_coding__tpu_torch.serve.engine import EncodeEngine, EncodeRequest, EngineClosed, default_buckets
from sparse_coding__tpu_torch.serve.registry import DictRegistry, group_key_of
from sparse_coding__tpu_torch.serve.server import RetryableRejection, ServeClient, ServeServer
from sparse_coding__tpu_torch.train.checkpoint import save_learned_dicts

pytestmark = pytest.mark.serve

REPO = Path(__file__).resolve().parents[1]
D, N = 16, 64
RTOL, ATOL = 1e-5, 1e-6


def _np(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tied(seed: int, d: int = D, n: int = N) -> TiedSAE:
    return TiedSAE(torch.from_numpy(_np(seed, n, d)), torch.from_numpy(_np(seed + 1000, n, scale=0.1)))


def _rows(seed: int, n: int = 5, d: int = D) -> np.ndarray:
    return _np(seed + 7, n, d)


def _pair(kind: str, seed: int):
    """One dict in both packages from the same numpy arrays: (JAX, port)."""
    enc, bias, dec = _np(seed, N, D), _np(seed + 1, N, scale=0.1), _np(seed + 2, N, D)
    if kind == "TiedSAE":
        return jld.TiedSAE(jnp.asarray(enc), jnp.asarray(bias)), TiedSAE(torch.from_numpy(enc), torch.from_numpy(bias))
    if kind == "UntiedSAE":
        return (jld.UntiedSAE(jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(bias)),
                UntiedSAE(torch.from_numpy(enc), torch.from_numpy(dec), torch.from_numpy(bias)))
    d = enc / np.linalg.norm(enc, axis=1, keepdims=True)
    return JTopK(jnp.asarray(d), 6), TopKLearnedDict(torch.from_numpy(d), 6)


@pytest.fixture()
def registry4():
    reg = DictRegistry(device="cpu")
    for i in range(4):
        reg.add(f"d{i}", _tied(i), hyperparams={"i": i})
    return reg


@pytest.fixture()
def engine4(registry4):
    eng = EncodeEngine(registry4, max_batch=64, max_wait_ms=1.0).start()
    yield eng
    eng.stop()


# -- against the JAX package --------------------------------------------------------

def _close_to_a_tie(vals: np.ndarray, k: int) -> np.ndarray:
    """Rows whose k-th and (k+1)-th values are within tolerance of a tie."""
    s = -np.sort(-vals, axis=-1)
    if k >= s.shape[-1]:
        return np.zeros(s.shape[0], bool)
    return np.abs(s[:, k - 1] - s[:, k]) <= ATOL + RTOL * np.abs(s[:, k])


@pytest.mark.parametrize("kind", ["TiedSAE", "UntiedSAE", "TopKLearnedDict"])
def test_lanes_match_the_jax_engine(kind):
    """Four same-shape dicts through one micro-batch in each package's
    engine, dense and top-k 9."""
    pairs = [_pair(kind, 10 * i) for i in range(4)]
    jreg, reg = jregistry.DictRegistry(), DictRegistry(device="cpu")
    for i, (j, t) in enumerate(pairs):
        jreg.add(f"d{i}", j)
        reg.add(f"d{i}", t)
    jeng = jengine.EncodeEngine(jreg, max_batch=64, max_wait_ms=20.0).start()
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=20.0).start()
    try:
        X = _rows(3, n=11)
        for k in (None, 9):
            jreqs = [jeng.submit(f"d{i}", X, top_k=k) for i in range(4)]
            reqs = [eng.submit(f"d{i}", X, top_k=k) for i in range(4)]
            for jr, r in zip(jreqs, reqs):
                jout, out = jr.result(60), r.result(60)
                if k is None:
                    np.testing.assert_allclose(out, np.asarray(jout), rtol=RTOL, atol=ATOL)
                    dense = out
                else:
                    np.testing.assert_allclose(out[1], np.asarray(jout[1]), rtol=RTOL, atol=ATOL)
                    tie = _close_to_a_tie(dense, k)
                    np.testing.assert_array_equal(out[0][~tie], np.asarray(jout[0])[~tie])
            if k is None:
                dense = reqs[-1].result(1)
    finally:
        jeng.stop()
        eng.stop()


def test_int8_residency_is_the_jax_package_s_bit_for_bit():
    """q, scales and the dequantized weights of f32 and bf16 leaves."""
    enc = _np(5, N, D)
    bf = enc.astype(ml_dtypes.bfloat16)
    cases = [(jld.TiedSAE(jnp.asarray(enc), jnp.zeros((N,))), TiedSAE(torch.from_numpy(enc), torch.zeros(N))),
             (jld.TiedSAE(jnp.asarray(bf), jnp.zeros((N,), jnp.bfloat16)),
              TiedSAE(torch.from_numpy(bf.view(np.int16).copy()).view(torch.bfloat16), torch.zeros(N, dtype=torch.bfloat16)))]
    for j, t in cases:
        jentry = jregistry.ServedDict("a", j, weights="int8")
        entry = DictRegistry(device="cpu").add("a", t, weights="int8")
        jq, q = jentry.quant_leaves[0], entry.quant_leaves[0]
        assert q["dtype"] == jq["dtype"]
        np.testing.assert_array_equal(q["q"].numpy(), np.asarray(jq["q"]))
        np.testing.assert_array_equal(q["scales"].numpy(), np.asarray(jq["scales"]))
        jstack = jengine._Stack([jentry])
        jw = np.asarray(jax.tree.leaves(jstack.dequant_fn(jstack.quant))[0])[0]
        from sparse_coding__tpu_torch.serve.engine import _Stack

        stack = _Stack([entry], torch.device("cpu"))
        stack.dequant()
        w = stack.bufs[0][0]
        bits = w.view(torch.int16).numpy() if w.dtype == torch.bfloat16 else w.numpy().view(np.int32)
        np.testing.assert_array_equal(bits, jw.view(np.int16) if jw.dtype.itemsize == 2 else jw.view(np.int32))


def test_stacking_groups_are_the_jax_package_s():
    specs = [("tied", 16, 64, "f32"), ("tied", 16, 64, "f32"), ("tied", 16, 32, "f32"), ("untied", 16, 64, "f32"),
             ("tied", 16, 64, "bf16"), ("topk3", 16, 64, "f32"), ("topk5", 16, 64, "f32"), ("topk3", 16, 64, "f32")]
    jkeys, keys = [], []
    for i, (kind, d, n, dt) in enumerate(specs):
        enc = _np(i, n, d)
        if kind == "tied":
            jd = jld.TiedSAE(jnp.asarray(enc, jnp.bfloat16 if dt == "bf16" else jnp.float32), jnp.zeros((n,)))
            td = TiedSAE(torch.from_numpy(enc).to(torch.bfloat16 if dt == "bf16" else torch.float32), torch.zeros(n))
        elif kind == "untied":
            jd, td = jld.UntiedSAE(jnp.asarray(enc), jnp.asarray(enc), jnp.zeros((n,))), UntiedSAE(
                torch.from_numpy(enc), torch.from_numpy(enc), torch.zeros(n))
        else:
            k = int(kind[4:])
            jd, td = JTopK(jnp.asarray(enc), k), TopKLearnedDict(torch.from_numpy(enc), k)
        jkeys.append(jregistry.group_key_of(jd))
        keys.append(group_key_of(td))

    def partition(ks):
        return sorted(sorted(i for i, k in enumerate(ks) if k == key) for key in set(ks))

    assert partition(keys) == partition(jkeys)


def test_features_match_the_jax_package():
    """A JAX subject carried over (`interop.lm_params_from_jax`): JAX's
    ``/features`` equals the port's encode of JAX's own harvested rows
    within rtol 1e-5 / atol 1e-6, and the port's ``/features`` equals JAX's
    within the bound one fp16 ulp of each activation allows."""
    from sparse_coding__tpu.lm import model as jm
    from sparse_coding__tpu_torch.interop import lm_params_from_jax
    from sparse_coding__tpu_torch.lm import model as tm

    kw = dict(arch="neox", n_layers=2, d_model=D, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32, rotary_pct=0.25)
    jc, tc = jm.LMConfig(**kw), tm.LMConfig(**kw)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jd, td = _pair("TiedSAE", 4)
    jreg, reg = jregistry.DictRegistry(), DictRegistry(device="cpu")
    jreg.add("f0", jd)
    reg.add("f0", td)
    jreg.attach_subject("s", jp, jc, 1)
    reg.attach_subject("s", tp, tc, 1)
    jeng = jengine.EncodeEngine(jreg, max_batch=64, max_wait_ms=1.0).start()
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=1.0).start()
    try:
        toks = np.random.default_rng(2).integers(0, 64, (3, 8)).astype(np.int32)
        jout = np.asarray(jeng.encode_features("f0", toks))
        out = eng.encode_features("f0", toks)
        from sparse_coding__tpu.data.activations import capture_fn as jcapture

        padded = np.zeros((4, 8), np.int32)
        padded[:3] = toks
        jact = np.asarray(jcapture(jc, (jm.make_tensor_name(1, "residual"),), 2)(jp, jnp.asarray(padded))[
            jm.make_tensor_name(1, "residual")]).reshape(-1, D)[:24]
        np.testing.assert_allclose(eng.encode_naive("f0", jact, bucket=32), jout, rtol=RTOL, atol=ATOL)
        ulp = np.spacing(np.abs(jact)).astype(np.float32)
        bound = 2 * ulp @ np.abs(_np(4, N, D)).T + ATOL
        assert (np.abs(out - jout) <= bound).all()
    finally:
        jeng.stop()
        eng.stop()


@pytest.mark.parametrize("kind", ["dense", "topk"])
def test_serve_feature_sketch_matches_the_jax_package(kind):
    from sparse_coding__tpu.telemetry import feature_stats as jfs
    from sparse_coding__tpu_torch.telemetry import feature_stats as tfs

    cfg_j, cfg_t = jfs.FeatureStatsConfig(), tfs.FeatureStatsConfig()
    codes = np.maximum(_np(1, 3, 10, N), 0.0)
    mask = (np.arange(10)[None, :] < np.array([[10], [4], [7]])).astype(np.float32)
    jst, tst = jfs.init_feature_stats(3, N, cfg_j), tfs.init_feature_stats(3, N, cfg_t)
    if kind == "dense":
        jnew = jfs._accumulate_dense(jst, jnp.asarray(codes), jnp.asarray(mask), cfg_j)
        tnew = tfs._accumulate_dense(tst, torch.from_numpy(codes), torch.from_numpy(mask), cfg_t)
    else:
        jvals, jidx = jax.lax.top_k(jnp.asarray(codes), 8)
        jnew = jfs._accumulate_topk(jst, jidx, jvals, jnp.asarray(mask), cfg_j)
        tnew = tfs._accumulate_topk(tst, torch.from_numpy(np.array(jidx)), torch.from_numpy(np.array(jvals)),
                                    torch.from_numpy(mask), cfg_t)
    for k in tfs.FEATURE_STATS_KEYS:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def test_histograms_and_exposition_match_the_jax_package():
    from sparse_coding__tpu.telemetry import events as jev
    from sparse_coding__tpu.telemetry import metrics_http as jmh
    from sparse_coding__tpu_torch.telemetry import events as tev
    from sparse_coding__tpu_torch.telemetry import metrics_http as tmh

    assert tev.DEFAULT_LATENCY_BUCKETS_MS == jev.DEFAULT_LATENCY_BUCKETS_MS
    jt, tt = jev.RunTelemetry(tags={"replica": "r0"}), tev.RunTelemetry(tags={"replica": "r0"})
    try:
        for t in (jt, tt):
            for v in (0.1, 0.3, 2.0, 7.5, 3000.0):
                t.hist_observe("serve.latency_ms", v)
            t.counter_inc("serve.requests", 5)
            t.gauge_set("serve.batch_occupancy", 0.5)
        assert tt.hists == jt.hists
        assert tmh.CONTENT_TYPE == jmh.CONTENT_TYPE
        assert tmh.telemetry_metrics_text(tt, uptime=False) == jmh.telemetry_metrics_text(jt, uptime=False)
        assert tt.snapshot()["hists"] == jt.snapshot()["hists"]
        assert tt.event("x")["replica"] == "r0"
    finally:
        jt.close()
        tt.close()


def test_trace_context_and_retry_schedule_match_the_jax_package(monkeypatch):
    from sparse_coding__tpu.telemetry.tracing import TraceContext as JTC
    from sparse_coding__tpu.utils import sync as jsync
    from sparse_coding__tpu_torch.telemetry.tracing import TraceContext
    from sparse_coding__tpu_torch.utils import sync

    hdrs = {"X-Trace-Id": "ab" * 16, "X-Parent-Span": "cd" * 8}
    t, j = TraceContext.from_headers(hdrs), JTC.from_headers(hdrs)
    assert (t.trace_id, t.parent_span) == (j.trace_id, j.parent_span) and len(t.span_id) == 16
    assert TraceContext.from_headers({}) is None and t.child().parent_span == t.span_id
    for env in ({}, {"SC_SYNC_RETRIES": "5", "SC_SYNC_BACKOFF": "0.5"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert (sync.default_retries(), sync.default_backoff()) == (jsync.default_retries(), jsync.default_backoff())
        assert sync.backoff_delays(6, sync.default_backoff()) == jsync.backoff_delays(6, jsync.default_backoff())
    slept, calls = [], []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise OSError("transient")
        return "ok"

    assert sync.retry_with_backoff(flaky, attempts=3, base_delay=0.25, sleep=slept.append,
                                   delay_floor_from=lambda e: 0.4) == "ok"
    assert calls == [0, 1, 2] and slept == [0.4, 0.5]
    # sync() builds JAX's command for each scheme and retries a failing tool
    for src, dst, kw in (("/a/", "host:proj", {"excludes": ["*.hdf"], "ssh_port": 2222}),
                         ("/a/", "gs://b/x", {"delete": True}), ("s3://b/x", "/a", {"includes": ["*.csv"]})):
        args = (src, dst, kw.get("includes"), kw.get("excludes"), kw.get("delete", False), kw.get("ssh_port", 22))
        assert sync._build_command(*args) == jsync._build_command(*args)
    runs = []

    def failing_tool(cmd):
        runs.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "boom")

    monkeypatch.setattr(sync.time, "sleep", slept.append)
    with pytest.raises(RuntimeError, match="after 5 attempts"):
        sync.sync("/a/", "host:proj", runner=failing_tool)
    assert len(runs) == 5 and runs[0] == jsync._build_command("/a/", "host:proj", None, None, False, 22)


# -- the port's own contract ---------------------------------------------------------

def test_every_lane_is_the_stack_of_one_at_every_bucket(registry4, engine4):
    """Each bucket, dense and top-k: the drainer's dispatch (the graph
    replay on the card), the eager dispatch and the stack of one agree bit
    for bit; top-k values are the dense codes at their indices; unpadded
    raw encodes agree within 1e-6."""
    for n in (1, 5, 8, 13, 31, 64):
        X = _rows(n, n=n)
        for did in ("d0", "d3"):
            dense = engine4.compare_routes(did, X)
            np.testing.assert_array_equal(dense["graph"], dense["eager"])
            np.testing.assert_array_equal(dense["graph"], dense["naive"])
            raw = registry4.get(did).ld.encode(torch.from_numpy(X)).numpy()
            np.testing.assert_allclose(dense["graph"], raw, rtol=1e-6, atol=1e-6)
            sparse = engine4.compare_routes(did, X, top_k=7)
            for route in ("eager", "naive"):
                for a, b in zip(sparse["graph"], sparse[route]):
                    np.testing.assert_array_equal(a, b)
            idx, vals = sparse["graph"]
            np.testing.assert_array_equal(vals, np.take_along_axis(dense["graph"], idx.astype(np.int64), axis=1))


def test_int8_lanes_equal_int8_stacks_of_one_and_stay_near_native():
    reg = DictRegistry(device="cpu")
    lds = [_tied(i) for i in range(4)]
    for i, ld in enumerate(lds):
        reg.add(f"q{i}", ld, weights="int8")
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=1.0).start()
    try:
        X = _rows(3, n=6)
        outs = [r.result(30) for r in [eng.submit(f"q{i}", X) for i in range(4)]]
        for i in range(4):
            np.testing.assert_array_equal(outs[i], eng.encode_naive(f"q{i}", X))
            np.testing.assert_allclose(outs[i], lds[i].encode(torch.from_numpy(X)).numpy(), atol=0.35, rtol=0.15)
        assert eng.stats["errors"] == 0
    finally:
        eng.stop()


def _subject_registry(ld=None, tokenize=None):
    from sparse_coding__tpu_torch.lm import model as tm

    cfg = tm.LMConfig(arch="neox", n_layers=2, d_model=D, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32,
                      rotary_pct=0.25)
    reg = DictRegistry(device="cpu")
    reg.add("f0", ld or _tied(3, n=32))
    reg.attach_subject("subject", tm.init_params(0, cfg, device="cpu"), cfg, 1, tokenize=tokenize)
    return reg


@pytest.fixture(scope="module")
def features_setup():
    reg = _subject_registry()
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=1.0).start()
    yield reg, eng
    eng.stop()


def test_features_equal_harvest_then_encode(features_setup):
    from sparse_coding__tpu_torch.data.activations import harvest_to_device

    reg, eng = features_setup
    subj = reg.get_subject()
    toks = np.random.default_rng(7).integers(0, 64, size=(4, 8)).astype(np.int32)
    fused = eng.encode_features("f0", toks)
    chunk = next(harvest_to_device(subj.params, subj.lm_cfg, toks, [1], ["residual"], batch_size=4,
                                   chunk_size_gb=4 * 8 * D * 2 / 1024**3, n_chunks=1, device="cpu"))[(1, "residual")]
    assert chunk.dtype == torch.float16
    np.testing.assert_array_equal(fused, eng.encode("f0", chunk))
    np.testing.assert_array_equal(fused, eng.features_naive("f0", toks))
    idx, vals = eng.encode_features("f0", toks, top_k=11)
    for r in range(fused.shape[0]):
        np.testing.assert_array_equal(vals[r], fused[r][idx[r]])


@pytest.mark.parametrize("case", ["validation", "never_exceeds_warmed_menu", "micro_batch"])
def test_features_cases(features_setup, case):
    reg, eng = features_setup
    if case == "validation":
        with pytest.raises(ValueError, match="integers"):
            eng.submit_features("f0", np.zeros((2, 4), np.float32))
        with pytest.raises(ValueError, match="dispatch cap"):
            eng.submit_features("f0", np.zeros((8, 32), np.int32))
        with pytest.raises(KeyError):
            eng.submit_features("f0", np.zeros((1, 4), np.int32), subject="nope")
        reg.add("narrow", _tied(9, d=8, n=32))
        try:
            with pytest.raises(ValueError, match="width"):
                eng.submit_features("narrow", np.zeros((1, 4), np.int32))
        finally:
            reg.remove("narrow")
        return
    # a linger of 1 s: coalescing rests on no host timing tighter than that
    e2 = EncodeEngine(reg, max_batch=64, max_wait_ms=1000.0).start()
    try:
        if case == "never_exceeds_warmed_menu":
            S = 6  # 64 // 6 = 10: not a power of two
            cap = e2._seq_cap(S)
            assert cap == 8 and cap * S <= 64
            e2.warmup_features(S)
            warm = set(e2.compiled_shapes)
            with pytest.raises(ValueError, match="dispatch cap"):
                e2.submit_features("f0", np.zeros((cap + 1, S), np.int32))
            reqs = [e2.submit_features("f0", np.full((2, S), 3 + i, np.int32)) for i in range(5)]
            outs = [r.result(60) for r in reqs]
            assert all(o.shape == (2 * S, 32) for o in outs)
            assert set(e2.compiled_shapes) == warm
            for out, r in zip(outs, reqs):
                np.testing.assert_array_equal(out, e2.features_naive("f0", np.full((2, S), 3 + reqs.index(r), np.int32),
                                                                     seq_bucket=r.bucket // S))
        else:
            e2.warmup_features(8)
            before = e2.stats["batches"]
            results = [None] * 6

            def client(i):
                results[i] = e2.encode_features("f0", np.full((1, 8), 5 + i, np.int32))

            threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert all(r is not None and r.shape == (8, 32) for r in results)
            assert e2.stats["batches"] - before < 6
    finally:
        e2.stop()


def test_features_texts_path(monkeypatch):
    from sparse_coding__tpu_torch.data.activations import chunk_and_tokenize_texts
    from sparse_coding__tpu_torch.serve.server import local_tokenizer

    stub = lambda t: [ord(c) % 61 + 1 for c in t]  # noqa: E731
    reg = _subject_registry(tokenize=stub)
    with ServeServer(reg, max_batch=256, max_wait_ms=1.0) as srv:
        client = srv.client()
        texts = ["hello world, this is a sentence"] * 4
        out = client.encode_features("f0", texts=texts, seq_len=8, format="raw")
        toks = chunk_and_tokenize_texts(texts, stub, eos_id=0, max_length=8)
        np.testing.assert_array_equal(out, srv.engine.encode_features("f0", toks))
    # without the tokenizer package, texts answer 400 naming it; tokens work
    monkeypatch.setitem(sys.modules, "transformers", None)
    reg = _subject_registry(tokenize=local_tokenizer("/nonexistent"))
    with ServeServer(reg, max_batch=64, max_wait_ms=1.0) as srv:
        client = srv.client()
        with pytest.raises(RuntimeError, match="400.*transformers"):
            client.encode_features("f0", texts=["some text here"] * 3, seq_len=4)
        assert client.encode_features("f0", tokens=np.ones((1, 4), np.int32)).shape == (4, 32)


# -- JAX's tests/test_serve.py, case for case -------------------------------------------

@pytest.mark.parametrize("case", ["verifies_manifest", "legacy_warns", "fleet_dir_verifies", "validates_first",
                                  "hot_add_swap_remove", "int8_rejects_leafless", "int8_quantizes_bf16"])
def test_registry_cases(tmp_path, registry4, case):
    p = tmp_path / "learned_dicts.pkl"
    if case == "verifies_manifest":
        save_learned_dicts(p, [(_tied(0), {"a": 1}), (_tied(1), {"a": 2})])
        reg = DictRegistry(device="cpu")
        assert reg.load_export(p) == ["learned_dicts:0", "learned_dicts:1"]
        assert reg.get("learned_dicts:0").hyperparams == {"a": 1}
        with open(p, "ab") as f:
            f.write(b"\x00")
        with pytest.raises(ValueError, match="manifest"):
            DictRegistry(device="cpu").load_export(p)
    elif case == "legacy_warns":
        save_learned_dicts(p, [(_tied(0), {})], manifest=False)
        with pytest.warns(RuntimeWarning, match="legacy"):
            assert len(DictRegistry(device="cpu").load_export(p)) == 1
    elif case == "fleet_dir_verifies":
        from sparse_coding__tpu_torch.fleet import write_export_manifest

        JRegistry = jregistry.DictRegistry

        for member in ("m0", "m1"):
            (tmp_path / member).mkdir()
            save_learned_dicts(tmp_path / member / "learned_dicts.pkl", [(_tied(len(member)), {})])
        reg = DictRegistry(device="cpu")
        assert sorted(reg.load_export(tmp_path)) == ["m0:0", "m1:0"]
        # a fleet run dir: its export manifest verifies the whole dir (then
        # no sidecar is needed), as in the JAX package's registry
        write_export_manifest(tmp_path)
        for member in ("m0", "m1"):
            (tmp_path / member / "learned_dicts.pkl.manifest.json").unlink()
        fleet_reg = DictRegistry(device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ids = fleet_reg.load_export(tmp_path)
        assert sorted(ids) == sorted(JRegistry().load_export(tmp_path)) == ["m0:0", "m1:0"]
        assert torch.equal(fleet_reg.get("m1:0").ld.encoder, reg.get("m1:0").ld.encoder)
        with open(tmp_path / "m0" / "learned_dicts.pkl", "ab") as f:
            f.write(b"\x00")
        for registry in (DictRegistry(device="cpu"), JRegistry()):
            with pytest.raises(ValueError, match="failed manifest verification"):
                registry.load_export(tmp_path)
    elif case == "validates_first":
        save_learned_dicts(p, [(_tied(0), {}), (_tied(1), {})])
        reg = DictRegistry(device="cpu")
        with pytest.raises(ValueError, match="dict_ids lists 1"):
            reg.load_export(p, dict_ids=["only_one"])
        assert len(reg) == 0 and reg.generation == 0
        reg.add("taken", _tied(2))
        with pytest.raises(ValueError, match="already registered"):
            reg.load_export(p, dict_ids=["taken", "fresh"])
        assert reg.ids() == ["taken"]
    elif case == "hot_add_swap_remove":
        gen0 = registry4.generation
        with pytest.raises(ValueError, match="already registered"):
            registry4.add("d0", _tied(9))
        registry4.swap("d0", _tied(9))
        assert registry4.generation > gen0
        registry4.remove("d3")
        assert "d3" not in registry4 and len(registry4) == 3
        with pytest.raises(KeyError):
            registry4.get("d3")
        meta = registry4.describe()
        assert {m["dict"] for m in meta} == {"d0", "d1", "d2"} and all(m["class"] == "TiedSAE" for m in meta)
    elif case == "int8_rejects_leafless":
        with pytest.raises(ValueError, match="no array leaves"):
            DictRegistry(device="cpu").add("id", Identity(D, device="cpu"), weights="int8")
    else:
        ld = TiedSAE(torch.from_numpy(_np(0, N, D)).to(torch.bfloat16), torch.zeros(N, dtype=torch.bfloat16))
        reg = DictRegistry(device="cpu")
        entry = reg.add("b0", ld, weights="int8")
        assert any(m is not None and m["dtype"] == "bfloat16" for m in entry.quant_leaves)
        eng = EncodeEngine(reg, max_batch=64).start()
        try:
            X = torch.from_numpy(_rows(8, n=4))
            out = eng.encode("b0", X.to(torch.bfloat16))
            np.testing.assert_allclose(out.float().numpy(), ld.encode(X.to(torch.bfloat16)).float().numpy(),
                                       atol=0.5, rtol=0.2)
        finally:
            eng.stop()


@pytest.mark.parametrize("case", ["multi_tenant", "bucketing_and_slicing", "no_compile_after_warmup", "coalesces",
                                  "mid_batch_removal", "retry_once_rebuild", "hot_swap", "validation",
                                  "drain_then_reject"])
def test_engine_cases(registry4, engine4, case):
    if case == "multi_tenant":
        X = _rows(0, n=9)
        outs = [r.result(30) for r in [engine4.submit(f"d{i}", X) for i in range(4)]]
        for i in range(4):
            np.testing.assert_array_equal(outs[i], engine4.encode_naive(f"d{i}", X))
            np.testing.assert_allclose(outs[i], registry4.get(f"d{i}").ld.encode(torch.from_numpy(X)).numpy(),
                                       rtol=1e-6, atol=1e-6)
    elif case == "bucketing_and_slicing":
        for n in (1, 3, 8, 17, 33):
            assert engine4.encode("d1", _rows(n, n=n)).shape == (n, N)
    elif case == "no_compile_after_warmup":
        engine4.warmup()
        warm = set(engine4.compiled_shapes)
        assert len(warm) == len(default_buckets(64))
        for n in (1, 2, 5, 7, 11, 13, 19, 29, 37, 53, 64):
            engine4.encode("d2", _rows(n, n=n))
        assert set(engine4.compiled_shapes) == warm and engine4.captures == 0  # no graphs on the CPU
    elif case == "coalesces":
        eng = EncodeEngine(registry4, max_batch=64, max_wait_ms=1000.0).start()
        try:
            eng.warmup()
            results = [None] * 16

            def client(i):
                results[i] = eng.encode(f"d{i % 4}", _rows(i, n=2))

            threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert all(r is not None and r.shape == (2, N) for r in results)
            assert eng.stats["batches"] < 16 and eng.stats["requests"] == 16
        finally:
            eng.stop()
    elif case == "mid_batch_removal":
        registry4.remove("d3")
        victim = EncodeRequest("d3", torch.from_numpy(_rows(0, n=2)))
        survivor_in = _rows(1, n=3)
        survivor = EncodeRequest("d0", torch.from_numpy(survivor_in))
        engine4._rebuild_stacks()
        fresh = engine4._stacks[(registry4.get("d0").group_key, "native")]
        assert "d3" not in fresh.ids
        engine4._run_group(fresh, [victim, survivor], time.time())
        with pytest.raises(KeyError):
            victim.result(5)
        np.testing.assert_array_equal(survivor.result(5), engine4.encode_naive("d0", survivor_in, bucket=8))
        assert engine4.encode("d1", _rows(2, n=2)).shape == (2, N)
    elif case == "retry_once_rebuild":
        engine4.encode("d0", _rows(0, n=2))
        odd = _tied(5, n=N // 2)
        registry4.add("odd", odd)
        engine4._stacks_generation = registry4.generation  # the window the generation check cannot see
        odd_key = (registry4.get("odd").group_key, "native")
        assert odd_key not in engine4._stacks
        X = _rows(6, n=3)
        out = engine4.encode("odd", X, timeout=30)
        np.testing.assert_array_equal(out, engine4.encode_naive("odd", X))
        np.testing.assert_allclose(out, odd.encode(torch.from_numpy(X)).numpy(), rtol=1e-6, atol=1e-6)
        assert engine4.stats["errors"] == 0 and odd_key in engine4._stacks
    elif case == "hot_swap":
        X = _rows(4, n=3)
        before = engine4.encode("d0", X)
        stack = engine4._stacks[(registry4.get("d0").group_key, "native")]
        new_ld = _tied(123)
        registry4.swap("d0", new_ld)
        after = engine4.encode("d0", X)
        assert engine4._stacks[(registry4.get("d0").group_key, "native")] is stack  # weights copied in place
        np.testing.assert_allclose(after, new_ld.encode(torch.from_numpy(X)).numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(after, engine4.encode_naive("d0", X))
        assert not np.array_equal(before, after)
    elif case == "validation":
        with pytest.raises(KeyError):
            engine4.submit("nope", _rows(0))
        with pytest.raises(ValueError, match="width"):
            engine4.submit("d0", np.zeros((2, D + 1), np.float32))
        with pytest.raises(ValueError, match="max_batch"):
            engine4.submit("d0", np.zeros((65, D), np.float32))
    else:
        eng = EncodeEngine(registry4, max_batch=64, max_wait_ms=50.0).start()
        eng.warmup()
        reqs = [eng.submit("d0", _rows(i, n=2)) for i in range(8)]
        eng.stop(drain=True)
        for r in reqs:
            assert r.result(10).shape == (2, N)
        with pytest.raises(EngineClosed):
            eng.submit("d0", _rows(0, n=2))
        assert eng.stats["rejected"] == 1


@pytest.mark.parametrize("case", ["roundtrip", "healthz", "drain_503", "metrics", "features_stats"])
def test_http_cases(registry4, case, tmp_path):
    if case == "roundtrip":
        with ServeServer(registry4, max_batch=64, max_wait_ms=1.0) as srv:
            client = srv.client()
            health = client.healthz()
            assert health["status"] == "ok" and health["dicts"] == 4
            assert {m["dict"] for m in client.dicts()} == {"d0", "d1", "d2", "d3"}
            X = _rows(5, n=4)
            np.testing.assert_allclose(client.encode("d2", X),
                                       registry4.get("d2").ld.encode(torch.from_numpy(X)).numpy(), rtol=1e-5, atol=1e-6)
            with pytest.raises(RuntimeError, match="404"):
                client._request("POST", "/encode", {"dict": "nope", "rows": [[0.0] * D]})
            with pytest.raises(RuntimeError, match="400"):
                client._request("POST", "/encode", {"dict": "d0"})
    elif case == "healthz":
        srv = ServeServer(registry4, max_batch=64, max_wait_ms=1.0, dict_generation=3, replica_id="replica7").start()
        try:
            client = srv.client()
            client.encode("d0", _rows(1, n=4))
            h = client.healthz()
            assert h["status"] == "ok" and h["draining"] is False and h["queue_depth"] == 0
            assert 0.0 < h["batch_occupancy"] <= 1.0
            assert h["registry_generation"] == registry4.generation and h["dict_generation"] == 3
            assert h["replica"] == "replica7" and h["requests"] >= 1 and h["errors"] == 0
            srv.drain()
            assert client.healthz()["status"] == "draining"
        finally:
            srv.close()
    elif case == "drain_503":
        srv = ServeServer(registry4, max_batch=64, max_wait_ms=1.0).start()
        try:
            client = srv.client()
            assert client.encode("d0", _rows(6, n=2)).shape == (2, N)
            srv.drain()
            with pytest.raises(RetryableRejection):
                client.encode("d0", _rows(7, n=2))
            retrying = ServeClient(srv.address, retries=2, backoff_base=0.0)
            with pytest.raises(RetryableRejection):
                retrying.encode("d0", _rows(7, n=2))
        finally:
            srv.close()
    elif case == "metrics":
        from sparse_coding__tpu_torch.telemetry.events import RunTelemetry

        tel = RunTelemetry()
        try:
            with ServeServer(registry4, max_batch=64, max_wait_ms=1.0, telemetry=tel) as srv:
                client = srv.client()
                client.encode("d0", _rows(1, n=3), format="npz")
                text = client._request_full("GET", "/metrics", raw=True)[0].decode()
            assert "sc_serve_requests_total 1" in text and "sc_serve_latency_ms_bucket" in text
            assert "sc_serve_bytes_out_npz_total" in text and "sc_span_encode_count_total" in text
        finally:
            tel.close()
    else:
        from sparse_coding__tpu_torch.telemetry.events import RunTelemetry

        tel = RunTelemetry(out_dir=str(tmp_path))
        try:
            srv = ServeServer(registry4, max_batch=64, max_wait_ms=1.0, telemetry=tel, feature_stats=True).start()
            client = srv.client()
            X = _rows(2, n=5)
            plain = EncodeEngine(registry4, max_batch=64).encode_naive("d1", X)
            np.testing.assert_array_equal(client.encode("d1", X), plain)
            client.encode("d2", X, top_k=4)
            srv.drain()
            srv.close()
            snaps = sorted(tmp_path.glob("feature_stats.serve*.npz"))
            assert len(snaps) == 1
            from sparse_coding__tpu_torch.telemetry.feature_stats import FeatureSnapshot

            snap = FeatureSnapshot.load(snaps[0])
            assert snap.names == ["d0", "d1", "d2", "d3"] and list(snap.rows) == [0, 5, 5, 0]
        finally:
            tel.close()


@pytest.mark.chaos
def test_sigterm_under_load_drains_clean(tmp_path):
    """SIGTERM a loaded ``--device cpu`` server process: every request ends as
    a bit-correct 200 (against the stack of one at its bucket), a clean
    retryable 503 or a connection error after the listener closed; the
    server exits 0 and logs the drain."""
    export = tmp_path / "learned_dicts.pkl"
    lds = [_tied(i) for i in range(2)]
    save_learned_dicts(export, [(ld, {"i": i}) for i, ld in enumerate(lds)])
    port_file, events_dir = tmp_path / "port", tmp_path / "serve_events"
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparse_coding__tpu_torch.serve.server", str(export), "--device", "cpu", "--port", "0",
         "--port-file", str(port_file), "--events", str(events_dir), "--max-batch", "64", "--max-wait-ms", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        deadline = time.time() + 120
        while not port_file.exists() and time.time() < deadline:
            if proc.poll() is not None:
                pytest.fail(f"server died early:\n{proc.stdout.read()}")
            time.sleep(0.1)
        assert port_file.exists(), "server never bound a port"
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        payload = _rows(42, n=3)
        reg = DictRegistry(device="cpu")
        reg.load_export(export)
        ref = EncodeEngine(reg, max_batch=64)
        outcomes = {"ok": 0, "rejected": 0, "conn_error": 0, "bad": []}
        lock = threading.Lock()
        stop = threading.Event()

        def client_loop(cid: int):
            import urllib.error

            client = ServeClient(url, timeout=30)
            i = 0
            while not stop.is_set():
                did = f"learned_dicts:{(cid + i) % 2}"
                i += 1
                try:
                    codes = client.encode(did, payload)
                except RetryableRejection:
                    with lock:
                        outcomes["rejected"] += 1
                    continue
                except (urllib.error.URLError, ConnectionError, OSError):
                    with lock:
                        outcomes["conn_error"] += 1
                    time.sleep(0.02)
                    continue
                except Exception as e:  # torn response / anything unclean
                    with lock:
                        outcomes["bad"].append(repr(e))
                    continue
                want = ref.encode_naive(did, payload, bucket=client.last_meta["bucket"])
                with lock:
                    if np.array_equal(codes, want):
                        outcomes["ok"] += 1
                    else:
                        outcomes["bad"].append(f"wrong codes for {did}")

        threads = [threading.Thread(target=client_loop, args=(c,)) for c in range(6)]
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while time.time() < deadline:
            with lock:
                if outcomes["ok"] >= 12:
                    break
            time.sleep(0.05)
        with lock:
            assert outcomes["ok"] >= 12, f"no load reached the server: {outcomes}"
        proc.send_signal(signal.SIGTERM)
        time.sleep(1.0)  # clients keep sending through the drain window
        stop.set()
        for t in threads:
            t.join(30)
        rc = proc.wait(timeout=120)
        out = proc.stdout.read()
        assert rc == 0, f"exit {rc}:\n{out}"
        assert outcomes["bad"] == [], outcomes["bad"]
        assert "drain requested" in out and "drained clean" in out
        assert '"event": "serve_drained"' in (events_dir / "events.jsonl").read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from sparse_coding__tpu_torch.serve.server import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DictRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["nonexistent.pkl", "--port", "0"])
    import sparse_coding__tpu_torch.serve as serve
    from sparse_coding__tpu_torch.serve.router import Router

    # the replica tier is exported since ROADMAP A7b; its replicas get no
    # fallback either (tests/test_torch_replicaset.py)
    assert serve.Router is Router
