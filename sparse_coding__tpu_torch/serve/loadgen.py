"""Closed-loop synthetic load generator for the serving path.

Counterpart of the JAX package's `scripts/loadgen.py`, with its options and
its JSON output. Drives the encode service in-process (`EncodeEngine`), over
HTTP (`ServeClient`) or through an in-process `serve.router.Router` in front
of replica URLs, with N client threads in *closed loop*: each client sends
its next request only after the previous one returned (open-loop generators
overstate throughput and understate latency under queueing).

Output: one JSON blob with the sustained throughput (rows/s, requests/s),
a log-spaced latency histogram and p50/p95/p99; ``--targets`` adds the
per-outcome accounting (ok / retried-ok / shed / failed), the router's stats
and the replicas' states.

CLI::

    python -m sparse_coding__tpu_torch.serve.loadgen --url http://127.0.0.1:8777 \\
        --dict d0 --clients 8 --requests 64 --rows 4
    python -m sparse_coding__tpu_torch.serve.loadgen --targets URL0 URL1 --top-k 32 ...
    python -m sparse_coding__tpu_torch.serve.loadgen --export out/learned_dicts.pkl \\
        --device cpu --clients 8 ...

``--slo slo.json`` evaluates the SLO objectives against the measured
latency histogram and counts (`telemetry.slo.evaluate_measured`), adds the
verdict under ``"slo"`` and exits 1 past budget. Importable: `run_load` /
`latency_stats`.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

# one nearest-rank percentile: the engine's gauges and the load generator's
# reported percentiles never diverge
from sparse_coding__tpu_torch.serve.engine import _percentile

__all__ = ["latency_stats", "latency_histogram", "run_load", "main"]


def latency_stats(latencies_ms: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 (nearest-rank), mean, max over a latency sample."""
    lat = sorted(float(v) for v in latencies_ms)
    if not lat:
        return {"n": 0, "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                "mean_ms": 0.0, "max_ms": 0.0}
    return {
        "n": len(lat),
        "p50_ms": round(_percentile(lat, 0.50), 3),
        "p95_ms": round(_percentile(lat, 0.95), 3),
        "p99_ms": round(_percentile(lat, 0.99), 3),
        "mean_ms": round(sum(lat) / len(lat), 3),
        "max_ms": round(lat[-1], 3),
    }


def latency_histogram(
    latencies_ms: Sequence[float], n_buckets: int = 12, base_ms: float = 0.25
) -> List[Dict[str, Any]]:
    """Log-spaced latency buckets (each bound 2x the previous): the shape a
    dashboard heatmap wants, cheap enough to print in a terminal."""
    bounds = [base_ms * (2 ** i) for i in range(n_buckets)]
    counts = [0] * (n_buckets + 1)
    for v in latencies_ms:
        for i, b in enumerate(bounds):
            if v <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    out = []
    lo = 0.0
    for i, b in enumerate(bounds):
        if counts[i]:
            out.append({"le_ms": round(b, 3), "gt_ms": round(lo, 3),
                        "count": counts[i]})
        lo = b
    if counts[-1]:
        out.append({"le_ms": None, "gt_ms": round(lo, 3), "count": counts[-1]})
    return out


def run_load(
    encode_fn: Callable[[str, np.ndarray], np.ndarray],
    dict_ids: Sequence[str],
    n_clients: int = 8,
    requests_per_client: int = 32,
    rows_per_request: int = 4,
    width: int = 512,
    seed: int = 0,
    histogram: bool = False,
    with_meta: bool = False,
    traced: bool = False,
    payload_fn: Optional[Callable[[np.random.Generator], np.ndarray]] = None,
    rows_of: Optional[Callable[[np.ndarray], int]] = None,
    bytes_snapshot: Optional[Callable[[], Dict[str, int]]] = None,
) -> Dict[str, Any]:
    """Closed-loop load: ``n_clients`` threads, each sending
    ``requests_per_client`` encodes of ``rows_per_request`` rows round-robin
    across ``dict_ids``, next request only after the previous returned.

    ``encode_fn(dict_id, rows) -> codes`` may raise; exceptions whose type
    name contains "Shed" count as ``shed`` (the router's fast load-shed
    503), other "Retryable"/"EngineClosed" as ``rejected`` (the clean drain
    hand-back), anything else as ``errors``. ``with_meta=True`` expects
    ``encode_fn`` to return ``(codes, meta)`` (a `RouterClient
    .encode_with_meta`) and splits ``ok`` into first-try vs ``retried_ok``
    (``meta["attempts"] > 1`` — the router retried transparently) — the
    per-outcome accounting the replica-tier chaos acceptance reads.

    ``traced=True`` mints one `telemetry.tracing` trace id per request and
    calls ``encode_fn(dict_id, rows, trace_id)``; the result gains a
    ``per_request`` list of ``{"trace_id", "latency_ms", "outcome",
    "attempts", "replica"}`` records — join them against ``python -m
    sparse_coding__tpu_torch.trace`` on the server-side run dir to explain any
    individual latency.

    ``payload_fn(rng)`` overrides payload generation (the /features path
    sends int token rows, not float activations) with ``rows_of(payload)``
    naming how many encoded rows a payload produces (token payloads expand
    to ``n_seq × seq_len``). ``bytes_snapshot`` (e.g. a `ServeClient
    .bytes_snapshot` bound method) is sampled before/after the run and the
    delta lands in the result as ``request_bytes`` / ``response_bytes`` +
    per-request/row rates (bytes per row by wire format). Returns
    the stats blob described in the module docstring."""
    rng = np.random.default_rng(seed)
    if payload_fn is None:
        payload_fn = lambda r: r.standard_normal(
            (rows_per_request, width)
        ).astype(np.float32)
    if rows_of is None:
        rows_of = lambda p: int(p.shape[0])
    # pre-generate request payloads so generation cost never pollutes timing
    payloads = [
        payload_fn(rng)
        for _ in range(min(64, n_clients * requests_per_client))
    ]
    if traced:
        from sparse_coding__tpu_torch.telemetry.tracing import mint_trace_id
    latencies: List[float] = []
    per_request: List[Dict[str, Any]] = []
    counts = {
        "ok": 0, "retried_ok": 0, "rejected": 0, "shed": 0, "errors": 0,
        "rows": 0,
    }
    lock = threading.Lock()

    def client(cid: int) -> None:
        for i in range(requests_per_client):
            did = dict_ids[(cid + i) % len(dict_ids)]
            rows = payloads[(cid * requests_per_client + i) % len(payloads)]
            trace_id = mint_trace_id() if traced else None
            t0 = time.monotonic()
            try:
                if traced:
                    result = encode_fn(did, rows, trace_id)
                else:
                    result = encode_fn(did, rows)
            except Exception as e:
                kind = type(e).__name__
                with lock:
                    if "Shed" in kind:
                        counts["shed"] += 1
                        outcome = "shed"
                    elif "Retryable" in kind or "EngineClosed" in kind:
                        counts["rejected"] += 1
                        outcome = "rejected"
                    else:
                        counts["errors"] += 1
                        outcome = f"error:{kind}"
                    if traced:
                        per_request.append({
                            "trace_id": trace_id, "latency_ms": None,
                            "outcome": outcome,
                        })
                continue
            dt_ms = (time.monotonic() - t0) * 1e3
            meta = result[1] if with_meta else {}
            with lock:
                latencies.append(dt_ms)
                counts["ok"] += 1
                if with_meta and int(meta.get("attempts", 1) or 1) > 1:
                    counts["retried_ok"] += 1
                counts["rows"] += rows_of(rows)
                if traced:
                    rec = {
                        "trace_id": trace_id,
                        "latency_ms": round(dt_ms, 3),
                        "outcome": "ok",
                    }
                    if with_meta:
                        rec["attempts"] = int(meta.get("attempts", 1) or 1)
                        rec["replica"] = meta.get("replica")
                    per_request.append(rec)

    threads = [
        threading.Thread(target=client, args=(c,), name=f"loadgen-{c}")
        for c in range(n_clients)
    ]
    bytes_before = bytes_snapshot() if bytes_snapshot else None
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    bytes_after = bytes_snapshot() if bytes_snapshot else None
    out: Dict[str, Any] = {
        "clients": n_clients,
        "requests": counts["ok"],
        "retried_ok": counts["retried_ok"],
        "rejected": counts["rejected"],
        "shed": counts["shed"],
        "errors": counts["errors"],
        "rows": counts["rows"],
        "wall_seconds": round(wall, 4),
        "rows_per_sec": round(counts["rows"] / wall, 1) if wall > 0 else 0.0,
        "requests_per_sec": round(counts["ok"] / wall, 1) if wall > 0 else 0.0,
        **latency_stats(latencies),
    }
    if bytes_before is not None:
        sent = bytes_after["bytes_sent"] - bytes_before["bytes_sent"]
        recv = bytes_after["bytes_received"] - bytes_before["bytes_received"]
        out["request_bytes"] = int(sent)
        out["response_bytes"] = int(recv)
        # per-request/row rates only for a fully-clean run: the byte
        # counters see EVERY round trip (shed/error bodies, each retry
        # attempt), so dividing them by ok-rows under failures would
        # inflate the bytes/row evidence — totals stay, rates go honest
        failures = (
            counts["rejected"] + counts["shed"] + counts["errors"]
        )
        if counts["ok"] and not failures:
            out["response_bytes_per_request"] = round(recv / counts["ok"], 1)
            out["response_bytes_per_row"] = round(recv / counts["rows"], 1)
    if histogram:
        out["histogram"] = latency_histogram(latencies)
    if traced:
        out["per_request"] = per_request
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sparse_coding__tpu_torch.serve.loadgen",
                                 description=__doc__.split("\n\n")[0])
    target = ap.add_mutually_exclusive_group(required=True)
    target.add_argument("--url", help="serve server base URL (HTTP mode)")
    target.add_argument(
        "--export",
        help="learned-dict export path — spin up an IN-PROCESS engine "
        "(no HTTP) and drive it directly",
    )
    ap.add_argument("--device", default=None,
                    help="--export mode: where the in-process engine runs "
                    "(default: the CUDA card; 'cpu' for the CPU)")
    target.add_argument(
        "--targets", nargs="+", metavar="URL",
        help="backend serve replica URLs — spin up an IN-PROCESS "
        "`serve.router.Router` in front of them and drive THROUGH it, "
        "with per-outcome accounting (ok / retried-ok / shed / failed)",
    )
    ap.add_argument("--dict", dest="dicts", action="append", default=None,
                    help="dict id(s) to target (default: all registered)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per client")
    ap.add_argument("--rows", type=int, default=4, help="rows per request")
    ap.add_argument("--width", type=int, default=None,
                    help="activation width (default: read from /dicts or "
                    "the loaded export)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="in-process engine batch budget")
    ap.add_argument("--format", choices=("json", "npz", "raw"),
                    default="json",
                    help="wire format for request AND response bodies "
                    "(serve.wire; HTTP modes only)")
    ap.add_argument("--endpoint", choices=("encode", "features"),
                    default="encode",
                    help="drive POST /encode (activation rows) or POST "
                    "/features (raw tokens through the fused subject-LM "
                    "capture→encode path)")
    ap.add_argument("--top-k", type=int, default=None, dest="top_k",
                    help="request sparse top-k responses (indices + values "
                    "instead of dense codes)")
    ap.add_argument("--seq-len", type=int, default=32,
                    help="features: tokens per sequence")
    ap.add_argument("--seqs", type=int, default=1,
                    help="features: sequences per request")
    ap.add_argument("--subject", default=None, metavar="SPEC",
                    help="in-process mode: attach a subject LM "
                    "('random:<model>:<layer>:<loc>[:seed]', see "
                    "serve.server --subject) for --endpoint features")
    ap.add_argument("--naive", action="store_true",
                    help="in-process mode: drive the naive per-request path "
                    "instead of the micro-batched engine")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="--targets mode: router hedge threshold")
    ap.add_argument("--trace", action="store_true",
                    help="mint an X-Trace-Id per request and record "
                    "per-request trace id + latency in the JSON output "
                    "(reconstruct server-side with `python -m "
                    "sparse_coding__tpu_torch.trace`)")
    ap.add_argument("--slo", default=None, metavar="slo.json",
                    help="evaluate SLO objectives against the measured "
                    "latency histogram/counts at the end of the run; "
                    "exit 1 past budget (telemetry.slo)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    fmt, top_k = args.format, args.top_k

    def feature_payloads(vocab: int):
        payload_fn = lambda r: np.asarray(
            r.integers(0, int(vocab), size=(args.seqs, args.seq_len)),
            dtype=np.int32,
        )
        rows_of = lambda p: int(p.shape[0]) * int(p.shape[1])
        return payload_fn, rows_of

    def http_fns(client):
        """(encode_fn, load kwargs) for an HTTP client at the chosen
        endpoint/format — bytes accounted through the client's counters."""
        extra: Dict[str, Any] = {
            "bytes_snapshot": client.bytes_snapshot,
        }
        if args.endpoint == "features":
            subjects = client.subjects()
            if not subjects:
                ap.error("server has no subject LM attached — "
                         "/features unavailable (serve.server --subject)")
            payload_fn, rows_of = feature_payloads(subjects[0]["vocab_size"])
            extra.update(payload_fn=payload_fn, rows_of=rows_of)
            fn = lambda d, toks, t=None: client.encode_features(
                d, tokens=toks, format=fmt, top_k=top_k, trace=t
            )
            return fn, extra
        fn = lambda d, r, t=None: client.encode(
            d, r, format=fmt, top_k=top_k, trace=t
        )
        return fn, extra

    if args.targets:
        from sparse_coding__tpu_torch.serve.router import Router

        with Router(args.targets, hedge_ms=args.hedge_ms) as router:
            client = router.client()
            dicts = args.dicts or [d["dict"] for d in client.dicts()]
            width = args.width
            if width is None:
                width = next(
                    d["activation_size"] for d in client.dicts()
                    if d["dict"] == dicts[0]
                )
            with_meta = args.endpoint == "encode"
            if with_meta:
                fn = lambda d, r, t=None: client.encode_with_meta(
                    d, r, trace=t, format=fmt, top_k=top_k
                )
                extra = {"bytes_snapshot": client.bytes_snapshot}
            else:
                fn, extra = http_fns(client)
            encode_fn = fn if args.trace else (lambda d, r: fn(d, r))
            result = run_load(
                encode_fn, dicts, n_clients=args.clients,
                requests_per_client=args.requests, rows_per_request=args.rows,
                width=width, seed=args.seed, histogram=True,
                with_meta=with_meta, traced=args.trace, **extra,
            )
            result["router"] = dict(router.stats)
            result["replica_states"] = router.states()
    elif args.url:
        from sparse_coding__tpu_torch.serve.server import ServeClient

        client = ServeClient(args.url)
        dicts = args.dicts or [d["dict"] for d in client.dicts()]
        width = args.width
        if width is None:
            width = next(
                d["activation_size"] for d in client.dicts()
                if d["dict"] == dicts[0]
            )
        fn, extra = http_fns(client)
        encode_fn = fn if args.trace else (lambda d, r: fn(d, r))
        result = run_load(
            encode_fn, dicts, n_clients=args.clients,
            requests_per_client=args.requests, rows_per_request=args.rows,
            width=width, seed=args.seed, histogram=True, traced=args.trace,
            **extra,
        )
    else:
        from sparse_coding__tpu_torch.serve.engine import EncodeEngine
        from sparse_coding__tpu_torch.serve.registry import DictRegistry

        registry = DictRegistry(device=args.device)
        registry.load_export(args.export)
        if args.subject:
            from sparse_coding__tpu_torch.serve.server import attach_subject_from_spec

            attach_subject_from_spec(registry, args.subject)
        dicts = args.dicts or registry.ids()
        width = args.width or registry.get(dicts[0]).activation_size
        engine = EncodeEngine(registry, max_batch=args.max_batch).start()
        engine.warmup(topk_ks=() if top_k is None else (top_k,))
        try:
            extra = {}
            traced = bool(args.trace)
            if args.trace:
                from sparse_coding__tpu_torch.telemetry.tracing import TraceContext
            if args.endpoint == "features":
                subj = registry.get_subject()
                payload_fn, rows_of = feature_payloads(subj.lm_cfg.vocab_size)
                extra.update(payload_fn=payload_fn, rows_of=rows_of)
                engine.warmup_features(
                    args.seq_len, topk_ks=() if top_k is None else (top_k,)
                )
                def encode_fn(d, toks, t=None):
                    tr = TraceContext(t) if (traced and t) else None
                    return engine.encode_features(d, toks, trace=tr,
                                                  top_k=top_k)
            elif args.naive:
                encode_fn, traced = (
                    lambda d, r: engine.encode_naive(d, r, top_k=top_k),
                    False,
                )
            else:
                def encode_fn(d, r, t=None):
                    tr = TraceContext(t) if (traced and t) else None
                    return engine.encode(d, r, trace=tr, top_k=top_k)
            result = run_load(
                encode_fn, dicts, n_clients=args.clients,
                requests_per_client=args.requests, rows_per_request=args.rows,
                width=width, seed=args.seed, histogram=True, traced=traced,
                **extra,
            )
        finally:
            engine.stop()
    rc = 0 if result["errors"] == 0 else 1
    if args.slo:
        from sparse_coding__tpu_torch.telemetry.slo import evaluate_measured, load_config

        slo_result = evaluate_measured(result, load_config(args.slo))
        result["slo"] = slo_result
        if not slo_result["ok"]:
            rc = 1
    print(json.dumps(result, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
