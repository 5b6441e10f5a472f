"""Pod-scale telemetry: per-process event logs that merge into one story.

Counterpart of `sparse_coding__tpu/telemetry/multihost.py`: the pod half,
and the offline half that the run tools read (`format_bytes`,
`chunk_skew_windows`, `fingerprint_diff`). Every rank of a
`torch.distributed` world is its own process with its own clock and its own
disk writes, so:

  - **Per-process log layout.** `RunTelemetry` asks `process_info()` at
    construction: in a world of several ranks the event file becomes
    ``events.p<i>.jsonl`` and every record carries ``process_index``. A
    world of one keeps ``events.jsonl``, untagged.
  - **Clock alignment** (`estimate_clock_offset` / `clock_state`): rank 0
    publishes its ``time.time()``; every other rank records ``offset =
    local receive − rank 0's send`` with the time it blocked as the
    uncertainty.
  - **Heartbeats + straggler skew** (`heartbeat`): at each flush boundary
    one small exchange of the per-rank window wall time gives the
    ``skew.flush.*`` gauges and a ``heartbeat`` event on every rank.
  - **Desync detection** (`check_desync`): at run start each rank digests
    its comparable fingerprint and the run config; a rank that disagrees
    with rank 0 is a hard ``desync`` anomaly (and `AnomalyAbort` under
    ``action="abort"``).

**Transport.** Every exchange is a host-side string put/get on the
`torch.distributed` store that the process group already holds (the TCP or
file store of `init_process_group`): no device and no collective, so
telemetry never waits behind the card's work, and it works on any backend.
Rounds are matched by a per-tag call counter, so every rank must reach the
same call sites in the same order (the drivers' flush boundaries are pod
sync points already). A get waits at most ``SC_MH_TIMEOUT_MS``: a missed
exchange is a missed heartbeat, never a crash. The checkpoint and dataset
barriers (`train.checkpoint._pod_barrier`) ride the same exchange but wait
the store's own timeout (the process group's, torch's default): there the
other ranks wait for rank 0's writes or its dataset build, which take as
long as they take.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import re
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sparse_coding__tpu_torch.utils import flags

__all__ = [
    "process_info",
    "per_process_file_name",
    "estimate_clock_offset",
    "clock_state",
    "heartbeat",
    "check_desync",
    "comparable_fingerprint",
    "format_bytes",
    "chunk_skew_windows",
    "fingerprint_diff",
]

# report / goodput / monitor recover a record's rank from its file name when
# the record itself is untagged
PROC_FILE_RE = re.compile(r"\.p(\d+)\.jsonl$")


def format_bytes(v) -> str:
    """Human bytes for report/monitor tables; '-' for None/non-numeric."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return f"{v:.2f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024
    return "-"  # pragma: no cover

# fingerprint keys that must agree across a pod; everything else
# (process_index, clock fields) is legitimately per-process
COMPARABLE_FINGERPRINT_KEYS = (
    "python", "torch", "cuda", "backend", "device_kind", "device_count",
    "process_count", "git_sha", "mesh", "distributed_backend",
)

# re-estimate the clock offset every Nth heartbeat (count-based, NOT
# time-based: ranks must decide identically or the exchange rounds skew)
CLOCK_RESYNC_EVERY_ENV = flags.SC_CLOCK_RESYNC_EVERY.name
_CLOCK_RESYNC_DEFAULT = 16

# how long one rank waits for the others' payloads before giving up on that
# exchange round
TIMEOUT_MS_ENV = flags.SC_MH_TIMEOUT_MS.name
_TIMEOUT_MS_DEFAULT = 60_000

# the most recent clock-offset estimate of this process
_CLOCK: Dict[str, float] = {}

# per-tag exchange round counters (matched across ranks by lockstep)
_ROUNDS: Dict[str, int] = {}


def process_info() -> Tuple[int, int]:
    """(rank, world size) of the `torch.distributed` world; (0, 1) when no
    group is initialised — telemetry must never fail a run."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    return 0, 1


def per_process_file_name(base: str, index: int, count: int) -> str:
    """``events.jsonl`` -> ``events.p<i>.jsonl`` in a pod; unchanged in a
    world of one."""
    if count <= 1:
        return base
    stem, dot, ext = base.rpartition(".")
    if not dot:
        return f"{base}.p{index}"
    return f"{stem}.p{index}.{ext}"


# -- the store exchange ---------------------------------------------------------

def _store():
    """The store of the default process group (host-side key/value), or
    None outside a world."""
    try:
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()
    except Exception:
        return None


def _timeout_ms() -> int:
    try:
        return flags.SC_MH_TIMEOUT_MS.get()
    except ValueError:
        return _TIMEOUT_MS_DEFAULT


def _get(store, key: str, store_timeout: bool = False) -> str:
    if store_timeout:
        store.wait([key])
    else:
        store.wait([key], datetime.timedelta(milliseconds=_timeout_ms()))
    return store.get(key).decode()


def _kv_allgather(tag: str, payload: str, store_timeout: bool = False) -> Optional[List[str]]:
    """Every rank's string, through the store: rank i sets
    ``sc_mh/<tag>/<round>/<i>``, then waits for every rank's key, at most
    ``SC_MH_TIMEOUT_MS`` (``store_timeout``: the store's own timeout, the
    process group's). Rounds are numbered per tag. Returns the list by
    rank, or None in a world of one and when the exchange fails or times
    out."""
    idx, count = process_info()
    if count <= 1:
        return None
    store = _store()
    if store is None:
        return None
    n = _ROUNDS.get(tag, 0)
    _ROUNDS[tag] = n + 1
    try:
        store.set(f"sc_mh/{tag}/{n}/{idx}", payload)
        return [_get(store, f"sc_mh/{tag}/{n}/{p}", store_timeout) for p in range(count)]
    except Exception:
        return None


# -- clock alignment -----------------------------------------------------------

def estimate_clock_offset() -> Optional[Dict[str, float]]:
    """One clock probe; returns (and keeps for `clock_state`)

        {"offset_seconds":      local clock minus rank 0's,
         "uncertainty_seconds": how long this rank blocked for the value,
         "measured_at":         local time.time() of the measurement}

    Rank 0 publishes its ``time.time()`` and is pinned to offset 0.0; every
    other rank times the blocking fetch of that key. None (and no state
    update) in a world of one or on any failure. Call it only where every
    rank calls it too."""
    idx, count = process_info()
    if count <= 1:
        return None
    store = _store()
    if store is None:
        return None
    n = _ROUNDS.get("clock", 0)
    _ROUNDS["clock"] = n + 1
    key = f"sc_mh/clock/{n}/0"
    try:
        if idx == 0:
            now = time.time()
            store.set(key, repr(now))
            est = {"offset_seconds": 0.0, "uncertainty_seconds": 0.0, "measured_at": now}
        else:
            t_before = time.time()
            coord_sent = float(_get(store, key))
            t_after = time.time()
            est = {
                "offset_seconds": round(t_after - coord_sent, 6),
                "uncertainty_seconds": round(t_after - t_before, 6),
                "measured_at": t_after,
            }
    except Exception:
        return None
    _CLOCK.clear()
    _CLOCK.update(est)
    return est


def clock_state() -> Optional[Dict[str, float]]:
    """The most recent `estimate_clock_offset` result, or None when never
    measured (a world of one)."""
    return dict(_CLOCK) if _CLOCK else None


# -- heartbeats + straggler skew -------------------------------------------------

def heartbeat(telemetry, step: Optional[int] = None,
              window_seconds: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Flush-boundary heartbeat; a no-op in a world of one.

    In a pod: exchanges the per-rank wall time of the window just closed
    (``window_seconds``; by default the time since this telemetry's previous
    heartbeat), sets ``skew.flush.max_seconds`` / ``min_seconds`` /
    ``spread_seconds`` (the same on every rank) and writes a ``heartbeat``
    event with the cumulative step count, the per-rank windows and the
    clock offset. Every ``SC_CLOCK_RESYNC_EVERY`` (default 16) calls the
    clock offset is measured again. Returns the event, or None."""
    idx, count = process_info()
    if count <= 1 or telemetry is None:
        return None
    now = time.time()
    last = getattr(telemetry, "_mh_last_heartbeat_t", None)
    if window_seconds is None:
        window_seconds = (now - last) if last is not None else 0.0
    telemetry._mh_last_heartbeat_t = now
    n_beats = getattr(telemetry, "_mh_heartbeats", 0) + 1
    telemetry._mh_heartbeats = n_beats

    resync_every = _CLOCK_RESYNC_DEFAULT
    try:
        override = flags.SC_CLOCK_RESYNC_EVERY.get()
        if override is not None:
            resync_every = override
    except ValueError:
        pass
    if resync_every > 0 and n_beats % resync_every == 0:
        estimate_clock_offset()

    raw = _kv_allgather("heartbeat", repr(float(window_seconds)))
    if raw is None:
        return None
    try:
        windows = [float(v) for v in raw]
    except ValueError:
        return None
    w_max, w_min = max(windows), min(windows)
    telemetry.gauge_set("skew.flush.max_seconds", round(w_max, 4))
    telemetry.gauge_set("skew.flush.min_seconds", round(w_min, 4))
    telemetry.gauge_set("skew.flush.spread_seconds", round(w_max - w_min, 4))
    telemetry.counter_inc("heartbeats")
    clock = clock_state() or {}
    return telemetry.event(
        "heartbeat",
        step=int(step) if step is not None else None,
        steps=int(telemetry.counters.get("train.steps", 0)),
        window_seconds=round(float(window_seconds), 4),
        window_seconds_by_process=[round(float(w), 4) for w in windows],
        skew_seconds=round(w_max - w_min, 4),
        clock_offset_seconds=clock.get("offset_seconds"),
        clock_uncertainty_seconds=clock.get("uncertainty_seconds"),
    )


# -- desync detection -------------------------------------------------------------

def comparable_fingerprint(config: Optional[Dict[str, Any]] = None, mesh=None) -> Dict[str, Any]:
    """The fingerprint fields every rank must agree on, plus the run config."""
    from sparse_coding__tpu_torch.telemetry.events import run_fingerprint

    fp = run_fingerprint(mesh=mesh)
    out = {k: fp[k] for k in COMPARABLE_FINGERPRINT_KEYS if k in fp}
    if config is not None:
        out["config"] = config
    return out


def _digest(payload: Dict[str, Any]) -> str:
    return hashlib.sha256(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()[:16]


def check_desync(telemetry=None, config: Optional[Dict[str, Any]] = None, action: str = "warn",
                 mesh=None) -> Optional[List[int]]:
    """Cross-rank config/environment agreement at run start.

    Digests `comparable_fingerprint(config)`, exchanges the digests and
    compares every rank with rank 0. On a mismatch: a hard ``desync``
    anomaly event, a `RuntimeWarning` and, under ``action="abort"``,
    `AnomalyAbort`. Returns the sorted mismatching ranks ([] = healthy), or
    None in a world of one or when the exchange fails."""
    if action not in ("warn", "abort"):
        raise ValueError(f"unknown desync action {action!r}")
    idx, count = process_info()
    if count <= 1:
        return None
    local = _digest(comparable_fingerprint(config, mesh=mesh))
    digests = _kv_allgather("desync", local)
    if digests is None:
        return None
    reference = digests[0]
    mismatched = sorted(p for p in range(count) if digests[p] != reference)
    if not mismatched:
        return []
    desc = (
        f"desync: processes {mismatched} disagree with the coordinator's "
        f"config/environment fingerprint (local p{idx} "
        f"{'matches' if idx not in mismatched else 'MISMATCHES'})"
    )
    if telemetry is not None:
        telemetry.anomaly("desync", processes=mismatched, local_digest=local, reference_digest=reference,
                          local_match=idx not in mismatched, action=action)
    warnings.warn(desc, RuntimeWarning)
    if action == "abort":
        from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyAbort

        raise AnomalyAbort(desc)
    return mismatched


# -- offline halves: shared by report, goodput and monitor ----------------------

def chunk_skew_windows(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-window cross-rank chunk-time skew from merged `chunk_end` events.

    Windows are keyed by ``(epoch, chunk, position)`` (absent fields are
    None: the drivers' chunk ids line up across ranks because the chunk
    schedule is seed-derived and identical pod-wide). Only windows covered
    by >= 2 distinct processes produce a row::

        {"key": (...), "seconds": {proc: s, ...}, "max": s, "min": s,
         "spread": s}

    in first-seen order. Re-emitted windows (restarts) keep the last
    observation per process.
    """
    windows: Dict[tuple, Dict[int, float]] = {}
    order: List[tuple] = []
    for e in events:
        # seconds=None: a chunk_end without its chunk_start (a resumed
        # generation's torn window) has no usable duration
        if e.get("event") != "chunk_end" or not isinstance(e.get("seconds"), (int, float)):
            continue
        key = (e.get("epoch"), e.get("chunk"), e.get("position"))
        proc = int(e.get("process_index", 0))
        if key not in windows:
            windows[key] = {}
            order.append(key)
        windows[key][proc] = float(e["seconds"])
    out = []
    for key in order:
        secs = windows[key]
        if len(secs) < 2:
            continue
        vals = list(secs.values())
        out.append({"key": key, "seconds": secs, "max": max(vals), "min": min(vals),
                    "spread": max(vals) - min(vals)})
    return out


def fingerprint_diff(run_starts: Sequence[Dict[str, Any]]) -> Dict[str, Dict[int, Any]]:
    """Offline desync attribution: given merged ``run_start`` events,
    ``{field: {process: value}}`` for every comparable fingerprint field
    (`COMPARABLE_FINGERPRINT_KEYS`: the port's torch, CUDA and device fields
    where the JAX package compares jax, jaxlib and its backend) or config on
    which the ranks disagree; empty when all agree."""
    per_proc: Dict[int, Dict[str, Any]] = {}
    for s in run_starts:
        proc = int(s.get("process_index", 0))
        fp = s.get("fingerprint") or {}
        row = {k: fp.get(k) for k in COMPARABLE_FINGERPRINT_KEYS}
        row["config"] = s.get("config")
        per_proc[proc] = row
    if len(per_proc) < 2:
        return {}
    diff: Dict[str, Dict[int, Any]] = {}
    fields = set()
    for row in per_proc.values():
        fields.update(row)
    for f in sorted(fields):
        vals = {p: per_proc[p].get(f) for p in sorted(per_proc)}
        canon = {p: json.dumps(v, sort_keys=True, default=str) for p, v in vals.items()}
        if len(set(canon.values())) > 1:
            diff[f] = vals
    return diff
