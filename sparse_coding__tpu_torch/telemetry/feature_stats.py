"""Per-feature statistics: the in-step firing sketch, its snapshots and the
drift math.

Counterpart of the training half of `sparse_coding__tpu/telemetry/
feature_stats.py`. A device-resident ``[M, F]`` sketch accumulates inside the
ensemble step (`ensemble.Ensemble` with ``feature_stats``; captured into the
step's CUDA graph with the rest of it), is read to the host at a flush
boundary in one batched copy, written as a ``feature_stats.<gen>.npz``
snapshot with a ``feature_stats`` pointer event, and reset in place.

Sketch layout (stacked, leading member axis M):

  - ``featstat_rows``   rows accumulated this window                  — ``[M]``
  - ``featstat_fire``   rows on which each feature fired (``c != 0``) — ``[M, F]``
  - ``featstat_sum``    sum of each feature's activation              — ``[M, F]``
  - ``featstat_sumsq``  sum of squared activation                     — ``[M, F]``
  - ``featstat_max``    max |activation| seen this window             — ``[M, F]``
  - ``featstat_hist``   fired-magnitude log-bucket counts             — ``[M, F, B]``

Bucket ``b`` holds fired magnitudes in ``[lo·ratio^b, lo·ratio^(b+1))``, the
first and last buckets absorbing under- and overflow. Snapshots use the JAX
package's npz layout, so each package reads the other's. Drift is the
per-feature population-stability index (or Jensen–Shannon divergence)
between two snapshots' firing distributions.

The flush resets the sketch with ``zero_()`` on the buffers' own tensors:
a captured step graph froze their addresses and stays valid across it. The
serving half (`ServeFeatureStats`) accumulates the encode engine's per-lane
sketches after each dispatch. `summarize_run` / `render_features` / `main`
are the run summary and the ``features`` CLI over a run's snapshots
(top-firing, dead and top-drifting features), the JAX package's output.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.telemetry.spans import Span
from sparse_coding__tpu_torch.utils.logging import _to_host

__all__ = [
    "FEATURE_STATS_KEYS",
    "FeatureStatsConfig",
    "FeatureSnapshot",
    "ServeFeatureStats",
    "init_feature_stats",
    "feature_stats_pack",
    "update_feature_stats",
    "snapshot_aggregates",
    "lane_distribution",
    "psi",
    "js_divergence",
    "drift_report",
    "write_snapshot",
    "flush_ensemble_feature_stats",
    "next_snapshot_path",
    "load_run_snapshots",
    "summarize_run",
    "render_features",
    "main",
]

FEATURE_STATS_KEYS = (
    "featstat_rows",
    "featstat_fire",
    "featstat_sum",
    "featstat_sumsq",
    "featstat_max",
    "featstat_hist",
)

SNAPSHOT_PREFIX = "feature_stats."


@dataclasses.dataclass(frozen=True)
class FeatureStatsConfig:
    """``n_buckets`` log-magnitude buckets from ``hist_lo``, ``hist_ratio``
    between edges: by default |c| from ~1e-3 to ~64 in 8 buckets. Hashable:
    part of a step graph's key."""

    n_buckets: int = 8
    hist_lo: float = 2.0 ** -10
    hist_ratio: float = 4.0

    def edges(self) -> np.ndarray:
        """Bucket edges, ``[n_buckets + 1]`` (the last bucket absorbs overflow)."""
        return self.hist_lo * self.hist_ratio ** np.arange(self.n_buckets + 1, dtype=np.float64)


def init_feature_stats(n_models: int, n_feats: int, cfg: FeatureStatsConfig, device=None) -> Dict[str, torch.Tensor]:
    """A zeroed stacked sketch: every leaf leads with ``n_models``."""

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "featstat_rows": z(n_models),
        "featstat_fire": z(n_models, n_feats),
        "featstat_sum": z(n_models, n_feats),
        "featstat_sumsq": z(n_models, n_feats),
        "featstat_max": z(n_models, n_feats),
        "featstat_hist": z(n_models, n_feats, cfg.n_buckets),
    }


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as an f32 tensor on ``like``'s device: dividing by a device
    tensor is a true division on every device (PyTorch's CUDA division by a
    host scalar multiplies by its reciprocal)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _bucket_index(a: torch.Tensor, cfg: FeatureStatsConfig) -> torch.Tensor:
    """Fixed-log-bucket index of magnitudes ``a`` (clipped to [0, B-1]),
    int32, by the JAX package's f32 expression."""
    safe = torch.clamp_min(a, cfg.hist_lo)
    idx = torch.floor(torch.log(safe / _const(cfg.hist_lo, a)) / _const(float(np.log(cfg.hist_ratio)), a))
    return torch.clamp(idx, 0, cfg.n_buckets - 1).to(torch.int32)


def _hist_counts(a: torch.Tensor, fired: torch.Tensor, cfg: FeatureStatsConfig) -> torch.Tensor:
    """Fired-magnitude bucket counts ``[M, F, B]`` from ``a``/``fired``
    [M, rows, F]: a loop over the buckets, so the largest temporary is one
    [M, rows, F] int8 index (never a [M, rows, F, B] one-hot)."""
    idx = torch.where(fired, _bucket_index(a, cfg), -1).to(torch.int8)
    return torch.stack([(idx == b).sum(dim=1, dtype=torch.float32) for b in range(cfg.n_buckets)], dim=-1)


def update_feature_stats(stats: Dict[str, torch.Tensor], c: torch.Tensor, cfg: FeatureStatsConfig,
                         mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One window update for every member: ``stats`` the stacked sketch,
    ``c`` the code [M, rows, F], ``mask`` an optional [M, rows] validity
    mask (rows with ``mask <= 0`` do not count). Returns the new sketch;
    device work only, no host sync."""
    with torch.no_grad():
        c32 = c.to(torch.float32)
        a = torch.abs(c32)
        fired = a > 0
        if mask is not None:
            valid = mask > 0
            fired = fired & valid[:, :, None]
            rows_add = valid.to(torch.float32).sum(dim=1)
        else:
            rows_add = float(c.shape[1])
        c_live = torch.where(fired, c32, 0.0)
        a_live = torch.where(fired, a, 0.0)
        return {
            "featstat_rows": stats["featstat_rows"] + rows_add,
            "featstat_fire": stats["featstat_fire"] + fired.sum(dim=1, dtype=torch.float32),
            "featstat_sum": stats["featstat_sum"] + c_live.sum(dim=1),
            "featstat_sumsq": stats["featstat_sumsq"] + (c_live * c_live).sum(dim=1),
            "featstat_max": torch.maximum(stats["featstat_max"], a_live.amax(dim=1)),
            "featstat_hist": stats["featstat_hist"] + _hist_counts(a, fired, cfg),
        }


def feature_stats_pack(aux, stats: Dict[str, torch.Tensor], cfg: FeatureStatsConfig) -> Dict[str, torch.Tensor]:
    """The step's hook: the updated sketch, or ``stats`` untouched when the
    signature's aux carries no code ``"c"``."""
    c = aux.get("c") if isinstance(aux, dict) else None
    if c is None:
        return stats
    return update_feature_stats(stats, c, cfg)


def _update_topk(stats: Dict[str, torch.Tensor], idx: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
                 cfg: FeatureStatsConfig) -> Dict[str, torch.Tensor]:
    """Sparse top-k window update for every lane: ``idx``/``vals`` the
    ``[G, rows, k]`` top-k outputs, ``mask`` ``[G, rows]``. Only the kept
    top-k magnitudes count (the JAX package's documented truncation bias:
    firings below the top k are invisible on this path)."""
    with torch.no_grad():
        g, n_feats = stats["featstat_fire"].shape
        a = torch.abs(vals.to(torch.float32))
        valid = mask > 0
        fired = (a > 0) & valid[:, :, None]
        flat = idx.reshape(g, -1).to(torch.int64)

        def scat_add(updates: torch.Tensor) -> torch.Tensor:
            return torch.zeros((g, n_feats), dtype=torch.float32, device=a.device).scatter_add_(
                1, flat, updates.reshape(g, -1))

        v_live = torch.where(fired, vals.to(torch.float32), 0.0)
        a_live = torch.where(fired, a, 0.0)
        bidx = _bucket_index(a, cfg)
        hist = torch.stack([scat_add((fired & (bidx == b)).to(torch.float32)) for b in range(cfg.n_buckets)], dim=-1)
        peak = torch.zeros((g, n_feats), dtype=torch.float32, device=a.device).scatter_reduce_(
            1, flat, a_live.reshape(g, -1), reduce="amax")
        return {
            "featstat_rows": stats["featstat_rows"] + valid.to(torch.float32).sum(dim=1),
            "featstat_fire": stats["featstat_fire"] + scat_add(fired.to(torch.float32)),
            "featstat_sum": stats["featstat_sum"] + scat_add(v_live),
            "featstat_sumsq": stats["featstat_sumsq"] + scat_add(v_live * v_live),
            "featstat_max": torch.maximum(stats["featstat_max"], peak),
            "featstat_hist": stats["featstat_hist"] + hist,
        }


def _accumulate_dense(stats, codes, mask, cfg: FeatureStatsConfig):
    """Stacked dense update: ``codes`` [G, rows, F], ``mask`` [G, rows]."""
    return update_feature_stats(stats, codes, cfg, mask=mask)


def _accumulate_topk(stats, idx, vals, mask, cfg: FeatureStatsConfig):
    """Stacked sparse update: ``idx``/``vals`` [G, rows, k], ``mask`` [G, rows]."""
    return _update_topk(stats, idx, vals, mask, cfg)


class ServeFeatureStats:
    """Serve-side accumulator: one device sketch per (lane set, n_feats).

    The engine calls `accumulate_dense` / `accumulate_topk` on its drainer
    right after a dispatch, on the dispatch's device outputs: device work
    only, no host sync. `flush` is the one sync (one batched copy), writes a
    ``feature_stats.serveNNNN.npz`` snapshot per lane set, runs the drift
    check against a baseline when one is set, and resets the window."""

    def __init__(self, cfg=None, scope: str = "serve"):
        self.cfg = cfg if isinstance(cfg, FeatureStatsConfig) else FeatureStatsConfig()
        self.scope = scope
        self.baseline: Optional[FeatureSnapshot] = None
        self._acc: Dict[Tuple[Tuple[str, ...], int], Dict[str, torch.Tensor]] = {}
        self._last_flush = time.monotonic()

    def set_baseline(self, snap: Optional["FeatureSnapshot"]) -> None:
        self.baseline = snap

    def _stats_for(self, ids: Tuple[str, ...], n_feats: int, device):
        key = (ids, n_feats)
        if key not in self._acc:
            self._acc[key] = init_feature_stats(len(ids), n_feats, self.cfg, device=device)
        return key, self._acc[key]

    @staticmethod
    def _mask(mask, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, dtype=np.float32)).to(device)

    def accumulate_dense(self, ids, n_feats, codes: torch.Tensor, mask) -> None:
        """``codes`` [G, rows, F] on the device, ``mask`` [G, rows] on the host."""
        key, stats = self._stats_for(tuple(ids), int(n_feats), codes.device)
        self._acc[key] = _accumulate_dense(stats, codes, self._mask(mask, codes.device), self.cfg)

    def accumulate_topk(self, ids, n_feats, idx: torch.Tensor, vals: torch.Tensor, mask) -> None:
        """``idx``/``vals`` [G, rows, k] on the device, ``mask`` [G, rows]."""
        key, stats = self._stats_for(tuple(ids), int(n_feats), vals.device)
        self._acc[key] = _accumulate_topk(stats, idx, vals, self._mask(mask, vals.device), self.cfg)

    @property
    def seconds_since_flush(self) -> float:
        return time.monotonic() - self._last_flush

    def flush(self, telemetry, out_dir, extra: Optional[Dict] = None) -> List[Dict]:
        """Snapshot and reset every accumulated lane set; the per-snapshot
        summaries (none when no window saw a row)."""
        self._last_flush = time.monotonic()
        if not self._acc:
            return []
        fspan = Span(telemetry, "feature_flush", name=self.scope).begin()
        try:
            keys = sorted(self._acc)
            host_all = _to_host([self._acc[k] for k in keys])
            self._acc = {}
            summaries = []
            for (ids, _n), host in zip(keys, host_all):
                if float(np.sum(host["featstat_rows"])) <= 0:
                    continue
                snap = write_snapshot(out_dir, self.scope, host, list(ids), self.cfg, meta=extra)
                agg = snapshot_aggregates(snap)
                drift = drift_report(self.baseline, snap) if self.baseline is not None else None
                summary = _emit_flush(telemetry, snap, agg, drift, extra=extra)
                summary["snapshot"] = snap
                summaries.append(summary)
            return summaries
        finally:
            fspan.end()


# ---------------------------------------------------------------------------
# Snapshots (host side, numpy only past this point)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FeatureSnapshot:
    """One flushed window of the sketch, on the host. ``names`` labels the
    leading axis; ``gen`` is the snapshot token (``train0003``)."""

    scope: str
    gen: str
    names: List[str]
    rows: np.ndarray  # [M]
    fire: np.ndarray  # [M, F]
    sum: np.ndarray  # [M, F]
    sumsq: np.ndarray  # [M, F]
    max: np.ndarray  # [M, F]
    hist: np.ndarray  # [M, F, B]
    edges: np.ndarray  # [B + 1]
    meta: Dict

    @property
    def n_feats(self) -> int:
        return int(self.fire.shape[1])

    def save(self, path) -> None:
        meta = dict(self.meta)
        meta.update(scope=self.scope, gen=self.gen, names=list(self.names))
        np.savez_compressed(
            path,
            rows=self.rows.astype(np.float64),
            fire=self.fire.astype(np.float64),
            sum=self.sum.astype(np.float64),
            sumsq=self.sumsq.astype(np.float64),
            max=self.max.astype(np.float64),
            hist=self.hist.astype(np.float64),
            edges=self.edges.astype(np.float64),
            meta_json=np.asarray(json.dumps(meta, sort_keys=True)),
        )

    @classmethod
    def load(cls, path) -> "FeatureSnapshot":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta_json"]))
            return cls(
                scope=meta.get("scope", "?"),
                gen=meta.get("gen", "?"),
                names=[str(n) for n in meta.get("names", [])],
                rows=np.asarray(z["rows"], np.float64),
                fire=np.asarray(z["fire"], np.float64),
                sum=np.asarray(z["sum"], np.float64),
                sumsq=np.asarray(z["sumsq"], np.float64),
                max=np.asarray(z["max"], np.float64),
                hist=np.asarray(z["hist"], np.float64),
                edges=np.asarray(z["edges"], np.float64),
                meta=meta,
            )


def next_snapshot_path(out_dir, scope: str) -> Tuple[Path, str]:
    """The next ``feature_stats.<scope>NNNN.npz`` path in ``out_dir``,
    counting the files there, so a resumed run appends."""
    out_dir = Path(out_dir)
    n = len(list(out_dir.glob(f"{SNAPSHOT_PREFIX}{scope}[0-9][0-9][0-9][0-9].npz")))
    gen = f"{scope}{n:04d}"
    return out_dir / f"{SNAPSHOT_PREFIX}{gen}.npz", gen


def write_snapshot(out_dir, scope: str, host: Dict[str, np.ndarray], names: Sequence[str], cfg: FeatureStatsConfig,
                   meta: Optional[Dict] = None) -> FeatureSnapshot:
    """Build and save one snapshot from the sketch's host arrays."""
    path, gen = next_snapshot_path(out_dir, scope)
    snap = FeatureSnapshot(
        scope=scope,
        gen=gen,
        names=[str(n) for n in names],
        rows=np.atleast_1d(np.asarray(host["featstat_rows"], np.float64)),
        fire=np.asarray(host["featstat_fire"], np.float64),
        sum=np.asarray(host["featstat_sum"], np.float64),
        sumsq=np.asarray(host["featstat_sumsq"], np.float64),
        max=np.asarray(host["featstat_max"], np.float64),
        hist=np.asarray(host["featstat_hist"], np.float64),
        edges=cfg.edges(),
        meta=dict(meta or {}),
    )
    snap.meta["path"] = path.name
    snap.save(path)
    return snap


def load_run_snapshots(run_dir) -> List[FeatureSnapshot]:
    """Every ``feature_stats.*.npz`` in ``run_dir``, in name order."""
    return [FeatureSnapshot.load(p) for p in sorted(Path(run_dir).glob(f"{SNAPSHOT_PREFIX}*.npz"))]


# ---------------------------------------------------------------------------
# Aggregates + drift math
# ---------------------------------------------------------------------------


def _gini(x: np.ndarray) -> float:
    """Gini coefficient of a non-negative firing-count vector (0: uniform,
    toward 1: all firings on one feature)."""
    x = np.sort(np.asarray(x, np.float64))
    n = x.size
    tot = x.sum()
    if n == 0 or tot <= 0:
        return 0.0
    cum = np.arange(1, n + 1) @ x
    return float(2.0 * cum / (n * tot) - (n + 1.0) / n)


def _hot_frac(fire: np.ndarray) -> float:
    """Share of all firings carried by the hottest 1% of features."""
    fire = np.asarray(fire, np.float64)
    tot = fire.sum()
    if tot <= 0:
        return 0.0
    k = max(1, fire.size // 100)
    return float(np.sort(fire)[-k:].sum() / tot)


def snapshot_aggregates(snap: FeatureSnapshot) -> Dict[str, float]:
    """Window aggregates, averaged over the lanes that saw rows:
    ``dead_frac`` (features that never fired), ``gini``, ``hot_frac``."""
    dead, gini, hot = [], [], []
    for m in range(snap.fire.shape[0]):
        if snap.rows[m] <= 0:
            continue
        dead.append(float((snap.fire[m] == 0).mean()))
        gini.append(_gini(snap.fire[m]))
        hot.append(_hot_frac(snap.fire[m]))
    if not dead:
        return {"rows": float(snap.rows.sum()), "dead_frac": float("nan"), "gini": float("nan"),
                "hot_frac": float("nan")}
    return {
        "rows": float(snap.rows.sum()),
        "dead_frac": float(np.mean(dead)),
        "gini": float(np.mean(gini)),
        "hot_frac": float(np.mean(hot)),
    }


def lane_distribution(rows: float, fire: np.ndarray, hist: np.ndarray) -> np.ndarray:
    """Each feature's firing distribution over ``B+1`` cells for one lane:
    cell 0 "did not fire on this row", cells 1..B the fired-magnitude
    buckets; rows sum to 1 (a lane without rows is uniform)."""
    fire = np.asarray(fire, np.float64)
    hist = np.asarray(hist, np.float64)
    nofire = np.maximum(float(rows) - fire, 0.0)[:, None]
    cells = np.concatenate([nofire, hist], axis=1)
    tot = cells.sum(axis=1, keepdims=True)
    uniform = np.full_like(cells, 1.0 / cells.shape[1])
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(tot > 0, cells / np.maximum(tot, 1e-300), uniform)


def psi(p: np.ndarray, q: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Population stability index per feature over the smoothed cells."""
    p = np.asarray(p, np.float64) + eps
    q = np.asarray(q, np.float64) + eps
    p = p / p.sum(axis=-1, keepdims=True)
    q = q / q.sum(axis=-1, keepdims=True)
    return ((p - q) * np.log(p / q)).sum(axis=-1)


def js_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Jensen–Shannon divergence per feature (base 2, in [0, 1])."""
    p = np.asarray(p, np.float64) + eps
    q = np.asarray(q, np.float64) + eps
    p = p / p.sum(axis=-1, keepdims=True)
    q = q / q.sum(axis=-1, keepdims=True)
    m = 0.5 * (p + q)

    def kl(a, b):
        return (a * np.log2(a / b)).sum(axis=-1)

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def _paired_lanes(base: FeatureSnapshot, cur: FeatureSnapshot) -> List[Tuple[int, int]]:
    """Lanes paired by name when the snapshots share names, else by position."""
    by_name = {n: i for i, n in enumerate(base.names)}
    pairs = [(by_name[n], j) for j, n in enumerate(cur.names) if n in by_name]
    if pairs:
        return pairs
    return [(i, i) for i in range(min(base.fire.shape[0], cur.fire.shape[0]))]


def drift_report(base: FeatureSnapshot, cur: FeatureSnapshot, top_n: int = 10, method: str = "psi",
                 min_rows: float = 1.0) -> Optional[Dict]:
    """Per-feature drift of ``cur`` against the baseline ``base``:
    ``{"score", "per_feature" [F], "top" [(feat, drift)...], "method",
    "lanes"}``, or None when the snapshots are not comparable or no paired
    lane has ``min_rows`` on both sides."""
    if base.n_feats != cur.n_feats or base.hist.shape[-1] != cur.hist.shape[-1]:
        return None
    div = js_divergence if method == "js" else psi
    per_lane, lanes = [], []
    for bi, ci in _paired_lanes(base, cur):
        if base.rows[bi] < min_rows or cur.rows[ci] < min_rows:
            continue
        p = lane_distribution(base.rows[bi], base.fire[bi], base.hist[bi])
        q = lane_distribution(cur.rows[ci], cur.fire[ci], cur.hist[ci])
        per_lane.append(div(p, q))
        lanes.append((base.names[bi] if bi < len(base.names) else str(bi),
                      cur.names[ci] if ci < len(cur.names) else str(ci)))
    if not per_lane:
        return None
    per_feature = np.mean(np.stack(per_lane, axis=0), axis=0)
    order = np.argsort(per_feature)[::-1][: max(0, int(top_n))]
    return {
        "method": method,
        "score": float(per_feature.mean()),
        "per_feature": per_feature,
        "top": [(int(i), float(per_feature[i])) for i in order],
        "lanes": lanes,
    }


# ---------------------------------------------------------------------------
# Flush
# ---------------------------------------------------------------------------


def drift_band(score: float) -> str:
    """The industry PSI reading: <0.1 stable, 0.1–0.25 drifting, else major."""
    if score != score:
        return "unknown"
    if score < 0.1:
        return "stable"
    if score < 0.25:
        return "drifting"
    return "major"


def _emit_flush(telemetry, snap: FeatureSnapshot, agg: Dict[str, float], drift: Optional[Dict],
                extra: Optional[Dict] = None) -> Dict:
    """The gauges and the ``feature_stats`` pointer event of one snapshot
    (the JAX package's names and fields)."""
    summary = {
        "scope": snap.scope,
        "gen": snap.gen,
        "path": snap.meta.get("path", ""),
        "names": list(snap.names),
        "n_feats": snap.n_feats,
        **{k: round(v, 6) if v == v else v for k, v in agg.items()},
    }
    if drift is not None:
        summary["drift_score"] = round(drift["score"], 6)
        summary["drift_method"] = drift["method"]
        summary["drift_top"] = [[f, round(d, 6)] for f, d in drift["top"]]
    if extra:
        summary.update(extra)
    if telemetry is None:
        return summary
    scope = "train" if snap.scope == "train" else "serve"
    telemetry.counter_inc(f"{scope}.feature.flushes")
    if agg["dead_frac"] == agg["dead_frac"]:
        for k in ("dead_frac", "gini", "hot_frac"):
            telemetry.gauge_set(f"{scope}.feature.{k}", round(agg[k], 6))
    if scope == "serve" and drift is not None:
        telemetry.gauge_set("serve.feature.drift_score", round(drift["score"], 6))
    telemetry.event("feature_stats", **summary)
    return summary


def flush_ensemble_feature_stats(ens, telemetry, out_dir, model_names: Optional[Sequence[str]] = None,
                                 baseline: Optional[FeatureSnapshot] = None,
                                 extra: Optional[Dict] = None) -> Optional[Dict]:
    """Snapshot the ensemble's sketch and reset it (a rolling window): one
    batched copy to the host inside a ``feature_flush`` span, the npz and
    its event, then ``zero_()`` on the sketch's own tensors (the step graphs
    stay valid). None when the ensemble has no sketch or the window saw no
    rows."""
    cfg = getattr(ens, "feature_stats", None)
    buffers = ens.state.buffers
    if cfg is None or FEATURE_STATS_KEYS[0] not in buffers:
        return None
    fspan = Span(telemetry, "feature_flush", name="train").begin()
    try:
        host = _to_host([{k: buffers[k] for k in FEATURE_STATS_KEYS}])[0]
        if float(np.sum(host["featstat_rows"])) <= 0:
            return None
        names = list(model_names or [f"m{i}" for i in range(ens.n_models)])
        snap = write_snapshot(out_dir, "train", host, names, cfg, meta=extra)
        agg = snapshot_aggregates(snap)
        drift = drift_report(baseline, snap) if baseline is not None else None
        summary = _emit_flush(telemetry, snap, agg, drift, extra=extra)
        summary["snapshot"] = snap
        with torch.no_grad():
            for k in FEATURE_STATS_KEYS:
                buffers[k].zero_()
        return summary
    finally:
        fspan.end()


# -- CLI: python -m sparse_coding__tpu_torch.features <run_dir> --------------


def _latest(snaps: List[FeatureSnapshot], scope: str) -> Optional[FeatureSnapshot]:
    scoped = [s for s in snaps if s.scope == scope]
    return scoped[-1] if scoped else None


def summarize_run(
    run_dir,
    baseline: Optional[str] = None,
    diff: Optional[Sequence[str]] = None,
    top_n: int = 10,
    method: str = "psi",
) -> Optional[Dict]:
    """The CLI's analysis payload (also the ``--json`` document).

    Baseline resolution for the drift section, most to least explicit:
    ``--diff GEN_A GEN_B`` (both addressed by gen token), ``--baseline``
    (an npz path), latest-train → latest-serve (the train↔serve question),
    first → last within the only scope present (did training itself move).
    Returns None when the run dir holds no snapshots."""
    snaps = load_run_snapshots(run_dir)
    if not snaps:
        return None
    by_gen = {s.gen: s for s in snaps}
    latest = _latest(snaps, "serve") or _latest(snaps, "train")

    rate = np.zeros((latest.n_feats,), np.float64)
    lanes = 0
    for m in range(latest.fire.shape[0]):
        if latest.rows[m] > 0:
            rate += latest.fire[m] / float(latest.rows[m])
            lanes += 1
    rate = rate / max(lanes, 1)
    order = np.argsort(rate)[::-1]
    dead = np.flatnonzero(latest.fire.sum(axis=0) == 0)

    base = cur = None
    if diff:
        gen_a, gen_b = diff
        if gen_a not in by_gen or gen_b not in by_gen:
            known = ", ".join(sorted(by_gen))
            raise SystemExit(f"unknown gen in --diff (have: {known})")
        base, cur = by_gen[gen_a], by_gen[gen_b]
    elif baseline is not None:
        base, cur = FeatureSnapshot.load(baseline), latest
    elif _latest(snaps, "train") is not None and _latest(snaps, "serve") is not None:
        base, cur = _latest(snaps, "train"), _latest(snaps, "serve")
    else:
        scoped = [s for s in snaps if s.scope == latest.scope]
        if len(scoped) >= 2:
            base, cur = scoped[0], scoped[-1]

    drift = (
        drift_report(base, cur, top_n=top_n, method=method)
        if base is not None
        else None
    )
    info = {
        "run_dir": str(run_dir),
        "snapshots": [
            {"gen": s.gen, "scope": s.scope, "n_feats": s.n_feats,
             "names": list(s.names), **snapshot_aggregates(s)}
            for s in snaps
        ],
        "latest": {"gen": latest.gen, "scope": latest.scope,
                   **snapshot_aggregates(latest)},
        "top_firing": [
            [int(i), round(float(rate[i]), 6)]
            for i in order[: max(0, int(top_n))]
            if rate[i] > 0
        ],
        "dead": {
            "count": int(dead.size),
            "frac": round(float(dead.size) / latest.n_feats, 6),
            "features": [int(i) for i in dead[: max(0, int(top_n))]],
        },
        "drift": None,
    }
    if drift is not None:
        info["drift"] = {
            "baseline": base.gen,
            "current": cur.gen,
            "method": drift["method"],
            "score": round(drift["score"], 6),
            "band": drift_band(drift["score"]),
            "top": [[f, round(d, 6)] for f, d in drift["top"]],
        }
    return info


def render_features(info: Dict) -> str:
    """Human rendering of `summarize_run`'s payload (golden-pinned — keep
    byte-stable across refactors)."""
    counts: Dict[str, int] = {}
    for s in info["snapshots"]:
        counts[s["scope"]] = counts.get(s["scope"], 0) + 1
    lines = [f"feature surface: {info['run_dir']}"]
    lines.append(
        "  snapshots: "
        + ", ".join(f"{n} {scope}" for scope, n in sorted(counts.items()))
    )
    la = info["latest"]
    lines.append(
        f"  latest {la['gen']}: rows {la['rows']:.0f}  "
        f"dead {la['dead_frac']:.1%}  gini {la['gini']:.3f}  "
        f"hot1% {la['hot_frac']:.1%}"
    )
    if info["top_firing"]:
        lines.append(
            "  top-firing: "
            + ", ".join(f"{f} ({r:.1%})" for f, r in info["top_firing"][:5])
        )
    d = info["dead"]
    feats = ", ".join(str(f) for f in d["features"])
    lines.append(
        f"  dead features: {d['count']} ({d['frac']:.1%})"
        + (f": {feats}" if feats else "")
    )
    dr = info["drift"]
    if dr is None:
        lines.append("  drift: no comparable snapshot pair")
    else:
        lines.append(
            f"  drift {dr['baseline']} -> {dr['current']} ({dr['method']}): "
            f"score {dr['score']:.3f}  [{dr['band'].upper()}]"
        )
        if dr["top"]:
            lines.append(
                "    top drifting: "
                + ", ".join(f"{f} ({v:.2f})" for f, v in dr["top"][:5])
            )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    """``python -m sparse_coding__tpu_torch.features <run_dir>``.

    Exit codes mirror the slo CLI: 0 healthy / drift below threshold,
    1 drift score at or past ``--threshold``, 3 no feature snapshots in the
    run dir (distinct so CI can tell "no data" from "drifted")."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.features",
        description="Dictionary feature surface: firing stats + drift "
        "(docs/observability.md §10)",
    )
    ap.add_argument("run_dir", help="run directory holding feature_stats.*.npz")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--top", type=int, default=10, help="list length (default 10)")
    ap.add_argument(
        "--diff", nargs=2, metavar=("GEN_A", "GEN_B"),
        help="drift between two snapshot gens (e.g. train0000 serve0002)",
    )
    ap.add_argument(
        "--baseline", default=None,
        help="baseline npz path (overrides latest-train as drift baseline)",
    )
    ap.add_argument(
        "--threshold", type=float, default=None,
        help="exit 1 when the drift score reaches this (PSI scale)",
    )
    ap.add_argument("--method", choices=("psi", "js"), default="psi")
    args = ap.parse_args(argv)

    info = summarize_run(
        args.run_dir, baseline=args.baseline, diff=args.diff,
        top_n=args.top, method=args.method,
    )
    if info is None:
        print(f"no feature snapshots under {args.run_dir}", flush=True)
        return 3
    if args.json:
        print(json.dumps(info, indent=1, sort_keys=True))
    else:
        print(render_features(info), end="")
    if (
        args.threshold is not None
        and info["drift"] is not None
        and info["drift"]["score"] >= args.threshold
    ):
        return 1
    return 0
