"""Anomaly guard: flush-boundary detection of dying or diverging ensemble
members.

A copy of `sparse_coding__tpu/telemetry/anomaly.py` (numpy only) for the
port. The guard observes every `utils.logging.MetricLogger` flush window on
the host, after the window's one batched copy (detection adds no device
sync), and on trigger

  1. writes an ``anomaly`` event to the run's `RunTelemetry`,
  2. dumps a diagnostic bundle under ``<out_dir>/diagnostics/``: the
     trailing metric window, the offending members and values, the policy,
     and an optional caller-supplied checkpoint,
  3. applies the policy action: ``"warn"`` (log and continue), ``"mask"``
     (freeze the sick members through `Ensemble.set_update_mask` and keep
     training the others) or ``"abort"`` (raise `AnomalyAbort`).

Detectors, per member and flush window: non-finite (a NaN/Inf loss-family
metric, or ``health_nonfinite > 0``); a loss spike over the member's
trailing window (``mean + max(spike_sigma·std, spike_rel_floor·|mean|)``);
a dead-feature jump (``health_dead_frac`` rising by more than
``dead_jump`` between observations). Masked members drop out of detection.

The port runs on one host: a bundle's name carries no process prefix. A
``trace_trigger`` (`telemetry.profiling.TraceTrigger`) is fired once, on the
first anomaly: a torch.profiler window over the steps right after it.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["AnomalyPolicy", "AnomalyGuard", "AnomalyAbort"]


class AnomalyAbort(RuntimeError):
    """Raised by the guard under ``action="abort"`` after the diagnostic
    bundle and anomaly event are safely on disk."""


@dataclasses.dataclass
class AnomalyPolicy:
    nonfinite: bool = True          # NaN/Inf detector on loss-family metrics
    spikes: bool = True             # loss-spike detector (disable when several
                                    # ensembles interleave one logger — their
                                    # mixed trailing windows would false-fire)
    spike_sigma: float = 6.0        # σ multiplier over the trailing window
    spike_rel_floor: float = 0.5    # min relative rise to call a spike
    spike_window: int = 64          # trailing samples kept per (model, metric)
    spike_min_window: int = 16      # don't judge spikes before this many
    dead_jump: float = 0.25         # dead_frac rise per observation that trips
    feature_drift: bool = True      # train↔serve drift detector (observe_feature_drift)
    drift_warn: float = 0.25        # PSI score that warns (industry "major shift")
    drift_abort: float = 1.0        # PSI score that escalates to abort regardless
                                    # of `action` — a dictionary serving a
                                    # different distribution than it trained on
    action: str = "warn"            # "warn" | "mask" | "abort"
    dump_last_k: int = 256          # metric records retained for the bundle
    max_bundles: int = 16           # stop dumping (not detecting) after this

    def __post_init__(self):
        if self.action not in ("warn", "mask", "abort"):
            raise ValueError(f"unknown anomaly action {self.action!r}")


_LOSS_METRICS = ("loss",)  # spike detection targets


class AnomalyGuard:
    """Wire as ``MetricLogger(..., on_flush=guard.observe)``.

    `ensemble` (optional) enables the ``"mask"`` action to actually freeze
    sick members via `Ensemble.set_update_mask`; without it, masking is
    bookkeeping-only (the indices are still excluded from detection and
    reported). `checkpoint_fn(bundle_dir) -> path` (optional) is invoked once
    per bundle to dump whatever checkpoint the caller wants alongside.
    `trace_trigger` (optional, a `telemetry.profiling.TraceTrigger`) is fired
    on the first anomaly: a profiler trace of the steps right after the
    blowup starts immediately, and its directory is recorded in both the
    anomaly event and the diagnostic bundle.
    """

    def __init__(
        self,
        telemetry=None,
        out_dir: Optional[str] = None,
        policy: Optional[AnomalyPolicy] = None,
        ensemble=None,
        model_names: Optional[Sequence[str]] = None,
        checkpoint_fn: Optional[Callable[[Path], Any]] = None,
        trace_trigger=None,
    ):
        self.telemetry = telemetry
        self.trace_trigger = trace_trigger
        self.policy = policy or AnomalyPolicy()
        self.ensemble = ensemble
        self.model_names = list(model_names) if model_names else None
        self.checkpoint_fn = checkpoint_fn
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.masked: set = set()
        self.anomalies: List[Dict[str, Any]] = []
        self._hist: Dict[tuple, deque] = {}      # (model, metric) -> values
        self._last_dead: Dict[int, float] = {}   # model -> last dead_frac
        self._window: deque = deque(maxlen=self.policy.dump_last_k)
        self._bundles = 0

    def _name(self, m: int) -> str:
        if self.model_names and m < len(self.model_names):
            return self.model_names[m]
        return f"model_{m}"

    # -- detection -----------------------------------------------------------

    def observe(self, steps: Sequence[int], trees: Sequence[Dict[str, Any]]):
        """One flush window: `steps[i]` with `trees[i]` a dict of metric ->
        [n_models] host array (the exact payload `MetricLogger.flush` pulls
        in its single device_get). Raises `AnomalyAbort` per policy."""
        found: List[Dict[str, Any]] = []
        for step, tree in zip(steps, trees):
            flat = {
                k: np.atleast_1d(np.asarray(v, dtype=np.float64))
                for k, v in tree.items()
            }
            self._window.append({"step": int(step), **{k: v.tolist() for k, v in flat.items()}})
            for metric, vals in flat.items():
                for m, v in enumerate(vals.tolist()):
                    if m in self.masked:
                        continue
                    found.extend(self._check(int(step), metric, m, float(v)))
        if found:
            self._trigger(found)
        return found

    def _check(self, step: int, metric: str, m: int, v: float):
        out = []
        p = self.policy
        if p.nonfinite and (
            (not np.isfinite(v) and not metric.startswith("health_"))
            or (metric == "health_nonfinite" and v > 0)
        ):
            out.append(
                {"kind": "nonfinite", "step": step, "metric": metric,
                 "model": m, "value": v}
            )
            return out  # don't feed garbage into the trailing stats
        if p.spikes and metric in _LOSS_METRICS and np.isfinite(v):
            hist = self._hist.setdefault((m, metric), deque(maxlen=p.spike_window))
            if len(hist) >= p.spike_min_window:
                mean = float(np.mean(hist))
                std = float(np.std(hist))
                thresh = mean + max(p.spike_sigma * std, p.spike_rel_floor * abs(mean))
                if v > thresh:
                    out.append(
                        {"kind": "loss_spike", "step": step, "metric": metric,
                         "model": m, "value": v,
                         "window_mean": mean, "window_std": std,
                         "threshold": thresh}
                    )
            hist.append(v)
        if metric == "health_dead_frac" and np.isfinite(v):
            last = self._last_dead.get(m)
            if last is not None and v - last > p.dead_jump:
                out.append(
                    {"kind": "dead_feature_jump", "step": step, "metric": metric,
                     "model": m, "value": v, "previous": last}
                )
            self._last_dead[m] = v
        return out

    def observe_feature_drift(
        self,
        score: float,
        step: int = 0,
        top: Optional[Sequence] = None,
        scope: str = "serve",
        baseline: Optional[str] = None,
        current: Optional[str] = None,
    ):
        """Train↔serve drift check (telemetry.feature_stats): `score` is the
        aggregate per-feature PSI of the current window against the training
        baseline, `top` the top-drifting ``(feature, psi)`` pairs. Warns at
        ``drift_warn`` under the policy action; at ``drift_abort`` the action
        escalates to abort regardless — a dictionary serving a distribution
        it never trained on is not a warning. Returns the detections (empty
        when quiet)."""
        p = self.policy
        if not p.feature_drift or score != score or score < p.drift_warn:
            return []
        found = [{
            "kind": "feature_drift", "step": int(step), "metric": "feature_drift",
            "model": 0, "value": float(score), "scope": scope,
            "baseline": baseline, "current": current,
            "top": [[int(f), float(d)] for f, d in (top or [])][:16],
            "threshold": p.drift_warn,
        }]
        self._trigger(
            found, action="abort" if score >= p.drift_abort else None
        )
        return found

    # -- response ------------------------------------------------------------

    def _trigger(self, found: List[Dict[str, Any]], action: Optional[str] = None):
        p = self.policy
        action = action or p.action
        self.anomalies.extend(found)
        models = sorted({f["model"] for f in found})
        kinds = sorted({f["kind"] for f in found})
        step = max(f["step"] for f in found)
        trace_dir = None
        if self.trace_trigger is not None:
            try:  # a refused capture (profiler busy, ...) must not mask detection
                trace_dir = self.trace_trigger.fire(reason=",".join(kinds), step=step)
            except Exception:
                trace_dir = None
        bundle_path = self._dump_bundle(step, kinds, found, trace_dir=trace_dir)
        if self.telemetry is not None:
            for kind in kinds:
                ks = [f for f in found if f["kind"] == kind]
                kind_models = sorted({f["model"] for f in ks})
                self.telemetry.anomaly(
                    kind,
                    step=step,
                    models=kind_models,
                    model_names=[self._name(m) for m in kind_models],
                    detections=ks[:8],
                    bundle=str(bundle_path) if bundle_path else None,
                    action=action,
                    trace_dir=trace_dir,
                )
        desc = (
            f"anomaly at step {step}: {', '.join(kinds)} on "
            f"{[self._name(m) for m in models]}"
            + (f" (bundle: {bundle_path})" if bundle_path else "")
        )
        if action == "mask":
            self.masked |= set(models)
            if self.ensemble is not None:
                mask = np.ones((self.ensemble.n_models,), np.float32)
                mask[sorted(self.masked)] = 0.0
                self.ensemble.set_update_mask(mask)
            warnings.warn(desc + f" — masked models {sorted(self.masked)}", RuntimeWarning)
        elif action == "abort":
            warnings.warn(desc + " — aborting per policy", RuntimeWarning)
            raise AnomalyAbort(desc)
        else:
            warnings.warn(desc, RuntimeWarning)

    def _dump_bundle(
        self, step: int, kinds: List[str], found, trace_dir: Optional[str] = None
    ) -> Optional[Path]:
        if self.out_dir is None or self._bundles >= self.policy.max_bundles:
            return None
        self._bundles += 1
        d = self.out_dir / "diagnostics"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"anomaly_step{step}_{'_'.join(kinds)}.json"
        bundle = {
            "ts": time.time(),
            "step": step,
            "process_index": None,
            "kinds": kinds,
            "detections": found,
            "masked_before": sorted(self.masked),
            "model_names": self.model_names,
            "policy": dataclasses.asdict(self.policy),
            "metric_window": list(self._window),
            "trace_dir": trace_dir,
        }
        if self.checkpoint_fn is not None:
            try:
                bundle["checkpoint"] = str(self.checkpoint_fn(d))
            except Exception as e:  # a failed ckpt must not mask the anomaly
                bundle["checkpoint_error"] = repr(e)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=float)
        return path
