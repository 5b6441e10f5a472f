"""Spread-aware bench regression comparator.

``python -m sparse_coding__tpu_torch.perfdiff OLD.json NEW.json`` compares two
`bench.py` output JSONs (raw, or wrapped in the round driver's
``{"parsed": {...}}`` envelope — BENCH_r*.json) and exits nonzero when a key
regressed. Until now the BENCH_r*.json trajectory was compared by eye; this
makes "did this change slow anything down" a one-command, CI-able check.

A naive ``new < old`` comparison false-positives constantly on a shared
chip, so the verdict is spread- and weather-aware:

  - every bench key already ships its [min, max] **spread** over the
    interleaved measurement rounds — a key only *regresses* when the new
    median falls below the OLD RUN'S WORST ROUND by more than
    ``--threshold`` (and only *improves* when it clears the old best round
    by the same margin); anything inside the old spread is noise;
  - the **pinned control** key (``control_matmul_tflops`` — a fixed matmul
    program that no code change touches) measures chip weather: every
    expectation is scaled by ``new_control/old_control`` first, so a session
    where the whole chip runs 10% slow does not page anyone, and a key that
    moves AGAINST the control is flagged even when the raw delta looks flat.

Only keys carrying a ``<key>_spread`` sibling participate (the measured
medians); derived scalars (mfu, ratios) and metadata are ignored. The
control key itself is reported but never gates — it IS the weather.

**Direction**: keys are higher-is-better (throughputs) unless
they end in a `LOWER_IS_BETTER_SUFFIXES` suffix (``_bytes_per_row``,
``_bytes_per_request``, ``_bytes``, ``_ms`` — sizes and latencies), which
gate inverted: a regression is the new median rising ABOVE the old spread
max. Weather scaling inverts with them (a slow chip legitimately raises
latencies by 1/ratio; wire sizes don't move with weather, but the control
ratio is ~1 across sessions so the correction is benign).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["load_bench", "compare", "render_table", "main"]

CONTROL_KEY = "control_matmul_tflops"
DEFAULT_THRESHOLD = 0.05  # fraction below the weather-scaled old worst round

# size/latency keys gate in the opposite direction: UP is a regression
LOWER_IS_BETTER_SUFFIXES = (
    "_bytes_per_row", "_bytes_per_request", "_bytes", "_ms",
)


def lower_is_better(key: str) -> bool:
    return key.endswith(LOWER_IS_BETTER_SUFFIXES)


def load_bench(path) -> Dict[str, Any]:
    """Load a bench JSON; unwraps the round driver's ``{"parsed": ...}``
    envelope (BENCH_r*.json) transparently."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a JSON object, got {type(data).__name__}")
    if "parsed" in data and isinstance(data["parsed"], dict):
        data = data["parsed"]
    return data


def _measured_keys(bench: Dict[str, Any]) -> List[str]:
    """Keys that carry a median + spread pair, in file order."""
    out = []
    for k, v in bench.items():
        if k.endswith("_spread"):
            continue
        spread = bench.get(f"{k}_spread")
        if (
            isinstance(v, (int, float))
            and isinstance(spread, (list, tuple))
            and len(spread) == 2
        ):
            out.append(k)
    return out


def compare(
    old: Dict[str, Any],
    new: Dict[str, Any],
    threshold: float = DEFAULT_THRESHOLD,
    control_key: str = CONTROL_KEY,
) -> Dict[str, Any]:
    """Compare two bench dicts. Returns::

        {"control_ratio": new_control/old_control (1.0 when absent),
         "rows": [{"key", "old", "old_spread", "new", "delta",
                   "adj_delta", "status"}, ...],
         "regressions": [keys...], "improvements": [keys...]}

    ``status`` is ``"ok"`` (inside the weather-scaled old spread),
    ``"regressed"`` (new median below old spread-min * ratio * (1-threshold)),
    ``"improved"`` (above old spread-max * ratio * (1+threshold)),
    ``"control"``/``"missing"``, or ``"new"`` — a measured key present only
    in NEW (a bench that grew a key must still compare cleanly against an
    older BENCH_r* envelope; new keys are reported, never gated).
    """
    ratio = 1.0
    oc, nc = old.get(control_key), new.get(control_key)
    if isinstance(oc, (int, float)) and isinstance(nc, (int, float)) and oc > 0:
        ratio = float(nc) / float(oc)
    rows: List[Dict[str, Any]] = []
    regressions: List[str] = []
    improvements: List[str] = []
    for key in _measured_keys(old):
        old_med = float(old[key])
        lo, hi = (float(v) for v in old[f"{key}_spread"])
        row: Dict[str, Any] = {
            "key": key, "old": old_med, "old_spread": [lo, hi],
            "new": None, "delta": None, "adj_delta": None, "status": "missing",
        }
        nv = new.get(key)
        if isinstance(nv, (int, float)):
            nv = float(nv)
            row["new"] = nv
            row["delta"] = nv / old_med - 1.0 if old_med else None
            inverted = lower_is_better(key)
            # weather correction: a slow chip deflates throughputs (divide
            # by ratio to compare) and inflates latencies (multiply)
            adj = (nv * ratio) if inverted else (nv / ratio if ratio > 0 else nv)
            row["adj_delta"] = adj / old_med - 1.0 if old_med else None
            if key == control_key:
                row["status"] = "control"
            elif inverted:
                scale = (1.0 / ratio) if ratio > 0 else 1.0
                if nv > hi * scale * (1.0 + threshold):
                    row["status"] = "regressed"
                    regressions.append(key)
                elif nv < lo * scale * (1.0 - threshold):
                    row["status"] = "improved"
                    improvements.append(key)
                else:
                    row["status"] = "ok"
            elif nv < lo * ratio * (1.0 - threshold):
                row["status"] = "regressed"
                regressions.append(key)
            elif nv > hi * ratio * (1.0 + threshold):
                row["status"] = "improved"
                improvements.append(key)
            else:
                row["status"] = "ok"
        rows.append(row)
    old_keys = set(_measured_keys(old))
    for key in _measured_keys(new):
        if key in old_keys:
            continue
        rows.append({
            "key": key, "old": None, "old_spread": None,
            "new": float(new[key]), "delta": None, "adj_delta": None,
            "status": "new",
        })
    return {
        "control_ratio": round(ratio, 4),
        "threshold": threshold,
        "rows": rows,
        "regressions": regressions,
        "improvements": improvements,
    }


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    return f"{v:.3g}"


def _fmt_pct(v: Optional[float]) -> str:
    return "-" if v is None else f"{100.0 * v:+.1f}%"


_STATUS_LABEL = {
    "ok": "ok",
    "regressed": "**REGRESSED**",
    "improved": "improved",
    "control": "(control)",
    "missing": "missing in NEW",
    "new": "new in NEW",
}


def render_table(result: Dict[str, Any]) -> str:
    lines = [
        f"chip-weather control ratio (new/old): **{result['control_ratio']:.3f}** — "
        f"expectations scaled by it; regression = new median below the old "
        f"worst round by >{100 * result['threshold']:.0f}% after scaling.",
        "",
        "| key | old median | old spread | new median | Δ | weather-adj Δ | verdict |",
        "|---|---:|---:|---:|---:|---:|---|",
    ]
    for r in result["rows"]:
        spread = (
            "-" if r["old_spread"] is None
            else f"[{_fmt(r['old_spread'][0])}, {_fmt(r['old_spread'][1])}]"
        )
        lines.append(
            f"| {r['key']} | {_fmt(r['old'])} | {spread} "
            f"| {_fmt(r['new'])} | {_fmt_pct(r['delta'])} "
            f"| {_fmt_pct(r['adj_delta'])} | {_STATUS_LABEL[r['status']]} |"
        )
    lines.append("")
    if result["regressions"]:
        lines.append(
            f"**{len(result['regressions'])} regression(s):** "
            + ", ".join(result["regressions"])
        )
    else:
        lines.append("No regressions.")
    if result["improvements"]:
        lines.append(
            f"{len(result['improvements'])} improvement(s): "
            + ", ".join(result["improvements"])
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.perfdiff", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("old", help="baseline bench JSON (bench.py output or BENCH_r*.json)")
    ap.add_argument("new", help="candidate bench JSON")
    ap.add_argument(
        "--threshold", type=float, default=DEFAULT_THRESHOLD,
        help="regression margin below the weather-scaled old spread-min "
        f"(default {DEFAULT_THRESHOLD})",
    )
    ap.add_argument(
        "--control-key", default=CONTROL_KEY,
        help=f"pinned-control key used for weather scaling (default {CONTROL_KEY})",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="print the comparison as JSON instead of a markdown table",
    )
    args = ap.parse_args(argv)
    old = load_bench(Path(args.old))
    new = load_bench(Path(args.new))
    result = compare(
        old, new, threshold=args.threshold, control_key=args.control_key
    )
    if args.json:
        print(json.dumps(result, indent=1))
    else:
        print(render_table(result))
    return 1 if result["regressions"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
