"""Goodput timeline CLI: render a run's wall-time ledger + Perfetto trace.

``python -m sparse_coding__tpu_torch.timeline <run_dir>`` reconstructs the
goodput/badput ledger (`telemetry.goodput`) from every ``events*.jsonl``
under the run directory — merged across processes, resume generations, and
the supervisor's restart log — and prints it: total wall, goodput %, the
badput breakdown, and the widest badput spans. A fleet directory raises
(`fleet/` is not ported yet, ROADMAP A9).

Options:

  ``--trace OUT.json``    export a Chrome trace-event JSON (one track per
                          host/generation, spans colored by category) —
                          load it in Perfetto (ui.perfetto.dev) or
                          chrome://tracing
  ``--json``              print the raw ledger as JSON
  ``--goodput-floor PCT`` regression gate: exit **1** when goodput %% falls
                          below PCT (the `perfdiff`-style CI hook — pin a
                          floor on a golden fixture and a change that
                          introduces a stall fails the build)

Exit codes: 0 ok; 1 goodput below ``--goodput-floor``; 3 nothing to work
with (missing/empty logs, or ``--goodput-floor`` on a span-less legacy run
that measured no goodput at all).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from sparse_coding__tpu_torch.telemetry.goodput import (
    build_ledger,
    render_ledger,
    to_chrome_trace,
)

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.timeline",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run_dir", help="directory holding events*.jsonl logs")
    ap.add_argument(
        "--trace", default=None, metavar="OUT.json",
        help="write a Chrome/Perfetto trace-event JSON here",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="print the ledger as JSON instead of the text summary",
    )
    ap.add_argument(
        "--goodput-floor", type=float, default=None, metavar="PCT",
        help="exit 1 when goodput %% is below this floor (CI gate)",
    )
    args = ap.parse_args(argv)

    try:
        ledger = build_ledger(args.run_dir)
    except FileNotFoundError as e:
        print(str(e))
        return 3
    if ledger["wall_seconds"] <= 0 and not ledger["spans"]:
        print(f"no attributable events under {args.run_dir}")
        return 3

    if args.json:
        print(json.dumps(ledger, indent=1, default=str))
    else:
        print(f"# Goodput ledger — `{ledger['run_dir']}`")
        print()
        print(render_ledger(ledger))

    if args.trace:
        trace = to_chrome_trace(ledger)
        Path(args.trace).write_text(json.dumps(trace))
        print(f"\n[trace: {len(trace['traceEvents'])} events → {args.trace} "
              "(load in ui.perfetto.dev or chrome://tracing)]")

    if args.goodput_floor is not None:
        if not ledger.get("has_spans"):
            # a span-less legacy run measures no goodput at all — gating it
            # would always fail; exit 3 so CI misconfiguration is loud
            print(
                f"\nno span instrumentation under {args.run_dir} — "
                "cannot gate goodput"
            )
            return 3
        frac = ledger.get("goodput_frac") or 0.0
        pct = 100.0 * frac
        if pct < args.goodput_floor:
            print(
                f"\nGOODPUT REGRESSION: {pct:.1f}% < floor "
                f"{args.goodput_floor:.1f}%"
            )
            return 1
        print(f"\ngoodput {pct:.1f}% >= floor {args.goodput_floor:.1f}% — ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
