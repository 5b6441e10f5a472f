"""CLI entry point: ``python -m sparse_coding__tpu_torch.analysis [paths...]``
(default path: ``sparse_coding__tpu_torch``).

Exit codes: 0 = clean, 1 = findings (or failed contracts), 2 = usage error
(argparse, an unknown rule id), 3 = no Python files found under the given
paths.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from sparse_coding__tpu_torch.analysis.engine import (
    iter_python_files,
    lint_paths,
    load_baseline,
    write_baseline,
)
from sparse_coding__tpu_torch.analysis.rules import RULES

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_NO_FILES = 3


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.analysis",
        description="sclint for the PyTorch/CUDA port: repo-native static "
                    "analysis of the port's contracts (rule catalog: README.md, "
                    "the port's section)",
    )
    p.add_argument("paths", nargs="*", default=["sparse_coding__tpu_torch"],
                   help="files and/or directories to lint "
                        "(default: sparse_coding__tpu_torch)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as a JSON document on stdout")
    p.add_argument("--baseline", metavar="FILE",
                   help="allowlist of grandfathered finding keys; matching "
                        "findings are dropped")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write current findings to FILE as a baseline and "
                        "exit 0")
    p.add_argument("--select", metavar="RULES",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--contracts", action="store_true",
                   help="also run the abstract contract checks "
                        "(partition coverage, span tables, flags docs); "
                        "builds small CPU ensembles")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rid, spec in sorted(RULES.items()):
            print(f"{rid}  [{spec.scope:>6}]  {spec.title}")
        return EXIT_CLEAN

    select = None
    if args.select:
        select = {r.strip().upper() for r in args.select.split(",") if r.strip()}
        unknown = select - set(RULES)
        if unknown:
            print(f"unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2

    baseline = None
    if args.baseline:
        baseline = load_baseline(args.baseline)

    if not iter_python_files(args.paths):
        print(f"no Python files found under {args.paths}", file=sys.stderr)
        return EXIT_NO_FILES

    findings, n_files = lint_paths(args.paths, select=select, baseline=baseline)

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return EXIT_CLEAN

    contract_results = []
    if args.contracts:
        from sparse_coding__tpu_torch.analysis.contracts import run_contracts

        contract_results = run_contracts()

    if args.as_json:
        doc = {
            "files_scanned": n_files,
            "findings": [f.to_json() for f in findings],
            "contracts": [
                {"name": c.name, "ok": c.ok, "summary": c.summary,
                 "details": c.details}
                for c in contract_results
            ],
        }
        print(json.dumps(doc, indent=2))
    else:
        for f in findings:
            print(f.render())
        for c in contract_results:
            print(c.render())
        bad_contracts = sum(1 for c in contract_results if not c.ok)
        tail = f", {len(contract_results)} contract(s)" if contract_results else ""
        print(
            f"sclint: {n_files} file(s) scanned, {len(findings)} finding(s)"
            f"{tail}",
            file=sys.stderr,
        )

    if findings or any(not c.ok for c in contract_results):
        return EXIT_FINDINGS
    return EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
