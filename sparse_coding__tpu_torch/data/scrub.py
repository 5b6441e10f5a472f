"""Chunk-store scrub: verify every chunk, quarantine failures, repair holes.

Counterpart of `sparse_coding__tpu/data/scrub.py`.
``python -m sparse_coding__tpu_torch.data.scrub <store>`` walks one
activation chunk store (``{i}.npy`` chunks + ``sc_chunk.<i>.json`` commit
manifests — `data.integrity`), verifies every chunk at the **digest** tier
by default (the depth the hot loop's loads skip), and:

  - quarantines every failing chunk (moved into ``<store>/quarantine/``
    with a reason record — never deleted);
  - sweeps stale dot-prefixed staging temps a killed writer left behind;
  - reports holes: indices in ``[0, max]`` with no verifiable chunk;
  - with ``--repair <config.json>``, re-generates exactly the missing
    indices and re-verifies them;
  - prints a markdown summary and exits **1 while any unrepaired loss
    remains**.

Repair configs (JSON), the JAX package's schema:

    {"kind": "synthetic", "generator": {...SparseMixDataset/
     RandomDatasetGenerator kwargs..., "class": "SparseMixDataset",
     "seed": 0}, "n_chunks": 8, "chunk_size_gb": 0.001,
     "activation_width": 64, "dtype": "float16"}

regenerates the quarantined indices through the same seeded generator
(`data.chunks.generate_synthetic_chunks(only_chunks=...)`: the stream
advances past the surviving chunks, so the repaired chunk is the bits its
producer wrote). The port's generators draw `torch.Generator` streams, which
are neither the JAX package's nor the same on the CPU and on CUDA: a repair
runs on the device type the store's manifests name (`synthetic_stamp`;
``"device"`` in the config overrides it), and refuses, naming the producer
it found, a store the port's generators did not write (`RepairRefused`)
rather than write other data under the same index. ``{"kind": "harvest",
"setup": {...setup_data kwargs...}}`` re-runs the harvest with
``resume=True``, which re-captures from the first unverifiable chunk.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from sparse_coding__tpu_torch.data import integrity

__all__ = [
    "RepairRefused",
    "scrub_store",
    "repair_from_config",
    "render_scrub_markdown",
    "store_loss",
    "main",
]


def _store_indices(folder: Path) -> List[int]:
    """Every chunk index the store knows about: data files, commit
    manifests (a manifest whose data file vanished is still a loss to
    report), and the quarantine ledger."""
    idx = set()
    for p in folder.iterdir():
        if p.suffix == ".npy" and p.stem.isdigit():
            idx.add(int(p.stem))
        elif p.name.startswith("sc_chunk.") and p.suffix == ".json":
            mid = p.name[len("sc_chunk."):-len(".json")]
            if mid.isdigit():
                idx.add(int(mid))
    idx.update(integrity.quarantined_indices(folder))
    return sorted(idx)


def _expected_top(folder: Path, idx: List[int]) -> int:
    """Highest chunk index the store SHOULD hold. The max index present on
    disk alone is blind to wholesale tail loss (a partial copy that drops
    chunks 6-9 with their manifests looks 'whole' up to 5), so the harvest
    cursor — which records how many chunks were committed — raises the
    floor when present."""
    from sparse_coding__tpu_torch.data.activations import read_harvest_cursor

    top = max(idx) if idx else -1
    cursor = read_harvest_cursor(folder)
    if cursor is not None and isinstance(cursor.get("chunk"), int):
        top = max(top, int(cursor["chunk"]) - 1)
    return top


def _sweep_stale_temps(folder: Path) -> List[str]:
    """Dot-prefixed staging temps (` .{name}.tmp{pid}`) from killed writers:
    swept when their writer is dead, left alone while it might be mid-dump
    (same discipline as `train.checkpoint.save_learned_dicts`)."""
    import os

    swept = []
    for stale in folder.glob(".*.tmp*"):
        try:
            os.kill(int(stale.name.rsplit("tmp", 1)[-1]), 0)
        except (ValueError, ProcessLookupError):
            stale.unlink(missing_ok=True)
            swept.append(stale.name)
        except PermissionError:
            pass  # alive under another uid: leave it
    return swept


def scrub_store(
    folder, depth: str = "digest", quarantine: bool = True,
    sweep_temps: bool = True,
) -> Dict[str, Any]:
    """Verify every chunk in `folder`; quarantine failures. Returns a
    summary dict (see `render_scrub_markdown` for the fields).
    ``quarantine=False, sweep_temps=False`` makes the pass fully
    non-mutating (the admission-check mode, `store_loss`)."""
    folder = Path(folder)
    if not folder.is_dir():
        raise FileNotFoundError(f"chunk store {folder} does not exist")
    depth = integrity.verify_depth(depth)
    pre_quarantined = integrity.quarantined_indices(folder)
    swept = _sweep_stale_temps(folder) if sweep_temps else []
    verified: List[int] = []
    failed: List[Dict[str, Any]] = []
    for i in _store_indices(folder):
        if i in pre_quarantined and not (folder / f"{i}.npy").exists():
            continue  # already quarantined in a previous pass
        ok, reason = integrity.verify_chunk(folder, i, depth=depth)
        if ok:
            verified.append(i)
            continue
        if quarantine:
            integrity.quarantine_chunk(folder, i, reason)
        failed.append({"chunk": i, "reason": reason})
    all_idx = sorted(
        set(verified) | {f["chunk"] for f in failed} | set(pre_quarantined)
    )
    top = _expected_top(folder, all_idx)
    missing = sorted(set(range(top + 1)) - set(verified))
    return {
        "store": str(folder),
        "depth": depth,
        "total": top + 1,
        "verified": verified,
        "failed": failed,
        "pre_quarantined": pre_quarantined,
        "missing": missing,
        "swept_temps": swept,
        "repaired": [],
    }


def store_loss(folder, depth: Optional[str] = None) -> Dict[str, Any]:
    """Non-mutating loss estimate for admission checks: `scrub_store` with
    every mutation off, reduced to ``{loss_frac, bad, total}`` where
    ``bad`` covers failing, missing, and already-quarantined indices —
    ONE verification sweep, so the fleet admission verdict can never
    diverge from the scrub CLI's."""
    summary = scrub_store(
        folder, depth=depth or "digest", quarantine=False, sweep_temps=False
    )
    total = summary["total"]
    return {
        "loss_frac": (len(summary["missing"]) / total) if total else 0.0,
        "bad": summary["missing"],
        "total": total,
    }


class RepairRefused(ValueError):
    """A synthetic repair that could not give the chunk's bits back: the
    store was written by another producer (the JAX package's generators, or
    none stamped), or on a device type this process does not have."""


def _producer_stamps(folder: Path, indices) -> List[Dict[str, Any]]:
    """The ``provenance`` of the manifests of ``indices`` (from the store, or
    from quarantine/ where a scrub moved them), else of every manifest left
    in the store: what the repair checks its producer against."""
    found = []
    for i in indices:
        for p in (integrity.chunk_manifest_path(folder, i),
                  folder / integrity.QUARANTINE_DIR / integrity.chunk_manifest_path(folder, i).name):
            try:
                found.append(json.loads(p.read_text()).get("provenance") or {})
                break
            except (OSError, ValueError):
                continue
    if not found:
        for p in sorted(folder.glob("sc_chunk.*.json")):
            try:
                found.append(json.loads(p.read_text()).get("provenance") or {})
            except (OSError, ValueError):
                continue
    return found


def _repair_device(folder: Path, indices, config: Dict[str, Any]) -> str:
    """The device type the repair draws on: the stores' stamps name it (the
    config's ``"device"`` overrides). Raises `RepairRefused` where the bits
    cannot come back."""
    import torch

    from sparse_coding__tpu_torch.data.chunks import SYNTHETIC_PRODUCER

    devices = set()
    for prov in _producer_stamps(folder, indices):
        syn = prov.get("synthetic") if isinstance(prov, dict) else None
        if not isinstance(syn, dict) or syn.get("producer") != SYNTHETIC_PRODUCER:
            who = (syn or {}).get("producer") or (
                f"producer_identity {prov}" if prov else "an unstamped producer (the JAX package's generators)")
            raise RepairRefused(
                f"{folder}: chunk(s) {sorted(indices)} were not written by {SYNTHETIC_PRODUCER}'s generators "
                f"(manifest provenance names {who}); its torch.Generator streams cannot give their bits "
                "back — repair the store with the package that wrote it")
        devices.add(syn.get("device", "cpu"))
    if len(devices) > 1:
        raise RepairRefused(f"{folder}: chunks drawn on several device types {sorted(devices)}")
    dev = str(config.get("device") or (devices.pop() if devices else "cpu"))
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RepairRefused(f"{folder}: the chunks were drawn on CUDA, whose stream differs from the CPU's; "
                            "this process has no CUDA device")
    return dev


def repair_from_config(folder, indices, config: Dict[str, Any]) -> List[int]:
    """Re-generate exactly `indices` of the store from a repair config
    (module docstring). Returns the indices re-verified OK afterwards.
    Raises `RepairRefused` where a synthetic repair cannot give the bits
    back."""
    if not indices:
        return []
    folder = Path(folder)
    kind = config.get("kind")
    if kind == "synthetic":
        import numpy as np

        from sparse_coding__tpu_torch.data import synthetic as syn
        from sparse_coding__tpu_torch.data.chunks import generate_synthetic_chunks

        device = _repair_device(folder, indices, config)
        gen_cfg = dict(config.get("generator") or {})
        cls = getattr(syn, gen_cfg.pop("class", "SparseMixDataset"))
        seed = int(gen_cfg.pop("seed", 0))
        generator = cls(**gen_cfg, key=seed, device=device)
        dtype = config.get("dtype", "float16")
        generate_synthetic_chunks(
            generator, folder,
            n_chunks=int(config["n_chunks"]),
            chunk_size_gb=float(config.get("chunk_size_gb", 2.0)),
            activation_width=config.get("activation_width"),
            dtype=dtype if str(dtype) == "int4" else np.dtype(dtype),
            only_chunks=indices,
        )
    elif kind == "harvest":
        from sparse_coding__tpu_torch.data.activations import setup_data

        # the harvest re-runs with resume semantics: everything from the
        # first unverifiable chunk is re-captured
        setup_data(**dict(config.get("setup") or {}), resume=True)
    else:
        raise ValueError(
            f"unknown repair config kind {kind!r} (synthetic | harvest)"
        )
    repaired = []
    for i in indices:
        ok, _ = integrity.verify_chunk(folder, i, depth="digest")
        if ok:
            repaired.append(i)
    return repaired


def render_scrub_markdown(summary: Dict[str, Any]) -> str:
    unrepaired = sorted(set(summary["missing"]) - set(summary.get("repaired", [])))
    lines = [f"# Chunk-store scrub — `{summary['store']}`", ""]
    lines.append(
        f"Verified **{len(summary['verified'])}** chunk(s) at the "
        f"`{summary['depth']}` tier; "
        f"**{len(summary['failed'])} quarantined** this pass, "
        f"{len(summary['pre_quarantined'])} already in quarantine, "
        f"{len(summary.get('repaired', []))} repaired."
    )
    lines.append("")
    if summary["failed"]:
        lines.append("| chunk | verdict |")
        lines.append("|---:|---|")
        for f in summary["failed"]:
            lines.append(f"| {f['chunk']} | {f['reason']} |")
        lines.append("")
    if summary.get("swept_temps"):
        lines.append(
            f"- swept {len(summary['swept_temps'])} stale staging temp(s) "
            "from dead writers"
        )
        lines.append("")
    if unrepaired:
        lines.append(
            f"⚠ **UNREPAIRED LOSS**: chunk(s) {unrepaired} have no "
            "verifiable data. Re-harvest them (`--repair <config.json>`, or "
            "`make_activation_dataset(..., only_chunks=...)` /"
            " `resume=True` — docs/DATAPLANE.md), or train in degraded mode "
            "within `SC_CHUNK_LOSS_BUDGET`."
        )
    else:
        lines.append("All chunk indices verify — store is whole. ✓")
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.data.scrub",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("store", help="chunk store folder ({i}.npy + sc_chunk.<i>.json)")
    ap.add_argument("--depth", default="digest",
                    choices=("digest", "size", "off"),
                    help="verification tier (default digest — the scrub "
                    "exists to catch what the hot loop's size tier cannot)")
    ap.add_argument("--no-quarantine", action="store_true",
                    help="report failures without moving files")
    ap.add_argument("--repair", default=None, metavar="CONFIG.json",
                    help="re-harvest missing/quarantined indices from a "
                    "repair config (see module docstring)")
    ap.add_argument("--out", default=None, help="also write the markdown here")
    args = ap.parse_args(argv)

    summary = scrub_store(
        args.store, depth=args.depth, quarantine=not args.no_quarantine
    )
    refused = None
    if args.repair and summary["missing"]:
        with open(args.repair) as f:
            config = json.load(f)
        try:
            summary["repaired"] = repair_from_config(
                args.store, summary["missing"], config
            )
        except RepairRefused as e:
            refused = str(e)
    md = render_scrub_markdown(summary)
    print(md)
    if refused:
        print(f"repair refused: {refused}")
    if args.out:
        Path(args.out).write_text(md + "\n")
        print(f"[written to {args.out}]")
    unrepaired = set(summary["missing"]) - set(summary.get("repaired", []))
    return 1 if unrepaired else 0


if __name__ == "__main__":
    raise SystemExit(main())
