"""Artifact provenance graph: harvest bytes → chunks → checkpoints →
exports → served dictionaries → traced responses.

Counterpart of `sparse_coding__tpu/telemetry/provenance.py`, on the same
on-disk contracts, so either package's graph joins either package's
artifacts. Every durable boundary commits content digests and config
fingerprints — chunk manifests (``sc_chunk.<i>.json``), the harvest cursor,
checkpoint manifests (``sc_manifest.json``: the port writes ``state.pt`` and
``shards/...pt`` under it where the JAX package writes ``tree.npz``; the
graph keys a checkpoint by the manifest's file digests, so the format does
not matter), export sidecars (``<file>.manifest.json``) and fleet
``export_manifest.json``, fleet queue items, registry events and
``run_start`` fingerprints in ``events.jsonl``. `build_graph` walks any mix
of chunk stores, run dirs, export dirs, fleet dirs (their queue is only
read) and serve dirs and joins them into a typed graph

    node types: chunk, store, harvest-run, training-run, checkpoint,
                export, dict, registry-generation, fleet-item,
                traced-response
    edge kinds: derived-from (dst is an input/producer of src),
                contains, resumed-from, swapped-in

from the committed manifests alone, folding in the explicit ``provenance``
events the drivers emit at their commit points.

CLI (``python -m sparse_coding__tpu_torch.lineage``):

    explain <artifact|trace-id> ROOT...  upstream closure with digest
                                         re-verification (--verify
                                         off|size|digest)
    blast   <artifact> ROOT...           downstream taint closure: a
                                         quarantined chunk names every
                                         checkpoint, export and LIVE
                                         serving generation downstream
    check   ROOT...                      CI gate — exit 1 while any
                                         artifact is tainted
    graph   ROOT...                      dump the whole graph

Taint: a chunk is *tainted* when its quarantine ledger
(``quarantine/sc_quarantine.<i>.json``) exists AND the chunk does not verify
against its manifest now. An exact-index repair (``scrub --repair``)
rewrites chunk and manifest and leaves the ledger as history, so ``lineage
check`` drops back to exit 0 as ``scrub`` does: verification, not the
ledger's absence, is the source of truth.

Stdlib only, like the rest of the run tools: the quarantine layout and the
chunk manifest schema are mirrored here by contract (see `data.integrity`).
The re-verification sweep runs under a ``lineage_verify`` badput span and
publishes ``lineage.*`` counters to every open `RunTelemetry`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from sparse_coding__tpu_torch.utils.manifest import sha256_file

__all__ = [
    "Graph",
    "GraphBuilder",
    "build_graph",
    "config_digest",
    "checkpoint_digest",
    "export_digest",
    "producer_identity",
    "verify_graph",
    "render_explain",
    "render_blast",
    "render_summary",
    "main",
]

# On-disk contracts mirrored from their owning modules (kept as string
# constants so this module stays stdlib-only — data.integrity pulls numpy):
CHUNK_MANIFEST_RE = re.compile(r"^sc_chunk\.(\d+)\.json$")  # data.integrity
QUARANTINE_DIR = "quarantine"                               # data.integrity
QUARANTINE_LEDGER = "sc_quarantine.{i}.json"                # data.integrity
HARVEST_CURSOR = "sc_harvest_cursor.json"                   # data.activations
CKPT_MANIFEST = "sc_manifest.json"                          # train.checkpoint
EXPORT_MANIFEST = "export_manifest.json"                    # fleet.worker
SIDECAR_SUFFIX = ".manifest.json"                           # utils.manifest
QUEUE_BUCKETS = ("pending", "leased", "done", "failed")     # fleet.queue

# display order for node types (render + summaries)
NODE_TYPES = (
    "traced-response",
    "registry-generation",
    "dict",
    "fleet-item",
    "export",
    "checkpoint",
    "training-run",
    "store",
    "chunk",
    "harvest-run",
)

_ID_PREFIXES = (
    "response", "generation", "dict", "fleet-item", "export",
    "checkpoint", "run", "store", "chunk", "harvest",
)

SHORT_DIGEST = 12


# -- digests & producer identity -----------------------------------------------


def config_digest(config: Any) -> str:
    """16-hex sha256 over canonical (sorted-key, compact) JSON — the config
    join key shared by provenance events, manifest producer-identity
    extras, and the graph's ``run_start`` reconstruction. Non-JSON leaves
    stringify (`default=str`) so dataclass reprs and Paths digest stably."""
    blob = json.dumps(
        config, sort_keys=True, separators=(",", ":"), default=str
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def manifest_files_digest(files: Dict[str, Any]) -> Optional[str]:
    """Content digest of a manifest's ``files`` table: canonical digest of
    {name: sha256}. Stable against manifest re-writes that only re-stamp
    ``created_at`` — the artifact identity is its bytes."""
    shas = {
        str(name): entry.get("sha256") or entry.get("bytes")
        for name, entry in files.items()
        if isinstance(entry, dict)
    }
    return config_digest(shas) if shas else None


def checkpoint_digest(ckpt_dir) -> Optional[str]:
    """Content digest of a checkpoint from its committed ``sc_manifest.json``
    (None for an uncommitted/legacy directory) — the join key drivers
    record as ``source_checkpoint`` when exporting."""
    man = _read_json(Path(ckpt_dir) / CKPT_MANIFEST)
    if not isinstance(man, dict):
        return None
    return manifest_files_digest(man.get("files") or {})


def export_digest(export_path) -> Optional[str]:
    """Content digest of a single-file export from its sidecar manifest
    (``<file>.manifest.json``), or None for a legacy unmanifested export."""
    p = Path(export_path)
    man = _read_json(p.with_name(p.name + SIDECAR_SUFFIX))
    if not isinstance(man, dict):
        return None
    return manifest_files_digest(man.get("files") or {})


def producer_identity(
    config: Any = None,
    fingerprint: Optional[Dict[str, Any]] = None,
    source_checkpoint: Optional[str] = None,
    run_dir=None,
) -> Dict[str, Any]:
    """The producer-identity block manifests carry under ``"provenance"``:
    who wrote this artifact (the fingerprint's git sha, framework — torch
    for the port, jax for the JAX package — backend and device), from what
    config, on top of which checkpoint. Every field optional — a partial
    identity still joins the graph on whatever keys it does carry."""
    ident: Dict[str, Any] = {"format": 1}
    if fingerprint:
        ident["fingerprint"] = {
            k: fingerprint[k]
            for k in ("git_sha", "jax", "torch", "backend", "device_kind")
            if fingerprint.get(k) is not None
        }
    if config is not None:
        ident["config_sha"] = config_digest(config)
    if source_checkpoint:
        ident["source_checkpoint"] = source_checkpoint
    if run_dir is not None:
        ident["run_dir"] = str(run_dir)
    return ident


def _short(digest: Optional[str]) -> str:
    return (digest or "")[:SHORT_DIGEST]


def _read_json(path: Path) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _iter_events(d: Path, event_files: Iterable[str]) -> Iterator[Dict[str, Any]]:
    """Records from a run dir's ``events*.jsonl`` files in name order;
    torn tail lines (a killed writer) are skipped, never fatal."""
    for name in event_files:
        try:
            with open(d / name) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict):
                        yield rec
        except OSError:
            continue


def _string_values(obj: Any) -> Iterator[str]:
    """Every string leaf of a nested config — candidate path join keys."""
    if isinstance(obj, str):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _string_values(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _string_values(v)


def _verify_files(files: Dict[str, Dict[str, Any]], tier: str) -> Tuple[bool, str]:
    """Re-verify a node's recorded file table ({abs path: {bytes, sha256}})
    at ``tier`` (size | digest). Mirrors `utils.manifest.verify_manifest`
    semantics: every listed file must exist with matching byte size, and
    at the digest tier matching sha256."""
    for path, entry in sorted(files.items()):
        p = Path(path)
        try:
            size = p.stat().st_size
        except OSError:
            return False, f"missing file {p.name}"
        want = entry.get("bytes")
        if want is not None and size != int(want):
            return False, f"size mismatch on {p.name} ({size} != {want})"
        if tier == "digest":
            want_sha = entry.get("sha256")
            if want_sha and sha256_file(p) != want_sha:
                return False, f"digest mismatch on {p.name}"
    return True, "ok"


# -- the graph -----------------------------------------------------------------


class Graph:
    """The built artifact graph: ``nodes`` (id → record) + directed
    ``edges`` ({src, dst, kind}; dst is upstream of src). `closure("up")`
    follows src→dst (inputs/producers); `closure("down")` follows the
    reverse (everything derived from a node — the taint direction)."""

    def __init__(self, nodes: Dict[str, Dict[str, Any]], edges: List[Dict[str, str]]):
        self.nodes = nodes
        self.edges = edges
        self.out: Dict[str, List[Dict[str, str]]] = {}
        self.inn: Dict[str, List[Dict[str, str]]] = {}
        for e in edges:
            self.out.setdefault(e["src"], []).append(e)
            self.inn.setdefault(e["dst"], []).append(e)

    def closure(self, nid: str, direction: str = "up") -> List[str]:
        """BFS closure from ``nid`` (excluded), deterministic order."""
        table = self.out if direction == "up" else self.inn
        key = "dst" if direction == "up" else "src"
        seen = {nid}
        order: List[str] = []
        frontier = [nid]
        while frontier:
            nxt: List[str] = []
            for cur in frontier:
                for e in table.get(cur, ()):
                    other = e[key]
                    if other not in seen:
                        seen.add(other)
                        order.append(other)
                        nxt.append(other)
            frontier = nxt
        return order

    def tainted(self) -> List[Dict[str, Any]]:
        return [
            n for _, n in sorted(self.nodes.items()) if n.get("tainted")
        ]

    def resolve(self, token: str) -> Optional[str]:
        """Map a CLI token — node id, bare id without type prefix, path,
        trace id, or digest prefix — to a node id (None when ambiguous
        or absent)."""
        if token in self.nodes:
            return token
        for prefix in _ID_PREFIXES:
            nid = f"{prefix}:{token}"
            if nid in self.nodes:
                return nid
        try:
            rp = str(Path(token).resolve())
        except OSError:
            rp = None
        if rp:
            for nid, n in sorted(self.nodes.items()):
                if n.get("path") == rp:
                    return nid
        cands = sorted(
            nid for nid, n in self.nodes.items()
            if n.get("digest", "").startswith(token)
        )
        if len(cands) == 1:
            return cands[0]
        cands = sorted(nid for nid in self.nodes if token in nid)
        if len(cands) == 1:
            return cands[0]
        return None

    def to_json(self) -> Dict[str, Any]:
        return {
            "nodes": [self.nodes[k] for k in sorted(self.nodes)],
            "edges": sorted(
                self.edges, key=lambda e: (e["src"], e["dst"], e["kind"])
            ),
        }


class GraphBuilder:
    """Walks artifact roots and accumulates nodes/edges. Join hints that
    may resolve against artifacts scanned later (paths, digests, config
    digests) are deferred and resolved in one pass at `build()`."""

    def __init__(self):
        self.nodes: Dict[str, Dict[str, Any]] = {}
        self.edges: List[Dict[str, str]] = []
        self._edge_seen: set = set()
        self._bases: List[Path] = []
        self._path_index: Dict[str, str] = {}
        self._digest_index: Dict[str, str] = {}
        self._config_index: Dict[str, str] = {}
        self._pending: List[Tuple[str, str, Dict[str, Any]]] = []
        self._live_generation: Dict[str, str] = {}

    # -- node/edge plumbing ----------------------------------------------------

    def rel(self, path) -> str:
        p = Path(path).resolve()
        for base in self._bases:
            try:
                r = p.relative_to(base).as_posix()
            except ValueError:
                continue
            return base.name if r == "." else r
        return str(p)

    def node(
        self,
        nid: str,
        ntype: str,
        path=None,
        digest: Optional[str] = None,
        ts=None,
        meta: Optional[Dict[str, Any]] = None,
        files: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> Dict[str, Any]:
        n = self.nodes.get(nid)
        if n is None:
            n = {"id": nid, "type": ntype, "meta": {}}
            self.nodes[nid] = n
        if path is not None:
            rp = str(Path(path).resolve())
            n.setdefault("path", rp)
            self._path_index.setdefault(rp, nid)
        if digest:
            n.setdefault("digest", digest)
            self._digest_index.setdefault(digest, nid)
        if ts is not None:
            n.setdefault("ts", ts)
        if files:
            n.setdefault("files", {}).update(files)
        if meta:
            for k, v in meta.items():
                if v is not None:
                    n["meta"].setdefault(k, v)
        return n

    def edge(self, src: str, dst: str, kind: str) -> None:
        key = (src, dst, kind)
        if src == dst or key in self._edge_seen:
            return
        self._edge_seen.add(key)
        self.edges.append({"src": src, "dst": dst, "kind": kind})

    def defer(self, src: str, kind: str, **hint) -> None:
        self._pending.append((src, kind, hint))

    def _harvest_node(self, config_sha: str) -> str:
        hid = f"harvest:{config_sha}"
        self.node(hid, "harvest-run", digest=config_sha,
                  meta={"config_sha": config_sha})
        return hid

    # -- roots -----------------------------------------------------------------

    def add_root(self, root) -> None:
        root = Path(root).resolve()
        if not root.exists():
            raise FileNotFoundError(root)
        if root.is_file():
            root = root.parent
        if root not in self._bases:
            self._bases.append(root)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()  # deterministic graph order across filesystems
            d = Path(dirpath)
            if d.name == QUARANTINE_DIR:
                dirnames[:] = []  # ledger dir is consumed by the store scan
                continue
            names = set(filenames)
            event_files = sorted(
                n for n in names
                if n.startswith("events") and n.endswith(".jsonl")
            )
            if HARVEST_CURSOR in names or any(
                CHUNK_MANIFEST_RE.match(n) for n in names
            ):
                self._scan_store(d, names)
            if event_files:
                self._scan_run(d, event_files)
            if CKPT_MANIFEST in names:
                self._scan_checkpoint(d)
            if EXPORT_MANIFEST in names or any(
                n.endswith(SIDECAR_SUFFIX) for n in names
            ):
                self._scan_exports(d, names)
            if sum(b in dirnames for b in QUEUE_BUCKETS) >= 2:
                self._scan_queue(d)

    # -- scanners --------------------------------------------------------------

    def _scan_store(self, d: Path, names: set) -> None:
        sid = f"store:{self.rel(d)}"
        self.node(sid, "store", path=d)
        cursor = _read_json(d / HARVEST_CURSOR)
        cursor_sha = (cursor or {}).get("config_sha") if isinstance(cursor, dict) else None
        if cursor_sha:
            self.edge(sid, self._harvest_node(cursor_sha), "derived-from")
        chunks = sorted(
            (int(m.group(1)), n)
            for n in names
            for m in [CHUNK_MANIFEST_RE.match(n)]
            if m
        )
        for i, name in chunks:
            man = _read_json(d / name)
            if not isinstance(man, dict):
                continue
            files = man.get("files") or {}
            cid = f"chunk:{self.rel(d)}#{i}"
            n = self.node(
                cid, "chunk", path=d / name,
                digest=manifest_files_digest(files),
                ts=man.get("created_at"),
                meta={"store": str(d), "chunk": i, "rows": man.get("rows")},
                files={
                    str((d / fname).resolve()): entry
                    for fname, entry in files.items()
                    if isinstance(entry, dict)
                },
            )
            for entry in files.values():
                if isinstance(entry, dict) and entry.get("sha256"):
                    self._digest_index.setdefault(entry["sha256"], cid)
            self.edge(sid, cid, "contains")
            prov = man.get("provenance") or {}
            harvest = prov.get("harvest") if isinstance(prov, dict) else None
            sha = (harvest or {}).get("config_sha") or cursor_sha
            if sha:
                self.edge(cid, self._harvest_node(sha), "derived-from")
            # Taint: ledger present AND the bytes do not verify right now.
            # A repaired chunk (scrub --repair --only-chunks) re-verifies
            # while the ledger stays as history — it is NOT tainted.
            ledger = d / QUARANTINE_DIR / QUARANTINE_LEDGER.format(i=i)
            if ledger.exists():
                ok, reason = _verify_files(n.get("files") or {}, "digest")
                led = _read_json(ledger) or {}
                if ok:
                    n["meta"]["repaired"] = True
                else:
                    n["tainted"] = True
                    n["taint_reason"] = (
                        f"quarantined ({led.get('reason', 'unknown')}); {reason}"
                    )
        # Unrepaired quarantined chunks: `quarantine_chunk` MOVES the data
        # + manifest into quarantine/, so the in-store scan above never
        # sees them. Reconstruct them from the moved manifest — tainted by
        # definition, their bytes are gone from the committed location.
        qdir = d / QUARANTINE_DIR
        if qdir.is_dir():
            for qp in sorted(qdir.glob("sc_quarantine.*.json")):
                led = _read_json(qp) or {}
                try:
                    i = int(led.get("chunk"))
                except (TypeError, ValueError):
                    continue
                cid = f"chunk:{self.rel(d)}#{i}"
                if cid in self.nodes:
                    continue  # repaired in place — handled above
                man = _read_json(qdir / f"sc_chunk.{i}.json")
                files = (man or {}).get("files") or {}
                n = self.node(
                    cid, "chunk", path=qdir / f"sc_chunk.{i}.json",
                    digest=manifest_files_digest(files),
                    ts=(man or {}).get("created_at"),
                    meta={"store": str(d), "chunk": i},
                )
                n["tainted"] = True
                n["taint_reason"] = (
                    f"quarantined ({led.get('reason', 'unknown')}); "
                    "files moved to quarantine/"
                )
                self.edge(sid, cid, "contains")
                harvest = ((man or {}).get("provenance") or {}).get("harvest")
                sha = (harvest or {}).get("config_sha") or cursor_sha
                if sha:
                    self.edge(cid, self._harvest_node(sha), "derived-from")

    def _scan_checkpoint(self, d: Path) -> None:
        man = _read_json(d / CKPT_MANIFEST)
        if not isinstance(man, dict):
            return
        files = man.get("files") or {}
        cid = f"checkpoint:{self.rel(d)}"
        n = self.node(
            cid, "checkpoint", path=d,
            digest=manifest_files_digest(files),
            ts=man.get("created_at"),
            meta={k: man.get(k) for k in ("epoch", "position", "chunk_cursor")},
            files={
                str((d / fname).resolve()): entry
                for fname, entry in files.items()
                if isinstance(entry, dict)
            },
        )
        for entry in files.values():
            if isinstance(entry, dict) and entry.get("sha256"):
                self._digest_index.setdefault(entry["sha256"], cid)
        self.defer(cid, "derived-from", run_dir=str(d.parent))
        prov = man.get("provenance")
        if isinstance(prov, dict):
            n["meta"]["provenance"] = prov
            if prov.get("config_sha"):
                self.defer(cid, "derived-from", config_sha=prov["config_sha"])

    def _scan_exports(self, d: Path, names: set) -> None:
        dir_eid = None
        if EXPORT_MANIFEST in names:
            dir_man = _read_json(d / EXPORT_MANIFEST)
            if isinstance(dir_man, dict):
                dir_eid = f"export:{self.rel(d)}"
                n = self.node(
                    dir_eid, "export", path=d,
                    # the manifest-BYTES digest — what fleet item
                    # completion records as export_digest
                    digest=sha256_file(d / EXPORT_MANIFEST),
                    ts=dir_man.get("created_at"),
                    meta={"manifest": EXPORT_MANIFEST},
                )
                self._apply_manifest_provenance(dir_eid, n, dir_man, d)
        for name in sorted(names):
            if not name.endswith(SIDECAR_SUFFIX) or name == EXPORT_MANIFEST:
                continue
            target = d / name[: -len(SIDECAR_SUFFIX)]
            man = _read_json(d / name)
            if not isinstance(man, dict):
                continue
            files = man.get("files") or {}
            eid = f"export:{self.rel(target)}"
            n = self.node(
                eid, "export", path=target,
                digest=manifest_files_digest(files),
                ts=man.get("created_at"),
                files={
                    str((d / fname).resolve()): entry
                    for fname, entry in files.items()
                    if isinstance(entry, dict)
                },
            )
            for entry in files.values():
                if isinstance(entry, dict) and entry.get("sha256"):
                    self._digest_index.setdefault(entry["sha256"], eid)
            if dir_eid:
                self.edge(dir_eid, eid, "contains")
            self._apply_manifest_provenance(eid, n, man, d)

    def _apply_manifest_provenance(
        self, eid: str, n: Dict[str, Any], man: Dict[str, Any], d: Path
    ) -> None:
        """Producer-identity extras join the export to its
        run / source checkpoint; a legacy digest-only manifest falls back
        to enclosing-run + latest-checkpoint reconstruction."""
        self.defer(eid, "derived-from", run_dir=str(d))
        prov = man.get("provenance")
        if isinstance(prov, dict):
            n["meta"]["provenance"] = prov
            if prov.get("config_sha"):
                self.defer(eid, "derived-from", config_sha=prov["config_sha"])
            if prov.get("source_checkpoint"):
                self.defer(
                    eid, "derived-from", digest=prov["source_checkpoint"]
                )
            if prov.get("run_dir"):
                self.defer(eid, "derived-from", run_dir=prov["run_dir"])
        else:
            # legacy export: the freshest committed checkpoint in the same
            # directory is its reconstruction-time source
            self.defer(eid, "derived-from", latest_ckpt_in=str(d))

    def _scan_run(self, d: Path, event_files: List[str]) -> None:
        rid = f"run:{self.rel(d)}"
        run = self.node(rid, "training-run", path=d)
        gen_counter = 0
        current_gid: Optional[str] = None
        for ev in _iter_events(d, event_files):
            et = ev.get("event")
            if et == "run_start":
                fp = ev.get("fingerprint") or {}
                if isinstance(fp, dict):
                    ident = {
                        k: fp.get(k)
                        for k in ("git_sha", "backend", "jax", "torch")
                        if fp.get(k) is not None
                    }
                    if ident:
                        run["meta"].setdefault("fingerprint", ident)
                cfg = ev.get("config")
                if isinstance(cfg, dict) and cfg:
                    sha = config_digest(cfg)
                    run["meta"].setdefault("config_sha", sha)
                    self._config_index.setdefault(sha, rid)
                    for v in _string_values(cfg):
                        if "/" in v or os.sep in v:
                            self.defer(
                                rid, "derived-from",
                                store_path=v, base=str(d),
                            )
            elif et == "resume":
                if ev.get("checkpoint"):
                    self.defer(
                        rid, "resumed-from",
                        path=str(ev["checkpoint"]), base=str(d),
                    )
            elif et == "provenance":
                self._apply_provenance_event(d, rid, ev)
            elif et in ("serve_dict_added", "serve_dict_swapped"):
                gen_counter += 1
                name = ev.get("dict")
                if name is None:
                    continue
                did = f"dict:{self.rel(d)}#{name}"
                self.node(
                    did, "dict", ts=ev.get("ts"),
                    meta={"dict": str(name), "weights": ev.get("weights")},
                )
                if ev.get("source"):
                    self.defer(
                        did, "derived-from",
                        path=str(ev["source"]), base=str(d),
                    )
                if ev.get("manifest_digest"):
                    self.defer(did, "derived-from",
                               digest=ev["manifest_digest"])
                # explicit generation stamp (new events) or the replayed
                # registry counter (legacy events lack the field)
                gen = ev.get("generation")
                gen = gen_counter if gen is None else int(gen)
                gid = f"generation:{self.rel(d)}#{gen}"
                self.node(gid, "registry-generation",
                          meta={"generation": gen})
                self.edge(
                    gid, did,
                    "swapped-in" if et == "serve_dict_swapped"
                    else "derived-from",
                )
                self.edge(rid, gid, "contains")
                current_gid = gid
                self._live_generation[rid] = gid
            elif et == "serve_dict_removed":
                gen_counter += 1
            elif et == "request_trace":
                tid = ev.get("trace_id")
                if not tid:
                    continue
                pid = f"response:{tid}"
                self.node(
                    pid, "traced-response", ts=ev.get("ts_start"),
                    meta={"trace_id": str(tid), "run": rid},
                )
                if ev.get("dict") is not None:
                    self.defer(
                        pid, "derived-from",
                        dict_in_run=(str(d), str(ev["dict"])),
                    )
                if current_gid:
                    self.edge(pid, current_gid, "derived-from")

    def _apply_provenance_event(
        self, d: Path, rid: str, ev: Dict[str, Any]
    ) -> None:
        """Fold one explicit ``provenance`` commit-point event into the
        graph. Schema: ``artifact`` (chunk|checkpoint|export|dict),
        ``path``/``store``+``chunk``/``dict``, optional ``digest``,
        ``config_sha``, and ``inputs`` ([{path|digest|config_sha,
        resumed?}])."""
        art = ev.get("artifact")
        nid: Optional[str] = None
        if art == "chunk":
            store = ev.get("store")
            idx = ev.get("chunk")
            if store is None or idx is None:
                return
            sp = self._resolve_path(str(store), base=d)
            sid = f"store:{self.rel(sp)}"
            self.node(sid, "store", path=sp)
            nid = f"chunk:{self.rel(sp)}#{int(idx)}"
            self.node(nid, "chunk", digest=ev.get("digest"),
                      meta={"store": str(sp), "chunk": int(idx)})
            self.edge(sid, nid, "contains")
            if ev.get("config_sha"):
                self.edge(nid, self._harvest_node(ev["config_sha"]),
                          "derived-from")
        elif art in ("checkpoint", "export"):
            path = ev.get("path")
            if not path:
                return
            p = self._resolve_path(str(path), base=d)
            nid = f"{art}:{self.rel(p)}"
            n = self.node(nid, art, path=p, digest=ev.get("digest"))
            if ev.get("config_sha"):
                n["meta"].setdefault("config_sha", ev["config_sha"])
        elif art == "dict":
            name = ev.get("dict")
            if name is None:
                return
            nid = f"dict:{self.rel(d)}#{name}"
            self.node(nid, "dict", meta={"dict": str(name)})
            if ev.get("path"):
                self.defer(nid, "derived-from",
                           path=str(ev["path"]), base=str(d))
            if ev.get("digest"):
                self.defer(nid, "derived-from", digest=ev["digest"])
        if nid is None:
            return
        self.edge(nid, rid, "derived-from")
        for inp in ev.get("inputs") or []:
            if not isinstance(inp, dict):
                continue
            kind = "resumed-from" if inp.get("resumed") else "derived-from"
            if inp.get("path"):
                hint_kind = (
                    "store_path" if inp.get("kind") == "store" else "path"
                )
                self.defer(nid, kind, base=str(d),
                           **{hint_kind: str(inp["path"])})
            if inp.get("digest"):
                self.defer(nid, kind, digest=inp["digest"])
            if inp.get("config_sha"):
                self.defer(nid, kind, config_sha=inp["config_sha"])

    def _scan_queue(self, d: Path) -> None:
        base = self.rel(d)
        # fleet layout: <fleet>/queue/{pending,leased,done,failed}, runs
        # live beside the queue at <fleet>/runs/<item>/
        runs_root = d.parent / "runs"
        for bucket in ("done", "failed", "leased", "pending"):
            bdir = d / bucket
            if not bdir.is_dir():
                continue
            for p in sorted(bdir.glob("*.json")):
                item = _read_json(p)
                if not isinstance(item, dict) or "item" not in item:
                    continue
                iid = str(item["item"])
                fid = f"fleet-item:{base}#{iid}"
                lineage = item.get("lineage") or []
                last = lineage[-1] if lineage else {}
                self.node(
                    fid, "fleet-item", path=p,
                    meta={
                        "bucket": bucket,
                        "attempts": item.get("attempt"),
                        "outcome": last.get("outcome"),
                    },
                )
                result = item.get("result") or {}
                dig = result.get("export_digest") or last.get("export_digest")
                if dig:
                    self.defer(fid, "derived-from", digest=dig)
                self.defer(fid, "derived-from",
                           run_dir=str(runs_root / iid))
                for entry in lineage:
                    if entry.get("resumed_from"):
                        self.defer(
                            fid, "resumed-from",
                            path=str(runs_root / iid / entry["resumed_from"]),
                        )

    # -- deferred join resolution ----------------------------------------------

    def _resolve_path(self, raw: str, base: Optional[Path] = None) -> Path:
        p = Path(raw)
        if not p.is_absolute() and base is not None:
            cand = (Path(base) / p)
            if cand.exists():
                return cand.resolve()
        if not p.is_absolute() and not p.exists():
            for b in self._bases:
                cand = b / p
                if cand.exists():
                    return cand.resolve()
        try:
            return p.resolve()
        except OSError:
            return p

    def _resolve_hint(self, hint: Dict[str, Any]) -> Optional[str]:
        if "digest" in hint:
            dig = str(hint["digest"])
            nid = self._digest_index.get(dig)
            if nid:
                return nid
            matches = {
                i for full, i in self._digest_index.items()
                if full.startswith(dig)
            }
            return matches.pop() if len(matches) == 1 else None
        if "config_sha" in hint:
            return self._config_index.get(hint["config_sha"])
        if "path" in hint or "store_path" in hint:
            raw = hint.get("path") or hint.get("store_path")
            stores_only = "store_path" in hint
            p = self._resolve_path(str(raw), base=hint.get("base"))
            nid = self._path_index.get(str(p))
            if nid and (
                not stores_only or self.nodes[nid]["type"] == "store"
            ):
                return nid
            return None
        if "run_dir" in hint:
            p = Path(hint["run_dir"])
            try:
                p = p.resolve()
            except OSError:
                return None
            for _ in range(8):
                nid = self._path_index.get(str(p))
                if nid and self.nodes[nid]["type"] == "training-run":
                    return nid
                if p.parent == p:
                    break
                p = p.parent
            return None
        if "dict_in_run" in hint:
            d, name = hint["dict_in_run"]
            nid = f"dict:{self.rel(Path(d))}#{name}"
            return nid if nid in self.nodes else None
        if "latest_ckpt_in" in hint:
            d = str(Path(hint["latest_ckpt_in"]).resolve())
            cands = [
                (n.get("ts") or 0, nid)
                for nid, n in self.nodes.items()
                if n["type"] == "checkpoint"
                and n.get("path", "").startswith(d + os.sep)
            ]
            return max(cands)[1] if cands else None
        return None

    def build(self) -> Graph:
        for src, kind, hint in self._pending:
            if src not in self.nodes:
                continue
            dst = self._resolve_hint(hint)
            if dst and dst != src and dst in self.nodes:
                self.edge(src, dst, kind)
        self._pending = []
        for gid in self._live_generation.values():
            self.nodes[gid]["meta"]["live"] = True
        return Graph(self.nodes, self.edges)


def build_graph(roots: Iterable, verify: str = "off") -> Graph:
    """Build the provenance graph over ``roots`` (any mix of chunk stores,
    run dirs, export dirs, fleet dirs, serve dirs — auto-detected by
    their committed marker files). ``verify`` re-checks manifest-backed
    nodes: "off" (taint detection only), "size", or "digest"."""
    b = GraphBuilder()
    for r in roots:
        b.add_root(r)
    g = b.build()
    if verify != "off":
        verify_graph(g, verify)
    return g


def verify_graph(graph: Graph, tier: str = "digest") -> int:
    """Re-verify every manifest-backed node's recorded files at ``tier``,
    stamping ``node["verify"]``. Returns the failure count. Runs under a
    ``lineage_verify`` badput span and publishes ``lineage.verify.*``
    counters through the broadcast channel (no-ops without an active
    telemetry handle)."""
    if tier not in ("size", "digest"):
        raise ValueError(f"unknown verify tier {tier!r} (size | digest)")
    from sparse_coding__tpu_torch.telemetry.events import counter_inc_active
    from sparse_coding__tpu_torch.telemetry.spans import ACTIVE, span

    checked = failures = 0
    with span(ACTIVE, "lineage_verify", name="sweep", tier=tier):
        for _, n in sorted(graph.nodes.items()):
            files = n.get("files")
            if not files:
                continue
            checked += 1
            ok, reason = _verify_files(files, tier)
            n["verify"] = "ok" if ok else f"FAIL: {reason}"
            if not ok:
                failures += 1
    counter_inc_active("lineage.verify.checked", checked)
    if failures:
        counter_inc_active("lineage.verify.failures", failures)
    return failures


# -- renderers -----------------------------------------------------------------


def _describe(n: Dict[str, Any]) -> str:
    parts = [f"{n['id']}  [{n['type']}]"]
    if n.get("digest"):
        parts.append(f"digest={_short(n['digest'])}")
    if n.get("verify"):
        parts.append(f"verify={n['verify']}")
    if n.get("tainted"):
        parts.append(f"TAINTED ({n.get('taint_reason', '?')})")
    elif n["meta"].get("repaired"):
        parts.append("repaired")
    if n["meta"].get("live"):
        parts.append("LIVE")
    sha = n["meta"].get("config_sha")
    if sha and n["type"] in ("training-run", "harvest-run"):
        parts.append(f"config_sha={sha}")
    git = (n["meta"].get("fingerprint") or {}).get("git_sha")
    if git:
        parts.append(f"git={git}")
    return "  ".join(parts)


def render_explain(graph: Graph, nid: str) -> List[str]:
    """Upstream closure as an indented tree: each line one artifact with
    its digest, re-verification verdict, and taint state; revisited
    nodes collapse to a back-reference so shared inputs render once."""
    lines = [f"# lineage explain — {nid}", ""]
    seen: set = set()

    def walk(cur: str, depth: int, kind: Optional[str]) -> None:
        prefix = "  " * depth + (f"{kind} -> " if kind else "")
        n = graph.nodes[cur]
        if cur in seen:
            lines.append(f"{prefix}{cur}  (see above)")
            return
        seen.add(cur)
        lines.append(prefix + _describe(n))
        for e in graph.out.get(cur, ()):
            if e["dst"] in graph.nodes:
                walk(e["dst"], depth + 1, e["kind"])

    walk(nid, 0, None)
    bad = [
        i for i in [nid] + graph.closure(nid, "up")
        if graph.nodes[i].get("tainted")
        or str(graph.nodes[i].get("verify", "")).startswith("FAIL")
    ]
    lines.append("")
    lines.append(
        f"upstream: {len(graph.closure(nid, 'up'))} artifact(s), "
        f"{len(bad)} failing"
    )
    return lines


def render_blast(graph: Graph, nid: str) -> List[str]:
    """Downstream taint closure, grouped by node type — everything that
    transitively consumed ``nid``. Live serving generations are flagged."""
    n = graph.nodes[nid]
    lines = [f"# lineage blast — {nid}", ""]
    if n.get("tainted"):
        lines.append(f"tainted: {n.get('taint_reason', '?')}")
        lines.append("")
    down = graph.closure(nid, "down")
    by_type: Dict[str, List[str]] = {}
    for i in down:
        by_type.setdefault(graph.nodes[i]["type"], []).append(i)
    for ntype in NODE_TYPES:
        ids = sorted(by_type.get(ntype, []))
        if not ids:
            continue
        lines.append(f"{ntype}:")
        for i in ids:
            mark = "  (LIVE)" if graph.nodes[i]["meta"].get("live") else ""
            lines.append(f"  {i}{mark}")
    lines.append("")
    live = sum(1 for i in down if graph.nodes[i]["meta"].get("live"))
    lines.append(
        f"downstream: {len(down)} artifact(s), "
        f"{live} live serving generation(s)"
    )
    return lines


def render_summary(graph: Graph) -> List[str]:
    """Graph totals + the taint table — the `check` CLI body and the run
    report's Provenance section."""
    counts: Dict[str, int] = {}
    for n in graph.nodes.values():
        counts[n["type"]] = counts.get(n["type"], 0) + 1
    kinds: Dict[str, int] = {}
    for e in graph.edges:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    lines = [
        "nodes: " + ", ".join(
            f"{t}={counts[t]}" for t in NODE_TYPES if t in counts
        ),
        "edges: " + ", ".join(
            f"{k}={kinds[k]}" for k in sorted(kinds)
        ),
    ]
    tainted = graph.tainted()
    if not tainted:
        lines.append("tainted: none")
        return lines
    lines.append(f"tainted: {len(tainted)}")
    for n in tainted:
        down = graph.closure(n["id"], "down")
        live = sum(1 for i in down if graph.nodes[i]["meta"].get("live"))
        lines.append(
            f"  {n['id']} — {n.get('taint_reason', '?')} "
            f"({len(down)} downstream, {live} live)"
        )
    return lines


# -- CLI -----------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.lineage", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name: str, help_: str, target: bool) -> argparse.ArgumentParser:
        p = sub.add_parser(name, help=help_)
        if target:
            p.add_argument(
                "target", help="artifact id, path, digest prefix, or trace id"
            )
        p.add_argument(
            "roots", nargs="+",
            help="artifact roots (stores, run dirs, exports, fleets, serve dirs)",
        )
        p.add_argument(
            "--verify", choices=("off", "size", "digest"),
            default="digest" if name == "explain" else "off",
            help="manifest re-verification tier",
        )
        p.add_argument("--json", action="store_true",
                       help="machine-readable output")
        return p

    add("explain", "upstream closure with digest re-verification", True)
    add("blast", "downstream taint closure", True)
    add("check", "CI gate: exit 1 while any artifact is tainted", False)
    add("graph", "dump the full graph", False)
    args = ap.parse_args(argv)

    try:
        graph = build_graph(args.roots, verify=args.verify)
    except FileNotFoundError as e:
        print(f"no such root: {e}", file=sys.stderr)
        return 3
    if not graph.nodes:
        print(f"no artifacts found under: {', '.join(args.roots)}")
        return 3

    if args.cmd in ("explain", "blast"):
        nid = graph.resolve(args.target)
        if nid is None:
            print(f"artifact {args.target!r} not found "
                  f"(or ambiguous) in the graph")
            return 2
        if args.cmd == "explain":
            up = [nid] + graph.closure(nid, "up")
            bad = any(
                graph.nodes[i].get("tainted")
                or str(graph.nodes[i].get("verify", "")).startswith("FAIL")
                for i in up
            )
            if args.json:
                print(json.dumps(
                    {"target": nid,
                     "upstream": [graph.nodes[i] for i in up]}, indent=1,
                ))
            else:
                print("\n".join(render_explain(graph, nid)))
            return 1 if bad else 0
        down = graph.closure(nid, "down")
        bad = graph.nodes[nid].get("tainted") or any(
            graph.nodes[i].get("tainted") for i in down
        )
        if args.json:
            print(json.dumps(
                {"target": nid,
                 "downstream": [graph.nodes[i] for i in down]}, indent=1,
            ))
        else:
            print("\n".join(render_blast(graph, nid)))
        return 1 if bad else 0

    if args.cmd == "graph":
        if args.json:
            print(json.dumps(graph.to_json(), indent=1))
        else:
            for nid in sorted(graph.nodes):
                print(_describe(graph.nodes[nid]))
            for e in sorted(
                graph.edges, key=lambda e: (e["src"], e["dst"], e["kind"])
            ):
                print(f"{e['src']} --{e['kind']}--> {e['dst']}")
        return 0

    # check
    from sparse_coding__tpu_torch.telemetry.events import gauge_set_active

    tainted = graph.tainted()
    gauge_set_active("lineage.tainted_artifacts", float(len(tainted)))
    if args.json:
        print(json.dumps(
            {"tainted": tainted,
             "nodes": len(graph.nodes), "edges": len(graph.edges)},
            indent=1,
        ))
    else:
        print("\n".join(render_summary(graph)))
    return 1 if tainted else 0


if __name__ == "__main__":
    raise SystemExit(main())
