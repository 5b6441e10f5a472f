"""The ``SC_*`` environment flags the port reads.

Counterpart of `sparse_coding__tpu/utils/flags.py`, cut to the flags the port
uses; each keeps the JAX package's name, default, kind and parse, because the
same environment drives runs of either package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple

# spellings that turn a default-on / truthy flag off
_FALSY = ("", "0", "false", "off")


@dataclasses.dataclass(frozen=True)
class Flag:
    """One declared ``SC_*`` env flag. ``kind`` picks the parse ``get()``
    applies: ``str`` (raw string, default applied, never None), ``opt_str``
    (raw string or None), ``float``, ``bool01`` (True iff exactly ``"1"``),
    ``int``, ``truthy`` (True iff set outside ``("", "0", "false", "off")``) or
    ``onoff`` (default on: False iff one of ``("0", "false", "off")``)."""

    name: str
    kind: str
    default: Optional[str]
    owner: str
    help: str
    choices: Tuple[str, ...] = ()

    def raw(self, env: Optional[Mapping[str, str]] = None) -> Optional[str]:
        """The unparsed env value, or None when unset (no default applied)."""
        return (os.environ if env is None else env).get(self.name)

    def get(self, env: Optional[Mapping[str, str]] = None):
        raw = self.raw(env)
        if raw is None:
            raw = self.default
        if self.kind == "opt_str":
            return raw
        if self.kind == "str":
            return raw if raw is not None else ""
        if self.kind == "float":
            return None if raw is None else float(raw)
        if self.kind == "int":
            return None if raw is None else int(raw)
        if self.kind == "bool01":
            return raw == "1"
        if self.kind == "truthy":
            return (raw or "").lower() not in _FALSY
        if self.kind == "onoff":
            return (raw or "").lower() not in ("0", "false", "off")
        raise ValueError(f"unknown flag kind {self.kind!r} for {self.name}")


FLAGS: Dict[str, Flag] = {
    f.name: f
    for f in (
        Flag("SC_RECOMPUTE_CODE", "bool01", "0", "ops.tied_sae_kernel",
             "Fused tied-SAE bwd rebuilds the code tile instead of storing it."),
        Flag("SC_PREEMPT", "onoff", "1", "train.preemption",
             "Default-on switch for SIGTERM/SIGINT preemption handling."),
        Flag("SC_RESUME", "truthy", "", "train.preemption",
             "Drivers resume from the latest checkpoint instead of starting fresh."),
        Flag("SC_CKPT_VERIFY", "str", "digest", "train.checkpoint",
             "Checkpoint verification depth.", ("digest", "size", "off")),
        Flag("SC_CHUNK_VERIFY", "str", "size", "data.integrity",
             "Read-side chunk verification depth.", ("digest", "size", "off")),
        Flag("SC_CHUNK_LOSS_BUDGET", "float", None, "data.integrity",
             "Max fraction of a store's chunks that may be quarantined (unset = 0.05)."),
        Flag("SC_FAULT", "opt_str", None, "utils.faults",
             "Fault-injection spec 'action[:site][:key=val...]' (utils.faults)."),
        Flag("SC_COST_CAPTURE", "str", "1", "telemetry.profiling",
             "Per-capture cost depth: 0/false/no/off disables, full/2/memory adds the step "
             "graph pool's bytes, anything else = the analytic FLOPs and bytes only.",
             ("0", "1", "full")),
        Flag("SC_TRACE_WINDOW", "opt_str", None, "telemetry.profiling",
             "start:stop step window for a triggered torch.profiler trace (TraceTrigger.from_env)."),
        Flag("SC_TRACE_DIR", "opt_str", None, "telemetry.profiling",
             "Directory a triggered trace capture writes into (default: the run's output dir)."),
        Flag("SC_TPU_REMOTE", "str", "", "utils.sync",
             "host:dir (or gs:// / s3://) target of the remote sync helpers; empty = none given."),
        Flag("SC_SYNC_RETRIES", "int", "3", "utils.sync",
             "Attempts of the shared retry engine (clamped to >= 1 at the call site)."),
        Flag("SC_SYNC_BACKOFF", "float", "1.0", "utils.sync",
             "Base seconds of its exponential backoff (clamped to >= 0 at the call site)."),
        Flag("SC_MH_TIMEOUT_MS", "int", "60000", "telemetry.multihost",
             "Pod telemetry KV-store exchange timeout in milliseconds (the checkpoint and dataset "
             "barriers wait the process group's own timeout)."),
        Flag("SC_CLOCK_RESYNC_EVERY", "int", None, "telemetry.multihost",
             "Override the heartbeat count between cross-host clock-offset "
             "resyncs (unset = the caller's configured cadence)."),
        Flag("SC_TEST_CHUNK_SLEEP", "float", "0", "tests._torch_mp_worker",
             "Test-only: seconds this host sleeps inside each chunk, to "
             "fake a straggler in multi-process tests."),
        Flag("SC_TEST_DESYNC", "truthy", "", "tests._torch_mp_worker",
             "Test-only: poison this host's run config with its process "
             "id to exercise pod desync detection."),
    )
}

SC_RECOMPUTE_CODE = FLAGS["SC_RECOMPUTE_CODE"]
SC_PREEMPT = FLAGS["SC_PREEMPT"]
SC_RESUME = FLAGS["SC_RESUME"]
SC_CKPT_VERIFY = FLAGS["SC_CKPT_VERIFY"]
SC_CHUNK_VERIFY = FLAGS["SC_CHUNK_VERIFY"]
SC_CHUNK_LOSS_BUDGET = FLAGS["SC_CHUNK_LOSS_BUDGET"]
SC_FAULT = FLAGS["SC_FAULT"]
SC_COST_CAPTURE = FLAGS["SC_COST_CAPTURE"]
SC_TRACE_WINDOW = FLAGS["SC_TRACE_WINDOW"]
SC_TRACE_DIR = FLAGS["SC_TRACE_DIR"]
SC_TPU_REMOTE = FLAGS["SC_TPU_REMOTE"]
SC_SYNC_RETRIES = FLAGS["SC_SYNC_RETRIES"]
SC_SYNC_BACKOFF = FLAGS["SC_SYNC_BACKOFF"]
SC_MH_TIMEOUT_MS = FLAGS["SC_MH_TIMEOUT_MS"]
SC_CLOCK_RESYNC_EVERY = FLAGS["SC_CLOCK_RESYNC_EVERY"]
SC_TEST_CHUNK_SLEEP = FLAGS["SC_TEST_CHUNK_SLEEP"]
SC_TEST_DESYNC = FLAGS["SC_TEST_DESYNC"]


def recompute_code() -> bool:
    """``SC_RECOMPUTE_CODE``: the fused tied-SAE step rebuilds each code tile
    in the backward instead of storing the [M, B, N] code tensor. On only for
    the literal ``"1"`` (default ``"0"``). Read when an ensemble is built."""
    return SC_RECOMPUTE_CODE.get()
