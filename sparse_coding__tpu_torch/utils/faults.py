"""Deterministic fault injection (``SC_FAULT``) for the recovery tests.

A copy of `sparse_coding__tpu/utils/faults.py` (stdlib only), with the same
grammar, so one ``SC_FAULT`` value means the same thing to a run of either
package::

    SC_FAULT = spec[;spec...]
    spec     = action[:site][:key=value ...]

Actions: ``kill`` (SIGKILL at the site), ``sigterm`` / ``sigint`` (deliver
the signal: the preemption path, exit 75 at the next boundary),
``io_error`` (raise OSError; attempt 0 only unless ``persist=1``), ``exc``
(raise `InjectedFault`), ``torn_checkpoint`` (InjectedFault between the
checkpoint's data write and its commit rename), ``corrupt_checkpoint``
(flip a byte of the just-committed checkpoint's largest file),
``torn_chunk_pair`` (InjectedFault at ``chunk_pair``: the chunk write dies
with its pair torn) and ``corrupt_chunk`` (at ``chunk_committed``: flip the
last byte of the just-committed chunk file, bit rot a digest catches).

Sites the port plants: ``chunk_loop`` (top of each sweep chunk: chunk),
``step_loop`` (top of each big-batch step: step),
``checkpoint_commit`` (data written, not committed: path),
``checkpoint_committed`` (after the commit: path), ``export`` (top of
`save_learned_dicts`: path), in `data.chunks.save_chunk`
``chunk_write`` (data staged, nothing landed: chunk), ``chunk_pair``
(between the pair's file operations: chunk) and ``chunk_committed`` (after
the chunk's manifest commit: chunk, path), in `data.chunks.ChunkStore.load`
``chunk_read`` (each read attempt: chunk, attempt), ``serve_loop`` (each tick of the
serve server's drain-wait loop: tick; ``kill:serve_loop:tick=40`` SIGKILLs
a serve replica mid-flight) and ``router_forward`` (in `serve.router` just
before a forward: replica; ``io_error`` there is a transport failure the
router retries on another replica).

Selectors: ``chunk=N`` / ``step=N`` / ``epoch=N`` / ``tick=N`` /
``replica=ID`` match the context; ``every=N`` fires on every Nth matching
hit; ``times=N`` caps the fires (torn/corrupt default to 1). With no site,
``kill:chunk=3`` means ``chunk_loop``. Unset ``SC_FAULT`` costs one dict
lookup per site.
"""

from __future__ import annotations

import os
import signal
from pathlib import Path
from typing import Any, Dict, List, Optional

from sparse_coding__tpu_torch.utils import flags

__all__ = ["FAULT_ENV", "InjectedFault", "fault_point", "parse_faults", "reset"]

FAULT_ENV = flags.SC_FAULT.name

_ACTIONS = (
    "kill", "sigterm", "sigint", "io_error", "exc",
    "torn_checkpoint", "corrupt_checkpoint", "torn_chunk_pair", "corrupt_chunk",
)
_ONCE = ("torn_checkpoint", "corrupt_checkpoint", "torn_chunk_pair", "corrupt_chunk")
_SITE_ALIASES = {"chunks": "chunk_read", "chunk": "chunk_loop", "checkpoint": "checkpoint_commit",
                 "export": "export"}
_DEFAULT_SITE = {
    "io_error": "chunk_read",
    "torn_checkpoint": "checkpoint_commit",
    "corrupt_checkpoint": "checkpoint_committed",
    "torn_chunk_pair": "chunk_pair",
    "corrupt_chunk": "chunk_committed",
}


class InjectedFault(RuntimeError):
    """An intentionally planted failure (``SC_FAULT`` exc/torn_*)."""


class _Spec:
    __slots__ = ("action", "site", "params", "hits", "fires", "max_fires")

    def __init__(self, action: str, site: Optional[str], params: Dict[str, Any]):
        self.action, self.site, self.params = action, site, params
        self.hits = self.fires = 0
        self.max_fires = params.get("times", 1 if action in _ONCE else None)


def parse_faults(text: str) -> List[_Spec]:
    """Parse an ``SC_FAULT`` value; an unknown action raises ValueError."""
    specs: List[_Spec] = []
    for raw in text.replace(",", ";").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        fields = raw.split(":")
        action = fields[0].strip()
        if action not in _ACTIONS:
            raise ValueError(f"unknown {FAULT_ENV} action {action!r} in {raw!r} (known: {', '.join(_ACTIONS)})")
        site: Optional[str] = None
        params: Dict[str, Any] = {}
        for field in fields[1:]:
            field = field.strip()
            if not field:
                continue
            if "=" in field:
                k, _, v = field.partition("=")
                try:
                    params[k.strip()] = int(v)
                except ValueError:
                    params[k.strip()] = v.strip()
            else:
                site = _SITE_ALIASES.get(field, field)
        if site is None:
            site = _DEFAULT_SITE.get(action)
            if site is None and any(k in params for k in ("chunk", "epoch")):
                site = "chunk_loop"
            elif site is None and "step" in params:
                site = "step_loop"
            elif site is None and "tick" in params:
                site = "serve_loop"
        if site is None:
            raise ValueError(f"{FAULT_ENV} spec {raw!r} names no site and none can be inferred")
        specs.append(_Spec(action, site, params))
    return specs


# parsed specs keyed by the env string; a changed SC_FAULT resets the counters
_CACHE: Dict[str, Any] = {"env": None, "specs": []}


def reset() -> None:
    """Drop parsed specs and fire counters."""
    _CACHE["env"] = None
    _CACHE["specs"] = []


def _fire(spec: _Spec, site: str, ctx: Dict[str, Any]) -> None:
    spec.fires += 1
    desc = f"SC_FAULT {spec.action} at {site} {ctx or ''}".strip()
    if spec.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif spec.action == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
    elif spec.action == "sigint":
        os.kill(os.getpid(), signal.SIGINT)
    elif spec.action == "io_error":
        raise OSError(desc)
    elif spec.action == "corrupt_checkpoint":
        if "path" in ctx:  # the first byte of the largest data file
            files = sorted((p for p in Path(ctx["path"]).rglob("*") if p.is_file() and p.name != "sc_manifest.json"),
                           key=lambda p: (-p.stat().st_size, str(p)))
            if files:
                data = bytearray(files[0].read_bytes())
                data[0] ^= 0xFF
                files[0].write_bytes(bytes(data))
    elif spec.action == "corrupt_chunk":
        if "path" in ctx:  # the last byte: array data, not the .npy header
            data = bytearray(Path(ctx["path"]).read_bytes())
            if data:
                data[-1] ^= 0xFF
                Path(ctx["path"]).write_bytes(bytes(data))
    else:  # exc / torn_checkpoint / torn_chunk_pair
        raise InjectedFault(desc)


def fault_point(site: str, **ctx) -> None:
    """A named fault site: a no-op unless ``SC_FAULT`` selects it."""
    env = flags.SC_FAULT.raw()
    if not env:
        return
    if env != _CACHE["env"]:
        _CACHE["env"] = env
        _CACHE["specs"] = parse_faults(env)
    for spec in _CACHE["specs"]:
        if spec.site != site:
            continue
        if spec.max_fires is not None and spec.fires >= spec.max_fires:
            continue
        if any(k in spec.params and ctx.get(k) != spec.params[k] for k in ("chunk", "step", "epoch", "tick", "replica")):
            continue
        if ctx.get("attempt", 0) != 0 and not spec.params.get("persist"):
            continue
        spec.hits += 1
        every = spec.params.get("every")
        if every and spec.hits % int(every) != 0:
            continue
        _fire(spec, site, ctx)
