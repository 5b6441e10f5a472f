"""Graceful preemption: signal → flag → checkpoint at a boundary → exit 75.

Counterpart of `sparse_coding__tpu/train/preemption.py` (stdlib only), with
the same contract:

  1. `install_signal_handlers()` (called by `train.loop.DriverCheckpointer`)
     turns SIGTERM/SIGINT into a host-side flag; nothing is interrupted
     mid-step.
  2. Drivers poll the flag at chunk boundaries (`pod_agree_preempt`).
  3. The driver commits a checkpoint and raises `Preempted`, a `SystemExit`
     carrying exit code **75** (``EX_TEMPFAIL``: try again).

A second SIGINT while the flag is set raises `KeyboardInterrupt`.
``SC_PREEMPT=0`` disables installation. Unlike the JAX package, the port
remembers the handlers it replaced: `restore_signal_handlers` puts them
back, and the checkpointer does so when its run ends, so a process that
runs several drivers (a test worker) keeps its own signal disposition.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Optional, Tuple

from sparse_coding__tpu_torch.utils import flags

__all__ = [
    "RESUMABLE_EXIT_CODE", "Preempted", "ResumableAbort", "clear_preemption", "install_signal_handlers",
    "pod_agree_preempt", "poller_started", "poller_stopped", "preemption_requested", "preemption_signal",
    "request_preemption", "reset", "restore_signal_handlers", "resume_requested",
]

RESUMABLE_EXIT_CODE = 75
RESUME_ENV = flags.SC_RESUME.name
DISABLE_ENV = flags.SC_PREEMPT.name


class Preempted(SystemExit):
    """Raised by a driver after its preemption checkpoint is committed: an
    unhandled unwind exits the process with code 75."""

    def __init__(self, message: str = "preempted"):
        super().__init__(RESUMABLE_EXIT_CODE)
        self.message = message

    def __str__(self) -> str:  # SystemExit.__str__ would print "75"
        return self.message


class ResumableAbort(Preempted):
    """A non-signal failure that is safe to retry from the last committed
    checkpoint (an exhausted chunk read, a spent chunk-loss budget). Exit
    code 75, as a preemption."""


_STATE = {"installed": False, "requested": False, "signum": None, "pollers": 0, "previous": {}}


def _handler(signum, frame):
    if _STATE["requested"] and signum == signal.SIGINT:
        raise KeyboardInterrupt
    if _STATE["pollers"] <= 0:
        # no driver polls the flag: behave as the default disposition
        if signum == signal.SIGINT:
            raise KeyboardInterrupt
        raise SystemExit(128 + signum)
    _STATE["requested"] = True
    _STATE["signum"] = signum
    try:
        name = signal.Signals(signum).name
    except ValueError:  # pragma: no cover - unknown signum
        name = str(signum)
    sys.stderr.write(
        f"[preemption] {name} received — will checkpoint at the next boundary and exit 75 "
        "(signal again with SIGINT to abort now)\n"
    )


def install_signal_handlers(signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)) -> bool:
    """Install the preemption handlers (idempotent), remembering the ones they
    replace. True when active; False when skipped (``SC_PREEMPT=0``, not the
    main thread, or an environment that refuses `signal.signal`)."""
    if not flags.SC_PREEMPT.get():
        return False
    if _STATE["installed"]:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    previous = {}
    try:
        for s in signals:
            previous[s] = signal.signal(s, _handler)
    except (ValueError, OSError):  # pragma: no cover - exotic embeddings
        for s, h in previous.items():
            signal.signal(s, h)
        return False
    _STATE["installed"] = True
    _STATE["previous"] = previous
    return True


def restore_signal_handlers() -> None:
    """Put back the handlers `install_signal_handlers` replaced (main thread
    only; elsewhere a no-op)."""
    if not _STATE["installed"] or threading.current_thread() is not threading.main_thread():
        return
    for s, h in _STATE["previous"].items():
        signal.signal(s, h if h is not None else signal.SIG_DFL)
    _STATE["installed"] = False
    _STATE["previous"] = {}


def preemption_requested() -> bool:
    """Has a preemption signal arrived in this process?"""
    return bool(_STATE["requested"])


def preemption_signal() -> Optional[int]:
    """The signum that set the flag (None when not preempted)."""
    return _STATE["signum"]


def request_preemption(signum: Optional[int] = None) -> None:
    """Set the flag programmatically (tests, cluster-notice pollers)."""
    _STATE["requested"] = True
    _STATE["signum"] = signum


def clear_preemption() -> None:
    """Clear a pending request without touching the handlers."""
    _STATE["requested"] = False
    _STATE["signum"] = None


def poller_started() -> None:
    """A boundary poller is live: signals set the flag instead of terminating."""
    _STATE["pollers"] += 1


def poller_stopped() -> None:
    """A poller's run is over; the last one out puts back the handlers."""
    _STATE["pollers"] = max(0, _STATE["pollers"] - 1)
    if _STATE["pollers"] == 0:
        restore_signal_handlers()


def reset() -> None:
    """Clear the flag and the pollers and put back the replaced handlers."""
    restore_signal_handlers()
    _STATE.update(requested=False, signum=None, installed=False, pollers=0, previous={})


def pod_agree_preempt(telemetry=None) -> bool:
    """The pod-wide "checkpoint now?" decision, at lockstep boundaries.

    A world of one: the local flag (no I/O). Several ranks: one exchange of
    the local flags through the process group's store
    (`telemetry.multihost._kv_allgather`); ANY rank flagged → True on EVERY
    rank, so the whole world checkpoints the same cursor and exits 75
    together (a rank that learns it from a peer writes a ``preempt_peer``
    event). When the exchange fails (the coordinator gone, often the
    preemption itself) it falls back to the local flag: better one rank
    checkpointing than none."""
    from sparse_coding__tpu_torch.telemetry.multihost import _kv_allgather, process_info

    local = preemption_requested()
    _, count = process_info()
    if count <= 1:
        return local
    raw = _kv_allgather("preempt", "1" if local else "0")
    if raw is None:
        return local
    agreed = any(v == "1" for v in raw)
    if agreed and not local and telemetry is not None:
        telemetry.event("preempt_peer", flagged=[i for i, v in enumerate(raw) if v == "1"])
    return agreed


def resume_requested(explicit: Optional[bool]) -> bool:
    """An explicit True/False wins; None defers to ``SC_RESUME``."""
    if explicit is not None:
        return bool(explicit)
    return flags.SC_RESUME.get()
