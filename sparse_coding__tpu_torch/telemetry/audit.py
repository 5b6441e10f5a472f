"""Transfer audit: make "the hot loop does no device-to-host sync" testable.

Counterpart of `sparse_coding__tpu/telemetry/audit.py`. Between
`MetricLogger` flushes the training loop keeps its losses on the device and
syncs once per flush window; `transfer_audit()` turns that claim into a
check:

    with transfer_audit():
        ensemble_train_loop(ens, chunk, ..., logger=logger)

Two layers, because they cover different devices:

  1. On CUDA the block runs under ``torch.cuda.set_sync_debug_mode("error")``:
     every operation that makes the host wait for the card raises — the
     explicit pulls, and the implicit syncs as well (``nonzero``, masked
     indexing, a blocking copy from pageable host memory, a host read of a
     device counter). The mode in force before the block is restored after
     it.
  2. On every device, a Python interposer on ``torch.Tensor``'s explicit
     host pulls (``item``, ``tolist``, ``cpu``, ``numpy``, ``__float__``),
     installed only while an audit is active, raises `TransferViolation`
     inside the audited thread — also on the CPU, where nothing syncs and
     layer 1 sees nothing.

Sanctioned sync points mark themselves with `allowed_transfer()`:
`MetricLogger.flush` (one batched copy per window), `StepTimer.report`'s
fence and the train loop's once-a-chunk dead-ensemble probe. On CUDA an
allowed block sets the sync-debug mode to its default while it runs and
puts ``"error"`` back after. The mode is process-wide: while an audit is
open it also trips on other threads' syncs, and while an allowed block runs
it sees no thread's syncs. So the CUDA layer covers the audited thread only
outside allowed blocks; the interposer (layer 2) stays per thread.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["transfer_audit", "allowed_transfer", "TransferViolation"]

_PULLS = ("item", "tolist", "cpu", "numpy", "__float__")


class TransferViolation(RuntimeError):
    """An unsanctioned device-to-host transfer inside a `transfer_audit` block."""


_STATE = threading.local()  # .audit_depth / .allow_depth per thread
_LOCK = threading.Lock()
_PATCH_COUNT = 0
_ORIG = {}
_CUDA = {"audits": 0, "allows": 0, "before": None}


def _depth(name: str) -> int:
    return getattr(_STATE, name, 0)


def _bump(name: str, d: int):
    setattr(_STATE, name, _depth(name) + d)


def _audited(name, orig):
    def pull(self, *args, **kwargs):
        if _depth("audit_depth") > 0 and _depth("allow_depth") == 0:
            raise TransferViolation(
                f"explicit device-to-host transfer (Tensor.{name}) inside a transfer_audit block — "
                "wrap sanctioned sync points in telemetry.audit.allowed_transfer"
            )
        return orig(self, *args, **kwargs)

    pull.__name__ = name
    pull.__doc__ = getattr(orig, "__doc__", None)
    return pull


def _install_interposer():
    """Wrap the explicit pulls (refcounted across nested and concurrent
    audits); they delegate untouched outside audits and allowed blocks."""
    global _PATCH_COUNT
    with _LOCK:
        _PATCH_COUNT += 1
        if _PATCH_COUNT > 1:
            return
        for name in _PULLS:
            # (the Tensor class's own attribute, or None when it is inherited)
            _ORIG[name] = (torch.Tensor.__dict__.get(name), getattr(torch.Tensor, name))
            setattr(torch.Tensor, name, _audited(name, _ORIG[name][1]))


def _remove_interposer():
    global _PATCH_COUNT
    with _LOCK:
        _PATCH_COUNT -= 1
        if _PATCH_COUNT > 0:
            return
        for name, (own, _) in _ORIG.items():
            if own is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, own)
        _ORIG.clear()


def _cuda_enter_audit():
    with _LOCK:
        if not torch.cuda.is_available():
            return
        _CUDA["audits"] += 1
        if _CUDA["audits"] == 1:
            _CUDA["before"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")


def _cuda_exit_audit():
    with _LOCK:
        if not torch.cuda.is_available() or _CUDA["audits"] == 0:
            return
        _CUDA["audits"] -= 1
        if _CUDA["audits"] == 0:
            torch.cuda.set_sync_debug_mode(_CUDA["before"] or 0)
            _CUDA["before"] = None


def _cuda_allow(d: int):
    with _LOCK:
        if _CUDA["audits"] == 0:
            return
        _CUDA["allows"] += d
        torch.cuda.set_sync_debug_mode(0 if _CUDA["allows"] > 0 else "error")


@contextlib.contextmanager
def allowed_transfer():
    """Mark a sanctioned host-sync point (flush boundaries, fences, probes):
    transfers inside this context are exempt from any enclosing audit."""
    _bump("allow_depth", 1)
    _cuda_allow(1)
    try:
        yield
    finally:
        _cuda_allow(-1)
        _bump("allow_depth", -1)


def _is_sync_trip(e: BaseException) -> bool:
    """torch's sync-debug error: "called a synchronizing CUDA operation"."""
    msg = str(e).lower()
    return isinstance(e, RuntimeError) and "synchronizing cuda operation" in msg


@contextlib.contextmanager
def transfer_audit(telemetry=None):
    """Disallow device-to-host syncs (explicit ones included) in the block.

    On a violation: an ``anomaly`` event (kind ``transfer_guard``) to
    ``telemetry`` when given, then `TransferViolation` (the stack trace
    points at the offending transfer). A blocking host-to-device copy is
    a sync too under the CUDA layer. The CUDA layer is process-wide: it
    covers the audited thread only outside `allowed_transfer` blocks (other
    threads' syncs go unseen while one runs, and trip it otherwise)."""
    _install_interposer()
    _cuda_enter_audit()
    _bump("audit_depth", 1)
    try:
        yield
    except Exception as e:
        if not (isinstance(e, TransferViolation) or _is_sync_trip(e)):
            raise  # not a guard trip: propagate untouched
        msg = str(e)
        if telemetry is not None:
            try:
                telemetry.anomaly("transfer_guard", error=msg[:500])
            except Exception:
                pass
        if isinstance(e, TransferViolation):
            raise
        raise TransferViolation(
            "device-to-host sync inside an audited hot-loop section "
            "(wrap sanctioned sync points in telemetry.audit.allowed_transfer): " + msg
        ) from e
    finally:
        _bump("audit_depth", -1)
        _cuda_exit_audit()
        _remove_interposer()
