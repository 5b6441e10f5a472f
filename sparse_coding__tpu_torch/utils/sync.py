"""The shared retry-with-backoff engine.

Counterpart of the retry half of the JAX package's `utils/sync.py`: the
schedule (`SC_SYNC_RETRIES` attempts, `SC_SYNC_BACKOFF` base seconds,
doubling up to 8 s) that `serve.server.ServeClient` rides for its retryable
503s. The remote-sync half (`sync`, rsync / gsutil / aws over URL schemes)
is not ported yet (ROADMAP A9) and raises.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple, Type

from sparse_coding__tpu_torch.utils import flags

__all__ = ["default_retries", "default_backoff", "backoff_delays", "retry_with_backoff", "sync"]

RETRIES_ENV = flags.SC_SYNC_RETRIES.name
BACKOFF_ENV = flags.SC_SYNC_BACKOFF.name
_DEFAULT_RETRIES = 3
_DEFAULT_BACKOFF = 1.0
_MAX_DELAY = 8.0


def default_retries() -> int:
    """Total attempts (not re-tries) per operation: `SC_SYNC_RETRIES`, else 3."""
    try:
        return max(1, flags.SC_SYNC_RETRIES.get())
    except ValueError:
        return _DEFAULT_RETRIES


def default_backoff() -> float:
    """Base delay (seconds) of the exponential backoff: `SC_SYNC_BACKOFF`,
    else 1.0. The k-th failure sleeps ``min(base * 2**k, 8.0)``."""
    try:
        return max(0.0, flags.SC_SYNC_BACKOFF.get())
    except ValueError:
        return _DEFAULT_BACKOFF


def backoff_delays(attempts: int, base_delay: float, max_delay: float = _MAX_DELAY) -> List[float]:
    """The sleeps between attempts: ``attempts - 1`` exponentially growing
    delays capped at ``max_delay`` (the last attempt never sleeps)."""
    return [min(base_delay * (2 ** k), max_delay) for k in range(max(0, attempts - 1))]


def retry_with_backoff(
    fn: Callable[[int], object],
    *,
    attempts: Optional[int] = None,
    base_delay: Optional[float] = None,
    max_delay: float = _MAX_DELAY,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    give_up_on: Tuple[Type[BaseException], ...] = (),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Optional[Callable[[float], None]] = None,
    delay_floor_from: Optional[Callable[[BaseException], float]] = None,
):
    """Call ``fn(attempt)`` until it returns, retrying ``retry_on`` exceptions
    with exponential backoff; ``give_up_on`` re-raises at once. ``on_retry
    (attempt, exc)`` fires before each sleep; ``delay_floor_from(exc)`` raises
    a sleep to a per-failure minimum (a server's ``Retry-After``). The final
    failure re-raises."""
    attempts = default_retries() if attempts is None else max(1, attempts)
    base = default_backoff() if base_delay is None else base_delay
    delays = backoff_delays(attempts, base, max_delay)
    if sleep is None:
        sleep = time.sleep  # bound at call time (tests monkeypatch the module)
    for attempt in range(attempts):
        try:
            return fn(attempt)
        except retry_on as e:
            if give_up_on and isinstance(e, give_up_on):
                raise
            if attempt >= attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = delays[attempt]
            if delay_floor_from is not None:
                try:
                    delay = max(delay, float(delay_floor_from(e) or 0.0))
                except (TypeError, ValueError):
                    pass
            if delay > 0:
                sleep(delay)


def sync(*_a, **_k):
    """The remote sync engine: not ported yet."""
    raise NotImplementedError("remote `sync()` (rsync / gsutil / aws) is not ported yet — ROADMAP A9")
