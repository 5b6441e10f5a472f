"""Remote sync for datasets and sweep outputs, and the shared retry engine.

Counterpart of the JAX package's `utils/sync.py`, copied (stdlib only):

  - one retry engine, `retry_with_backoff` (`SC_SYNC_RETRIES` attempts,
    `SC_SYNC_BACKOFF` base seconds, doubling up to 8 s), which `sync`, the
    chunk store's reads (`data.chunks.ChunkStore.load`) and the serving
    tier's retries (`serve.server.ServeClient`, `serve.router`) all ride;
  - one transfer engine with URL-scheme dispatch: ``host:path`` /
    ``ssh://`` → rsync over ssh, ``gs://`` → ``gsutil -m rsync``, ``s3://``
    → ``aws s3 sync``, plain paths → local rsync (a pure-python mirror when
    rsync is not installed);
  - destinations from arguments or ``SC_TPU_REMOTE``, and the task-level
    wrappers `push_outputs`, `pull_outputs`, `push_dataset`,
    `pull_latest_outputs`.

Pure orchestration: a ``runner`` can be injected (tests stub the
subprocess; no network needed).
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Type

from sparse_coding__tpu_torch.utils import flags

__all__ = ["default_retries", "default_backoff", "backoff_delays", "retry_with_backoff", "sync", "push_outputs",
           "pull_outputs", "push_dataset", "pull_latest_outputs"]

Runner = Callable[[List[str]], "subprocess.CompletedProcess"]

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


class _SyncFailed(Exception):
    """Internal: a transfer tool run returned nonzero (retried)."""

    def __init__(self, result: "subprocess.CompletedProcess"):
        super().__init__(result.stderr)
        self.result = result


def _default_runner(cmd: List[str]) -> "subprocess.CompletedProcess":
    return subprocess.run(cmd, capture_output=True, text=True)


def _is_remote(path: str) -> bool:
    """rsync's own convention, made deterministic: any ``host:rest`` whose
    host part contains no path separator is remote. No filesystem probing —
    the old existence check made the same string mean different things
    depending on what directories happened to exist in cwd (ADVICE r3). A
    local filename containing a colon must be disambiguated the way rsync
    itself requires: prefix it with ``./``."""
    if path.startswith(("gs://", "s3://", "ssh://")):
        return True
    head, sep, _ = path.partition(":")
    return bool(sep) and "/" not in head and "\\" not in head


def _build_command(
    src: str,
    dst: str,
    includes: Optional[Sequence[str]],
    excludes: Optional[Sequence[str]],
    delete: bool,
    ssh_port: int,
) -> List[str]:
    """One transfer command for the scheme pair. Cloud schemes must appear on
    at most one side (gsutil/aws sync between two clouds is out of scope)."""
    cloud = [p for p in (src, dst) if p.startswith(("gs://", "s3://"))]
    if len(cloud) > 1:
        raise ValueError("cloud-to-cloud sync not supported; stage locally")
    if cloud:
        scheme = cloud[0].split("://", 1)[0]
        if scheme == "gs":
            cmd = ["gsutil", "-m", "rsync", "-r"]
            if delete:
                cmd.append("-d")
            if excludes:
                # gsutil takes ONE Python-regex -x (globs are invalid regex,
                # repeated flags override each other): translate and join
                import fnmatch

                cmd += ["-x", "|".join(fnmatch.translate(p) for p in excludes)]
            if includes:
                raise ValueError("gsutil rsync has no include filter; use excludes")
            return cmd + [src, dst]
        cmd = ["aws", "s3", "sync", src, dst]
        if delete:
            cmd.append("--delete")
        if includes:
            # aws filter semantics: later filters win, so the canonical
            # include-list form is exclude-everything THEN re-include
            cmd += ["--exclude", "*"]
            for pat in includes:
                cmd += ["--include", pat]
        else:
            for pat in excludes or ():
                cmd += ["--exclude", pat]
        return cmd
    # rsync (local or over ssh). `ssh://host/path` → host:path
    def rs(p: str) -> str:
        return p.split("://", 1)[1].replace("/", ":", 1) if p.startswith("ssh://") else p

    cmd = ["rsync", "-az", "--partial"]
    if delete:
        cmd.append("--delete")
    if includes:
        # include-list semantics (reference datasets_sync): directories must
        # stay included or rsync never descends to nested matches
        cmd += ["--include", "*/"]
        for pat in includes:
            cmd += ["--include", pat]
        cmd += ["--exclude", "*", "--prune-empty-dirs"]
    else:
        for pat in excludes or ():
            cmd += ["--exclude", pat]
    if _is_remote(src) or _is_remote(dst):
        cmd += ["-e", f"ssh -p {ssh_port}"]
    return cmd + [rs(src), rs(dst)]


def sync(
    src: str,
    dst: str,
    includes: Optional[Sequence[str]] = None,
    excludes: Optional[Sequence[str]] = None,
    delete: bool = False,
    retries: Optional[int] = None,
    ssh_port: int = 22,
    runner: Runner = _default_runner,
) -> "subprocess.CompletedProcess":
    """Sync `src` → `dst` with scheme dispatch and retry/backoff.

    `retries` (total attempts) defaults to `SC_SYNC_RETRIES` (3); the
    backoff base comes from `SC_SYNC_BACKOFF` (1.0 s, doubling per failure,
    capped at 8 s) — the shared `retry_with_backoff` schedule. Raises
    RuntimeError with the tool's stderr after the final failure.
    """
    cmd = _build_command(src, dst, includes, excludes, delete, ssh_port)

    def attempt_once(_attempt: int) -> "subprocess.CompletedProcess":
        try:
            result = runner(cmd)
        except FileNotFoundError:
            # transfer tool not installed. Local↔local still works through a
            # pure-python fallback (minimal images — like TPU-VM containers —
            # often ship no rsync); remote schemes genuinely need the tool.
            if cmd[0] == "rsync" and not (_is_remote(src) or _is_remote(dst)):
                _local_sync(src, dst, includes, excludes, delete)
                return subprocess.CompletedProcess(cmd, 0, "local python fallback", "")
            raise RuntimeError(
                f"`{cmd[0]}` is not installed; install it (or use a local "
                "destination, which falls back to a pure-python copy)"
            ) from None
        if result.returncode != 0:
            raise _SyncFailed(result)
        return result

    attempts = default_retries() if retries is None else max(1, retries)
    try:
        return retry_with_backoff(
            attempt_once, attempts=attempts, retry_on=(_SyncFailed,)
        )
    except _SyncFailed as e:
        raise RuntimeError(
            f"sync failed after {attempts} attempts: {' '.join(cmd)}\n"
            f"{e.result.stderr}"
        ) from None


def _local_sync(src, dst, includes, excludes, delete):
    """Pure-python local mirror honoring the include/exclude semantics."""
    import fnmatch
    import shutil

    src_p, dst_p = Path(src), Path(dst)
    # rsync semantics: `src/` copies contents, `src` copies the folder itself
    if not str(src).endswith("/"):
        dst_p = dst_p / src_p.name
    copied = set()
    for f in src_p.rglob("*"):
        if not f.is_file():
            continue
        rel = f.relative_to(src_p)
        name = f.name
        if includes and not any(fnmatch.fnmatch(name, p) for p in includes):
            continue
        if not includes and any(
            fnmatch.fnmatch(name, p) or fnmatch.fnmatch(str(rel), p)
            for p in excludes or ()
        ):
            continue
        target = dst_p / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, target)
        copied.add(rel)
    if delete and dst_p.exists():
        for f in list(dst_p.rglob("*")):
            if f.is_file() and f.relative_to(dst_p) not in copied:
                f.unlink()


def _remote_base(remote: Optional[str]) -> str:
    remote = remote or flags.SC_TPU_REMOTE.get()
    if not remote:
        raise ValueError(
            "no remote given: pass remote=... or set SC_TPU_REMOTE "
            "(e.g. 'gs://my-bucket/sparse_coding' or 'host:sparse_coding')"
        )
    return remote.rstrip("/")


# -- task-level wrappers (the reference's entry points) ------------------------

def push_outputs(output_folder, remote: Optional[str] = None, **kw):
    """Upload a sweep's output folder (reference `sync` / `upload_outputs`)."""
    base = _remote_base(remote)
    return sync(str(output_folder).rstrip("/"), f"{base}/outputs/", **kw)


def pull_outputs(remote: Optional[str] = None, local="outputs", **kw):
    """Mirror the remote outputs tree locally (reference `autointerp_sync`,
    minus its hardcoded host path)."""
    base = _remote_base(remote)
    return sync(f"{base}/outputs/", str(local), **kw)


def push_dataset(dataset_folder, remote: Optional[str] = None, **kw):
    """Upload an activation-chunk dataset folder (reference `datasets_sync`,
    which only moved csv files; chunk stores move wholesale)."""
    base = _remote_base(remote)
    return sync(str(dataset_folder).rstrip("/"), f"{base}/datasets/", **kw)


def pull_latest_outputs(
    remote: Optional[str] = None,
    local="outputs",
    ssh_port: int = 22,
    runner: Runner = _default_runner,
    **kw,
):
    """Fetch the most recently modified run folder under the remote outputs
    tree (reference `copy_recent`). ssh-remote only — cloud stores list
    differently and their consoles do this better."""
    base = _remote_base(remote)
    if base.startswith(("gs://", "s3://")):
        raise ValueError("pull_latest_outputs supports ssh remotes only")
    host, _, root = base.partition(":")
    probe = runner(
        ["ssh", "-p", str(ssh_port), host, f"ls -td {root}/outputs/*/ | head -1"]
    )
    if probe.returncode != 0 or not probe.stdout.strip():
        raise RuntimeError(f"could not list remote outputs: {probe.stderr}")
    newest = probe.stdout.strip().rstrip("/")
    name = newest.rsplit("/", 1)[-1]
    dest = Path(local) / name
    dest.mkdir(parents=True, exist_ok=True)
    return sync(f"{host}:{newest}/", str(dest), ssh_port=ssh_port, runner=runner, **kw)
