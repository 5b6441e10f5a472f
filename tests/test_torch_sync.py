"""The port's remote sync (`utils/sync.py`) and the chunk store's read
retries, against the JAX package's.

Every case of the JAX package's `tests/test_sync.py`, run on the port's
module through an injected runner (no network); the commands both packages
build for the same arguments compared whole; and `ChunkStore.load` under the
``chunk_read`` fault site: a transient read error retried on the shared
schedule, a schedule that burns out, and a missing chunk that fails at once,
each with the same rows, exception and ``io.*`` counters in both packages.
"""

import fnmatch
import re
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

from sparse_coding__tpu.utils import sync as J
from sparse_coding__tpu_torch.utils import sync as S


class Recorder:
    def __init__(self, fail_times=0, stdout=""):
        self.calls = []
        self.fail_times = fail_times
        self.stdout = stdout

    def __call__(self, cmd):
        self.calls.append(cmd)
        rc = 1 if len(self.calls) <= self.fail_times else 0
        return SimpleNamespace(returncode=rc, stdout=self.stdout, stderr="boom")


# -- JAX's tests/test_sync.py, case for case ----------------------------------------

def test_local_rsync_command():
    r = Recorder()
    S.sync("/a/", "/b", runner=r)
    assert r.calls[0][:3] == ["rsync", "-az", "--partial"]
    assert r.calls[0][-2:] == ["/a/", "/b"]
    assert "-e" not in r.calls[0]


def test_is_remote_deterministic(tmp_path, monkeypatch):
    assert S._is_remote("host:proj")
    assert S._is_remote("user@host:proj")
    assert S._is_remote("gs://bucket/x") and S._is_remote("ssh://pod1/d")
    assert not S._is_remote("./weird:name")
    assert not S._is_remote("/abs/weird:name")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "host").mkdir()
    assert S._is_remote("host:proj")


def test_ssh_rsync_with_port_and_excludes():
    r = Recorder()
    S.sync("/a/", "host:proj", excludes=["*.hdf", ".git"], ssh_port=2222, runner=r)
    cmd = r.calls[0]
    assert ["-e", "ssh -p 2222"] == cmd[-4:-2]
    assert cmd.count("--exclude") == 2


def test_include_list_semantics():
    r = Recorder()
    S.sync("/a/", "host:proj", includes=["*.csv"], runner=r)
    cmd = r.calls[0]
    i = cmd.index("--include")
    assert cmd[i + 1] == "*/" and cmd[i + 2: i + 4] == ["--include", "*.csv"]
    assert ["--exclude", "*", "--prune-empty-dirs"] == cmd[i + 4: i + 7]


def test_ssh_url_scheme_converted():
    r = Recorder()
    S.sync("ssh://pod1/data/", "/local", runner=r)
    assert r.calls[0][-2:] == ["pod1:data/", "/local"]


def test_gcs_and_s3_dispatch():
    r = Recorder()
    S.sync("/a/", "gs://bucket/x", delete=True, excludes=["*.hdf", ".git"], runner=r)
    cmd = r.calls[0]
    assert cmd[:5] == ["gsutil", "-m", "rsync", "-r", "-d"]
    assert cmd.count("-x") == 1
    rx = cmd[cmd.index("-x") + 1]
    assert re.fullmatch(rx, "a.hdf") and re.fullmatch(rx, ".git")
    assert not re.fullmatch(rx, "keep.npy")
    S.sync("s3://bucket/x", "/a", excludes=["*.pkl"], runner=r)
    assert r.calls[1][:4] == ["aws", "s3", "sync", "s3://bucket/x"]
    assert "--exclude" in r.calls[1]
    S.sync("/a/", "s3://bucket/x", includes=["*.csv"], runner=r)
    cmd = r.calls[2]
    assert cmd.index("--exclude") < cmd.index("--include")
    assert cmd[cmd.index("--exclude") + 1] == "*"
    with pytest.raises(ValueError):
        S.sync("gs://a/x", "s3://b/y", runner=r)


def test_retry_then_success_and_failure():
    r = Recorder(fail_times=2)
    S.sync("/a/", "/b", retries=3, runner=r)
    assert len(r.calls) == 3
    r2 = Recorder(fail_times=5)
    with pytest.raises(RuntimeError, match="boom"):
        S.sync("/a/", "/b", retries=2, runner=r2)


def test_backoff_schedule_and_env_config(monkeypatch):
    monkeypatch.setenv(S.RETRIES_ENV, "5")
    monkeypatch.setenv(S.BACKOFF_ENV, "0.5")
    assert S.default_retries() == 5 and S.default_backoff() == 0.5
    assert S.backoff_delays(5, 0.5) == [0.5, 1.0, 2.0, 4.0]
    assert S.backoff_delays(7, 2.0) == [2.0, 4.0, 8.0, 8.0, 8.0, 8.0]
    slept, attempts = [], []

    def fn(attempt):
        attempts.append(attempt)
        raise OSError("transient")

    with pytest.raises(OSError):
        S.retry_with_backoff(fn, sleep=slept.append)
    assert attempts == [0, 1, 2, 3, 4] and slept == [0.5, 1.0, 2.0, 4.0]
    slept.clear()
    monkeypatch.setattr(S.time, "sleep", slept.append)
    r = Recorder(fail_times=99)
    with pytest.raises(RuntimeError, match="after 5 attempts"):
        S.sync("/a/", "/b", runner=r)
    assert len(r.calls) == 5 and slept == [0.5, 1.0, 2.0, 4.0]
    monkeypatch.setenv(S.RETRIES_ENV, "many")
    monkeypatch.setenv(S.BACKOFF_ENV, "soon")
    assert S.default_retries() == 3 and S.default_backoff() == 1.0


def test_retry_with_backoff_on_retry_hook():
    seen = []

    def fn(attempt):
        if attempt < 2:
            raise OSError("flaky")
        return "ok"

    out = S.retry_with_backoff(fn, attempts=4, base_delay=0.0,
                               on_retry=lambda attempt, exc: seen.append((attempt, str(exc))))
    assert out == "ok" and seen == [(0, "flaky"), (1, "flaky")]


def test_task_wrappers_use_env_remote(monkeypatch, tmp_path):
    monkeypatch.setenv("SC_TPU_REMOTE", "gs://bucket/proj/")
    r = Recorder()
    S.push_outputs(tmp_path / "outputs", runner=r)
    assert r.calls[0][-1] == "gs://bucket/proj/outputs/"
    S.push_dataset(tmp_path / "acts", runner=r)
    assert r.calls[1][-1] == "gs://bucket/proj/datasets/"
    S.pull_outputs(runner=r, local=str(tmp_path / "pulled"))
    assert r.calls[2][-2:] == ["gs://bucket/proj/outputs/", str(tmp_path / "pulled")]
    monkeypatch.delenv("SC_TPU_REMOTE")
    with pytest.raises(ValueError, match="SC_TPU_REMOTE"):
        S.push_outputs(tmp_path)


def test_pull_latest_outputs(tmp_path):
    r = Recorder(stdout="proj/outputs/run_42/\n")
    S.pull_latest_outputs(remote="host:proj", local=tmp_path, runner=r)
    assert r.calls[0][0] == "ssh" and "ls -td" in r.calls[0][-1]
    assert r.calls[1][-2] == "host:proj/outputs/run_42/"
    assert str(tmp_path / "run_42") == r.calls[1][-1]
    with pytest.raises(ValueError):
        S.pull_latest_outputs(remote="gs://bucket/x", local=tmp_path, runner=r)
    with pytest.raises(RuntimeError, match="could not list"):
        S.pull_latest_outputs(remote="host:proj", local=tmp_path, runner=Recorder(fail_times=1))


def test_local_python_fallback(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.csv").write_text("1")
    (src / "sub" / "b.csv").write_text("2")
    (src / "c.txt").write_text("3")

    def no_tool(cmd):
        raise FileNotFoundError(cmd[0])

    S.sync(f"{src}/", str(tmp_path / "dst"), includes=["*.csv"], runner=no_tool)
    assert (tmp_path / "dst" / "a.csv").exists()
    assert (tmp_path / "dst" / "sub" / "b.csv").exists()
    assert not (tmp_path / "dst" / "c.txt").exists()
    # without the trailing slash the folder itself lands; excludes and delete hold
    (tmp_path / "dst2" / "src").mkdir(parents=True)
    (tmp_path / "dst2" / "src" / "stale.bin").write_text("x")
    S.sync(str(src), str(tmp_path / "dst2"), excludes=["*.txt"], delete=True, runner=no_tool)
    got = sorted(str(p.relative_to(tmp_path / "dst2")) for p in (tmp_path / "dst2").rglob("*") if p.is_file())
    assert got == ["src/a.csv", "src/sub/b.csv"]
    with pytest.raises(RuntimeError, match="not installed"):
        S.sync(f"{src}/", "host:proj", runner=no_tool)


# -- the two packages side by side ---------------------------------------------------

COMMANDS = [
    ("/a/", "/b", None, None, False, 22),
    ("/a", "/b/", ["*.csv"], None, True, 22),
    ("/a/", "host:proj", None, ["*.hdf", ".git"], False, 2222),
    ("ssh://pod1/data/", "/local", None, ["*.pkl"], True, 22),
    ("user@host:x/", "./weird:name", ["*.npy", "*.json"], None, False, 2200),
    ("/a/", "gs://bucket/x", None, ["*.hdf", ".git"], True, 22),
    ("gs://bucket/x", "/a", None, None, False, 22),
    ("/a/", "s3://bucket/x", ["*.csv"], None, True, 22),
    ("s3://bucket/x", "/a", None, ["*.pkl", "*.npy"], False, 22),
    ("/a/", "gs://bucket/x", ["*.csv"], None, False, 22),
    ("gs://a/x", "s3://b/y", None, None, False, 22),
]


@pytest.mark.parametrize("args", COMMANDS, ids=[f"{a[0]}->{a[1]}" for a in COMMANDS])
def test_commands_match_the_jax_package(args):
    def build(mod):
        try:
            return mod._build_command(*args)
        except ValueError as e:
            return ("ValueError", str(e))

    assert build(S) == build(J)
    for p in args[:2]:
        assert S._is_remote(p) == J._is_remote(p)


def test_wrappers_and_fallback_match_the_jax_package(tmp_path, monkeypatch):
    """The wrappers' commands under ``SC_TPU_REMOTE`` (one environment drives
    either package) and the python fallback's copied tree."""
    from sparse_coding__tpu.utils import flags as jflags
    from sparse_coding__tpu_torch.utils import flags

    assert flags.SC_TPU_REMOTE.name == jflags.SC_TPU_REMOTE.name == "SC_TPU_REMOTE"
    for remote in ("gs://bucket/proj/", "host:proj", "s3://b/p"):
        monkeypatch.setenv("SC_TPU_REMOTE", remote)
        rs, rj = Recorder(), Recorder()
        for fn, arg in (("push_outputs", tmp_path / "out"), ("push_dataset", tmp_path / "acts")):
            getattr(S, fn)(arg, runner=rs)
            getattr(J, fn)(arg, runner=rj)
        S.pull_outputs(local=str(tmp_path / "o"), runner=rs)
        J.pull_outputs(local=str(tmp_path / "o"), runner=rj)
        assert rs.calls == rj.calls
    src = tmp_path / "src"
    (src / "d").mkdir(parents=True)
    for name in ("a.csv", "d/b.csv", "d/c.txt", "e.npy"):
        (src / name).write_text(name)

    def no_tool(cmd):
        raise FileNotFoundError(cmd[0])

    trees = []
    for mod, dst in ((S, tmp_path / "port"), (J, tmp_path / "jax")):
        mod.sync(str(src), str(dst), excludes=["*.txt"], runner=no_tool)
        trees.append(sorted(str(p.relative_to(dst)) for p in dst.rglob("*") if p.is_file()))
    assert trees[0] == trees[1] == ["src/a.csv", "src/d/b.csv", "src/e.npy"]


def test_sync_runs_the_real_local_tool_or_the_fallback(tmp_path):
    """The default runner on a local pair: rsync when installed, else the
    python mirror; either way the files land."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "x.bin").write_bytes(b"abc")
    out = S.sync(f"{src}/", str(tmp_path / "dst"))
    assert isinstance(out, subprocess.CompletedProcess) and out.returncode == 0
    assert (tmp_path / "dst" / "x.bin").read_bytes() == b"abc"


# -- ChunkStore.load: the chunk_read fault site and the read retries ----------------

@pytest.fixture
def fault_env(monkeypatch):
    from sparse_coding__tpu.utils import faults as jfaults
    from sparse_coding__tpu_torch.utils import faults

    monkeypatch.setenv("SC_SYNC_BACKOFF", "0")
    monkeypatch.setenv("SC_SYNC_RETRIES", "3")

    def set_fault(spec):
        if spec is None:
            monkeypatch.delenv("SC_FAULT", raising=False)
        else:
            monkeypatch.setenv("SC_FAULT", spec)
        faults.reset()
        jfaults.reset()

    yield set_fault
    faults.reset()
    jfaults.reset()


def _store(folder, dtype=np.float16):
    from sparse_coding__tpu_torch.data.chunks import save_chunk

    rng = np.random.default_rng(0)
    for i in range(2):
        save_chunk(folder, i, rng.normal(size=(64, 16)).astype(np.float32), dtype=dtype)
    return folder


def _load_both(folder, i, set_fault, spec, **kw):
    """(rows or the exception's type, counters) from each package's load of
    chunk ``i`` under ``spec``, each under a live telemetry of its own."""
    from sparse_coding__tpu.data.chunks import ChunkStore as JStore
    from sparse_coding__tpu.telemetry import RunTelemetry as JTel
    from sparse_coding__tpu_torch.data.chunks import ChunkStore
    from sparse_coding__tpu_torch.telemetry import RunTelemetry

    out = {}
    for tag, store, tel_cls, host in (
            ("jax", JStore(folder), JTel, np.asarray),
            ("port", ChunkStore(folder), RunTelemetry, lambda t: t.numpy())):
        set_fault(spec)
        tel = tel_cls(out_dir=None, run_name=f"read_{tag}")
        try:
            try:
                rows = host(store.load(i, device="cpu", **kw) if tag == "port" else store.load(i, **kw))
            except OSError as e:
                rows = type(e)
            counters = {k: v for k, v in tel.counters.items() if k.startswith(("io.", "data."))}
        finally:
            tel.close()
        out[tag] = (rows, counters)
    return out


@pytest.mark.parametrize("tier", ["float16", "int8"])
def test_chunk_read_transient_error_is_retried_as_in_the_jax_package(tmp_path, fault_env, tier):
    folder = _store(tmp_path / "store", dtype=np.float16 if tier == "float16" else np.int8)
    got = _load_both(folder, 0, fault_env, "io_error:chunk=0")
    (jrows, jc), (trows, tc) = got["jax"], got["port"]
    assert isinstance(trows, np.ndarray) and trows.dtype == np.float32 and trows.shape == (64, 16)
    assert np.array_equal(trows, jrows)
    assert tc == jc and tc["io.retry"] == 1 and "io.exhausted" not in tc
    # the selector names chunk 0: chunk 1 reads at once
    got = _load_both(folder, 1, fault_env, "io_error:chunk=0")
    assert np.array_equal(got["port"][0], got["jax"][0]) and "io.retry" not in got["port"][1]


def test_chunk_read_exhausted_schedule_raises_as_in_the_jax_package(tmp_path, fault_env):
    folder = _store(tmp_path / "store")
    got = _load_both(folder, 0, fault_env, "io_error:chunk=0:persist=1")
    assert got["port"][0] is OSError and got["jax"][0] is OSError
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1]["io.exhausted"] == 1 and got["port"][1]["io.retry"] == 2  # 3 attempts


def test_missing_chunk_fails_at_once_as_in_the_jax_package(tmp_path, fault_env):
    folder = _store(tmp_path / "store")
    got = _load_both(folder, 5, fault_env, "io_error:chunk_read:persist=1")
    assert got["port"][0] is FileNotFoundError and got["jax"][0] is FileNotFoundError
    assert got["port"][1] == got["jax"][1] and "io.retry" not in got["port"][1]
    # a committed chunk whose file vanished, read without verification: the
    # read itself meets FileNotFoundError, a permanent error, never retried
    (folder / "1.npy").unlink()
    got = _load_both(folder, 1, fault_env, None, verify="off")
    assert got["port"][0] is FileNotFoundError and got["jax"][0] is FileNotFoundError
    assert got["port"][1] == got["jax"][1] and "io.retry" not in got["port"][1]


def test_driver_rides_out_a_transient_read(tmp_path, fault_env):
    """The port's `basic_l1_sweep` under a transient chunk-read error: the
    run finishes (before, the single read raised and the driver exited 75)
    and its events count the retry."""
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep

    folder = _store(tmp_path / "store")
    fault_env("io_error:chunk_read:times=1")
    basic_l1_sweep(str(folder), str(tmp_path / "out"), activation_width=16, l1_values=[1e-3], dict_ratio=2.0,
                   batch_size=64, fista_iters=2, device="cpu")
    events = read_events(tmp_path / "out" / "events.jsonl")
    assert [e["status"] for e in events if e["event"] == "run_end"] == ["ok"]
    assert [e for e in events if e["event"] == "snapshot"][-1]["counters"]["io.retry"] == 1
