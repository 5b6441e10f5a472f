"""A stand-in for the port's profiler window (`utils.trace.start_trace_safe`
/ `stop_trace_safe`) in CPU tests: it records the calls and keeps the
one-window-at-a-time rule, without starting torch.profiler."""

import importlib


def stub_profiler(monkeypatch):
    """Patch the port's window pair; returns the record ``{"started": [dirs],
    "stopped": n, "active": dir or None}``."""
    calls = {"started": [], "stopped": 0, "active": None}

    def start(log_dir, create_perfetto_link=False):
        if calls["active"] is not None:
            return False
        calls["active"] = log_dir
        calls["started"].append(log_dir)
        return True

    def stop():
        d, calls["active"] = calls["active"], None
        if d is not None:
            calls["stopped"] += 1
        return d

    trace_mod = importlib.import_module("sparse_coding__tpu_torch.utils.trace")
    monkeypatch.setattr(trace_mod, "start_trace_safe", start)
    monkeypatch.setattr(trace_mod, "stop_trace_safe", stop)
    return calls
