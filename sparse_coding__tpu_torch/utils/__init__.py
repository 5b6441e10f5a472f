"""Host-side utilities (counterpart of `sparse_coding__tpu/utils`, with its
re-exports). As in JAX's package, ``utils.trace`` is then the profiler
window's context manager, not its module: import the module by its full
name (``from sparse_coding__tpu_torch.utils.trace import ...``). The run
configs load lazily, at first use: `utils.config` imports the subject LM's
hook table, and the package's own modules import `utils.flags` while they
load."""

from sparse_coding__tpu_torch.utils.logging import MetricLogger, format_hyperparam_val, make_hyperparam_name
from sparse_coding__tpu_torch.utils.trace import (
    Progress,
    StepTimer,
    annotate,
    start_trace_safe,
    stop_trace_safe,
    trace,
    trace_active,
)

__all__ = [
    "MetricLogger", "format_hyperparam_val", "make_hyperparam_name", "BaseArgs", "EnsembleArgs", "ErasureArgs",
    "InterpArgs", "InterpGraphArgs", "InvestigateArgs", "SyntheticEnsembleArgs", "ToyArgs", "TrainArgs",
    "Progress", "StepTimer", "annotate", "start_trace_safe", "stop_trace_safe", "trace", "trace_active",
]
_CONFIGS = frozenset(__all__[3:12])


def __getattr__(name: str):
    if name in _CONFIGS:
        from sparse_coding__tpu_torch.utils import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
