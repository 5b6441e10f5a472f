"""`sclint` for the PyTorch/CUDA port: repo-native static analysis of the
port's contracts.

The JAX package's sclint encodes bugs that package shipped, each a contract
that lived in another module than the code that broke it. The port keeps its
rule ids, scopes, suppressions, baseline and CLI, with every registry read
from the port (its span tables, flag registry, fault sites and metrics
sanitizer), and rewrites the two rules whose bug class is JAX's own in
torch's terms: SC003 (host syncs in the hot loops: ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``, ``synchronize()``, coercions of tensors) and
SC004 (a bare parameter sizing a tensor under CUDA-graph capture or
``torch.compile``). `rules` holds the registry, `engine` the single-parse
walker, and `contracts` the checks an AST walk cannot make (partition
coverage of the real ensemble states, the span tables, the flags docs).

CLI::

    python -m sparse_coding__tpu_torch.analysis sparse_coding__tpu_torch/ chip_smoke.py

Exit codes: 0 = clean, 1 = findings (or a failed contract), 2 = usage, 3 =
no Python files found. ``--json`` emits machine-readable findings,
``--baseline FILE`` grandfathers a reviewed allowlist, ``--contracts`` adds
the abstract checks.

Suppression: a ``# sclint: allow(SC003) <reason>`` comment on the finding's
line, on the first line of its enclosing statement, or on a comment line
directly above it sanctions exactly that rule there — the idiom for the
serve drainer's deliberate host syncs (response materialization); a ``with
allowed_transfer():`` block (`telemetry.audit`) sanctions SC003 over its
extent, as it does the runtime audit.
"""

from sparse_coding__tpu_torch.analysis.findings import Finding
from sparse_coding__tpu_torch.analysis.engine import (
    iter_python_files,
    lint_paths,
    load_baseline,
)

__all__ = ["Finding", "iter_python_files", "lint_paths", "load_baseline"]
