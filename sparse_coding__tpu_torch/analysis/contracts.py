"""Abstract contract checks — invariants a pure AST walk cannot see.

These run the port's own code against small real states and registry
introspection, so they need no card. The flagship check is partition-rule
coverage: every leaf of the ensemble + optimizer state trees must be
classified by an explicit `parallel.mesh.infer_state_specs` rule, because an
unclassified leaf defaults to replication and the first symptom is an OOM
(or a silent n-fold memory bill) at sweep scale, not a test failure.

Run via ``python -m sparse_coding__tpu_torch.analysis --contracts``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

__all__ = ["ContractResult", "CONTRACTS", "run_contracts"]


@dataclasses.dataclass
class ContractResult:
    name: str
    ok: bool
    summary: str
    details: List[str] = dataclasses.field(default_factory=list)

    def render(self) -> str:
        mark = "ok" if self.ok else "FAIL"
        lines = [f"[{mark}] {self.name}: {self.summary}"]
        lines += [f"       {d}" for d in self.details]
        return "\n".join(lines)


CONTRACTS: Dict[str, Callable[[], ContractResult]] = {}


def contract(name: str):
    def deco(fn):
        CONTRACTS[name] = fn
        return fn

    return deco


# -- partition-rule coverage --------------------------------------------------

class _FakeMesh:
    """Duck-typed stand-in for `parallel.Mesh`: `infer_state_specs` reads only
    ``mesh.shape``, so the contract runs without a process group."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = shape


# the optimizer states the contract classifies: Adam with f32 moments (the
# JAX contract's), SGD's momentum trace, fp16 mu, and int8 mu (`QuantMoment`
# leaves: codes and per-row scales) with bf16 nu
OPTIMIZER_STATES: Dict[str, Tuple[str, Dict[str, Any]]] = {
    "adam": ("adam", {"learning_rate": 1e-3}),
    "sgd-trace": ("sgd", {"learning_rate": 1e-2, "momentum": 0.9}),
    "adam-fp16-mu": ("adam", {"learning_rate": 1e-3, "mu_dtype": "float16"}),
    "adam-int8-mu": ("adam", {"learning_rate": 1e-3, "mu_dtype": "int8", "nu_dtype": "bfloat16"}),
}


def ensemble_state(optimizer: str, optimizer_kwargs: Dict[str, Any], n_models: int = 4,
                   activation_size: int = 64, n_dict_components: int = 128):
    """The real state tree — params, buffers, optimizer state, step — built
    by the constructors `Ensemble` uses (`build_ensemble` over
    `FunctionalTiedSAE`). Built on the CPU, asked for explicitly: the
    signatures draw their init from a `torch.Generator`, which the ``meta``
    device does not have; at the contract's sizes (4 members, 64 -> 128)
    that is a few hundred kB."""
    from sparse_coding__tpu_torch.ensemble import build_ensemble
    from sparse_coding__tpu_torch.models.sae import FunctionalTiedSAE

    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}] * n_models, optimizer=optimizer,
                         optimizer_kwargs=optimizer_kwargs, activation_size=activation_size,
                         n_dict_components=n_dict_components, device="cpu")
    return ens.state


def classify(state, n_models: int, dict_size: int = 4) -> Tuple[List[Tuple[Tuple, Tuple, Any]], List[str]]:
    """``([(path, shape, spec)] for every leaf, [problems])`` of ``state``'s
    specs on a ``{model: n_models, dict: dict_size}`` mesh."""
    from sparse_coding__tpu_torch.parallel import mesh as pmesh
    from sparse_coding__tpu_torch.utils.tree import tree_paths

    fake = _FakeMesh({pmesh.MODEL_AXIS: n_models, pmesh.DICT_AXIS: dict_size})
    specs = pmesh.infer_state_specs(state, n_models, fake, shard_dict=True)
    rows, problems = [], []
    for (path, leaf), (_, spec) in zip(tree_paths(state), tree_paths(specs)):
        shape = tuple(getattr(leaf, "shape", ()))
        axes = tuple(spec)
        rows.append((path, shape, spec))
        where = "/".join(str(p) for p in path)
        if len(shape) >= 1 and shape[0] == n_models:
            if not axes or axes[0] != pmesh.MODEL_AXIS:
                problems.append(f"{where} {shape}: stacked leaf not placed on the model axis (spec {axes}) — "
                                "replicated n_models times")
            elif pmesh.DICT_AXIS in axes and (len(shape) < 2 or shape[1] % dict_size != 0):
                problems.append(f"{where} {shape}: dict-axis spec with indivisible dim 1")
        elif any(a is not None for a in axes):
            problems.append(f"{where} {shape}: unstacked leaf given sharded spec {axes}")
    return rows, problems


@contract("partition-coverage")
def partition_coverage(n_models: int = 4, activation_size: int = 64, n_dict_components: int = 128) -> ContractResult:
    """Every leaf of the ensemble + optimizer state trees must be matched by
    an explicit `infer_state_specs` rule: stacked leaves (leading dim ==
    n_models) get the model axis (the dict axis too when their dim 1
    divides the dict mesh size), everything else is *deliberately*
    replicated (the host step). A stacked leaf that comes back replicated
    means a new state field slipped past the spec table — the silent-OOM
    class. Run for each state of `OPTIMIZER_STATES`."""
    covered = total = 0
    details: List[str] = []
    parts = []
    for label, (optimizer, kwargs) in OPTIMIZER_STATES.items():
        state = ensemble_state(optimizer, kwargs, n_models, activation_size, n_dict_components)
        rows, problems = classify(state, n_models)
        total += len(rows)
        covered += len(rows) - len(problems)
        details += [f"{label}: {p}" for p in problems]
        parts.append(f"{label} {len(rows) - len(problems)}/{len(rows)}")
    return ContractResult(
        name="partition-coverage",
        ok=not details,
        summary=(f"{covered}/{total} state leaves classified by an explicit partition rule "
                 f"({', '.join(parts)}; n_models={n_models})"),
        details=details,
    )


# -- span-table invariants ----------------------------------------------------

@contract("span-tables")
def span_tables() -> ContractResult:
    """Structural invariants of the port's telemetry category registry: the
    three tables are disjoint (a category in two tables is double-counted
    by construction), and every nestable (INNER) category is itself
    emittable — an INNER entry nobody can emit is a dead suppression
    rule."""
    from sparse_coding__tpu_torch.analysis.context import RepoContext

    t = RepoContext().span_tables
    good, bad, derived, inner = (set(t["GOODPUT_CATEGORIES"]), set(t["BADPUT_CATEGORIES"]),
                                 set(t["DERIVED_CATEGORIES"]), set(t["INNER_CATEGORIES"]))
    problems: List[str] = []
    for a, b, name in ((good, bad, "GOODPUT∩BADPUT"), (good, derived, "GOODPUT∩DERIVED"),
                       (bad, derived, "BADPUT∩DERIVED")):
        if a & b:
            problems.append(f"{name} = {sorted(a & b)}")
    dead_inner = inner - (good | bad)
    if dead_inner:
        problems.append(f"INNER categories nobody can emit: {sorted(dead_inner)}")
    for table_name in ("GOODPUT_CATEGORIES", "BADPUT_CATEGORIES"):
        seq = t[table_name]
        if len(seq) != len(set(seq)):
            problems.append(f"duplicates inside {table_name}")
    return ContractResult(
        name="span-tables",
        ok=not problems,
        summary=f"{len(good)} goodput / {len(bad)} badput / {len(derived)} derived categories, {len(inner)} nestable",
        details=problems,
    )


# -- flags/docs sync ----------------------------------------------------------

@contract("flags-docs")
def flags_docs() -> ContractResult:
    """The port's flag table in README.md is generated from
    `utils.flags.FLAGS`; this fails when the registry changed but
    ``python -m sparse_coding__tpu_torch.utils.flags --update-docs`` wasn't
    re-run."""
    from sparse_coding__tpu_torch.utils import flags

    ok = flags.check_docs()
    return ContractResult(
        name="flags-docs",
        ok=ok,
        summary=(f"README.md port flag table in sync ({len(flags.FLAGS)} flags)" if ok
                 else "README.md port flag table is stale — run python -m sparse_coding__tpu_torch.utils.flags "
                      "--update-docs"),
    )


def run_contracts() -> List[ContractResult]:
    return [fn() for fn in CONTRACTS.values()]
