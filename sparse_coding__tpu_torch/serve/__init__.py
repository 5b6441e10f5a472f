"""Online feature-inference serving over trained `LearnedDict`s.

Counterpart of the JAX package's `serve/`, single-process tier (ROADMAP A7a):

  - `serve.registry.DictRegistry`: verified export loads, hot
    add/swap/remove, int8-resident weights, attached subject LMs;
  - `serve.engine.EncodeEngine`: continuous micro-batching over lanes of
    same-shape dicts, padded power-of-two buckets, on-device top-k, each
    dispatch a replayed CUDA graph on the card;
  - `serve.wire`: json / npz / raw payloads, byte-identical to the JAX
    package's;
  - `serve.server`: the stdlib HTTP API (``/encode``, ``/features``,
    ``/dicts``, ``/healthz``, ``/metrics``) with the SIGTERM drain, and
    `ServeClient`.

The replica tier (`Router`, `RouterClient`, `ReplicaSet`, `ShedRejection`)
is ROADMAP A7b and raises.
"""

__all__ = [
    "DictRegistry",
    "EncodeEngine",
    "EngineClosed",
    "ReplicaSet",
    "Router",
    "RouterClient",
    "ServeClient",
    "ServeServer",
    "ShedRejection",
    "SubjectLM",
]

_EXPORTS = {
    "DictRegistry": "sparse_coding__tpu_torch.serve.registry",
    "EncodeEngine": "sparse_coding__tpu_torch.serve.engine",
    "EngineClosed": "sparse_coding__tpu_torch.serve.engine",
    "ServeClient": "sparse_coding__tpu_torch.serve.server",
    "ServeServer": "sparse_coding__tpu_torch.serve.server",
    "SubjectLM": "sparse_coding__tpu_torch.serve.registry",
}
_REPLICA_TIER = ("ReplicaSet", "Router", "RouterClient", "ShedRejection")


def __getattr__(name: str):
    # lazy re-exports: `python -m sparse_coding__tpu_torch.serve.server` must
    # not find the submodule already imported by the package
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    if name in _REPLICA_TIER:
        raise NotImplementedError(f"{name}: the replica tier (router, replica sets) is not ported yet — ROADMAP A7b")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
