"""Online feature-inference serving over trained `LearnedDict`s.

Counterpart of the JAX package's `serve/`. The single process:

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

The replicated tier:

  - `serve.router.Router`: the HTTP front end over N replicas (health
    states, retry on another replica, hedging, bounded shedding, generation
    pinning) and `RouterClient`, whose `ShedRejection` is the router's fast
    retryable 503;
  - `serve.replicaset.ReplicaSet`: N server processes supervised with a
    restart budget, and drain-aware rolling dict swaps;
  - `serve.loadgen`: the closed-loop load generator.
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
    "ReplicaSet": "sparse_coding__tpu_torch.serve.replicaset",
    "Router": "sparse_coding__tpu_torch.serve.router",
    "RouterClient": "sparse_coding__tpu_torch.serve.router",
    "ServeClient": "sparse_coding__tpu_torch.serve.server",
    "ServeServer": "sparse_coding__tpu_torch.serve.server",
    "ShedRejection": "sparse_coding__tpu_torch.serve.router",
    "SubjectLM": "sparse_coding__tpu_torch.serve.registry",
}


def __getattr__(name: str):
    # lazy re-exports: `python -m sparse_coding__tpu_torch.serve.server` must
    # not find the submodule already imported by the package
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
