"""The hand-written kernels' wrappers (counterpart of `sparse_coding__tpu/ops`,
with its re-export `fista_solve`; JAX's `fista_pallas`, `on_tpu` and
`pallas_fits` are the TPU's gates, owed nothing). `fista_solve` loads
lazily, at first use: `ops.fista_kernel` imports `models.fista`, whose
package imports these wrappers. Nothing here builds or loads a CUDA library:
the kernels are built at their first launch."""

__all__ = ["fista_solve"]


def __getattr__(name: str):
    if name == "fista_solve":
        from sparse_coding__tpu_torch.ops.fista_kernel import fista_solve

        return fista_solve
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
