"""The FISTA solve kernel K_f for the H100, its plain version, and the selector.

Counterpart of `sparse_coding__tpu/ops/fista_pallas.py`. Its two Pallas
kernels, `_fista_kernel` (everything in VMEM) and `_fista_kernel_hbm_dict`
(the dictionary copied once into one VMEM scratch), compute the same
function; both are ported by one CUDA kernel:

  K_f `fista_cuda` (csrc/fista.cu): the whole ``num_iter``-iteration loop
      for every member of the stack in one cooperative launch: a persistent
      grid walks each iteration's two products in float32 FMA tiles fed by
      cp.async through shared memory (each output one chain from depth 0,
      so the codes are the plain loop's bit for bit), the shrink/momentum
      step in the second one's epilogue, a grid barrier after each; with
      ``tol > 0`` the device stops each member, and the whole solve. The kernel
      keeps the batch fastest, so every operand tile is a plain copy: the
      wrapper transposes x and the warm start in and the codes out, gives
      it the dictionary's transpose too, and pads the batch and widths to
      multiples of 4 with zeros (zero terms at the end of an FMA chain
      change no bit: the kernel's sums never hold -0).

`fista_cuda` dispatches on the device of its tensors: CPU tensors run the
plain version (`models.fista.fista_codes`, the torch loop K_f is held to);
CUDA tensors launch the kernel, or raise. Each launch of a whole solve adds
one to ``LAUNCHES["fista_solve"]`` (`_wrap.LaunchCounts`).

`fista_solve` is the solve of the decoder update: η from the power
iteration, then `fista_cuda` (K_f on the card; outside `shapes_supported` it
raises), then the residual. It follows `models.fista.fista` where the JAX
package's two routes differ: η is rounded to the batch's dtype and the
codes come back float32; the early exit (``tol > 0``) takes one largest code
change per member over its whole batch (the Pallas kernels decide per batch
tile). The power iteration for η and the residual after the solve stay
`torch.matmul` (the JAX package runs them outside its kernels too).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sparse_coding__tpu_torch.models.fista import default_eta, fista_codes, momentum_table
from sparse_coding__tpu_torch.ops import _build
from sparse_coding__tpu_torch.ops._wrap import LaunchCounts, check_cuda, check_dtype, require, stream

fp32 = torch.float32

# launches of each kernel since the counts were last reset, counted on the
# card (`_wrap.LaunchCounts`; plain-version calls on CPU tensors do not
# count); one launch = one whole solve
LAUNCHES = LaunchCounts(("fista_solve",))

# the batch rows K_f takes: its first design's limit (128-row tiles on one
# grid axis), kept; the C entry refuses shapes whose tile count leaves int32
MAX_BATCH = 128 * 65535

_TABLES: Dict[Tuple[int, str], torch.Tensor] = {}


def reset_launches() -> None:
    LAUNCHES.reset()


def shapes_supported(B: int, N: int, D: int) -> bool:
    """THE shape predicate of K_f on Hopper (its own tiling, not the TPU's
    VMEM budgets `pallas_fits` / `pallas_hbm_dict_fits`): any N and D, and
    batches up to `MAX_BATCH` rows. Ragged tiles are masked, and sizes that
    are not multiples of 4 are padded with zeros (the same sums, in the same
    order)."""
    return 1 <= B <= MAX_BATCH and N >= 1 and D >= 1


def _momentum(num_iter: int, dev: torch.device) -> torch.Tensor:
    """`models.fista.momentum_table` on ``dev``, copied there once per length
    (a copy from pageable host memory waits for the work queued before it)."""
    key = (num_iter, str(dev))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(momentum_table(num_iter).copy()).to(dev)
    return _TABLES[key]


def _iterations_from_delta(delta: torch.Tensor, exit_thresh: torch.Tensor, num_iter: int) -> torch.Tensor:
    """Each member's iteration count from K_f's per-iteration largest code
    changes ``delta`` [M, num_iter] (float bits; never-written slots 0): one
    more than the leading run of changes above ``exit_thresh``, at most
    ``num_iter``."""
    above = delta.view(fp32) > exit_thresh[:, None]
    lead = torch.cumprod(above.to(torch.int32), dim=1).sum(dim=1)
    return torch.clamp_max(lead + 1, num_iter).to(torch.int32)


def fista_cuda(x, dicts, eta, l1, c0, num_iter: int, tol: float = 0.0):
    """K_f. x [B, D], dicts [M, N, D], eta [M], l1 [M], c0 [M, B, N] (the
    warm start; None = zeros), all float32 → ``(ahat [M, B, N] f32,
    iterations [M] int32)``. ``tol > 0``: each member stops after the first
    iteration whose largest code change over its batch is not above
    ``tol·eta``."""
    M, N, D = dicts.shape
    B = x.shape[0]
    if not x.is_cuda:
        if c0 is None:
            c0 = torch.zeros((M, B, N), dtype=fp32, device=x.device)
        return fista_codes(x, dicts, eta, l1, c0, num_iter, tol)
    name = "fista_solve"
    tensors = dict(x=x, dicts=dicts, eta=eta, l1=l1)
    if c0 is not None:
        tensors["c0"] = c0
    dev = check_cuda(name, **tensors)
    for key, t in tensors.items():
        check_dtype(name, t, key, fp32)
    require(x.shape == (B, D) and eta.shape == (M,) and l1.shape == (M,), f"{name}: shape mismatch")
    require(c0 is None or c0.shape == (M, B, N), f"{name}: c0 must be [M, B, N]")
    require(shapes_supported(B, N, D), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    require(num_iter >= 0, f"{name}: num_iter {num_iter} < 0")
    # the kernel keeps the batch fastest (xᵀ, aᵀ, yᵀ) and takes the
    # dictionary's transpose too; batch and widths padded to whole float4s
    # with zeros (zero rows stay zero codes and zero residuals; zero terms at
    # the end of an FMA chain change no bit: its sums never hold -0)
    Bp, Np, Dp = (-(-n // 4) * 4 for n in (B, N, D))
    x_t = torch.zeros((Dp, Bp), dtype=fp32, device=dev)
    x_t[:D, :B] = x.t()
    if (Np, Dp) != (N, D):
        dicts = torch.nn.functional.pad(dicts, (0, Dp - D, 0, Np - N))
    dicts_t = dicts.transpose(1, 2).contiguous()
    a_t = torch.zeros((M, Np, Bp), dtype=fp32, device=dev)
    if c0 is not None:
        a_t[:, :N, :B] = c0.transpose(1, 2)
    y_t = a_t.clone()
    res_t = torch.empty((M, Dp, Bp), dtype=fp32, device=dev)
    sync = torch.zeros((1,), dtype=torch.int32, device=dev)  # the grid barrier's count
    exit_thresh = delta = None
    if tol > 0.0:
        exit_thresh = (tol * eta).contiguous()
        delta = torch.zeros((M, max(num_iter, 1)), dtype=torch.int32, device=dev)
    rc = _build.load()["fista"].sc_fista_solve(
        x_t.data_ptr(), dicts.data_ptr(), dicts_t.data_ptr(), eta.data_ptr(), l1.data_ptr(),
        _momentum(num_iter, dev).data_ptr(), None if exit_thresh is None else exit_thresh.data_ptr(),
        None if delta is None else delta.data_ptr(), a_t.data_ptr(), y_t.data_ptr(), res_t.data_ptr(),
        sync.data_ptr(), M, Bp, Np, Dp, num_iter, stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES.count(name, dev)
    a = a_t[:, :N, :B].transpose(1, 2).contiguous()
    if delta is None:
        return a, torch.full((M,), num_iter, dtype=torch.int32, device=dev)
    return a, _iterations_from_delta(delta[:, :num_iter], exit_thresh, num_iter)


def fista_solve(
    batch: torch.Tensor,
    dicts: torch.Tensor,
    l1: torch.Tensor,
    c0: Optional[torch.Tensor],
    num_iter: int = 500,
    tol: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FISTA for the stack, the contract of `models.fista.fista`: batch
    [B, D], dicts [M, N, D], l1 [M], c0 [M, B, N] or None (zeros) →
    ``(ahat [M, B, N], residual [M, B, D])``. The device decides: K_f for
    CUDA tensors (raising outside `shapes_supported`), its plain loop for
    CPU tensors."""
    eta = default_eta(dicts).to(batch.dtype)
    ahat, _ = fista_cuda(batch, dicts, eta, l1.reshape(-1), c0, num_iter, tol)
    return ahat, batch - torch.matmul(ahat, dicts)
