"""Multi-process initialization and the host-side batch helpers.

Counterpart of `sparse_coding__tpu/parallel/distributed.py`. Where JAX wires
its hosts with `jax.distributed.initialize`, the port starts a
`torch.distributed` process group: one process per device (a rank), its
address, world size and rank given by the caller or by the environment
(``COORDINATOR_ADDRESS``, or a launcher's ``MASTER_ADDR`` / ``MASTER_PORT``
with ``RANK`` and ``WORLD_SIZE``). Nothing on the machine announces a
cluster, so with none of these set the call is a no-op and the program runs
as a world of one.

The backend is chosen explicitly: NCCL when every rank has a CUDA device of
its own, gloo on the CPU and when ranks share a device (NCCL refuses two
ranks on one card). It is recorded in the run fingerprint
(`telemetry.events.run_fingerprint`). The group keeps torch's own timeout
for its collectives and its store's waits: rank 0 alone may build a
dataset, write exports or commit a checkpoint while the others wait, so
the short ``SC_MH_TIMEOUT_MS`` bounds only the telemetry exchanges
(`telemetry.multihost`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def choose_backend(num_processes: int, device=None) -> str:
    """``"nccl"`` when each of the ``num_processes`` ranks can hold a CUDA
    device of its own, else ``"gloo"``. ``device`` is where this rank runs
    (None: the card when there is one)."""
    if device is not None and torch.device(device).type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= num_processes else "gloo"


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Start the process group if this process is one rank of several; a
    no-op returning False when nothing is configured (arguments or env).

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0) or a URL
    (``tcp://...``, ``file://...``). The backend is `choose_backend`'s
    (``device="cpu"``: gloo). On the card each rank takes device
    ``process_id % device_count`` as its current device (every rank device
    0 when they share one card). Returns True once the group is up (also
    when it already was and holds several ranks)."""
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if not address:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs num_processes and process_id (or WORLD_SIZE and RANK)")
    backend = choose_backend(num_processes, device)
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    # a failed init (an unreachable coordinator, a timeout) propagates:
    # swallowing it would split the pod into independent single-process runs
    # with no gradient sync
    dist.init_process_group(
        backend=backend, init_method=_init_method(address), world_size=int(num_processes), rank=int(process_id),
    )
    # pod observability: the clock offset to rank 0, measured once here,
    # while every process is at the same point; best-effort
    try:
        from sparse_coding__tpu_torch.telemetry.multihost import estimate_clock_offset

        estimate_clock_offset()
    except Exception:
        pass
    return True


def local_batch_slice(global_batch: int) -> slice:
    """This rank's slice of a globally-sharded batch (for host-side loaders
    that feed only their own rows)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per_host = global_batch // n
    start = (dist.get_rank() if dist.is_initialized() else 0) * per_host
    return slice(start, start + per_host)


def host_local_to_global(batch: torch.Tensor, mesh, spec) -> torch.Tensor:
    """Assemble each rank's rows of a batch into the global batch, in rank
    order along the data axis (``spec`` a `mesh.BatchSlice`: the rows are cut
    on the data axis). Every rank receives the whole batch."""
    from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

    return mesh.all_gather(batch, DATA_AXIS, dim=spec.leading + (1 if spec.per_model else 0))
