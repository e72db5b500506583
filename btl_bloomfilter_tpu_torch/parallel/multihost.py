"""Process-group set-up for the distribution layer.

Every rank runs the same program; ``init()`` joins this process to the
group. The filter state is either replicated (OR-allreduce merges) or
sharded (all-to-all routing); ``collectives`` holds the exchanges. As in
the JAX package there is no elastic layer: the .bf / .mibf files are the
checkpoints, written by one rank from the replicated or gathered state.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU.
NCCL takes one rank a device, so several ranks on one card run on gloo
(``backend="gloo"``), whose collectives then stage CUDA tensors through
the host (``mesh.Mesh.stages_through_host``).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


def init(init_method: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, *, device="cuda",
         backend: str | None = None,
         timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the process group: ``init_method`` a ``file://`` store or a
    ``tcp://host:port`` address with ``num_processes`` ranks of which this
    is ``process_id``; with no ``init_method``, torchrun's environment
    (``env://``). ``backend`` defaults to NCCL for a CUDA ``device`` and
    gloo for the CPU. A collective that a rank never joins fails after
    ``timeout``."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if init_method is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(name: str = "btl") -> None:
    """Wait for every rank of the default group (``name`` is kept from
    the JAX package's signature)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
