"""The ranks of the distribution layer, the port's stand-in for a JAX mesh.

The reference has no distributed layer (shared-memory atomics only); the
JAX package's is one 1-D device axis ("shards") under ``shard_map``. Here
each rank is one process of a ``torch.distributed`` group that holds its
slice of a batch and its shard of a filter. A :class:`Mesh` names the
group, the rank, the group's size and the rank's device.

Batches are split into contiguous row blocks in rank order: rank r holds
rows [r*B/P, (r+1)*B/P) (:func:`sharded`), the JAX package's ``P(AXIS)``
on axis 0, so the ranks' outputs joined in rank order are the JAX global
array.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the group: ``group`` (None for the default
    group), ``rank`` in [0, size) and the device its tensors live on."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def stages_through_host(self) -> bool:
        """True where the collectives copy CUDA tensors to the host and
        back: gloo over a CUDA device (the rule of ``collectives``)."""
        return self.device.type == "cuda" and self.backend == "gloo"


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of this process in ``group`` (the default group when None),
    on ``device``: ``cuda:<local rank>`` unless the caller names another
    (``device="cpu"`` for the CPU). The local rank is torchrun's
    ``LOCAL_RANK``, else the rank."""
    rank = dist.get_rank(group)
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
    return Mesh(group=group, rank=rank, size=dist.get_world_size(group),
                device=torch.device(device))


def block(mesh: Mesh, n: int) -> slice:
    """The rows of an axis of length n that this rank holds; n must be a
    multiple of the mesh size."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def sharded(mesh: Mesh, x, axis: int = 0) -> torch.Tensor:
    """This rank's block of a global array (numpy or torch) along ``axis``,
    on the mesh's device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    idx = [slice(None)] * x.dim()
    idx[axis] = block(mesh, x.shape[axis])
    return x[tuple(idx)].to(mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """A global array (numpy or torch) whole on every rank, on the mesh's
    device."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(mesh.device)
