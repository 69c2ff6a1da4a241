"""Several processes on torch.distributed: the second tier of the mesh.

VectorX distributes map jobs over machines. Here that is a two-tier mesh:
the outer axis ("dcn") spans the processes (hosts), the inner axis spans
each process's local mesh (its devices). The layout rule: independent
work (header batches, map proofs) is sharded over the processes, so what
crosses hosts is a few boundary values; cooperative work (one large NTT)
stays on one process's local mesh.

``init_distributed`` joins the process group over a ``tcp://`` address,
with the backend named or derived from the device: ``nccl`` for CUDA,
``gloo`` for the CPU (never switched when one fails). ``dcn_mesh`` builds
(process rank) x (local mesh); ``shard_headers`` splits the header axis
host-first, so adjacent headers stay on one process.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import default_device
from .mesh import Mesh, Sharding, make_mesh


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: Optional[str] = None,
                     device=None) -> str:
    """Join the process group (a second call with the same values does
    nothing) and return its backend. ``coordinator_address`` is
    ``host:port`` of process 0, or a full ``tcp://`` URL."""
    if backend is None:
        backend = "nccl" if default_device(device).type == "cuda" else "gloo"
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank(), dist.get_backend()) != (
                num_processes, process_id, backend):
            raise RuntimeError("the process group is already initialized "
                               "with other values")
        return backend
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return backend


class DcnMesh:
    """(process rank) x (local mesh). Its shards are numbered host-first:
    process p holds global shards [p * L, (p + 1) * L) for L local ones."""

    def __init__(self, local: Mesh, dcn_axis: str = "dcn"):
        self.local = local
        self.dcn_axis = dcn_axis
        self.rank = dist.get_rank()
        self.processes = dist.get_world_size()
        self.backend = dist.get_backend()

    @property
    def size(self) -> int:
        return self.processes * self.local.size

    @property
    def shape(self) -> dict:
        return {self.dcn_axis: self.processes, **self.local.shape}

    @property
    def first_shard(self) -> int:
        return self.rank * self.local.size

    def collective_device(self) -> torch.device:
        """Where a collective's tensors lie: the CPU for gloo, the first
        local device for NCCL."""
        if self.backend == "gloo":
            return torch.device("cpu")
        return self.local.devices[0]

    def put(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """This process's shards of axis ``dim`` of the global ``x``."""
        if x.shape[dim] % self.size:
            raise ValueError(f"axis {dim} of length {x.shape[dim]} does not "
                             f"split over {self.size} shards")
        mine = torch.chunk(x, self.processes, dim)[self.rank]
        return self.local.put(mine, dim)

    def gather(self, shards: Sequence[torch.Tensor], dim: int = 0,
               device=None) -> torch.Tensor:
        """The global tensor from every process's shards (equal shapes)."""
        mine = self.local.gather(shards, dim, self.collective_device())
        parts = self.all_gather(mine)
        dev = self.local.devices[0] if device is None else device
        return torch.cat([p.to(dev) for p in parts], dim)

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.local.replicate(x)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every process's ``t`` (same shape and dtype), in rank order."""
        t = t.to(self.collective_device()).contiguous()
        parts = [torch.empty_like(t) for _ in range(self.processes)]
        dist.all_gather(parts, t)
        return parts


def dcn_mesh(local: Optional[Mesh] = None, dcn_axis: str = "dcn",
             ici_axis: str = "batch", device=None) -> DcnMesh:
    """The two-tier mesh of the joined process group over ``local`` (this
    process's devices: ``make_mesh`` when None). Every process must bring
    as many local devices."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed first")
    local = local or make_mesh(axis=ici_axis, device=device)
    mesh = DcnMesh(local, dcn_axis)
    sizes = mesh.all_gather(torch.tensor([local.size], dtype=torch.int64))
    if any(int(s) != local.size for s in sizes):
        raise ValueError(f"uneven devices per process: "
                         f"{[int(s) for s in sizes]}")
    return mesh


def shard_headers(mesh: DcnMesh) -> Sharding:
    """The header axis over both tiers, host-first: adjacent headers stay
    on one process, and only the batch boundaries cross processes."""
    return Sharding(mesh, 0)


def replicate(mesh: DcnMesh) -> Sharding:
    return Sharding(mesh, None)
