"""Device meshes: an ordered list of torch devices along one named axis.

VectorX scatters 8-header map jobs over machines and reduces their proofs
pairwise. Here the same data parallelism is a sharded batch axis over a
``Mesh``: ``put`` splits a tensor's leading (or any) axis into one shard
per mesh device, ``gather`` joins the shards again. A mesh may name one
device several times: its shards then run one after another on that
device, which is how a single card (or the CPU) stands in for several.
``make_mesh`` never repeats a device on its own; such a mesh is built
explicitly, ``Mesh([dev] * 4)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from .. import default_device


class Mesh:
    """An explicit, ordered list of torch devices with an axis name."""

    def __init__(self, devices: Sequence, axis: str = "batch"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def local(self) -> "Mesh":
        """The devices of this process (all of them, for one process)."""
        return self

    #: the global index of this process's first shard
    first_shard = 0

    def key(self) -> tuple:
        return (tuple(str(d) for d in self.devices), self.axis)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"

    def put(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """Split axis ``dim`` of ``x`` into ``size`` equal contiguous
        shards, shard i on ``devices[i]``."""
        if x.shape[dim] % self.size:
            raise ValueError(f"axis {dim} of length {x.shape[dim]} does not "
                             f"split over {self.size} shards")
        return [c.to(d) for c, d in
                zip(torch.chunk(x, self.size, dim), self.devices)]

    def gather(self, shards: Sequence[torch.Tensor], dim: int = 0,
               device=None) -> torch.Tensor:
        """Join ``put``'s shards along ``dim`` on ``device`` (the first mesh
        device when None)."""
        dev = self.devices[0] if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in shards], dim)

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``x`` on every mesh device."""
        return [x.to(d) for d in self.devices]


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: axis ``dim`` split over the mesh, or
    a copy on every device (``dim`` None)."""
    mesh: object
    dim: Optional[int] = 0

    def put(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.dim is None:
            return self.mesh.replicate(x)
        return self.mesh.put(x, self.dim)

    def gather(self, shards: Sequence[torch.Tensor],
               device=None) -> torch.Tensor:
        if self.dim is None:
            return shards[0].to(device or shards[0].device)
        return self.mesh.gather(shards, self.dim, device)


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              device=None) -> Mesh:
    """The first ``n_devices`` devices (all when None) of ``device``'s
    kind: the CUDA devices by default, or the one CPU when the caller
    names it. Raises when there are fewer; a mesh that repeats a device is
    built explicitly (``Mesh([dev] * n)``)."""
    dev = default_device(device)
    if dev.type == "cuda":
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [dev]
    n = len(avail) if n_devices is None else n_devices
    if not 0 < n <= len(avail):
        raise ValueError(
            f"{n} {dev.type} devices asked for, {len(avail)} present; build "
            f"a mesh that repeats a device explicitly: Mesh([dev] * {n})")
    return Mesh(avail[:n], axis)


def shard_batch(mesh, axis: str = "batch") -> Sharding:
    """Shard the leading axis across the mesh."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.shape}")
    return Sharding(mesh, 0)


def replicate(mesh) -> Sharding:
    return Sharding(mesh, None)
