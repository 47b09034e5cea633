"""Row-block sharding of the valuation state: one process, a device list.

Counterpart of the valuation half of `repro.distributed.sharding`. The JAX
engine has one controller drive the local devices through `shard_map`
over a 1-D mesh; the port drives an explicit list of devices from one
process. Shard i of D owns rows [i n/D, (i+1) n/D) of the (n, n)
interaction accumulator (and of the (n,) diagonal or point vector), and
every D-th slice of each test batch. The list may name one device more
than once: that is how D shards run on a one-card host (or on the CPU),
each shard a block of its own on the same device.

`ShardGroup` holds the list and the two collectives the sharded step
needs, written for one process: `all_gather` (concatenate the per-shard
parts, one copy per device) and `reduce_scatter` (sum the per-shard
partials, then hand block i to shard i). It plays the part of the mesh
axis in the JAX `shard_map` body. `torch.distributed` is not used: NCCL
refuses two ranks on one card, so it could not run D > 1 on a one-card
host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = [
    "VALUATION_AXIS",
    "ShardGroup",
    "shard_count",
    "valuation_devices",
    "shard_rows",
    "replicate",
    "gather_rows",
]

# the name of the one sharded axis, as in the JAX package
VALUATION_AXIS = "shards"


def shard_count(n: int, requested: Optional[int] = None, *,
                available: Optional[int] = None) -> int:
    """Usable shard count for an n-row accumulator: the largest divisor of
    n that is <= min(requested, available), so the row blocks are exact
    ((n/D, n) each) without padding n. `available` defaults to the number
    of local CUDA cards (0 on a host without one, which gives 1)."""
    if available is None:
        available = torch.cuda.device_count()
    avail = max(1, int(available))
    d = avail if requested is None else int(requested)
    d = max(1, min(d, avail))
    n = int(n)
    while d > 1 and n % d:
        d -= 1
    return d


def valuation_devices(num_shards: Optional[int] = None
                      ) -> list[torch.device]:
    """The first `num_shards` local CUDA cards (default: all), one shard
    each: the device-list counterpart of `valuation_mesh`."""
    count = torch.cuda.device_count()
    num = count if num_shards is None else int(num_shards)
    if not 1 <= num <= count:
        raise ValueError(
            f"num_shards={num} out of range for {count} local CUDA cards; "
            f"pass an explicit device list to run several shards on one"
        )
    return [torch.device("cuda", i) for i in range(num)]


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """D shards over an explicit device list (entries may repeat). Shard i
    lives on `devices[i]`; collectives take and return one tensor per
    shard, in shard order."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        """The number of shards D."""
        return len(self.devices)

    def all_gather(self, parts: Sequence[torch.Tensor]
                   ) -> list[torch.Tensor]:
        """The per-shard parts concatenated along dim 0 in shard order (the
        tiled all-gather), one copy on each shard's device; shards on one
        device share one tensor."""
        whole = torch.cat([p.to(self.devices[0]) for p in parts])
        return [whole.to(dev) for dev in self.devices]

    def reduce_scatter(self, parts: Sequence[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """The per-shard partials summed in shard order, then split along
        dim 0 into D equal blocks, block i on shard i's device (the tiled
        reduce-scatter)."""
        total = parts[0].to(self.devices[0], copy=True)
        for p in parts[1:]:
            total.add_(p.to(self.devices[0]))
        return shard_rows(total, self)


def shard_rows(x: torch.Tensor, group: ShardGroup) -> list[torch.Tensor]:
    """Split `x` along dim 0 into D equal row blocks, block i on shard i's
    device. This one placement serves the JAX package's row-block
    (accumulator), row-vector (diagonal, point vector) and stream (test
    batch) shardings. A block already on its device is a view of `x`."""
    rows = x.shape[0]
    if rows % group.size:
        raise ValueError(
            f"{rows} rows do not split evenly into {group.size} shards"
        )
    return [block.to(dev) for block, dev in
            zip(torch.split(x, rows // group.size), group.devices)]


def replicate(x: torch.Tensor, group: ShardGroup) -> list[torch.Tensor]:
    """`x` on every shard's device (train features and labels); shards on
    one device share one tensor."""
    return [x.to(dev) for dev in group.devices]


def gather_rows(parts: Sequence[torch.Tensor],
                group: ShardGroup) -> torch.Tensor:
    """The per-shard row blocks as one tensor on the first shard's device
    (the sharded state at finalize and checkpoint). Always a new tensor."""
    return torch.cat([p.to(group.devices[0]) for p in parts])
