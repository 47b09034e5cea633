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

`DeviceGrid` is the counterpart of the JAX package's 2-D ("data",
"model") mesh, for the "distributed" engine (`launch/specs.py::sti_cell`):
a D x M grid over an explicit device list, repeats allowed, with the one
collective that engine needs, `psum_data`, a sum over the data axis onto
data row 0, which then holds every model shard's block. No `torch.distributed`
either, for the same reason: the grid runs (2, 2) on one card and (4, 2)
on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.device import resolve_device

__all__ = [
    "VALUATION_AXIS",
    "ShardGroup",
    "shard_count",
    "valuation_devices",
    "shard_rows",
    "replicate",
    "gather_rows",
    "DeviceGrid",
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


def _indexed(device) -> torch.device:
    """`device` resolved (raising when a card is asked for and absent),
    a CUDA device given its index, so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """A D x M grid of devices, axes ("data", "model"): the port's
    counterpart of a 2-D `jax.sharding.Mesh`. `devices` lists the grid
    row-major (device (i, j) is `devices[i * M + j]`); entries may repeat,
    so four cells of a (2, 2) grid can share one card. Cell (i, j) takes
    data shard i of what is sharded over "data" and owns block j of what
    is sharded over "model"."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]

    axis_names = ("data", "model")

    def __post_init__(self):
        devs = tuple(_indexed(d) for d in self.devices)
        shape = tuple(int(s) for s in self.shape)
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(f"a device grid is 2-D with positive sizes, "
                             f"got shape {self.shape}")
        if len(devs) != shape[0] * shape[1]:
            raise ValueError(f"{len(devs)} devices do not fill a "
                             f"{shape[0]} x {shape[1]} grid")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "shape", shape)

    @property
    def axis_sizes(self) -> dict:
        """{"data": D, "model": M}, as `dict(mesh.shape)` reads."""
        return dict(zip(self.axis_names, self.shape))

    def device(self, i: int, j: int) -> torch.device:
        """The device of cell (i, j): data shard i, model shard j."""
        return self.devices[i * self.shape[1] + j]

    def psum_data(self, parts: Sequence[Sequence[torch.Tensor]]
                  ) -> list[torch.Tensor]:
        """parts[i][j], cell (i, j)'s partial on its device -> for every j
        the sum over i, on device (0, j): the psum over the data axis, held
        only where the reference's out spec reads it (data row 0). The
        distinct tensors are summed in data order, in place into
        parts[0][j]. Cells that share a device may share one accumulator:
        a tensor that appears again in a later data row already holds that
        row's partial and is not added twice."""
        out = []
        for j in range(len(parts[0])):
            total, seen = parts[0][j], {id(parts[0][j])}
            for row in parts[1:]:
                if id(row[j]) not in seen:
                    seen.add(id(row[j]))
                    total.add_(row[j].to(total.device))
            out.append(total)
        return out
