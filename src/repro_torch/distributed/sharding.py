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

The LM half lays a model over a `DeviceGrid`: `rules_for`,
`strategy_for`, `batch_spec` and `cache_pytree_spec` return the
reference's specs, each a tuple with one entry per dimension that reads
as `tuple(PartitionSpec(...))` does (a mesh-axis name, a tuple of names,
or None). `named` binds a spec to the grid as a `Placement`, the
counterpart of `NamedSharding`: it splits a whole tensor into one block
per cell (`Sharded`), reports each cell's index ranges (those of
`NamedSharding.devices_indices_map`) and gathers the blocks back, bit for
bit. Cells that share a device and an index range share one block, so a
(2, 2) grid of one card holds a replicated weight once.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import (
    DEFAULT_RULES, FSDP_RULES, ModelConfig, spec_entry, tree_leaves,
    tree_map)
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
    "CollectiveCounter",
    "COLLECTIVES",
    "data_axes",
    "data_size",
    "rules_for",
    "strategy_for",
    "batch_spec",
    "cache_pytree_spec",
    "is_spec",
    "Placement",
    "Sharded",
    "assemble",
    "named",
    "tree_named",
    "place_tree",
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
    a CUDA device given its index, so that equal devices compare equal.
    "meta" stays as it is: a placeholder cell of a dry run."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
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
    is sharded over "model".

    `pods` > 1 splits the D data rows into that many pods of D / pods
    rows: the grid then has the axes ("pod", "data", "model") of the
    reference's multi-pod mesh, row i being data shard i % (D / pods) of
    pod i // (D / pods), and the data axes ("pod", "data") still number
    the rows 0..D-1 in order. Devices may be "meta": the placeholder cells
    of a dry run."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]
    pods: int = 1

    def __post_init__(self):
        devs = tuple(_indexed(d) for d in self.devices)
        shape = tuple(int(s) for s in self.shape)
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(f"a device grid is 2-D with positive sizes, "
                             f"got shape {self.shape}")
        if len(devs) != shape[0] * shape[1]:
            raise ValueError(f"{len(devs)} devices do not fill a "
                             f"{shape[0]} x {shape[1]} grid")
        if self.pods < 1 or shape[0] % self.pods:
            raise ValueError(f"{shape[0]} data rows do not split into "
                             f"{self.pods} pods")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "shape", shape)

    @property
    def axis_names(self) -> tuple:
        """("data", "model"), or ("pod", "data", "model") with pods."""
        return (("pod",) if self.pods > 1 else ()) + ("data", "model")

    @property
    def axis_sizes(self) -> dict:
        """{"data": D, "model": M} ({"pod": P, "data": D / P, "model": M}
        with pods), as `dict(mesh.shape)` reads."""
        d, m = self.shape
        if self.pods > 1:
            return {"pod": self.pods, "data": d // self.pods, "model": m}
        return {"data": d, "model": m}

    def coords(self, i: int, j: int) -> dict:
        """Cell (i, j)'s index on each axis."""
        if self.pods > 1:
            per = self.shape[0] // self.pods
            return {"pod": i // per, "data": i % per, "model": j}
        return {"data": i, "model": j}

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
        row's partial and is not added twice. Each row's partial past row 0
        counts as all-reduce bytes into cell (0, j) (`COLLECTIVES`), shared
        or not."""
        out = []
        for j in range(len(parts[0])):
            total, seen = parts[0][j], {id(parts[0][j])}
            for row in parts[1:]:
                COLLECTIVES.add("all-reduce", (0, j),
                                row[j].numel() * row[j].element_size())
                if id(row[j]) not in seen:
                    seen.add(id(row[j]))
                    total.add_(row[j].to(total.device))
            out.append(total)
        return out


class CollectiveCounter:
    """Bytes moved between the cells of a grid, by kind and by the cell
    that receives them: "all-gather" (weights gathered onto a data row's
    cell), "all-reduce" (replica gradient sums, `psum_data`) and
    "collective-permute" (decode's attention partials sent to the row's
    cell). Keyed by cell, not device: every cell counts as a device of its
    own, as on a grid of distinct cards, so a meta grid (every cell one
    device) counts what a real one would move. The dry run reads it
    (`hlo_analysis.collective_bytes`)."""

    def __init__(self):
        self.by_cell: dict = {}

    def reset(self) -> None:
        self.by_cell = {}

    def add(self, kind: str, cell: tuple, nbytes) -> None:
        if nbytes:
            kinds = self.by_cell.setdefault(tuple(cell), {})
            kinds[kind] = kinds.get(kind, 0) + int(nbytes)

    def fullest(self) -> dict:
        """{kind: bytes} of the cell that receives the most."""
        if not self.by_cell:
            return {}
        return dict(max(self.by_cell.values(),
                        key=lambda kinds: sum(kinds.values())))


COLLECTIVES = CollectiveCounter()


# ------------------------------------------------------------ the LM half
def data_axes(grid: DeviceGrid) -> tuple:
    """The grid's data-parallel axes, in ("pod", "data") order, restricted
    to the axes it has: ("data",) for a `DeviceGrid`."""
    return tuple(a for a in ("pod", "data") if a in grid.axis_names)


def data_size(grid: DeviceGrid) -> int:
    """The number of data shards: the product of the data axes' sizes."""
    return math.prod(grid.axis_sizes[a] for a in data_axes(grid))


def rules_for(cfg: ModelConfig, strategy: str, grid: DeviceGrid) -> dict:
    """Logical-axis -> mesh-axis table for `strategy`: "tp_dp" replicates
    weights over data; "fsdp" also shards the embed dim over the data
    axes (the tuple of them, as the reference's table holds)."""
    if strategy == "fsdp":
        return dict(FSDP_RULES, embed=data_axes(grid))
    return dict(DEFAULT_RULES)


def strategy_for(cfg: ModelConfig) -> str:
    """FSDP for big models (d_model >= 3000 or >= 8 experts), TP + DP
    replication for small ones."""
    big = cfg.d_model >= 3000 or cfg.num_experts >= 8
    return "fsdp" if big else "tp_dp"


def _spec(*entries) -> tuple:
    return tuple(spec_entry(e) for e in entries)


def batch_spec(cfg: ModelConfig, kind: str, grid: DeviceGrid) -> dict:
    """The spec of each batch field: the batch dim over the data axes."""
    da = data_axes(grid)
    spec = {"tokens": _spec(da, None), "labels": _spec(da, None)}
    if cfg.family == "vlm":
        spec["patch_embeds"] = _spec(da, None, None)
    if cfg.family == "audio":
        spec["frames"] = _spec(da, None, None)
    if kind != "train":
        spec.pop("labels")
    return spec


def _map_with_keys(fn, tree, keys=()):
    """`fn(keys, leaf)` over a cache tree of lists, dicts and NamedTuples,
    `keys` the dict keys on the leaf's path (the reference reads a
    path's `DictKey`s; list indices and NamedTuple fields add none)."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (k,))
                for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_keys(fn, t, keys) for t in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(keys, tree)


def cache_pytree_spec(cfg: ModelConfig, caches, shape_kind: str,
                      grid: DeviceGrid, seq_len: int, *,
                      cache_seq_shard: bool = True):
    """The spec tree of `init_caches`' tree `caches` (tensors or meta
    tensors), leaf by leaf as the reference's:
      - the batch dim over the data axes when it divides them;
      - decode KV caches (k, v, pos) take their seq dim over "model"
        (flash-decode across the model shards), over data + model when the
        batch does not divide the data axes; an "xkv" cache never
        (`cache_seq_shard=False`: the seq dim stays whole, or over the data
        axes at decode when the batch does not divide them);
      - SSM states take their inner dims over "model" (the mLSTM C its
        value dim, the Mamba state its d_inner dim, the Mamba conv window
        its channels)."""
    da = data_axes(grid)
    dp = data_size(grid)
    leaves = tree_leaves(caches)
    batch = leaves[0].shape[1] if leaves else 0
    b_ok = batch % dp == 0 and batch > 0
    bspec = da if b_ok else None
    if shape_kind == "decode" and cache_seq_shard:
        s_ax = "model" if b_ok else tuple(da) + ("model",)
    else:
        s_ax = None if b_ok else da
        if shape_kind != "decode":
            s_ax = None

    def leaf_spec(keys, leaf):
        in_kv = "kv" in keys or "xkv" in keys
        is_x = "xkv" in keys
        if in_kv:
            if leaf.ndim == 5:  # k/v (g, b, kv, S, hd)
                return _spec(None, bspec, None, None if is_x else s_ax,
                             None)
            return _spec(None, bspec, None if is_x else s_ax)
        if leaf.ndim == 5:  # mlstm C (g, b, h, dk, dv)
            return _spec(None, bspec, None, None, "model")
        if leaf.ndim == 4:
            if leaf.shape[-1] == cfg.ssm_state_dim:   # mamba (g,b,di,ds)
                return _spec(None, bspec, "model", None)
            if leaf.shape[-1] == cfg.d_inner:          # mamba conv
                return _spec(None, bspec, None, "model")
            return _spec(None, bspec, None, None)      # mlstm n
        if leaf.ndim == 3:  # mlstm m / slstm vectors
            return _spec(None, bspec, None)
        return _spec(None, bspec) if leaf.ndim == 2 else ()

    return _map_with_keys(leaf_spec, caches)


def is_spec(x) -> bool:
    """True for a spec: a plain tuple whose entries are None, a mesh-axis
    name or a tuple of names (a NamedTuple is a tree node, not a spec)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x))


@dataclasses.dataclass(frozen=True)
class Placement:
    """A spec bound to a grid: the counterpart of `NamedSharding`. Entry k
    of `spec` names the grid axes dimension k is split over (major to
    minor); dimensions past the spec's length are whole."""

    grid: DeviceGrid
    spec: tuple

    def __post_init__(self):
        named = [a for k in range(len(self.spec)) for a in self._axes(k)]
        for a in named:
            if a not in self.grid.axis_names:
                raise ValueError(
                    f"spec {self.spec} names axis {a!r}, which the grid "
                    f"{self.grid.axis_names} lacks")
        if len(set(named)) != len(named):
            raise ValueError(f"spec {self.spec} names a grid axis twice")

    def _axes(self, k: int) -> tuple:
        e = self.spec[k] if k < len(self.spec) else None
        return () if e is None else (e,) if isinstance(e, str) else e

    def indices(self, shape) -> dict:
        """{(i, j): cell (i, j)'s index ranges, one slice per dimension}:
        `NamedSharding.devices_indices_map(shape)`, keyed by cell. Raises
        ValueError where a split dimension does not divide evenly, as JAX
        does. Cached per (placement, shape): do not mutate the result."""
        return _indices(self, tuple(shape))

    def _indices(self, shape: tuple) -> dict:
        sizes = self.grid.axis_sizes
        parts = []
        for k, n in enumerate(shape):
            axes = self._axes(k)
            count = math.prod(sizes[a] for a in axes)
            if n % count:
                raise ValueError(
                    f"spec {self.spec} splits dimension {k} of {tuple(shape)}"
                    f" {count} ways, which does not divide {n}")
            parts.append((axes, count, n // count))
        out = {}
        d_size, m_size = self.grid.shape
        for i in range(d_size):
            for j in range(m_size):
                at = self.grid.coords(i, j)
                sl = []
                for axes, count, size in parts:
                    if count == 1:
                        sl.append(slice(None))
                        continue
                    idx = 0
                    for a in axes:
                        idx = idx * sizes[a] + at[a]
                    sl.append(slice(idx * size, (idx + 1) * size))
                out[(i, j)] = tuple(sl)
        return out

    def place(self, x: torch.Tensor) -> "Sharded":
        """`x` split into one owned, contiguous block per cell, cell
        (i, j)'s on `grid.device(i, j)`; cells with one device and one
        index range share a block."""
        x = x.detach()
        made, blocks = {}, {}
        for cell, sl in self.indices(x.shape).items():
            key = (self.grid.device(*cell), _range_key(sl))
            if key not in made:
                made[key] = x[sl].to(key[0], copy=True).contiguous()
            blocks[cell] = made[key]
        return Sharded(self, tuple(x.shape), x.dtype, blocks)

    def ranges(self, blocks: dict, shape, device=None, row=None) -> list:
        """(slices, block) for each index range held in `blocks` ({cell:
        block}, one per cell or at least one per index range): the block
        of a cell on `device` where one holds the range, else of a cell in
        data row `row`, else of the range's first cell in row-major
        order."""
        best = {}
        for cell, sl in self.indices(shape).items():
            if cell not in blocks:
                continue
            rank = (0 if self.grid.device(*cell) == device else
                    1 if cell[0] == row else 2)
            key = _range_key(sl)
            if key not in best or rank < best[key][0]:
                best[key] = (rank, sl, blocks[cell])
        return [(sl, blk) for _, sl, blk in best.values()]

    def gather(self, blocks: dict, shape, device=None, dtype=None,
               row=None) -> torch.Tensor:
        """The whole tensor from `blocks` on `device` (default cell
        (0, 0)'s), in `dtype` (default the blocks'; each block is cast
        before it is moved): `assemble` of `ranges(blocks, shape, device,
        row)`, so a range is read where it is held on `device` or in data
        row `row`."""
        device = self.grid.device(0, 0) if device is None else device
        return assemble(self.ranges(blocks, shape, device, row), shape,
                        device, dtype)


@functools.lru_cache(maxsize=4096)
def _indices(placement: Placement, shape: tuple) -> dict:
    return placement._indices(shape)


def assemble(parts, shape, device, dtype=None) -> torch.Tensor:
    """The tensor of `shape` on `device` whose index ranges are `parts`,
    (slices, block) pairs that tile it, each block cast to `dtype`
    (default its own) before it is moved; differentiable in the blocks.
    One whole block comes back as itself where it already has the device
    and type, else as a new tensor."""
    parts = list(parts)
    dtype = parts[0][1].dtype if dtype is None else dtype
    if len(parts) == 1 and all(s == slice(None) for s in parts[0][0]):
        return parts[0][1].to(dtype).to(device)
    whole = torch.empty(tuple(shape), dtype=dtype, device=device)
    for sl, block in parts:
        whole[sl] = block.to(dtype).to(device)
    return whole


def _range_key(sl: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in sl)


class Sharded:
    """A tensor laid over a grid by a `Placement`: `blocks[(i, j)]` is cell
    (i, j)'s block on `grid.device(i, j)`. Blocks of cells that share a
    device and an index range are one tensor."""

    def __init__(self, placement: Placement, shape, dtype, blocks: dict):
        self.placement = placement
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = blocks

    def block(self, i: int, j: int) -> torch.Tensor:
        return self.blocks[(i, j)]

    def ranges(self, device=None, row=None) -> list:
        """(slices, block) for each distinct index range (see
        `Placement.ranges`)."""
        return self.placement.ranges(self.blocks, self.shape, device, row)

    def replicas(self) -> list:
        """For each distinct index range, the distinct block tensors that
        hold it, in row-major order of their cells."""
        sets = {}
        for cell, sl in self.placement.indices(self.shape).items():
            held = sets.setdefault(_range_key(sl), [])
            if all(b is not self.blocks[cell] for b in held):
                held.append(self.blocks[cell])
        return list(sets.values())

    def tensors(self) -> list:
        """Every distinct block tensor once, in row-major order of first
        appearance."""
        seen, out = set(), []
        for b in self.blocks.values():
            if id(b) not in seen:
                seen.add(id(b))
                out.append(b)
        return out

    def gather(self, device=None, dtype=None, row=None) -> torch.Tensor:
        """The whole tensor (see `Placement.gather`)."""
        return self.placement.gather(self.blocks, self.shape, device, dtype,
                                     row)

    def map(self, fn) -> "Sharded":
        """`fn` applied once to each distinct block, sharing kept."""
        made = {id(b): fn(b) for b in self.tensors()}
        return Sharded(self.placement, self.shape,
                       made[id(self.tensors()[0])].dtype,
                       {c: made[id(b)] for c, b in self.blocks.items()})


def named(grid: DeviceGrid, spec: tuple) -> Placement:
    """Bind one spec to `grid` as a `Placement`."""
    return Placement(grid, tuple(spec))


def tree_named(grid: DeviceGrid, spec_tree_):
    """Bind a tree of specs to `grid` (leaf-wise `named`)."""
    return tree_map(lambda s: named(grid, s), spec_tree_, is_leaf=is_spec)


def place_tree(grid: DeviceGrid, spec_tree_, tree):
    """`tree`'s tensors laid over `grid` by the matching specs of
    `spec_tree_`, as a tree of `Sharded` (`device_put` with
    `tree_named`'s placements)."""
    return tree_map(lambda pl, x: pl.place(x), tree_named(grid, spec_tree_),
                    tree)
