"""An LM run over the data rows of a `DeviceGrid`: the port's part of what
GSPMD does for the reference's `lm_cell` and `Trainer`.

The parameters are stored as `Sharded` leaves (one block per cell, laid
out by `tree_named(grid, param_spec(rules))`). A forward runs the model
once per data row i, on `grid.device(i, 0)`, over that row's slice of the
batch (the whole batch on row 0 alone where it does not divide the data
axes), all rows of a block before the next (`Model.forward_rows`). Each
group's weights are gathered onto each row's device at use, inside the
group's recomputed function, so a backward pass gathers them again;
under `cfg.fsdp_constrain` each >= 2-D f32 weight is cast to `cfg.dtype`
before it is gathered, as the reference casts before its all-gather. A
row reads each index range from the block held on its own device where
there is one, else from a cell of its own data row (`Placement.ranges`),
so a weight replicated over "data" is read from each row's own replica.

Gradients come back through the gathers to the blocks read; the blocks
of one index range are summed (`range_grads`, the all-reduce over their
replicas). AdamW (`update`) clips those per-range gradients by their
global norm, then applies each range's gradient to every block that holds
the range, params and both moments alike, each on its own device: as
each device of a GSPMD program updates its own replica, so replicas stay
equal without a copy between them. On a grid whose cells share one card
every range has one block, and nothing is stored twice.

Design choice (ROADMAP.md queue C 5): outside the MoE's `shard_map`
body, the reference leaves the split of the compute over "model" to
GSPMD. The port computes each row's shard whole on the row's device from
the gathered weights; results equal the reference's up to the order of
reductions. On a grid whose cells share one card, splitting the matmuls
over model shards would only add launches. The MoE blocks split the
expert hidden dim over the model shards where the reference does: with
`cfg.shmap_axes` set (`lm_cell`) each row's tokens are routed alone and
`moe.apply_moe(model_shards=M)` computes M slices; without it (the
`Trainer`) the rows' tokens are routed as one batch on row 0's device,
the single-device semantics GSPMD keeps.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed.sharding import (
    COLLECTIVES, DeviceGrid, Placement, Sharded, assemble, data_size)
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.model import Model

__all__ = ["GridRun", "batch_rows", "range_grads", "update",
           "zero_moments"]


def _replica_sets(tree) -> list:
    """For each index range of every `Sharded` leaf (leaves in tree
    order), the distinct blocks that hold it."""
    return [held for s in tree_leaves(tree) for held in s.replicas()]


@functools.lru_cache(maxsize=1024)
def _held_by_cell(placement: Placement, shape: tuple) -> dict:
    return {cell: math.prod(len(range(*s.indices(n)))
                            for s, n in zip(sl, shape))
            for cell, sl in placement.indices(shape).items()}


def _held(placement: Placement, shape: tuple, cell: tuple) -> int:
    """Elements of a `shape` tensor that `cell` holds under `placement`."""
    return _held_by_cell(placement, tuple(shape))[cell]


def _count_gathers(leaves: list, rows: int, one_group: bool = False,
                   dtype_of=None) -> None:
    """Count, for each data row r < `rows`, the bytes of every `Sharded`
    leaf that r's cell (r, 0) gathers and does not hold (one group's
    slice when `one_group`) as all-gather bytes into (r, 0), in
    `dtype_of(leaf)` (default the leaf's type)."""
    for r in range(rows):
        total = 0
        for s in leaves:
            missing = math.prod(s.shape) - _held(s.placement, s.shape, (r, 0))
            if one_group:
                missing //= s.shape[0]
            dt = s.dtype if dtype_of is None else dtype_of(s)
            total += missing * dt.itemsize
        COLLECTIVES.add("all-gather", (r, 0), total)


def range_grads(sets: list, grads) -> list:
    """Gradients of the blocks of `sets` (flattened in order; None where a
    block was not read) -> one per index range: its blocks' gradients
    summed in cell order on its first block's device."""
    grads, out = iter(grads), []
    for held in sets:
        total = None
        for blk in held:
            g = next(grads)
            if g is not None:
                total = g.to(held[0].device) if total is None else \
                    total.add_(g.to(total.device))
        out.append(torch.zeros_like(held[0]) if total is None else total)
    return out


def n_rows(grid: DeviceGrid, batch_size: int) -> int:
    """The data rows a batch of `batch_size` runs on: every data shard
    where it divides them, else data row 0 alone (the batch replicated)."""
    dp = data_size(grid)
    return dp if batch_size % dp == 0 else 1


def batch_rows(grid: DeviceGrid, batch: dict) -> list:
    """A whole batch (tensors) -> one dict per data row, on the row's
    device: contiguous slices of the batch dim (`n_rows`)."""
    size = next(iter(batch.values())).shape[0]
    rows = n_rows(grid, size)
    return [{k: v[r * (size // rows):(r + 1) * (size // rows)].to(
        grid.device(r, 0)) for k, v in batch.items()} for r in range(rows)]


class GridRun:
    """`model` with parameters `params` (a tree of `Sharded`) run over
    `grid`'s data rows."""

    def __init__(self, model: Model, grid: DeviceGrid, params):
        self.model, self.cfg, self.grid = model, model.cfg, grid
        self.params = params

    # ------------------------------------------------------ the rows
    def rows(self, count: int) -> T.Rows:
        """The `Rows` of one forward over data rows 0..count-1: the top
        level (and the audio encoder) gathered on each row's device now,
        each group's weights at use, from the blocks' per-group views
        (each block split once along its groups axis). Rows on one device
        that read the same blocks share what is gathered."""
        cfg, grid = self.cfg, self.grid
        devs = [grid.device(r, 0) for r in range(count)]
        cast = cfg.dtype if cfg.fsdp_constrain else None
        dec = self.params["decoder"] if cfg.family == "audio" \
            else self.params
        top = {k: v for k, v in dec.items() if k != "groups"}
        groups = tree_leaves(dec["groups"])

        def read(tree):
            # per row, per leaf: the (slices, block) pairs the row reads
            return [[s.ranges(devs[r], r) for s in tree_leaves(tree)]
                    for r in range(count)]

        def per_row(build, reads):
            made, out = {}, []
            for r in range(count):
                key = (devs[r], tuple(id(blk) for parts in reads[r]
                                      for _, blk in parts))
                if key not in made:
                    made[key] = build(r)
                out.append(made[key])
            return out

        def whole(tree):
            reads = read(tree)
            _count_gathers(tree_leaves(tree), count)
            return per_row(lambda r: tree_unflatten(tree, [
                assemble(parts, s.shape, devs[r]) for parts, s in
                zip(reads[r], tree_leaves(tree))]), reads)

        reads = read(dec["groups"])
        views = {}
        for row in reads:
            for parts in row:
                for _, blk in parts:
                    if id(blk) not in views:
                        views[id(blk)] = blk.unbind(0)

        def params(gi):
            if gi is None:
                return whole(top)

            def build(r):
                leaves = []
                for parts, s in zip(reads[r], groups):
                    w = views[id(parts[0][1])][gi]
                    dt = cast if (cast is not None and len(s.shape) >= 3 and
                                  w.dtype == torch.float32) else None
                    leaves.append(assemble(
                        [(sl[1:], views[id(blk)][gi]) for sl, blk in parts],
                        s.shape[1:], devs[r], dt))
                return tree_unflatten(dec["groups"], leaves)
            _count_gathers(groups, count, one_group=True, dtype_of=lambda s: (
                cast if cast is not None and len(s.shape) >= 3 and
                s.dtype == torch.float32 else s.dtype))
            return per_row(build, reads)

        m_size = grid.shape[1]

        def moe(ps, hs):
            if cfg.shmap_axes:
                outs = [MOE.apply_moe(p, h, cfg, m_size) for p, h in
                        zip(ps, hs)]
                aux = torch.stack([a.to(devs[0]) for _, a in outs]).mean()
                return [y for y, _ in outs], aux
            sizes = [h.shape[0] for h in hs]
            y, aux = MOE.apply_moe(ps[0], torch.cat(
                [h.to(devs[0]) for h in hs]), cfg)
            return [part.to(d) for part, d in
                    zip(torch.split(y, sizes), devs)], aux

        encoder = None
        if cfg.family == "audio":
            enc = {k: v for k, v in self.params.items() if k != "decoder"}
            encoder = lambda: whole(enc)  # noqa: E731
        return T.Rows(params, moe, encoder)

    # -------------------------------------------------- the entry points
    def grads(self, batch: dict, grad_accum: int = 1):
        """(loss, metrics, grads) of one whole batch (tensors): grad_accum
        micro-batches, each split over the data rows that divide it
        (`Model.loss_rows`), their gradients (one per index range,
        `range_grads`) summed in order and divided by grad_accum; metrics
        those of the last micro-batch."""
        sets = _replica_sets(self.params)
        leaves = [blk for held in sets for blk in held]
        size = next(iter(batch.values())).shape[0]
        if size % grad_accum:
            raise ValueError(f"batch of {size} does not split into "
                             f"grad_accum={grad_accum} micro-batches")
        mb = size // grad_accum
        for p in leaves:
            p.requires_grad_(True)
        try:
            grads, loss_sum = None, 0
            with torch.enable_grad():
                for m in range(grad_accum):
                    part = batch_rows(self.grid, {
                        k: v[m * mb:(m + 1) * mb] for k, v in batch.items()})
                    loss, metrics = self.model.loss_rows(
                        self.rows(len(part)), part)
                    if len(part) > 1:
                        self._count_grad_sums()
                    g = range_grads(sets, torch.autograd.grad(
                        loss, leaves, allow_unused=True))
                    grads = g if grads is None else [
                        a.add_(b) for a, b in zip(grads, g)]
                    loss_sum = loss_sum + loss.detach()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if grad_accum == 1:
            return loss.detach(), metrics, grads
        return loss_sum / grad_accum, metrics, [g / grad_accum
                                                for g in grads]

    def _count_grad_sums(self) -> None:
        """The gradients of several data rows summed into each cell's
        ranges: every cell receives its ranges' f32 gradient as
        all-reduce bytes (`COLLECTIVES`)."""
        grid = self.grid
        leaves = tree_leaves(self.params)
        for i in range(grid.shape[0]):
            for j in range(grid.shape[1]):
                COLLECTIVES.add("all-reduce", (i, j), 4 * sum(
                    _held(s.placement, s.shape, (i, j)) for s in leaves))

    @torch.no_grad()
    def prefill(self, batch: dict):
        """`Model.prefill` of a whole batch over the data rows -> (last
        logits, caches), whole tensors on cell (0, 0)'s device (the rows'
        parts concatenated along the batch dim)."""
        rows = batch_rows(self.grid, batch)
        logits, _, caches, _ = self.model.forward_rows(
            self.rows(len(rows)), rows, "prefill")
        dev = self.grid.device(0, 0)
        last = torch.cat([lg[:, -1:].to(dev) for lg in logits])
        whole = tree_map(lambda *cs: torch.cat([c.to(dev) for c in cs], 1),
                         *caches)
        return last, whole

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, caches, index: int):
        """`Model.decode_step` over the data rows, from `caches` laid out
        by `cache_pytree_spec` (a tree of `Sharded`). Each row attends to
        its own blocks of every KV cache (seq blocks in order, each on
        its cell's device; the new k/v written into the block holding the
        slot, in place); an SSM or cross cache is gathered per row and,
        for SSM states, laid out again after the step. Returns (logits on
        cell (0, 0)'s device, the caches)."""
        grid = self.grid
        count = n_rows(grid, tokens.shape[0])
        per = tokens.shape[0] // count
        rows = [{"tokens": tokens[r * per:(r + 1) * per].to(
            grid.device(r, 0))} for r in range(count)]
        row_caches = [self._row_caches(caches, r, count, per)
                      for r in range(count)]
        logits, _, out, _ = self.model.forward_rows(
            self.rows(count), rows, "decode", row_caches, index)
        dev = grid.device(0, 0)
        for i, entry in enumerate(caches):
            if "ssm" in entry:
                entry["ssm"] = type(entry["ssm"])(*(
                    s.placement.place(torch.cat(
                        [o[i]["ssm"][k].to(dev) for o in out], 1))
                    for k, s in enumerate(entry["ssm"])))
        return torch.cat([lg.to(dev) for lg in logits]), caches

    def _row_caches(self, caches, r: int, count: int, per: int):
        """Row r's view of the laid-out caches: per KV cache the list of
        its distinct seq blocks (cells of row r, or every cell where the
        batch is replicated), in seq order; every other leaf gathered
        whole on the row's device and cut to the row's batch slice."""
        grid = self.grid
        dev = grid.device(r, 0)
        cells = ([(r, j) for j in range(grid.shape[1])] if count > 1 else
                 [(i, j) for i in range(grid.shape[0])
                  for j in range(grid.shape[1])])
        out = []
        for entry in caches:
            row = {}
            for key, c in entry.items():
                if key == "kv":
                    index = c.k.placement.indices(c.k.shape)
                    seen, blocks = set(), []
                    for cell in sorted(cells, key=lambda x: (
                            index[x][3].start or 0)):
                        start = index[cell][3].start or 0
                        if start not in seen:
                            seen.add(start)
                            blocks.append(type(c)(*(s.block(*cell)
                                                    for s in c)))
                            if cell != (r, 0):
                                # the block's attention partial (out, max,
                                # sum in f32) goes to the row's cell
                                g, hd = c.k.shape[0], c.k.shape[-1]
                                COLLECTIVES.add(
                                    "collective-permute", (r, 0),
                                    4 * g * per * self.cfg.num_heads *
                                    (hd + 2))
                    row[key] = blocks
                else:
                    row[key] = tree_map(
                        lambda s: s.gather(dev, row=r)[:, r * per:(r + 1) * per]
                        if count > 1 else s.gather(dev, row=r), c)
            out.append(row)
        return out


def zero_moments(params, count_device):
    """AdamW's zero state for `params` (a tree of `Sharded`): f32 moments
    laid out as the params, each block made on its device, sharing kept;
    the count a 0-d int32 tensor on `count_device`."""
    from repro_torch.training.optimizer import AdamState

    def zeros(s):
        return s.map(lambda b: torch.zeros(b.shape, dtype=torch.float32,
                                           device=b.device))
    return AdamState(tree_map(zeros, params), tree_map(zeros, params),
                     torch.zeros((), dtype=torch.int32, device=count_device))


def update(opt, grads: list, opt_state, params):
    """AdamW over a grid, in place: `grads` one per index range of
    `params` (`range_grads` order) are clipped by their global norm, and
    each then updates every block that holds its range, in `params` and
    in both moments of `opt_state` (an `AdamState` of `Sharded` trees laid
    out as `params`). Returns the new count and the metrics {"grad_norm",
    "lr"}."""
    from repro_torch.training.optimizer import adamw_step, clip_by_global_norm

    count = opt_state.count
    if isinstance(count, Sharded):
        count = count.block(0, 0)
    grads, gnorm = clip_by_global_norm(grads, opt.clip_norm)
    count = count + 1
    blocks = ([], [], [], [])
    for g, *held in zip(grads, _replica_sets(params),
                        _replica_sets(opt_state.mu),
                        _replica_sets(opt_state.nu), strict=True):
        for p, mu, nu in zip(*held, strict=True):
            for out, x in zip(blocks, (p, g, mu, nu)):
                out.append(x)
    lr = adamw_step(opt, count, *blocks)
    return count, {"grad_norm": gnorm, "lr": lr}
