"""Cells on a device grid: counterpart of `repro.launch.specs`.

`lm_cell` builds one (arch x input shape) cell of an LM: its step
function, abstract inputs (meta tensors) and the specs that lay them over
a `DeviceGrid`; the step runs on blocks placed by `tree_named` (see
`distributed/grid_step.py` for how). `sti_cell` is the paper's workload
as a grid cell.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, tree_map
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.grid_step import GridRun, update
from repro_torch.distributed.sharding import DeviceGrid, Sharded
from repro_torch.kernels.distance import distance_cuda
from repro_torch.kernels.sti_fill import rect_row_view, sti_fill_acc_rect_cuda
from repro_torch.models import build_model
from repro_torch.training.optimizer import AdamState, AdamWConfig

__all__ = ["lm_batch_specs", "lm_cell", "sti_cell"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The abstract batch of one cell (meta tensors)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch = {"tokens": _meta((b, 1), torch.int32)}
    elif cfg.family == "vlm":
        batch = {"tokens": _meta((b, s - cfg.num_patches), torch.int32)}
    else:
        batch = {"tokens": _meta((b, s), torch.int32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patch_embeds"] = _meta((b, cfg.num_patches, cfg.d_model),
                                      cfg.dtype)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    if shape.kind == "train":
        batch["labels"] = _meta(tuple(batch["tokens"].shape), torch.int32)
    return batch


def _whole(x):
    """A batch field as one tensor: a `Sharded` gathered, a tensor as is."""
    return x.gather() if isinstance(x, Sharded) else x


def lm_cell(cfg: ModelConfig, shape: ShapeSpec, grid: DeviceGrid,
            strategy: str | None = None, opt: AdamWConfig | None = None,
            grad_accum: int = 1, cache_seq_shard: bool = True):
    """(step, args, in_specs, out_specs) of one cell, as the reference's:

    train  : step(params, opt_state, batch) -> (params, opt_state, metrics)
             grad_accum micro-batches' gradients summed in f32 and
             divided, then AdamW, every block updated in place
    prefill: step(params, batch) -> (last_logits, caches)
    decode : step(params, batch{tokens, caches, index}) -> (logits, caches)

    The rules are the reference's: inference kinds default to "tp_dp" with
    `cfg.dtype` params, train to `strategy_for(cfg)` with f32 params;
    `fsdp_constrain` is set for "fsdp", `shmap_axes = (data axes,
    "model")` for MoE configs; the batch is replicated where global_batch
    does not divide the data axes. `args` are meta tensors; the specs are
    trees of spec tuples (None where the reference leaves an output
    unconstrained). The step takes params, moments, batch fields and
    caches placed by `tree_named(grid, in_specs)` (`Sharded` leaves; a
    batch field may also be a whole tensor) and returns those of
    `out_specs` in that layout; an unconstrained output comes back whole
    on cell (0, 0)'s device. Decode attends to a seq-sharded KV cache
    block by block and combines the partials (`models.attention.
    decode_attention`); prefill's self-attention runs the flash kernel.
    The step raises without a card unless the grid names the CPU."""
    if shape.kind != "train" and strategy is None:
        strategy = "tp_dp"
    strategy = strategy or SH.strategy_for(cfg)
    da = SH.data_axes(grid)
    cfg = cfg.replace(fsdp_constrain=(strategy == "fsdp"),
                      shmap_axes=(da, "model") if cfg.num_experts else ())
    model = build_model(cfg)
    rules = SH.rules_for(cfg, strategy, grid)
    pspec = model.param_spec(rules)
    params = model.abstract(
        dtype=cfg.dtype if shape.kind != "train" else torch.float32)
    batch = lm_batch_specs(cfg, shape)
    bspec = {k: v for k, v in SH.batch_spec(cfg, shape.kind, grid).items()
             if k in batch}
    if shape.global_batch % SH.data_size(grid):
        bspec = {k: (None,) * len(v) for k, v in bspec.items()}
    opt = opt or AdamWConfig()

    if shape.kind == "train":
        def step(params, opt_state, batch):
            run = GridRun(model, grid, params)
            loss, metrics, grads = run.grads(
                {k: _whole(v) for k, v in batch.items()}, grad_accum)
            if grad_accum > 1:
                metrics = {}
            count, om = update(opt, grads, opt_state, params)
            if isinstance(opt_state.count, Sharded):
                count = opt_state.count.placement.place(count)
            return params, AdamState(opt_state.mu, opt_state.nu, count), \
                dict(metrics, loss=loss, **om)

        opt_state = AdamState(
            mu=tree_map(lambda p: _meta(p.shape, torch.float32), params),
            nu=tree_map(lambda p: _meta(p.shape, torch.float32), params),
            count=_meta((), torch.int32))
        opt_spec = AdamState(mu=pspec, nu=pspec, count=())
        return step, (params, opt_state, batch), (pspec, opt_spec, bspec), \
            (pspec, opt_spec, None)

    if shape.kind == "prefill":
        def step(params, batch):
            return GridRun(model, grid, params).prefill(
                {k: _whole(v) for k, v in batch.items()})

        return step, (params, batch), (pspec, bspec), None

    caches = model.init_caches(shape.global_batch, shape.seq_len,
                               device="meta")
    cspec = SH.cache_pytree_spec(cfg, caches, shape.kind, grid,
                                 shape.seq_len,
                                 cache_seq_shard=cache_seq_shard)
    batch = dict(batch, caches=caches, index=_meta((), torch.int32))
    bspec = dict(bspec, caches=cspec, index=())

    def step(params, batch):
        return GridRun(model, grid, params).decode(
            _whole(batch["tokens"]), batch["caches"],
            int(_whole(batch["index"])))

    return step, (params, batch), (pspec, bspec), (None, cspec)


def _check_cell(scfg, grid: DeviceGrid) -> tuple[int, int]:
    """(test points per data shard, phi columns per model shard); raises
    unless both split evenly, as the JAX cell's shard_map needs."""
    d, m = grid.shape
    n, tc = int(scfg.n_train), int(scfg.test_chunk)
    if tc % d:
        raise ValueError(f"test_chunk={tc} does not split evenly over the "
                         f"{d} data shards of the grid")
    if n % m:
        raise ValueError(f"n_train={n} does not split evenly into {m} phi "
                         f"column blocks")
    return tc // d, n // m


def sti_cell(scfg, grid: DeviceGrid):
    """The paper's workload as a grid cell (`scfg` a `STIConfig`).

    Cell (i, j) of the D x M grid takes test shard i and owns phi column
    block j:
      1-2. the exact step's head (`kernels/sti_pipeline.py::step_head`)
         on its (tc/D, d) test shard: distances to the (n, d) train set
         through the distance kernel, a stable sort per test point and
         its ranks through the rank stage's kernel, u = match / k and g
         by the reverse-cumsum recurrence;
      3. the fill phi_cols[a, jb] += g[max(rank[a], rank_cols[jb])]. phi is
         symmetric, so column block j is the transpose of the (n/M, n) row
         block j, and the cell fills that row block with the rect fill
         kernel, its row table the window at column j n/M of its ranks;
      4. `grid.psum_data` over the data shards: data row 0 holds every
         model shard's block summed over all tc test points.
    The diagonal sum, sum_p 1[y_a == y_p] / k (u gathered through the
    ranks), is taken once per data shard and summed the same way onto
    device (0, 0).

    Returns `(step, args, in_specs, out_specs)` as the JAX function does:
    `args` the (shape, dtype) of each input, the specs naming how each is
    laid over the grid. `step(x_train, y_train, x_test, y_test, col_ids=
    None, *, out=None) -> (acc, diag)`: acc[j] is model shard j's (n, n/M)
    column block on device (0, j), the reference's P(None, "model") read
    per shard (a transposed view of a contiguous row block); diag the
    (n,) sum on device (0, 0), P(None). Neither is divided by tc.
    `col_ids` is arange(n) (the default), what every caller of the
    reference passes; other ids raise. `out`, M zeroed
    contiguous (n/M, n) f32 tensors, out[j] on device (0, j), takes the
    sums in place (the row blocks of one gathered (n, n) tensor, say).
    Cells that share a device fill one accumulator, so a (2, 2) grid on
    one card holds two row blocks, not four.
    """
    from repro_torch.kernels.sti_pipeline import step_head
    from repro_torch.kernels.stream_kernels import make_update_kernel

    n, dim, k = int(scfg.n_train), int(scfg.feat_dim), int(scfg.k)
    tc, mode = int(scfg.test_chunk), scfg.mode
    tc_local, n_local = _check_cell(scfg, grid)
    d_size, m_size = grid.shape
    head = step_head(make_update_kernel(mode, k), k, distance_cuda)

    def step(x_train, y_train, x_test, y_test, col_ids=None, *, out=None):
        if tuple(x_train.shape) != (n, dim) or tuple(x_test.shape) != (tc,
                                                                        dim):
            raise ValueError(
                f"the cell takes x_train ({n}, {dim}) and x_test ({tc}, "
                f"{dim}), got {tuple(x_train.shape)} and "
                f"{tuple(x_test.shape)}")
        if col_ids is not None and not torch.equal(
                torch.as_tensor(col_ids).cpu().long(), torch.arange(n)):
            raise ValueError("col_ids takes only arange(n_train), the ids "
                             "every caller of the reference's cell passes")
        if out is not None and (len(out) != m_size or any(
                o.shape != (n_local, n) or o.dtype != torch.float32
                or not o.is_contiguous() or o.device != grid.device(0, j)
                for j, o in enumerate(out))):
            raise ValueError(f"out takes {m_size} contiguous ({n_local}, "
                             f"{n}) float32 tensors, out[j] on device "
                             f"(0, j)")
        train = {}
        for dev in dict.fromkeys(grid.devices):
            train[dev] = (x_train.to(dev, torch.float32).contiguous(),
                          y_train.to(dev))
        accs = [[None] * m_size for _ in range(d_size)]
        diags = [None] * d_size
        for j in range(m_size):
            shared = {}   # device -> column j's accumulator on it
            for i in range(d_size):
                dev = grid.device(i, j)
                xtr, ytr = train[dev]
                xt = x_test[i * tc_local:(i + 1) * tc_local].to(
                    dev, torch.float32).contiguous()
                yt = y_test[i * tc_local:(i + 1) * tc_local].to(dev)
                u, g, ranks = head(xt, yt, torch.ones(
                    (tc_local,), dtype=torch.float32, device=dev), xtr, ytr)
                if dev not in shared:
                    shared[dev] = (out[j] if out is not None and i == 0
                                   else torch.zeros((n_local, n),
                                                    dtype=torch.float32,
                                                    device=dev))
                accs[i][j] = sti_fill_acc_rect_cuda(
                    shared[dev], g, rect_row_view(ranks, j * n_local,
                                                  n_local), ranks)
                if j == 0:   # the diagonal depends on the data shard only
                    diags[i] = torch.gather(u, 1, ranks).sum(0)
        blocks = grid.psum_data(accs)
        diag = grid.psum_data([[dg] for dg in diags])[0]
        return [b.T for b in blocks], diag

    args = ((n, dim), torch.float32), ((n,), torch.int32), \
        ((tc, dim), torch.float32), ((tc,), torch.int32), \
        ((n,), torch.int32)
    in_specs = ((None, None), (None,), ("data", None), ("data",),
                ("model",))
    out_specs = ((None, "model"), (None,))
    return step, args, in_specs, out_specs
