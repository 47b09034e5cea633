"""The fused valuation step: distance -> full-width stable sort -> method
tables -> accumulator update, in ONE kernel launch per streaming step.

Counterpart of `repro.kernels.sti_megakernel` (the Pallas kernels
`sti_megakernel` and `point_megakernel`). For one test batch of tb points
against n train points, with r[p, i] the stable rank of train point i
under test point p (ties by index) and the method's tables built on the
SORTED stream (`stream_kernels.make_megakernel_tables`):

    sti / sii:  acc[a, b] += sum_p g[p, max(r[p, off + a], r[p, b])]
                diag[a]   += sum_p u[p, r[p, off + a]]
    points:     vec[a]    += sum_p vals[p, r[p, off + a]]

on the (nr, n) / (nr,) row block whose row a is train point off + a
(off = `row_offset`; the whole square when it is None). acc, diag and vec
are updated IN PLACE, which replaces the Pallas kernel's
`input_output_aliases`.

`*_cuda` launches the cooperative kernel of `csrc/sti_megakernel.cu` on
CUDA tensors (or raises) and takes `*_plain`, the same step in plain
PyTorch, on CPU tensors. `compute_dtype="bfloat16"` rounds only the
distance cross term's operands to bf16 (f32 accumulate); the norms, the
sort keys and every table stay f32, as in the TPU kernel.

`megakernel_rank_phase_cuda` runs the kernel's rank phase alone and
returns the sorted (d2, index) stream, so tests and the chip smoke run can
hold the sort bit for bit against `torch.sort(stable=True)`. The sort is
a stable LSD radix sort of `RADIX_BITS`-bit digits over tiles of
`SORT_TILE` keys; `radix_passes` says how many passes it takes on a row
(a digit that is the same for every key - min of the row takes none,
down to two passes).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sti_knn import ranks_from_order
from repro_torch.kernels.build import library
from repro_torch.kernels.distance import tma_operands
from repro_torch.kernels.sti_fill import add_tile_sum
from repro_torch.kernels.stream_kernels import make_megakernel_tables
from repro_torch.launch.hlo_analysis import (
    KERNELS, point_megakernel_cost, sti_megakernel_cost)

__all__ = [
    "MEGAKERNEL_FILL",
    "MEGAKERNEL_PARAMS",
    "megakernel_static",
    "merge_sorted_tile",
    "streaming_merge_reference",
    "RADIX_BITS",
    "SORT_KEYS_PER_THREAD",
    "SORT_THREADS",
    "SORT_TILE",
    "radix_passes",
    "megakernel_rank_phase_plain",
    "megakernel_rank_phase_cuda",
    "sti_megakernel_plain",
    "sti_megakernel_cuda",
    "point_megakernel_plain",
    "point_megakernel_cuda",
]

# the registry/CLI name that routes a streaming step to this module
MEGAKERNEL_FILL = "megakernel"

# the static knobs the step factories accept as fill_params (the TPU
# kernel's tile shapes have no counterpart here: one cooperative grid
# covers the card)
MEGAKERNEL_PARAMS = frozenset(("compute_dtype",))

_COMPUTE_DTYPES = ("float32", "bfloat16")

# what the kernel's table phase computes (`enum Kind` in the CUDA source)
_INTERACTION_KINDS = {"sti": 1, "sii": 2}
_POINT_KINDS = {"knn_shapley": 3, "loo": 7}
_WKNN_KINDS = {"rbf": 4, "inverse": 5, "uniform": 6}
# int32 (tb, n) scratch planes: the sorted keys and indices, then two
# buffers of (key, index) pairs for the radix passes between, over which
# the method's tables lie once the row is sorted (`csrc/sti_megakernel.cu`)
_PLANES = 6

# the kernel's sort (`csrc/sti_megakernel.cu`): digits of RADIX_BITS bits,
# ranked in tiles of SORT_TILE keys, SORT_KEYS_PER_THREAD for each of the
# block's SORT_THREADS threads
RADIX_BITS = 8
SORT_THREADS = 256
SORT_KEYS_PER_THREAD = 16
SORT_TILE = SORT_THREADS * SORT_KEYS_PER_THREAD

# sentinel distance for padded columns of the merge: sorts after every real
# entry, including the online service's ~1e30 dead-slot distances
_PAD_D2 = float("inf")


def megakernel_static(fill_params) -> tuple:
    """Filter a fill_params dict down to the megakernel's static knobs and
    return them as a hashable sorted tuple (unknown keys, such as the TPU
    kernel's tile shapes or a square fill's `chunk`, are dropped)."""
    params = {key: value for key, value in dict(fill_params or {}).items()
              if key in MEGAKERNEL_PARAMS}
    return tuple(sorted(params.items()))


def _round_bf16(compute_dtype) -> bool:
    name = str(compute_dtype).replace("torch.", "")
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {_COMPUTE_DTYPES}, got "
            f"{compute_dtype!r}"
        )
    return name == "bfloat16"


# ------------------------------------------------------------ online merge
# The TPU kernel's streaming merge, kept as the specification of the sort:
# the step never calls it (the CUDA kernel radix-sorts and the plain step
# uses torch.sort), and the tests hold both against it.
def merge_sorted_tile(d2_run, idx_run, match_run, d2_tile, idx_tile,
                      match_tile):
    """One online merge step of the streaming sort: the w smallest entries
    of the union of a running (..., w) triple, sorted by (d2, index), and
    one tile's (..., bn) distances, GLOBAL column indices and matches.

    torch has no multi-key sort. The real indices are unique, so a stable
    sort by index followed by a stable sort by d2 gives the lexicographic
    (d2, index) order, the tie-break of `torch.sort(stable=True)`; the
    running triple's padding entries all carry (inf, n, 0) and are equal
    whatever their order."""
    keep = d2_run.shape[-1]
    d2 = torch.cat([d2_run, d2_tile], dim=-1)
    idx = torch.cat([idx_run, idx_tile], dim=-1)
    match = torch.cat([match_run, match_tile], dim=-1)
    d2, idx, match = _stable_by(idx, d2, idx, match)
    d2, idx, match = _stable_by(d2, d2, idx, match)
    return d2[..., :keep], idx[..., :keep], match[..., :keep]


def _stable_by(key, *arrays):
    """`arrays` permuted along the last axis by a stable sort of `key`."""
    o = torch.sort(key, dim=-1, stable=True).indices
    return tuple(torch.gather(a, -1, o) for a in arrays)


def streaming_merge_reference(d2, match, *, n_keep=None, block_n=128):
    """Drive `merge_sorted_tile` over precomputed (t, n) distances, one
    train tile of `block_n` columns at a time, and return the (t, n_keep)
    sorted (d2, index, match) triple (`n_keep=None` keeps all n)."""
    t, n = d2.shape
    keep = n if n_keep is None else int(n_keep)
    dev = d2.device
    run = (
        torch.full((t, keep), _PAD_D2, dtype=torch.float32, device=dev),
        torch.full((t, keep), n, dtype=torch.int64, device=dev),
        torch.zeros((t, keep), dtype=torch.float32, device=dev),
    )
    step = max(1, int(block_n))
    for start in range(0, n, step):
        end = min(n, start + step)
        cols = torch.arange(start, end, device=dev).expand(t, end - start)
        run = merge_sorted_tile(
            *run, d2[:, start:end].to(torch.float32), cols,
            match[:, start:end].to(torch.float32),
        )
    return run


# ------------------------------------------------------ plain step versions
def _megakernel_d2(xb, x_train, bf16: bool) -> torch.Tensor:
    """(tb, n) f32 squared distances as the kernel forms them: norms from
    the f32 inputs, the cross term on f32 or bf16-rounded operands with
    f32 accumulation, clamped at 0 (the `pairwise_sq_dists` expression)."""
    xt = xb.to(torch.float32)
    xn = x_train.to(torch.float32)
    qt, qn = ((xt.to(torch.bfloat16).to(torch.float32),
               xn.to(torch.bfloat16).to(torch.float32)) if bf16 else (xt, xn))
    d2 = (
        torch.sum(xt * xt, -1, keepdim=True)
        - 2.0 * (qt @ qn.T)
        + torch.sum(xn * xn, -1)[None, :]
    )
    return torch.clamp_min(d2, 0.0)


def _sort_keys(d2: torch.Tensor) -> torch.Tensor:
    """(..., n) f32 distances -> the kernel's unsigned sort keys as int64:
    the f32 bits, -0 made +0 (for d2 >= 0 their order is the floats')."""
    bits = d2.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    return torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)


def radix_passes(d2: torch.Tensor) -> torch.Tensor:
    """(tb,) int32: the passes the kernel's sort takes on each row of (tb,
    n) distances, one for each RADIX_BITS-bit digit of key - min(key)
    that differs between two keys of the row, and at least two (the first
    reads the keys, the last writes the rows; a pass by a digit that every
    key shares is the identity)."""
    x = _sort_keys(d2)
    x = x - x.min(-1, keepdim=True).values
    passes = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for shift in range(0, 32, RADIX_BITS):
        digit = (x >> shift) & ((1 << RADIX_BITS) - 1)
        passes += (digit != digit[..., :1]).any(-1).to(torch.int32)
    return passes.clamp_min(2)


def megakernel_rank_phase_plain(xb, x_train, *, compute_dtype="float32",
                                with_passes=False):
    """The rank phase in plain PyTorch: (tb, n) sorted f32 distances and
    the int64 train indices in (d2, index) order, and with `with_passes`
    the (tb,) `radix_passes` the kernel takes on them."""
    d2 = _megakernel_d2(xb, x_train, _round_bf16(compute_dtype))
    out = torch.sort(d2, dim=-1, stable=True)
    if with_passes:
        return out.values, out.indices, radix_passes(d2)
    return out.values, out.indices


def _row_offset(row_offset, nr: int, n: int) -> int:
    off = 0 if row_offset is None else int(row_offset)
    if off < 0 or off + nr > n:
        raise ValueError(
            f"row block [{off}, {off + nr}) does not fit in n={n} train rows"
        )
    return off


def _sorted_tables(method, k, opts, xb, yb, mask, x_train, y_train,
                   compute_dtype):
    """Rank phase + the method's sorted tables -> (ranks, tables)."""
    d2s, order = megakernel_rank_phase_plain(xb, x_train,
                                             compute_dtype=compute_dtype)
    match_s = (y_train[order] == yb[:, None]).to(torch.float32)
    tables = make_megakernel_tables(method, k, opts=opts)(
        d2s, match_s, mask.to(torch.float32))
    return ranks_from_order(order), tables


def sti_megakernel_plain(acc, diag, xb, yb, mask, x_train, y_train, *, k,
                         mode="sti", row_offset=None,
                         compute_dtype="float32"):
    """One fused interaction step in plain PyTorch, in place on the (nr, n)
    acc row block and its (nr,) diag; returns (acc, diag). Each acc
    element sums the step's test points from zero in order p = 0, 1, ...
    and adds that sum once (`add_tile_sum`), as the kernel and the JAX
    kernel do."""
    nr, n = acc.shape
    off = _row_offset(row_offset, nr, n)
    ranks, (g, u) = _sorted_tables(mode, k, None, xb, yb, mask, x_train,
                                   y_train, compute_dtype)
    gt = torch.gather(g, 1, ranks)
    rows = slice(off, off + nr)
    add_tile_sum(acc, ranks[:, rows], gt[:, rows], ranks, gt)
    diag.add_(torch.gather(u, 1, ranks)[:, rows].sum(0))
    return acc, diag


def point_megakernel_plain(vec, xb, yb, mask, x_train, y_train, *, method,
                           k, opts=None, row_offset=None,
                           compute_dtype="float32"):
    """One fused point-value step in plain PyTorch, in place on the (nr,)
    vec row block; returns vec."""
    nr, n = vec.shape[0], x_train.shape[0]
    off = _row_offset(row_offset, nr, n)
    ranks, vals = _sorted_tables(method, k, opts, xb, yb, mask, x_train,
                                 y_train, compute_dtype)
    vec.add_(torch.gather(vals, 1, ranks)[:, off:off + nr].sum(0))
    return vec


# --------------------------------------------------------- kernel wrappers
def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _point_kind(method: str, opts: Optional[dict]) -> int:
    if method == "wknn":
        weights = dict(opts or {}).get("weights", "rbf")
        if weights not in _WKNN_KINDS:
            raise ValueError(f"unknown wknn weight kind {weights!r}")
        return _WKNN_KINDS[weights]
    if method not in _POINT_KINDS:
        raise ValueError(
            f"the megakernel has no table phase for point method "
            f"{method!r}; it has: {sorted(_POINT_KINDS) + ['wknn']}"
        )
    return _POINT_KINDS[method]


def _operands(xb, yb, mask, x_train, y_train):
    """Check the batch and train operands and bring them to the kernel's
    types: f32 contiguous features, int32 labels, f32 mask (no copy when
    they already are)."""
    dev = xb.device
    for x in (yb, mask, x_train, y_train):
        if x.device != dev:
            raise ValueError(
                f"all operands must share a device: {dev} vs {x.device}"
            )
    if xb.ndim != 2 or x_train.ndim != 2 or xb.shape[1] != x_train.shape[1]:
        raise ValueError(
            f"features must be (tb, d) and (n, d): {tuple(xb.shape)}, "
            f"{tuple(x_train.shape)}"
        )
    tb, n = xb.shape[0], x_train.shape[0]
    if yb.shape != (tb,) or mask.shape != (tb,) or y_train.shape != (n,):
        raise ValueError(
            f"labels and mask must be (tb,) and (n,): {tuple(yb.shape)}, "
            f"{tuple(mask.shape)}, {tuple(y_train.shape)}"
        )
    for y in (yb, y_train):
        if y.dtype.is_floating_point or y.dtype == torch.bool:
            raise TypeError(f"labels must be integer, got {y.dtype}")
    xb, x_train = _features(xb, x_train)
    return (xb, yb.to(torch.int32).contiguous(),
            mask.to(torch.float32).contiguous(), x_train,
            y_train.to(torch.int32).contiguous())


def _features(xb, x_train):
    """The f32 features as the distance phase takes them: contiguous, rows
    padded to 16 bytes and aligned (`tma_operands`, the distance kernel's
    contract); no copy for f32 contiguous features with d % 4 == 0."""
    return tma_operands(xb.to(torch.float32).contiguous(),
                        x_train.to(torch.float32).contiguous())


def _state(x: torch.Tensor, shape: tuple, name: str) -> None:
    if x.shape != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"{name} must be contiguous float32, got {x.dtype}")


def _launch(fn_name: str, argtypes: list, *args, dev) -> None:
    fn = getattr(library("sti_megakernel"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"megakernel launch refused or failed: CUDA error {rc} (a "
            f"cooperative launch needs every block resident on the card)"
        )


def _abstract_step(name, acc, vec, xb, yb, mask, x_train, y_train,
                   row_offset) -> None:
    """The meta path of a step: the launch's checks, then its cost (the
    formula of the square step, `hlo_analysis`) added to `KERNELS`."""
    xb, yb, mask, x_train, y_train = _operands(xb, yb, mask, x_train,
                                               y_train)
    (tb, d), n, nr = xb.shape, x_train.shape[0], vec.shape[0]
    _state(vec, (nr,), "diag/vec")
    if acc is not None:
        _state(acc, (nr, n), "acc")
    _row_offset(row_offset, nr, n)
    cost = (sti_megakernel_cost if acc is not None
            else point_megakernel_cost)(tb, n, d)
    KERNELS.add(name, cost)


_STEP_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p]


def _step_cuda(acc, vec, xb, yb, mask, x_train, y_train, *, k, kind,
               row_offset, compute_dtype) -> bool:
    """Launch one step of the kernel; returns whether it launched (an
    empty batch, train set or row block has nothing to do)."""
    xb, yb, mask, x_train, y_train = _operands(xb, yb, mask, x_train,
                                               y_train)
    (tb, d), n, nr = xb.shape, x_train.shape[0], vec.shape[0]
    _state(vec, (nr,), "diag/vec")
    if acc is not None:
        _state(acc, (nr, n), "acc")
    if vec.device != xb.device or (acc is not None
                                   and acc.device != xb.device):
        raise ValueError("state and operands must share a device")
    off = _row_offset(row_offset, nr, n)
    bf16 = _round_bf16(compute_dtype)
    if k < 1:
        raise ValueError("k must be >= 1")
    if tb == 0 or n == 0 or nr == 0:
        return False
    dev = xb.device
    # the norms, then the recurrence's coefficient at each sorted position
    norms = torch.empty((tb + 2 * n,), dtype=torch.float32, device=dev)
    scratch = torch.empty((_PLANES, tb, n), dtype=torch.int32, device=dev)
    _launch("valuation_megakernel", _STEP_ARGTYPES,
            None if acc is None else acc.data_ptr(), vec.data_ptr(),
            xb.data_ptr(), yb.data_ptr(), mask.data_ptr(), x_train.data_ptr(),
            y_train.data_ptr(), norms.data_ptr(), scratch.data_ptr(),
            tb, n, d, nr, off, int(k), kind, int(bf16), dev=dev)
    return True


def sti_megakernel_cuda(acc, diag, xb, yb, mask, x_train, y_train, *, k,
                        mode="sti", row_offset=None, compute_dtype="float32"):
    """One fused interaction step in place on (acc, diag); returns them.
    CPU tensors take `sti_megakernel_plain`; CUDA tensors launch the
    kernel once (or raise). Meta tensors in the dry run
    (`KERNELS.counting()`) add the kernel's cost to
    `hlo_analysis.KERNELS`. `sti_megakernel_cuda.launches` counts
    launches."""
    if _on_cpu(acc, diag, xb, yb, mask, x_train, y_train):
        return sti_megakernel_plain(
            acc, diag, xb, yb, mask, x_train, y_train, k=k, mode=mode,
            row_offset=row_offset, compute_dtype=compute_dtype)
    if mode not in _INTERACTION_KINDS:
        raise ValueError(f"unknown interaction mode {mode!r}")
    if acc.device.type == "meta" and KERNELS.active:
        _abstract_step("sti_megakernel", acc, diag, xb, yb, mask, x_train,
                       y_train, row_offset)
        return acc, diag
    if _step_cuda(acc, diag, xb, yb, mask, x_train, y_train, k=k,
                  kind=_INTERACTION_KINDS[mode], row_offset=row_offset,
                  compute_dtype=compute_dtype):
        sti_megakernel_cuda.launches += 1
    return acc, diag


sti_megakernel_cuda.launches = 0


def point_megakernel_cuda(vec, xb, yb, mask, x_train, y_train, *, method, k,
                          opts=None, row_offset=None,
                          compute_dtype="float32"):
    """One fused point-value step ("knn_shapley", "wknn" with its `opts`
    weight kind, "loo") in place on vec; returns vec. CPU tensors take
    `point_megakernel_plain`; CUDA tensors launch the kernel once (or
    raise). Meta tensors in the dry run (`KERNELS.counting()`) add the
    kernel's cost to `hlo_analysis.KERNELS`.
    `point_megakernel_cuda.launches` counts launches."""
    if _on_cpu(vec, xb, yb, mask, x_train, y_train):
        return point_megakernel_plain(
            vec, xb, yb, mask, x_train, y_train, method=method, k=k,
            opts=opts, row_offset=row_offset, compute_dtype=compute_dtype)
    kind = _point_kind(method, opts)
    if vec.device.type == "meta" and KERNELS.active:
        _abstract_step("point_megakernel", None, vec, xb, yb, mask, x_train,
                       y_train, row_offset)
        return vec
    if _step_cuda(None, vec, xb, yb, mask, x_train, y_train, k=k, kind=kind,
                  row_offset=row_offset, compute_dtype=compute_dtype):
        point_megakernel_cuda.launches += 1
    return vec


point_megakernel_cuda.launches = 0


def megakernel_rank_phase_cuda(xb, x_train, *, compute_dtype="float32",
                               with_passes=False):
    """The kernel's rank phase alone (distances and the stable radix sort):
    (tb, n) sorted f32 distances and int64 train indices, the same as
    `megakernel_rank_phase_plain` gives, and with `with_passes` the (tb,)
    int32 radix passes each row took. CPU tensors take the plain version.
    For tests and diagnostics: its launches count on
    `megakernel_rank_phase_cuda.launches`, not on the step wrappers."""
    if _on_cpu(xb, x_train):
        return megakernel_rank_phase_plain(xb, x_train,
                                           compute_dtype=compute_dtype,
                                           with_passes=with_passes)
    if xb.device != x_train.device:
        raise ValueError("xb and x_train must share a device")
    if xb.ndim != 2 or x_train.ndim != 2 or xb.shape[1] != x_train.shape[1]:
        raise ValueError("features must be (tb, d) and (n, d)")
    xb, x_train = _features(xb, x_train)
    bf16 = _round_bf16(compute_dtype)
    (tb, d), n = xb.shape, x_train.shape[0]
    dev = xb.device
    scratch = torch.empty((_PLANES, tb, n), dtype=torch.int32, device=dev)
    passes = torch.zeros((tb,), dtype=torch.int32, device=dev)
    if tb and n:
        norms = torch.empty((tb + n,), dtype=torch.float32, device=dev)
        _launch("megakernel_rank_phase", [ctypes.c_void_p] * 5 +
                [ctypes.c_int] * 4 + [ctypes.c_void_p],
                xb.data_ptr(), x_train.data_ptr(), norms.data_ptr(),
                scratch.data_ptr(), passes.data_ptr(), tb, n, d, int(bf16),
                dev=dev)
        megakernel_rank_phase_cuda.launches += 1
    out = scratch[0].view(torch.float32), scratch[1].long()
    return out + (passes,) if with_passes else out


megakernel_rank_phase_cuda.launches = 0
