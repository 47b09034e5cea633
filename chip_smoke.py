#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`src/repro_torch/csrc/` (one nvcc per source, all at once), holds each
kernel against its plain PyTorch version on the card, checks every method
against the O(2^n) oracle through the kernels, and drives three paths at
the full width of the paper configuration (`configs/sti_knn_paper.py`:
n = 65536, d = 768, k = 5) with t = 384 test points (one full batch of
256 and one ragged batch padded to 256):

  [4] `get_method("sti")` on the fused engine: the three-stage step, the
      distance, rank sort and fill kernels, one launch of each a step;
  [5] the same with `fill="megakernel"`: one launch of the fused
      megakernel per step, its phi held against [4]'s;
  [6] `ValuationSession(mode=m, fill="megakernel")` for each per-point
      method m, held against the three-stage step;
  [7] the sharded engine on four shards of the one card
      (`devices=["cuda"] * 4`, (16384, 65536) row blocks): sti through the
      rect fill kernel and through one megakernel launch per shard, and
      knn_shapley both ways, held against [4] and the single-device step.

and then the LM serving path at the full width and depth of qwen3-1.7b
(`src/repro_torch/configs/qwen3_1_7b.py`: 28 layers, d_model 2048, 16
query and 8 KV heads of 128, vocab 151936):

  [8] the flash-attention kernel against its plain version (f32 and bf16,
      the JAX tests' shapes, a ragged length, head dims 96 and 64 at
      s = 2048, s = 4096, the path's shape), its times and TFLOP/s beside
      `scaled_dot_product_attention`, and the bf16 kernel's SASS checked
      for wgmma (HGMMA) and TMA (UTMALDG); prefill/decode
      consistency through the kernel (4 layers, f32); then
      `Engine(ServeConfig(max_slots=4, max_len=2112))` serving 8 requests
      of 1984-2048 prompt tokens greedily to max_len - 1, every prefill
      through the kernel (28 launches a request).

and then the approximate engine and the tuner, this run's tuning cache a
fresh temporary file ($REPRO_TORCH_AUTOTUNE_CACHE), so every "auto" of
[1]-[9] resolves from the heuristic as it did before the cache existed:

  [9] `engine="approx"` (LSH top-m candidates, no kernel of its own; the
      recall probe's exact rows take the distance kernel) on [4]-[6]'s
      data at top_m = 64 with the default index (4 tables x window 32)
      and every row probed: sti and sii within the certified bound of
      [4]'s phi and an exact sii phi, phi exactly symmetric and its
      diagonal bit-equal to the exact one; the three point methods within
      the bound of [6]'s exact values (wknn with 1e-5 slack); top_m = n
      bit-identical to the exact engine; two runs, and a session
      checkpointed after batch 1 and restored, bit-identical; each step's
      time by stage (candidates, probe, values / COO emission by CUDA
      events, the host pair merge by the host clock) and peak memory;
      [9g] one full-width batch of sti's and knn_shapley's approx steps
      on the card and on the CPU, on [4]'s features rounded to integers
      under 1/16-grid planes (exact sums on both sides): tables,
      candidates, COO coordinates and probe results bit-equal, values
      within 1e-6 of max |CPU|. The bound checks above are loose on blob
      data (its recall is near zero); this one is tight;
  [9f] knn_shapley at the approx engine's own scale, n = 2^20 (3 GiB of
      features drawn on the card from a seeded torch.Generator), t = 384,
      top_m = 256, within the bound of the exact streamed engine on the
      same data, both timed;
  [10] the tuners on the card: distance, fill and rect fill have the
      CUDA kernel as their one candidate, so they time and store nothing
      and a plain winner planted under the card's keys is not served; the
      LSH index and whole-step (sti, knn_shapley) tuners with every
      candidate's time, their winners served back, an entry planted under
      the CPU platform never served, and `fill="auto"` valuations
      launching what the cache names.

and then the resilient runtime and the online service, at the paper
configuration's full width on [4]'s blob data, with a fresh tuning cache
again (so "auto" is the CUDA distance and fill):

  [11] a `ResilientValuationSession` (sti, ckpt_every=2, keep=2, async
      checkpoints of the 16 GiB accumulator) over 4 batches of 256 test
      points with a NaN fault at seq 3: rolled back to checkpoint 2,
      replayed, refolded; dropped unfinalized (the kill), restored from
      checkpoint 2 and the stream replayed (batches 0-1 skipped): phi and
      its diagonal bit-identical to a bare `ValuationSession`; launches
      equal to the folds run; each snapshot, write, sha256 pass and
      restore timed, free disk and host RAM read first;
  [12a] a `ValuationService` (sti, capacity 65536, 65280 live, test_batch
      256, eager rank caches): 4 coalesced queries of 96, remove_points of
      64 ids (bit-identical to the service's full recompute, no rank-step
      call), add_points of 64 (within 2e-5 of state / t), 2 more queries,
      get_values within 1e-5 of the offline engine on the final live set;
      every request's latency split into refold and rebase checkpoint; the
      sentinel slots finite and last in index order on the distance
      kernel; [12b] the same for knn_shapley; [12c] the reference's chaos
      drill on four shards of the card (n = 4096, d = 768, t = 64):
      every request answered, health degraded, drift <= 1e-5.

and then the "distributed" engine and the LM training path:

  [13] `get_method("sti")(engine="distributed")` at the paper
      configuration's full width on [4]'s data, on a (data 2, model 2)
      `DeviceGrid` of the one card: phi and its diagonal within 1e-6 of
      max |ref| of [4]'s phi (the same call recomputed), phi exactly
      symmetric, exactly 4 distance, 4 rank sort and 4 rect fill
      launches and no other; its time (CUDA events, then again with the allocator warm),
      one cell's rect fill alone and peak memory; sii on a (2, 2) grid at
      n = 8192 against the fused engine; `make_sti_step_fn` at full width
      (one distance, one rank sort, one square fill launch) against [4]'s
      sums;
  [14] training qwen3-1.7b: the loss and every gradient leaf on the card
      against the CPU at full width with 2 layers (f32, TF32 off, 1 x 256
      tokens; the CPU side in a process of its own, MKL in its
      reproducible mode), within 1e-4; 4 `Trainer` steps at full width and depth
      (2.03 B parameters, bf16 activations, f32 parameters and AdamW,
      remat "block", one fixed batch of 2 x 2048 tokens, warmup 1):
      finite, the last loss below the first; step time, tokens/s, peak
      memory, and one more step under torch.profiler (busy share, top
      kernels); the restart drill at the reduced config (6 steps,
      ckpt_every 3, a fresh Trainer resumes at step 6 bit for bit),
      checkpoint write and restore timed. No flash launch: training
      differentiates the blockwise attention, as the reference does.

and then the MoE, xLSTM and hybrid decoder families at full width (the
CPU sides of [14a]-[20a] in one child process, MKL in its reproducible
mode, started before [13]):

  [15] mixtral-8x7b: [15a] 1 layer, f32, 1 x 256 tokens on the card
      against the CPU (logits 1e-4 of max, aux 1e-5 relative, the MoE
      layer's routing equal) at the fan-in scale (the init scale's error
      logged beside it); [15b] the flash kernel at mixtral's attention
      shape (1, 32, 8192, 128), causal, window 4096, f32 and bf16 against
      plain, timed beside its bound and SDPA with the mask; [15c] 8 of 32
      layers (bf16) serving 4 requests of 3968-4090 tokens to max_len 4224
      (32 flash launches, the 4096-slot ring wraps); [15d] phi3.5-moe, 4
      of 32 layers, 4 requests of 1985-2039 tokens (16 launches);
  [16] xlstm-1.3b: [16a] one group, f32, 600 tokens, a prefill and 8
      decode steps card vs CPU at three scales, held at 1/16 of the
      fan-in scale, the card's own sensitivity logged at each; [16b] all
      48 blocks (f32 params, bf16 activations) serving 4 requests of
      960-1024 tokens (no flash launch), the sLSTM's share of a prefill;
  [17] jamba-v0.1-52b: [17a] one Mamba mixer, f32, 1100 tokens and 8
      decode steps card vs CPU (one launch of the fused scan); [17b] one
      group (8 of 32 layers, bf16) serving 4 requests of 1985-2039 tokens
      (4 flash launches; 42 of the scan, 7 a prefill), the Mamba layers'
      share of a prefill.

  Each served phase reports prefill ms per request, decode ms per step,
  tokens/s, peak memory and the device busy share with its top kernels
  over one prefill and 8 decode steps; its weights are drawn on the card
  at the fan-in scale (ROADMAP.md queue C 1.6), and every phase frees
  them before the next.

and then the audio and VLM families and the families' training:

  [18] whisper-small: [18a] 2 encoder and 2 decoder layers at full
      width, f32, 1 x 1500 frames and 64 prompt tokens card vs CPU (the
      encoder output, the prefill's logits at every position and 8
      decode steps from its caches, 1e-4 of max at the fan-in scale, the
      init scale's logged); [18b] the flash kernel non-causal at the
      encoder's (4, 16, 1500, 64) and the cross (4, 16, 448, 64) x
      (4, 16, 1500, 64), f32 and bf16 against plain (the ragged key edge
      at 1500 element by element), timed beside its bound and SDPA;
      [18c] 12 + 12 layers (bf16) serving 4 requests of 1500 frames and
      Whisper's 4-token prompt as one batch through `Model.prefill` (36
      flash launches: 12 encoder, 12 self, 12 cross) and decoding
      greedily through `Model.decode_step` to position 447 (no launch);
  [19] internvl2-2b: [19a] 2 layers, f32, 1 x (256 patch embeddings +
      256 tokens), prefill logits and 8 decode steps card vs CPU; [19b]
      24 layers (bf16) serving 4 requests of 256 patches + 256 tokens as
      one batch (24 flash launches) and 128 greedy decode steps, then
      `Engine(ServeConfig(max_slots=4, max_len=640))` on 4 text-only
      prompts of 500-512 tokens (24 launches a request);
  [20] training: [20a] the loss and every gradient leaf card vs CPU,
      1e-4 of max (whisper 1 + 1 layers with 1500 frames and 128 tokens,
      internvl2 2 layers with 256 + 256, mixtral 1 layer with 128 tokens,
      xlstm one group with 256 tokens, one jamba Mamba mixer with 512),
      the init scale logged beside; [20b] `Trainer` steps at full width
      (f32 params and AdamW, bf16 activations, remat "block", one fixed
      batch, params at the fan-in scale): whisper 12 + 12 layers 2 x
      (1500 + 448), internvl2 24 layers 2 x (256 + 1792), mixtral 1 layer
      1 x 2048, xlstm one group 1 x 1024, finite with the last loss below
      the first, no flash launch; [20c] the restart drill at the reduced
      config for jamba and whisper.

and then the LM on a (data 2, model 2) `DeviceGrid` of the one card
(`launch/specs.py::lm_cell`, the grid `Trainer`):

  [21] [21a] one lm_cell train step card vs CPU (the CPU side a (2, 2)
      grid of the CPU in the same child, under `MKL_CBWR=AVX2`), f32 at
      the fan-in scale: mixtral-8x7b's full width with 1 layer, fsdp (the
      `shmap_axes` MoE, capacity factor 0.5: the dropped choices logged
      on both sides), 2 x 64 tokens, and qwen3-1.7b's with 2 layers,
      tp_dp, 2 x 128; the metrics and every updated parameter leaf within
      1e-4 of max; [21b] each step synchronized, its time, tokens/s and
      peak memory logged: 3 lm_cell train steps of mixtral (1 layer,
      bf16 activations, fsdp) on 2 x 1024 tokens; 3 steps of
      `Trainer(mesh=grid)` (tp_dp) on qwen3-1.7b at full depth, 2 x 2048;
      then, f32 on those trained params, lm_cell prefill of 4 x 2048
      (56 flash launches: one a layer for each data row) and 32 lm_cell
      decode steps from KV caches seq-sharded over model, the last
      logits, the caches and every decode step's logits (over the real
      vocab: the padded columns are -1e30) within 1e-5 of max of the
      single-device `Model.prefill` / `decode_step` on the card; [21c] a checkpoint of the (2, 2) grid Trainer (reduced
      qwen3-1.7b, fsdp) restored onto (1, 1) and (4, 1) grids bit for
      bit.

and then the port's tooling and its last entry points:

  [22] the lint child and the contract checker on the card; the dry run
      of qwen3-1.7b train_4k on the production grid's meta cells (2 of
      28 layers); [22d] [21b]'s mixtral cell on a (2, 2) meta grid and on
      the card: argument bytes equal to the placed blocks exactly, and
      temp_bytes x busy cells within `TEMP_BYTES_BOUND` of one real
      step's peak above the placed state;
  [23] `launch/valuate.py` in process at n = 65536, t = 512: wknn with
      each `--weights` kind streamed and as the megakernel, `--stream`
      for sti (as is, sharded on four shards of the card, megakernel)
      and knn_shapley, and `--stream --engine approx` for both, against
      the one-shot runs; `kernels.ops`' `pairwise_distance` and
      `sti_fill` bit-equal to their kernels at the main path's shapes;
      the four `examples/*_torch.py` in process with `--device cuda` at
      their default sizes, each with its kernels' launches; at most 90 s;
  [24] the rank stage's kernel (`kernels/rank_sort.py`) at the two
      benchmark cells' shapes, 256 x 92,160 and 256 x 1,281,167 distances
      of blob features at d = 768: order and ranks bit-equal to its plain
      version (`torch.sort` + `ranks_from_order`), the passes each row
      took, its time, the plain version's and `torch.sort`'s alone by
      CUDA events beside its bound (the stage's floor: keys read, order
      and ranks written once) and the radix passes' own traffic, its peak
      memory, and its runtime launches and memsets in one call (a
      torch.profiler trace);
  [25] Mamba's fused selective scan (`kernels/selective_scan.py`) at the
      AI21-Jamba2-Mini cell's shapes: 32 rows of the cell's first batch
      of lengths (one set to the mix's clip, 1536), bf16, d_inner 8192,
      z read in place from a (b, s, 2 d_inner) tensor, against its plain
      version (the recurrence position by position) on the same tensors,
      its time beside `portbench/costs_jamba.py`'s bound at the real
      tokens; then its launches counted from zero on jamba2-mini's embed
      path (one period, 7 a `Model.embed`) and a prefill (7);
  [26] the knn point update's kernel (`kernels/point_update.py`) at the
      two cells' shapes, 256 x 1,281,167 and 32 x 650,000: a label match
      and a wknn-weighted one, a padded row, against its plain version
      (`_shapley_point_values(...).sum(0)`) within 1e-6 of max |plain|,
      two runs bit for bit, its time, its two kernels' and the plain
      version's by CUDA events beside its bound (`point_update_cost`:
      u and ranks read once, 12 bytes a key), peak memory, and its
      runtime launches in one call. The streamed knn_shapley and wknn
      paths count its launches ([7], [9f], [10], [12b], [23]); the sti,
      megakernel and approx paths count none.

Each path's launch counts are set to 0 just before it runs and read just
after. Every phase fails the run with a non-zero exit. It imports nothing
of JAX or of the JAX package. The line before the last is one JSON object
describing each kernel (launches on its path, error against the plain
version, kernel / plain / bound / library times); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import faulthandler
import gc
import io
import json
import os
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# [22d]: the dry run's temp_bytes x cells_busy over the card's peak above
# the placed state in one real step of the same cell. Both count the
# storages the step allocates and frees eagerly, so they should agree up
# to the allocator's 512-byte rounding and what the meta device cannot
# see (cuBLAS workspaces, the kernels' own scratch), a few percent at
# this cell's 9 GiB; the CPU tests hold the same bound against
# torch.profiler's allocator peak.
TEMP_BYTES_BOUND = (0.8, 1.25)

def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of `fn` by CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(torch, a, b, rows: int = 4096) -> float:
    """max |a - b| over two equal-shape tensors, a block of rows at a time
    (no full-size temporary for (65536, 65536) operands)."""
    m = 0.0
    for r0 in range(0, a.shape[0], rows):
        m = max(m, float((a[r0:r0 + rows] - b[r0:r0 + rows]).abs().max()))
    return m


def max_abs(torch, a, rows: int = 4096) -> float:
    return max(float(a[r0:r0 + rows].abs().max())
               for r0 in range(0, a.shape[0], rows))


def _costs():
    """`repro_torch.launch.hlo_analysis`: the one definition of each
    kernel's cost (operations, bytes) and of the card's data-sheet peaks
    (H100 SXM, dense, 700 W), which the dry run also counts with. `src`
    is on the path once `main` has checked the checkout."""
    from repro_torch.launch import hlo_analysis

    return hlo_analysis


def distance_ops_ms(t, n, d, elt) -> float:
    # the cross term's 2 t n d operations at the card's peak for the
    # inputs' type: the tensor cores' TF32 rate for f32, bf16 for bf16
    return 1e3 * _costs().distance_cost(t, n, d, elt).ops_s


def distance_bound_ms(t, n, d, elt) -> tuple[float, str]:
    # x_test and x_train read once, the (t, n) output written once
    return _costs().distance_cost(t, n, d, elt).bound_ms()


def distance_other_bounds_ms(t, n, d, elt) -> str:
    """The figures beside the bound: the design's own floor (f32 as three
    TF32 products, 3 x 2 t n d at the TF32 rate), the bytes with the norm
    pre-pass reading both inputs a second time, and the cross term on the
    CUDA cores at the f32 rate (the bound before the tensor-core kernel)."""
    ha = _costs()
    pre = ((t * d + n * d) * elt * 2 + t * n * 4) / ha.HBM_BYTES_PER_S
    cores = 2.0 * t * n * d / ha.F32_FLOP_PER_S
    floor = (f"3xTF32 floor {3 * distance_ops_ms(t, n, d, elt):.4f} ms, "
             if elt == 4 else "")
    return (f"{floor}bytes with the norm pre-pass {1e3 * pre:.4f} ms, f32 "
            f"CUDA-core operations {1e3 * cores:.4f} ms")


def fill_bound_ms(t, n) -> tuple[float, str]:
    # acc read and written once, g and ranks read once; the pairs on and
    # above the diagonal, then the mirror (`hlo_analysis.fill_cost`)
    return _costs().fill_cost(t, n).bound_ms()


def rect_fill_bound_ms(t, nr, n) -> tuple[float, str]:
    # the (nr, n) block read and written once, g and the rank table read
    # once; the window's diagonal square mirrored (`rect_fill_cost`)
    return _costs().rect_fill_cost(t, nr, n).bound_ms()


def sti_megakernel_bound_ms(t, n, d) -> tuple[float, str]:
    # the fill's operations on the CUDA cores and the distance's on the
    # tensor cores, the larger of the two (`sti_megakernel_cost`)
    return _costs().sti_megakernel_cost(t, n, d).bound_ms()


def point_megakernel_bound_ms(t, n, d) -> tuple[float, str]:
    # x_train and the batch read once, vec read and written once; the
    # distance's 2 t n d on the tensor cores (`point_megakernel_cost`)
    return _costs().point_megakernel_cost(t, n, d).bound_ms()


def sort_floor_ms(n, passes) -> float:
    """The megakernel sort's own traffic over the card's memory rate
    (`hlo_analysis.sort_floor_ms`)."""
    return _costs().sort_floor_ms(n, passes)


def visible_pairs(s, sk, causal, window) -> int:
    """(query, key) pairs that the causal / window masks leave visible."""
    return _costs().visible_pairs(s, sk, causal, window)


def flash_bound_ms(b, h, s, sk, d, causal, window, elt) -> tuple[float, str]:
    # q, k, v read once and out written once; two products of 2 d
    # operations per visible pair (`hlo_analysis.flash_cost`)
    return _costs().flash_cost(b, h, s, sk, d, causal, window,
                               elt).bound_ms()


def bf16_ulp(torch, x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def hold_flash(torch, gen, dev, label, b, h, s, d, causal, window, dtype,
               sk=None):
    """The flash-attention kernel against its plain version on random
    (b, h, s, d) queries and (b, h, sk, d) keys and values (sk = s by
    default) of `dtype`, element by element: f32 within 2e-5 abs + 2e-5
    rel (the same f32 function, sums in another order), bf16 within one
    bf16 ulp of the larger magnitude + 2e-5 (both round the same f32
    function once). Returns (q, k, v, max_abs_err)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)

    sk = s if sk is None else sk
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype)
               for n in (s, sk, sk))
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    del got, want
    err = float((g - w).abs().max())
    if dtype == torch.float32:
        ok = bool(((g - w).abs() <= 2e-5 + 2e-5 * w.abs()).all())
        tol = "2e-5 abs + 2e-5 rel"
    else:
        ok = bool(((g - w).abs() <= bf16_ulp(torch, torch.maximum(
            g.abs(), w.abs())) + 2e-5).all())
        tol = "1 bf16 ulp + 2e-5"
    shape = f"({b}, {h}, {s}, {d})" + (f" x sk {sk}" if sk != s else "")
    log(f"{label} flash_attention {str(dtype)[6:]} {shape} "
        f"causal={causal} window={window}: max_abs_err {err:.3e} "
        f"(tol {tol}, element by element)")
    if not ok:
        fail(f"flash attention kernel disagrees with plain at {shape} "
             f"{dtype} causal={causal} window={window}: {err}")
    return q, k, v, err


def with_clocks(fn):
    """(fn(), the card's SM clock and power draw while it ran): mean MHz
    and W over `nvidia-smi` samples taken every 100 ms beside it."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
        try:
            text = proc.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0]
    rows = []
    for ln in text.splitlines():
        try:
            mhz, watts = (float(v) for v in ln.split(","))
        except ValueError:
            continue
        rows.append((mhz, watts))
    mean = (lambda i: sum(r[i] for r in rows) / len(rows)) if rows else None
    return out, {"sm_mhz": mean(0) if rows else None,
                 "power_w": mean(1) if rows else None,
                 "samples": len(rows)}


def ptxas_usage(report: str) -> dict:
    """{mangled kernel name: registers, spill stores and loads, stack
    bytes} from an `nvcc -Xptxas -v` build log."""
    usage, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = usage.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return usage


def sass_loop(sass: str, marker: str, at_least: int) -> dict:
    """The smallest loop of a kernel's SASS (`cuobjdump -sass`) that holds
    at least `at_least` `marker` instructions: the instructions from a
    branch's target up to the branch back to it, counted by opcode
    (predicates and modifiers dropped, except the width of shared-memory
    loads); {} if there is none."""
    addrs, ops, best = [], [], {}
    for ln in sass.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if not m:
            continue
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
        op = text.split()[0] if text else ""
        addrs.append(int(m.group(1), 16))
        ops.append(op if op.startswith("LDS") else op.split(".")[0])
        b = re.search(r"BRA\s+(?:\S+,\s*)?(0x[0-9a-f]+)", text)
        if not b or int(b.group(1), 16) > addrs[-1]:
            continue
        first = next(i for i, a in enumerate(addrs)
                     if a >= int(b.group(1), 16))
        hist: dict = {}
        for o in ops[first:]:
            hist[o] = hist.get(o, 0) + 1
        if hist.get(marker, 0) >= at_least and (
                not best or sum(hist.values()) < sum(best.values())):
            best = hist
    return best


def device_busy(torch, fn, top: int = 5) -> dict | None:
    """Device time of `fn` from a torch.profiler trace: the sum of the
    durations of its kernels, copies and sets (one stream, so they do not
    overlap), the flash-attention kernels' share of it, and the `top`
    kernels that take the most. None when the trace holds no device
    event."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    by_name: dict[str, float] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
    if not by_name:
        return None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_ms": sum(by_name.values()) / 1e3,
            "flash_ms": sum(us for nm, us in by_name.items()
                            if "flash_attention" in nm) / 1e3,
            "top": [(nm, us / 1e3) for nm, us in ranked]}


def approx_breakdown(torch, sess, xb, yb, mask, xtr, ytr) -> dict:
    """Where one approx step of `sess` goes on a full batch: the candidate
    stage, the recall probe and the whole on-device step by CUDA events
    (the values or COO emission is the step less the other two), the
    host merge of an interaction step's COO triplets (device-to-host copy
    included) by the host clock, and `sess.update` of the batch (probe
    fold and merge included) by the host clock, three times."""
    from repro_torch.kernels.ann import (
        matched_prefix_and_recall, topm_candidates)
    from repro_torch.kernels.sti_pipeline import (
        ApproxPairAccumulator, make_approx_interaction_step,
        make_approx_point_step)

    n, k, m = int(sess.x_train.shape[0]), sess.k, sess.m
    w, tables = sess._resolved["window"], sess._tables
    s = min(sess.recall_sample, xb.shape[0])
    out = {"candidates_ms": cuda_ms(
        torch, lambda: topm_candidates(xb, xtr, tables, m, w), reps=5)}
    cand = topm_candidates(xb, xtr, tables, m, w)[0]
    out["probe_ms"] = cuda_ms(torch, lambda: matched_prefix_and_recall(
        cand[:s], xb[:s], xtr, sess._probe_k), reps=3)
    state = torch.zeros((n,), device=xb.device)
    if sess._pairs is None:
        step = make_approx_point_step(
            sess.mode, k, n, m, w, s, sess._probe_k,
            tuple(sorted(sess.method_opts.items())))
    else:
        step = make_approx_interaction_step(sess.mode, k, n, m, w, s,
                                            sess._probe_k)
    out["device_step_ms"] = cuda_ms(
        torch, lambda: step(state, xb, yb, mask, xtr, ytr, tables), reps=3)
    out["emission_ms"] = (out["device_step_ms"] - out["candidates_ms"]
                          - out["probe_ms"])
    if sess._pairs is not None:
        _, rows, cols, vals, _, _ = step(state, xb, yb, mask, xtr, ytr,
                                         tables)
        torch.cuda.synchronize()
        merge = []
        for held in (None, sess._pairs):
            acc = ApproxPairAccumulator(n)
            if held is not None:  # into the pairs a whole run stored
                acc.load(*held.state())
            t0 = time.perf_counter()
            acc.add(rows, cols, vals)
            merge.append(1e3 * (time.perf_counter() - t0))
        out["host_merge_ms"], out["host_merge_into_run_ms"] = merge
        out["pairs_emitted"] = int((rows < n).sum())
    updates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.update(xb, yb)
        torch.cuda.synchronize()
        updates.append(1e3 * (time.perf_counter() - t0))
    out["session_update_ms"] = updates
    return out


def log_step(label: str, step: dict) -> None:
    log(f"{label}: " + ", ".join(
        f"{key} {val:.3f}" if isinstance(val, float) else f"{key} {val}"
        for key, val in step.items() if key != "session_update_ms")
        + "; session update ms " + ", ".join(
        f"{u:.2f}" for u in step["session_update_ms"]))


def approx_card_vs_cpu(torch, dev, c) -> dict:
    """[9g]: one full-width batch (t = 384 of n = 65536, d = 768, top_m =
    64, the default 4 tables x window 32, every row probed) of sti's
    approx interaction step and knn_shapley's approx point step, on the
    card and on the CPU from the same planes. The features are [4]'s times
    4 rounded to integers and the planes lie on the 1/16 grid in [-4, 4],
    so every code, norm and squared distance is an exact f32 integer on
    both sides in any order of summation: the tables, candidate ids and
    distances, COO coordinates, merged pair keys, matched prefixes and
    recalls must agree bit for bit, and the values within 1e-6 of max
    |CPU| (what the CPU computes is held against the JAX package by the
    parity tests)."""
    from repro_torch.kernels.ann import (
        build_tables, draw_planes, topm_candidates)
    from repro_torch.kernels.autotune import default_ann
    from repro_torch.kernels.sti_pipeline import (
        ApproxPairAccumulator, make_approx_interaction_step,
        make_approx_point_step, pad_test_batch)

    k, tb, n, m = c.k, c.tb, c.n, 64
    n_tables, window = default_ann(n, m)
    probe_k = min(2 * k + 2, m)
    proj = torch.clamp(torch.round(draw_planes(0, n_tables, 16, c.d) * 16)
                       / 16, -4.0, 4.0)
    x_int = torch.round(c.x_train.float() * 4)
    q_int = torch.round(c.x_test[:tb].float() * 4)
    sides = {}
    for name, side in (("card", dev), ("cpu", torch.device("cpu"))):
        xtr, ytr = x_int.to(side), c.y_train.to(side)
        xb, yb, mask = pad_test_batch(q_int.to(side).contiguous(),
                                      c.y_test[:tb].to(side), tb)
        tables = build_tables(xtr, proj)
        got = dict(zip(("cand", "d2m", "valid"),
                       topm_candidates(xb, xtr, tables, m, window)))
        got.update(sorted_codes=tables.sorted_codes, sort_idx=tables.sort_idx)
        sti = make_approx_interaction_step("sti", k, n, m, window, tb,
                                           probe_k)
        out = sti(torch.zeros((n,), device=side), xb, yb, mask, xtr, ytr,
                  tables)
        got.update(zip(("diag", "rows", "cols", "vals", "sti_prefix",
                        "sti_recall"), out))
        pt = make_approx_point_step("knn_shapley", k, n, m, window, tb,
                                    probe_k)
        out = pt(torch.zeros((n,), device=side), xb, yb, mask, xtr, ytr,
                 tables)
        got.update(zip(("vec", "pt_prefix", "pt_recall"), out))
        got = {key: val.cpu() for key, val in got.items()}
        acc = ApproxPairAccumulator(n)
        acc.add(got["rows"], got["cols"], got["vals"])
        got["pair_keys"], got["pair_vals"] = (torch.from_numpy(a) for a in
                                              acc.state())
        sides[name] = got
        del xtr, ytr, xb, yb, mask, tables
    card, ref = sides["card"], sides["cpu"]
    close = ("diag", "vals", "vec", "pair_vals")
    errs = {}
    for key in close:
        scale = max(float(ref[key].abs().max()), 1e-30)
        errs[key] = float((card[key] - ref[key]).abs().max()) / scale
    unequal = [key for key in ref if key not in close
               and not torch.equal(card[key], ref[key])]
    out = {"pairs": int((ref["rows"] < n).sum()),
           "max_rel_err": errs, "unequal": unequal,
           "matched_prefix_mean": float(ref["pt_prefix"].float().mean()),
           "recall_mean": float(ref["pt_recall"].mean())}
    log(f"[9g] one full-width approx batch on the card vs the CPU "
        f"(integer features, 1/16-grid planes; {out['pairs']} pairs, mean "
        f"matched prefix {out['matched_prefix_mean']:.3f}, mean recall "
        f"{out['recall_mean']:.4f}): bit-equal tables, candidates, COO "
        f"coordinates, pair keys, prefixes, recalls: {not unequal} "
        f"{unequal or ''}; max |card - CPU| / max |CPU| "
        + ", ".join(f"{key} {err:.3e}" for key, err in errs.items())
        + " (tol 1e-6)")
    if unequal or not all(err <= 1e-6 for err in errs.values()):
        fail(f"[9g] the approx steps on the card disagree with the CPU: "
             f"unequal {unequal}, errors {errs}")
    return out


def approx_phase(torch, dev, c) -> dict:
    """[9]: engine="approx" at the paper configuration's full width, on
    [4]-[6]'s data, held to the certified bound against [4]'s phi, an
    exact sii phi and [6]'s exact point values; top_m = n bit-identical
    to the exact engine; two runs and a checkpoint/restore bit-identical;
    the step's time by stage."""
    import tempfile

    from repro_torch import ApproxValuationSession, get_method
    from repro_torch.kernels.autotune import default_ann

    k, tb, n, m = c.k, c.tb, c.n, 64
    opts = dict(k=k, engine="approx", test_batch=tb, top_m=m, device=dev,
                approx_params={"recall_sample": 384})
    out = {"top_m": m, "index": default_ann(n, m)}

    def run(method, **extra):
        c.zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = get_method(method)(c.x_train, c.y_train, c.x_test, c.y_test,
                                 **{**opts, **extra})
        torch.cuda.synchronize()
        return res, {"total_s": time.perf_counter() - t0,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches": c.read_counts()}

    def meta_of(res):
        return {key: res.meta.get(key) for key in (
            "approx_exact", "recall_estimate", "matched_prefix",
            "error_bound", "pairs_stored", "n_tables", "window", "probe_k",
            "probed_rows")}

    def same_meta(a, b):
        return all(a.meta.get(key) == b.meta.get(key) for key in (
            "recall_estimate", "matched_prefix", "error_bound",
            "pairs_stored"))

    def symmetric(phi):
        return all(bool(torch.equal(phi[r0:r0 + 4096],
                                    phi[:, r0:r0 + 4096].T))
                   for r0 in range(0, n, 4096))

    def equal(a, b):
        return all(bool(torch.equal(a[r0:r0 + 4096], b[r0:r0 + 4096]))
                   for r0 in range(0, a.shape[0], 4096))

    def hold_pairs(label, res, info, exact):
        meta = res.meta
        err = max_abs_diff(torch, res.phi, exact)
        bound = meta["error_bound"]
        sym = symmetric(res.phi)
        diag_eq = bool(torch.equal(res.phi.diagonal(), exact.diagonal()))
        log(f"[9a] {label} approx top_m={m} (index {meta['n_tables']} "
            f"tables x window {meta['window']}, {meta['probed_rows']} rows "
            f"probed at depth {meta['probe_k']}): {info['total_s']:.3f} s, "
            f"peak {info['peak_gib']:.2f} GiB, launches {info['launches']}; "
            f"pairs stored {meta['pairs_stored']}, matched prefix "
            f"{meta['matched_prefix']}, recall {meta['recall_estimate']:.4f}"
            f"; max |phi - exact| {err:.3e} <= certified bound {bound:.4f} "
            f"+ 1e-6: {err <= bound + 1e-6}; symmetric {sym}; diagonal "
            f"bit-equal {diag_eq}")
        if res.phi.shape != (n, n) or res.phi.device.type != dev.type:
            fail(f"[9a] {label} phi {tuple(res.phi.shape)} on "
                 f"{res.phi.device}")
        if not err <= bound + 1e-6:
            fail(f"[9a] {label}: error {err} exceeds the certified bound "
                 f"{bound}")
        if not (sym and diag_eq):
            fail(f"[9a] {label}: phi symmetric {sym}, diagonal bit-equal "
                 f"{diag_eq}")
        c.expect(f"[9a] {label}", info["launches"], distance=c.n_steps)
        return dict(info, max_abs_err=err, symmetric=sym,
                    diagonal_bit_equal=diag_eq, **meta_of(res))

    out["card_vs_cpu"] = approx_card_vs_cpu(torch, dev, c)
    torch.cuda.empty_cache()
    xb, yb, mask = c.pad(c.x_test[:tb], c.y_test[:tb])
    xtr, ytr = c.xtr, c.ytr
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # (a), (d), (e) for sti: [4]'s phi is the exact one
    res_a, info = run("sti")
    out["sti"] = hold_pairs("sti", res_a, info, c.phi)
    res_b, _ = run("sti")
    runs_equal = equal(res_a.phi, res_b.phi) and same_meta(res_a, res_b)
    del res_b
    torch.cuda.empty_cache()
    kw = dict(k=k, mode="sti", test_batch=tb, top_m=m, recall_sample=384,
              device=dev)
    first = ApproxValuationSession(c.x_train, c.y_train, **kw)
    first.update(c.x_test[:tb], c.y_test[:tb]).checkpoint(
        Path(ckpt_dir) / "sti")
    del first
    resumed = ApproxValuationSession.restore(Path(ckpt_dir) / "sti",
                                             c.x_train, c.y_train,
                                             device=dev)
    res_e = resumed.update(c.x_test[tb:], c.y_test[tb:]).finalize()
    restore_equal = equal(res_a.phi, res_e.phi) and same_meta(res_a, res_e)
    out["sti"].update(two_runs_bit_identical=runs_equal,
                      restore_bit_identical=restore_equal)
    log(f"[9d] sti: two runs bit-identical (phi and meta) {runs_equal}; "
        f"[9e] checkpointed after batch 1 and restored: bit-identical "
        f"{restore_equal}")
    if not (runs_equal and restore_equal):
        fail("[9d/e] sti approx runs are not bit-identical")
    del res_e, resumed
    torch.cuda.empty_cache()
    sess = ApproxValuationSession(c.x_train, c.y_train, **kw)
    out["sti"]["step"] = approx_breakdown(torch, sess, xb, yb, mask,
                                          xtr, ytr)
    log_step(f"[9] sti approx step (t={tb})", out["sti"]["step"])
    del sess, res_a
    torch.cuda.empty_cache()
    # (c) sti at top_m = n: the exact engine's step, bit for bit
    res_c, info = run("sti", top_m=n, approx_params=None)
    full_equal = equal(res_c.phi, c.phi)
    log(f"[9c] sti approx top_m=n={n}: {info['total_s']:.3f} s, launches "
        f"{info['launches']}, approx_exact {res_c.meta['approx_exact']}, "
        f"error_bound {res_c.meta['error_bound']}, bit-identical to [4]'s "
        f"exact phi {full_equal}")
    c.expect("[9c] sti top_m=n", info["launches"], distance=c.n_steps,
             rank_sort=c.n_steps, sti_fill_acc=c.n_steps)
    if not (full_equal and res_c.meta["approx_exact"] is True
            and res_c.meta["error_bound"] == 0.0):
        fail("[9c] sti at top_m=n is not the exact engine bit for bit")
    out["sti_full_m"] = dict(info, bit_identical=full_equal)
    del res_c
    torch.cuda.empty_cache()
    # (a) sii: against an exact sii phi of the fused engine
    exact_sii = get_method("sii")(c.x_train, c.y_train, c.x_test, c.y_test,
                                  k=k, engine="fused", test_batch=tb,
                                  device=dev).phi
    res, info = run("sii")
    out["sii"] = hold_pairs("sii", res, info, exact_sii)
    del res, exact_sii
    torch.cuda.empty_cache()
    # (b) the point methods against [6]'s exact values; (c)-(e) knn_shapley
    for method in ("knn_shapley", "wknn", "loo"):
        res, info = run(method)
        want = c.exact_points[method]
        err = float((res.point_values - want).abs().max())
        bound, slack = res.meta["error_bound"], 1e-5 if method == "wknn" \
            else 1e-6
        log(f"[9b] {method} approx top_m={m}: {info['total_s']:.3f} s, peak "
            f"{info['peak_gib']:.2f} GiB, launches {info['launches']}; "
            f"matched prefix {res.meta['matched_prefix']}, recall "
            f"{res.meta['recall_estimate']:.4f}; max |values - exact| "
            f"{err:.3e} <= bound {bound:.4f} + {slack:g}: "
            f"{err <= bound + slack}")
        if res.point_values.shape != (n,) or not bool(
                torch.isfinite(res.point_values).all()):
            fail(f"[9b] {method} values: shape "
                 f"{tuple(res.point_values.shape)} or non-finite")
        if not err <= bound + slack:
            fail(f"[9b] {method}: error {err} exceeds the bound {bound}")
        c.expect(f"[9b] {method}", info["launches"], distance=c.n_steps)
        out[method] = dict(info, max_abs_err=err, **meta_of(res))
        if method != "knn_shapley":
            continue
        again, _ = run(method)
        runs_equal = bool(torch.equal(again.point_values,
                                      res.point_values)) and same_meta(
            again, res)
        kw = dict(k=k, mode=method, test_batch=tb, top_m=m,
                  recall_sample=384, device=dev)
        first = ApproxValuationSession(c.x_train, c.y_train, **kw)
        first.update(c.x_test[:tb], c.y_test[:tb]).checkpoint(
            Path(ckpt_dir) / method)
        resumed = ApproxValuationSession.restore(
            Path(ckpt_dir) / method, c.x_train, c.y_train, device=dev)
        res_e = resumed.update(c.x_test[tb:], c.y_test[tb:]).finalize()
        restore_equal = bool(torch.equal(res_e.point_values,
                                         res.point_values)) and same_meta(
            res_e, res)
        exact = get_method(method)(c.x_train, c.y_train, c.x_test,
                                   c.y_test, k=k, engine="streamed",
                                   test_batch=tb, device=dev)
        full, info_c = run(method, top_m=n, approx_params=None)
        full_equal = bool(torch.equal(full.point_values,
                                      exact.point_values))
        log(f"[9d] {method}: two runs bit-identical {runs_equal}; [9e] "
            f"restored after batch 1: bit-identical {restore_equal}; [9c] "
            f"top_m=n: approx_exact {full.meta['approx_exact']}, "
            f"error_bound {full.meta['error_bound']}, bit-identical to the "
            f"streamed engine {full_equal} ({info_c['total_s']:.3f} s)")
        if not (runs_equal and restore_equal and full_equal
                and full.meta["approx_exact"] is True
                and full.meta["error_bound"] == 0.0):
            fail(f"[9c-e] {method}: not bit-identical")
        out[method].update(two_runs_bit_identical=runs_equal,
                           restore_bit_identical=restore_equal,
                           full_m_bit_identical=full_equal)
        sess = ApproxValuationSession(c.x_train, c.y_train, **kw)
        out[method]["step"] = approx_breakdown(torch, sess, xb, yb, mask,
                                               xtr, ytr)
        log_step(f"[9] {method} approx step (t={tb})", out[method]["step"])
        del again, first, resumed, res_e, exact, full, sess
    import shutil

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def approx_scale_phase(torch, dev, c) -> dict:
    """[9f]: knn_shapley on the approx engine at its own scale, n = 2^20
    train points of d = 768 (3 GiB of f32 features drawn on the card from
    a seeded torch.Generator: two Gaussian blobs, 10 % of train labels
    flipped), t = 384, top_m = 256, held to the certified bound against
    the exact streamed engine on the same data; both valuations timed."""
    from repro_torch import ApproxValuationSession, get_method

    n, d, t, k, tb, m = c.scale_n, c.d, 384, c.k, c.tb, 256
    gen = torch.Generator(device=dev).manual_seed(20)
    centers = 2.0 * torch.randn((2, d), generator=gen, device=dev)

    def blobs(rows):
        y = torch.randint(0, 2, (rows,), generator=gen, device=dev,
                          dtype=torch.int32)
        x = centers[y.long()] + 0.3 * torch.randn(
            (rows, d), generator=gen, device=dev)
        return x, y

    x, y = blobs(n)
    flip = torch.rand((n,), generator=gen, device=dev) < 0.1
    y = torch.where(flip, 1 - y, y)
    xt, yt = blobs(t)
    out = {"n": n, "d": d, "t": t, "top_m": m}
    results = {}
    for engine, extra in (("approx", {"top_m": m}),
                          ("streamed", {"distance": "cuda"})):
        c.zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = get_method("knn_shapley")(x, y, xt, yt, k=k, engine=engine,
                                        test_batch=tb, device=dev, **extra)
        torch.cuda.synchronize()
        info = {"total_s": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": c.read_counts()}
        results[engine] = res
        out[engine] = info
        log(f"[9f] knn_shapley {engine} n={n} d={d} t={t}: "
            f"{info['total_s']:.3f} s, peak {info['peak_gib']:.2f} GiB, "
            f"launches {info['launches']}")
        streamed = c.n_steps if engine == "streamed" else 0
        c.expect(f"[9f] {engine}", info["launches"], distance=c.n_steps,
                 rank_sort=streamed, point_update=streamed)
    ap, ex = results["approx"], results["streamed"]
    err = float((ap.point_values - ex.point_values).abs().max())
    bound = ap.meta["error_bound"]
    out["approx"].update(max_abs_err=err, error_bound=bound,
                         matched_prefix=ap.meta["matched_prefix"],
                         recall_estimate=ap.meta["recall_estimate"],
                         n_tables=ap.meta["n_tables"],
                         window=ap.meta["window"])
    log(f"[9f] approx index {ap.meta['n_tables']} tables x window "
        f"{ap.meta['window']}, {ap.meta['probed_rows']} rows probed: "
        f"matched prefix {ap.meta['matched_prefix']}, recall "
        f"{ap.meta['recall_estimate']:.4f}; max |approx - exact| {err:.3e} "
        f"<= certified bound {bound:.4f} + 1e-6: {err <= bound + 1e-6}")
    if not (bool(torch.isfinite(ap.point_values).all())
            and err <= bound + 1e-6):
        fail(f"[9f] approx at n={n}: error {err} vs bound {bound}")
    del results, ap, ex
    torch.cuda.empty_cache()
    xb, yb, mask = c.pad(xt[:tb], yt[:tb])
    sess = ApproxValuationSession(x, y, k=k, mode="knn_shapley",
                                  test_batch=tb, top_m=m, device=dev)
    out["approx"]["step"] = approx_breakdown(torch, sess, xb, yb, mask,
                                             sess.x_train, sess.y_train)
    log_step(f"[9f] knn_shapley approx step (t={tb}, n={n})",
             out["approx"]["step"])
    del sess
    torch.cuda.empty_cache()
    from repro_torch.kernels.distance import distance_cuda
    from repro_torch.kernels.stream_kernels import accumulator_spec
    from repro_torch.kernels.sti_pipeline import make_stream_step

    step = make_stream_step("knn_shapley", k, distance="cuda")
    state = accumulator_spec("knn_shapley").init(n, dev)
    out["streamed"]["step_ms"] = cuda_ms(
        torch, lambda: step(state, xb, yb, mask, x, y), reps=3)
    out["streamed"]["distance_ms"] = cuda_ms(
        torch, lambda: distance_cuda(xb, x), reps=3)
    log(f"[9f] knn_shapley streamed step (t={tb}, n={n}): "
        f"{out['streamed']['step_ms']:.3f} ms, of it the distance kernel "
        f"{out['streamed']['distance_ms']:.3f} ms")
    del x, y, xt, yt, state, xb, yb, mask
    torch.cuda.empty_cache()
    return out


def tuner_phase(torch, dev, c) -> dict:
    """[10]: the persistent autotuner on the card, writing only to this
    run's temporary cache: the fill, rect fill and distance tuners, whose
    one candidate on a card is the CUDA kernel, time and store nothing and
    serve the kernel whatever plain winner the cache names; every
    candidate's time of the LSH index and whole-step tuners, their winners
    served back by `best_*`, an entry planted under the CPU platform never
    served to this CUDA process, and `fill="auto"` valuations launching
    what the cache names."""
    from repro_torch import ValuationSession, get_method
    from repro_torch.kernels import autotune as at

    n, d, k, tb, m, rows = c.n, c.d, c.k, c.tb, 64, c.n // 4
    out = {"platform": at.device_platform("cuda"),
           "cache": at.cache_path()}
    t0 = time.perf_counter()
    kernel_only = {
        "distance": at.autotune_distance(tb, n, d, backend="cuda"),
        "fill": at.autotune_fill(n, tb, backend="cuda"),
        "rect_fill": at.autotune_rect_fill(rows, n, tb, backend="cuda"),
    }
    out["kernel_only_s"] = time.perf_counter() - t0
    if at._load(None) or any(v != ("cuda", {})
                             for v in kernel_only.values()):
        fail(f"[10] the single-candidate tuners returned {kernel_only} or "
             f"stored {sorted(at._load(None))}")
    log(f"[10] distance, fill and rect fill tuners: the CUDA kernel, their "
        f"one candidate on a card, in {out['kernel_only_s']:.3f} s, nothing "
        f"timed or stored")
    t0 = time.perf_counter()
    won = {
        "ann": at.autotune_ann(n, tb, d, m, backend="cuda"),
        "megastep_sti": at.autotune_megastep(n, d, k, tb, method="sti",
                                             backend="cuda"),
        "megastep_knn_shapley": at.autotune_megastep(
            n, d, k, tb, method="knn_shapley", backend="cuda"),
    }
    out["tune_s"] = time.perf_counter() - t0
    cache = at._load(None)
    keys = {
        "ann": at._ann_key(n, tb, d, m, "cuda"),
        "megastep_sti": at._megastep_key(n, tb, d, "sti", "cuda"),
        "megastep_knn_shapley": at._megastep_key(n, tb, d, "knn_shapley",
                                                 "cuda"),
    }
    for name, key in keys.items():
        entry = cache.get(key)
        if not isinstance(entry, dict):
            fail(f"[10] the {name} tuner wrote no entry under {key}")
        out[name] = {"winner": won[name], "key": key,
                     "candidates": entry["candidates"]}
        if name == "ann":
            out[name]["floor_met"] = entry["floor_met"]
            detail = ", ".join(
                f"{lbl}: {v['us']:.1f} us, recall@16 {v['recall']:.4f}"
                for lbl, v in entry["candidates"].items()) + \
                f"; recall floor met {entry['floor_met']}"
        else:
            out[name]["rounds"] = entry["rounds"]
            detail = ", ".join(
                f"{lbl}: rounds " + ", ".join(f"{u:.1f}" for u in r) + " us"
                for lbl, r in entry["rounds"].items())
        log(f"[10] {name} at {key}: winner {won[name]}; candidates {detail}")
    log(f"[10] beside the measured steps: [4] three-stage step "
        f"{c.step_ms:.2f} ms at t={tb}, [5] megakernel step "
        f"{c.mega_step_ms:.2f} ms (the tuner times t={at._SAMPLE_T} rows)")
    served = {
        "ann": at.best_ann(n, tb, d, m, backend="cuda"),
        "megastep_sti": at.best_megastep(n, tb, d, k, method="sti",
                                         backend="cuda"),
        "megastep_knn_shapley": at.best_megastep(
            n, tb, d, k, method="knn_shapley", backend="cuda"),
    }
    for name, got in served.items():
        if tuple(got) != tuple(won[name]):
            fail(f"[10] best_{name} served {got}, the tuner cached "
                 f"{won[name]}")
    log("[10] every best_* served the cached winner")
    # plain winners planted under this card's own keys are not served
    at._store(None, at._key("fill", "cuda", n, tb),
              {"fill": "chunked", "params": {"chunk": 8}})
    at._store(None, at._key("rectfill", "cuda", n, tb, rows=rows),
              {"fill": "chunked", "params": {"chunk": 8}})
    at._store(None, at._key(f"distance_d{d}", "cuda", n, tb),
              {"distance": "plain", "params": {}})
    plain_served = {
        "distance": at.best_distance(tb, n, d, backend="cuda"),
        "fill": at.best_fill(n, tb, backend="cuda"),
        "rect_fill": at.best_rect_fill(rows, n, tb, backend="cuda")}
    if any(v != ("cuda", {}) for v in plain_served.values()):
        fail(f"[10] a plain winner planted under the card's keys was "
             f"served: {plain_served}")
    log("[10] plain fill, rect fill and distance winners planted under "
        "this card's keys: not served, the kernels resolve")
    # a winner planted under the CPU platform -- with the cpu backend and
    # with this process's -- is never served here
    sizes = f"n{at._bucket(n)}:t{at._bucket(tb)}"
    other_step = ("stages" if won["megastep_sti"][0] == "megakernel"
                  else "megakernel")
    for backend, devices in (("cpu", 1),
                             ("cuda", torch.cuda.device_count())):
        seg = f"{backend}:cpu:dev{devices}:{sizes}"
        at._store(None, f"fill:{seg}",
                  {"fill": "chunked", "params": {"chunk": 8}})
        at._store(None, f"megastep_sti_d{d}:{seg}",
                  {"step": other_step, "params": {}})
    if at.best_fill(n, tb, backend="cuda") != ("cuda", {}) or \
            at.best_megastep(n, tb, d, k, method="sti",
                             backend="cuda") != tuple(won["megastep_sti"]):
        fail("[10] an entry planted under the cpu platform was served to "
             "the CUDA process")
    if at.lookup_fill(n, tb, backend="cpu") != ("chunked", {"chunk": 8}):
        fail("[10] the planted cpu entry is not where a CPU run reads it")
    log("[10] entries planted under the cpu platform slug: not served to "
        "this CUDA process (a CPU run reads them)")
    # fill="auto" runs what the cache names
    want_sti = ({"sti_megakernel": c.n_steps}
                if won["megastep_sti"][0] == "megakernel" else
                {"distance": c.n_steps, "rank_sort": c.n_steps,
                 "sti_fill_acc": c.n_steps})
    c.zero_counts()
    res = get_method("sti")(c.x_train, c.y_train, c.x_test, c.y_test, k=k,
                            engine="fused", test_batch=tb, device=dev)
    torch.cuda.synchronize()
    got_sti = c.read_counts()
    log(f"[10] sti fused fill=auto after the tune: resolved "
        f"fill={res.meta['fill']} distance={res.meta['distance']}, "
        f"launches {got_sti}")
    c.expect("[10] sti fill=auto", got_sti, **want_sti)
    del res
    torch.cuda.empty_cache()
    want_pt = ({"point_megakernel": c.n_steps}
               if won["megastep_knn_shapley"][0] == "megakernel" else
               {"distance": c.n_steps, "rank_sort": c.n_steps,
                "point_update": c.n_steps})
    c.zero_counts()
    sess = ValuationSession(c.x_train, c.y_train, k=k, mode="knn_shapley",
                            test_batch=tb, device=dev)
    sess.update(c.x_test, c.y_test).finalize()
    torch.cuda.synchronize()
    got_pt = c.read_counts()
    log(f"[10] knn_shapley session fill=auto after the tune: resolved "
        f"fill={sess._resolved['fill']} distance="
        f"{sess._resolved['distance']}, launches {got_pt}")
    c.expect("[10] knn_shapley fill=auto", got_pt, **want_pt)
    out["auto_after_tune"] = {"sti": got_sti, "knn_shapley": got_pt}
    del sess
    torch.cuda.empty_cache()
    return out


def blob_points(np, count, dim, seed):
    """`count` more points of [4]'s two blobs (the centres
    `make_gaussian_blobs(..., seed=0)` draws, spread 0.3), alternating
    classes, from their own seed."""
    centers = np.random.default_rng(0).normal(size=(2, dim)) * 2.0
    rng = np.random.default_rng(seed)
    y = np.arange(count, dtype=np.int32) % 2
    x = centers[y] + rng.normal(scale=0.3, size=(count, dim))
    return x.astype(np.float32), y


def host_peak_gib() -> float:
    """Peak resident host memory of this process so far (getrusage)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def device_gib(torch) -> str:
    """Device memory now and at its peak since the last reset."""
    return (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


class CheckpointClock:
    """Times the Checkpointer's synchronous snapshot, its write (np.save +
    sha256, on the writer thread), each sha256 verification and each
    restore, by wrapping the class's methods for the length of a phase."""

    def __init__(self):
        from repro_torch.checkpoint.checkpointer import Checkpointer

        self.cls = Checkpointer
        self.events = []
        self._saved = {}
        for name in ("_snapshot", "_write", "verify_step", "restore"):
            self._saved[name] = getattr(Checkpointer, name)
            setattr(Checkpointer, name, self._timed(name, self._saved[name]))

    def _timed(self, name, fn):
        def timed(ck, *args, **kw):
            t0 = time.perf_counter()
            out = fn(ck, *args, **kw)
            self.events.append((name, time.perf_counter() - t0))
            return out
        return timed

    def take(self) -> list:
        got, self.events = self.events, []
        return got

    def close(self):
        for name, fn in self._saved.items():
            setattr(self.cls, name, fn)


def timings(events, name) -> list:
    """The seconds of each `CheckpointClock` event called `name`."""
    return [round(dt, 3) for nm, dt in events if nm == name]


def resilient_phase(torch, np, dev, c) -> dict:
    """[11]: a ResilientValuationSession at the paper configuration's full
    width (n = 65536, d = 768, k = 5, sti) on [4]'s blob data, 4 batches
    of 256 test points, ckpt_every=2, keep=2, async checkpoints, a NaN
    fault at seq 3: batch 3 is poisoned, rolled back to checkpoint 2,
    replayed and refolded; the session is dropped unfinalized (the kill),
    restored from checkpoint 2 and the stream replayed (batches 0-1
    skipped, 2-3 folded). Held bit for bit against a bare
    ValuationSession over the same batches."""
    from repro_torch.core.resilient import ResilientValuationSession
    from repro_torch.core.session import ValuationSession
    from repro_torch.distributed.fault_injection import Fault, FaultInjector

    n, tb, k = c.n, c.tb, c.k
    extra_x, extra_y = c.extra
    xt = torch.cat([c.x_test, torch.from_numpy(extra_x[:1024 - c.x_test.shape[0]])])
    yt = torch.cat([c.y_test, torch.from_numpy(extra_y[:1024 - c.y_test.shape[0]])])
    batches = [(xt[i:i + tb], yt[i:i + tb]) for i in range(0, 1024, tb)]
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt_gib = (n * n + n) * 4 / 2**30
    free_gib = shutil.disk_usage(ck_dir).free / 2**30
    keep = 2
    # this schedule writes checkpoints 2 and 4 (keep=2, so neither is
    # pruned): at most two on disk at once, the second while it is written.
    # The restored session replays with ckpt_every=8, so it writes none: at
    # ckpt_every=2 it would rewrite step 4 beside steps 2 and 4 (three
    # checkpoints in flight, 48 GiB, more than half this machine's disk)
    peak_gib = 2 * ckpt_gib
    with open("/proc/meminfo") as fh:
        mem = {ln.split(":")[0]: int(ln.split()[1]) for ln in fh}
    log(f"[11] checkpoint directory {ck_dir}: free disk {free_gib:.2f} GiB, "
        f"one checkpoint {ckpt_gib:.3f} GiB, this schedule's peak "
        f"{peak_gib:.2f} GiB on disk (two checkpoints, the second in "
        f"flight; three would need {3 * ckpt_gib:.2f}); host RAM "
        f"{mem['MemTotal'] / 2**20:.1f} GiB, available "
        f"{mem['MemAvailable'] / 2**20:.1f} GiB")
    if peak_gib > free_gib / 2:
        fail(f"[11] the checkpoints need {peak_gib:.2f} GiB of disk, more "
             f"than half the {free_gib:.2f} GiB free in {ck_dir}")
    out = {"free_disk_gib": free_gib, "checkpoint_gib": ckpt_gib,
           "disk_peak_gib": peak_gib,
           "host_ram_gib": mem["MemTotal"] / 2**20}
    clock = CheckpointClock()
    try:
        c.zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        log(f"[11] device memory at the start: {device_gib(torch)}")
        t0 = time.perf_counter()
        inj = FaultInjector([Fault("nan", at_seq=3, seed=0)])
        sess = ResilientValuationSession(
            c.x_train, c.y_train, ckpt_dir=ck_dir, mode="sti", k=k,
            test_batch=tb, ckpt_every=2, keep=keep, async_checkpoint=True,
            injector=inj, device=dev)
        fold_s = []
        for xb, yb in batches:
            t1 = time.perf_counter()
            sess.update(xb, yb)
            torch.cuda.synchronize()
            fold_s.append(time.perf_counter() - t1)
        sess._ckpt.wait()  # the write of checkpoint 4 lands before the kill
        first = c.read_counts()
        res = sess.resilience_summary()
        ev = clock.take()
        log(f"[11] folded 4 batches with a NaN fault at seq 3 in "
            f"{time.perf_counter() - t0:.2f} s (per update "
            f"{[round(s, 3) for s in fold_s]} s): {inj.fired('nan')}, "
            f"rollbacks {res['rollbacks']}, checkpoints "
            f"{res['checkpoint_steps']}, launches {first}")
        verify = timings(ev, "verify_step")
        log(f"[11] snapshots (device to host, synchronous) "
            f"{timings(ev, '_snapshot')} s; writes (np.save + sha256 + "
            f"prune, writer thread) {timings(ev, '_write')} s; sha256 "
            f"verifications {verify} s ("
            f"{[round(ckpt_gib * 2**30 / 1e9 / v, 3) for v in verify if v]} "
            f"GB/s); restores {timings(ev, 'restore')} s (their "
            f"verification included)")
        if res["rollbacks"] != 1 or res["nan_detected"] != 1:
            fail(f"[11] expected one NaN rollback, got {res}")
        # folds run: 0, 1, 2, 3 (poisoned), then the replay of 2 and 3
        c.expect("[11] resilient folds", first, distance=6, rank_sort=6,
                 sti_fill_acc=6)
        out["first_run"] = dict(
            update_s=fold_s, launches=first, resilience=res,
            snapshot_s=timings(ev, "_snapshot"),
            write_s=timings(ev, "_write"),
            verify_s=timings(ev, "verify_step"),
            restore_s=timings(ev, "restore"))
        del sess  # the kill: no finalize
        torch.cuda.empty_cache()
        log(f"[11] device memory after the kill: {device_gib(torch)}")

        c.zero_counts()
        t0 = time.perf_counter()
        resumed = ResilientValuationSession.restore(ck_dir, c.x_train,
                                                    c.y_train, step=2,
                                                    ckpt_every=8, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for xb, yb in batches:
            resumed.update(xb, yb)
        result = resumed.finalize(checkpoint=False)
        resumed._ckpt.wait()
        torch.cuda.synchronize()
        second = c.read_counts()
        res2 = result.meta["resilience"]
        ev = clock.take()
        if res2["checkpoint_steps"]:
            fail(f"[11] the restored session wrote checkpoints "
                 f"{res2['checkpoint_steps']}")
        log(f"[11] restored checkpoint 2 in {restore_s:.2f} s (sha256 "
            f"verifications {timings(ev, 'verify_step')} s, of "
            f"{ckpt_gib:.3f} GiB each; Checkpointer.restore "
            f"{timings(ev, 'restore')} s, its verification included) "
            f"and replayed: skipped "
            f"{res2['replayed_skipped']}, launches {second}")
        if res2["replayed_skipped"] != 2:
            fail(f"[11] replayed_skipped {res2['replayed_skipped']} != 2")
        c.expect("[11] restored folds", second, distance=2, rank_sort=2,
                 sti_fill_acc=2)
        phi_r = result.phi
        del resumed, result
        torch.cuda.empty_cache()
        log(f"[11] device memory after the resumed finalize: "
            f"{device_gib(torch)}")

        c.zero_counts()
        bare = ValuationSession(c.x_train, c.y_train, k=k, mode="sti",
                                test_batch=tb, device=dev)
        for xb, yb in batches:
            bare.update(xb, yb)
        phi_b = bare.finalize().phi
        del bare
        torch.cuda.synchronize()
        log(f"[11] device memory after the bare finalize: {device_gib(torch)}")
        c.expect("[11] bare session", c.read_counts(), distance=4,
                 rank_sort=4, sti_fill_acc=4)
        same = all(bool(torch.equal(phi_r[r0:r0 + 4096], phi_b[r0:r0 + 4096]))
                   for r0 in range(0, n, 4096))
        same_diag = bool(torch.equal(phi_r.diagonal(), phi_b.diagonal()))
        finite = all(bool(torch.isfinite(phi_r[r0:r0 + 4096]).all())
                     for r0 in range(0, n, 4096))
        peak_dev = torch.cuda.max_memory_allocated() / 2**30
        log(f"[11] restored + replayed phi vs a bare ValuationSession over "
            f"the same 4 batches: bit-identical {same}, diagonal "
            f"bit-identical {same_diag}, finite {finite}; peak device "
            f"memory {peak_dev:.2f} GiB")
        if not (same and same_diag and finite):
            fail("[11] the resumed resilient phi is not bit-identical to the "
                 "bare session's")
        used = sum(f.stat().st_size for f in Path(ck_dir).rglob("*")
                   if f.is_file()) / 2**30
        out.update(restore_s=restore_s, launches_restored=second,
                   resilience_restored=res2, bit_identical=same,
                   diag_bit_identical=same_diag, peak_device_gib=peak_dev,
                   disk_used_gib=used,
                   restore_verify_s=timings(ev, "verify_step"),
                   restore_load_s=timings(ev, "restore"))
        out["launches"] = {name: first[name] + second[name]
                           for name in first}
        del phi_r, phi_b
        torch.cuda.empty_cache()
    finally:
        clock.close()
        shutil.rmtree(ck_dir, ignore_errors=True)
    out["host_peak_gib"] = host_peak_gib()
    log(f"[11] disk used at the end {out['disk_used_gib']:.2f} GiB; host "
        f"peak resident memory of this process so far "
        f"{out['host_peak_gib']:.2f} GiB")
    return out


def service_requests(torch, np, dev, c, method, svc, clock, extra, label):
    """[12a]/[12b]'s request mix on `svc`: 4 value_query requests of 96
    points submitted together (coalesced into a 256 and a 128 chunk),
    remove_points of 64 ids, add_points of 64 points, 2 more queries of
    96, get_values. Holds the remove bit for bit and the add within 2e-5
    (of state / t) against the service's own full recompute, and logs each
    request's latency split into refold and rebase (the checkpoint)."""
    timing = {"refold": [], "rebase": []}
    refold_all, rebase = svc._refold_all, svc._session.rebase

    def timed_refold(*a, **kw):
        t0 = time.perf_counter()
        got = refold_all(*a, **kw)
        torch.cuda.synchronize()
        timing["refold"].append(time.perf_counter() - t0)
        return got

    def timed_rebase(*a, **kw):
        t0 = time.perf_counter()
        got = rebase(*a, **kw)
        torch.cuda.synchronize()
        timing["rebase"].append(time.perf_counter() - t0)
        return got

    ranks = {"n": 0}
    rank = svc._rank

    def counted_rank(*a):
        ranks["n"] += 1
        return rank(*a)

    svc._refold_all, svc._session.rebase = timed_refold, timed_rebase
    svc._rank = counted_rank
    requests, statuses = [], []
    total = {name: 0 for name in c.read_counts()}

    def add(launches):
        for name, count in launches.items():
            total[name] += count

    def note(kind, resp, launches, refold_s=None, rebase_s=None, extra=None):
        statuses.append(resp.status)
        row = dict(kind=kind, status=resp.status, latency_s=resp.latency_s,
                   launches=launches, refold_s=refold_s, rebase_s=rebase_s,
                   rank_calls=ranks["n"], **(extra or {}))
        requests.append(row)
        log(f"[{label}] {method} {kind}: {resp.status} in "
            f"{resp.latency_s:.3f} s" +
            (f" = refold {refold_s:.3f} s + rebase (state copy, checkpoint "
             f"write, sha256) {rebase_s:.3f} s" if refold_s is not None
             else "") + f"; rank-step calls {ranks['n']}, launches "
            f"{launches}")

    def mutate(kind, fn):
        timing["refold"].clear()
        timing["rebase"].clear()
        ranks["n"] = 0
        c.zero_counts()
        clock.take()
        resp = fn()
        torch.cuda.synchronize()
        ev = clock.take()
        add(c.read_counts())
        note(kind, resp, c.read_counts(), sum(timing["refold"]),
             sum(timing["rebase"]),
             dict(snapshot_s=timings(ev, "_snapshot"),
                  write_s=timings(ev, "_write"),
                  verify_s=timings(ev, "verify_step")))
        return resp

    def recompute_matches(what, exact):
        """The live state against `_refold_all(use_caches=False)`."""
        state, t = refold_all(use_caches=False)
        torch.cuda.synchronize()
        errs, equal = [], True
        for got, want in zip(svc._session.inner._state, state):
            rows = 4096 if got.ndim == 2 else got.shape[0]
            for r0 in range(0, got.shape[0], rows):
                a, b = got[r0:r0 + rows], want[r0:r0 + rows]
                equal = equal and bool(torch.equal(a, b))
                errs.append(float((a - b).abs().max()) / t)
        del state
        torch.cuda.empty_cache()
        err = max(errs)
        log(f"[{label}] {method} state after the {what} vs the service's "
            f"full recompute (ranked anew, no caches): bit-identical "
            f"{equal}, max |diff| / t {err:.3e}")
        if exact and not equal:
            fail(f"[{label}] {method} {what}: the incremental state is not "
                 f"bit-identical to the full recompute")
        if not err <= 2e-5:
            fail(f"[{label}] {method} {what}: max |diff| / t {err} > 2e-5")
        return equal, err

    # the sentinel rows on the card's distance kernel: finite, past 1e20,
    # ranked last in index order by the stable sort
    xb = torch.from_numpy(np.ascontiguousarray(c.x_test[:c.tb].numpy())).to(dev)
    d2, order = rank(xb, torch.from_numpy(svc._x).to(dev))
    free = torch.from_numpy(np.flatnonzero(svc._keep == 0)).to(dev)
    tail = order[:, -free.shape[0]:].long()
    sentinel_ok = (bool(torch.isfinite(d2).all())
                   and bool((d2[:, free] >= 1e20).all())
                   and bool((d2[:, svc._keep > 0] < 1e20).all())
                   and bool((tail == free[None, :]).all()))
    log(f"[{label}] sentinel slots on the distance kernel ({c.tb} x "
        f"{svc.capacity}, {free.shape[0]} free): finite, >= 1e20 (min "
        f"{float(d2[:, free].min()):.4e}), ranked last in index order: "
        f"{sentinel_ok}")
    if not sentinel_ok:
        fail(f"[{label}] sentinel slots are not finite and last in index "
             f"order on the card")
    del d2, order, tail

    ranks["n"] = 0
    c.zero_counts()
    rids = [svc.submit("value_query", x=c.x_test[i:i + 96],
                       y=c.y_test[i:i + 96]) for i in range(0, 384, 96)]
    svc.drain()
    torch.cuda.synchronize()
    launches = c.read_counts()
    add(launches)
    for rid in rids:
        r = svc.poll(rid)
        note("value_query", r, launches,
             extra={"coalesced_with": r.payload["coalesced_with"]})
    if [rec.b for rec in svc._log] != [c.tb, 384 - c.tb]:
        fail(f"[{label}] the 4 queries did not coalesce into a {c.tb} and a "
             f"{384 - c.tb} chunk: {[rec.b for rec in svc._log]}")
    gone = [int(i) for i in np.random.default_rng(4).choice(
        svc.n_live, 64, replace=False)]
    mutate("remove_points", lambda: svc.remove_points(gone))
    if requests[-1]["rank_calls"] != 0:
        fail(f"[{label}] the remove called the rank step "
             f"{requests[-1]['rank_calls']} times with warm caches")
    exact_remove = recompute_matches("remove", exact=True)
    add_x, add_y = extra[0][832:896], extra[1][832:896]
    r = mutate("add_points", lambda: svc.add_points(add_x, add_y))
    new_ids = r.payload.get("ids")
    add_err = recompute_matches("add", exact=False)
    for lo in (640, 736):
        ranks["n"] = 0
        c.zero_counts()
        resp = svc.value_query(extra[0][lo:lo + 96], extra[1][lo:lo + 96])
        torch.cuda.synchronize()
        add(c.read_counts())
        note("value_query", resp, c.read_counts())
    ranks["n"] = 0
    c.zero_counts()
    clock.take()
    gv = svc.get_values()
    torch.cuda.synchronize()
    add(c.read_counts())
    note("get_values", gv, c.read_counts())
    # the methods come back by removing the instance attributes: a bound
    # method stored on its own instance would hold the service (and its
    # 16 GiB state) in a reference cycle after the caller drops it
    del svc._refold_all, svc._session.rebase
    svc._rank = rank
    if any(st != "ok" for st in statuses):
        fail(f"[{label}] {method}: statuses {statuses}")
    log(f"[{label}] {method} launches over the requests {total}")
    return dict(requests=requests, remove_bit_identical=exact_remove[0],
                add_max_err=add_err[1], new_ids=new_ids,
                sentinel_ok=sentinel_ok, launches=total), gv


def service_phase(torch, np, dev, c) -> dict:
    """[12]: the online service at the paper configuration's width
    (capacity 65536, 65280 live, 256 free slots, test_batch 256) for sti
    ([12a]) and knn_shapley ([12b]), then the reference's chaos drill on
    four shards of the card ([12c], n = 4096)."""
    from repro_torch.core.methods import get_method
    from repro_torch.distributed.fault_injection import Fault, FaultInjector
    from repro_torch.serving.valuation_service import ValuationService

    n, tb, k = c.n, c.tb, c.k
    live0 = n - 256
    out = {}
    clock = CheckpointClock()
    try:
        for label, method in (("12a", "sti"), ("12b", "knn_shapley")):
            t_phase = time.perf_counter()
            ck_dir = tempfile.mkdtemp(prefix="chip_smoke_svc_")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            svc = ValuationService(
                c.x_train[:live0], c.y_train[:live0], method=method, k=k,
                capacity=n, test_batch=tb, ckpt_dir=ck_dir, ckpt_every=8,
                ckpt_keep=2, cache_policy="eager", seed=0, device=dev)
            got, gv = service_requests(torch, np, dev, c, method, svc, clock,
                                       c.extra, label)
            live = np.flatnonzero(svc._keep > 0)
            xs = np.concatenate([c.x_test.numpy(), c.extra[0][640:832]])
            ys = np.concatenate([c.y_test.numpy(), c.extra[1][640:832]])
            # the offline engine takes the service's distance kernel, so a
            # near tie ranks alike on both sides
            offline = get_method(method)(svc._x[live], svc._y[live], xs, ys,
                                         k=k, test_batch=tb, distance="cuda",
                                         device=dev)
            want = offline.values().cpu().numpy()
            del offline
            torch.cuda.empty_cache()
            drift = float(np.abs(want - gv.payload["values"]).max())
            log(f"[{label}] {method} final live values ({live.shape[0]} of "
                f"{n}, t={svc.t_seen}) vs the offline engine on the final "
                f"live set: max |diff| {drift:.3e} (tol 1e-5)")
            if not drift <= 1e-5 or gv.payload["n_live"] != live0:
                fail(f"[{label}] {method}: drift {drift}, n_live "
                     f"{gv.payload['n_live']}")
            svc.close()  # joins any checkpoint write in flight
            peak = torch.cuda.max_memory_allocated() / 2**30
            used = sum(f.stat().st_size for f in Path(ck_dir).rglob("*")
                       if f.is_file()) / 2**30
            del svc, gv
            torch.cuda.empty_cache()
            shutil.rmtree(ck_dir, ignore_errors=True)
            got.update(drift=drift, peak_device_gib=peak,
                       disk_used_gib=used,
                       phase_s=time.perf_counter() - t_phase)
            log(f"[{label}] phase {got['phase_s']:.1f} s, peak device memory "
                f"{peak:.2f} GiB, checkpoint disk at the end {used:.2f} GiB")
            out[method] = got
    finally:
        clock.close()

    # [12c] the reference's chaos drill on four shards of the card
    t_phase = time.perf_counter()
    n_c, t_c, tb_c, cap_c = c.chaos
    x_c, y_c = c.x_train[:n_c].numpy(), c.y_train[:n_c].numpy()
    xt_c, yt_c = c.x_test[:t_c].numpy(), c.y_test[:t_c].numpy()
    inj = FaultInjector([
        Fault(kind="device", at_seq=1, times=99),  # beyond any budget
        Fault(kind="nan", at_seq=2, seed=0),
        Fault(kind="ckpt_corrupt", at_seq=2, seed=0),
    ])
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    c.zero_counts()
    svc = ValuationService(
        x_c, y_c, method="sti", k=k, capacity=cap_c, test_batch=tb_c,
        devices=[dev] * 4, ckpt_dir=ck_dir, ckpt_every=2, max_retries=1,
        min_shards=2, seed=0, injector=inj)
    statuses = []
    for s in range(0, t_c, tb_c):
        if s == t_c // 2:
            statuses.append(svc.remove_points([0, 1]).status)
        half = tb_c // 2
        rids = [svc.submit("value_query", x=xt_c[s:s + half],
                           y=yt_c[s:s + half]),
                svc.submit("value_query", x=xt_c[s + half:s + tb_c],
                           y=yt_c[s + half:s + tb_c])]
        svc.drain()
        statuses += [svc.poll(r).status for r in rids]
    gv = svc.get_values()
    statuses.append(gv.status)
    svc._session._ckpt.wait()
    torch.cuda.synchronize()
    launches = c.read_counts()
    h = svc.health()
    keep = np.array([i for i in range(n_c) if i not in (0, 1)])
    off = get_method("sti")(x_c[keep], y_c[keep], xt_c, yt_c, k=k,
                            device=dev)
    drift = float(np.abs(off.values().cpu().numpy()
                         - gv.payload["values"]).max())
    svc.close()
    shutil.rmtree(ck_dir, ignore_errors=True)
    log(f"[12c] chaos drill (sti, n={n_c}, capacity {cap_c}, d={c.d}, "
        f"t={t_c}, 4 shards of the card, min_shards 2): statuses "
        f"{statuses}; health {h['status']}, degradations "
        f"{h['resilience']['degradations']}, full recoveries "
        f"{h['requests']['full_recoveries']}, faults fired "
        f"{[(e['kind'], e['seq']) for e in inj.events]}; drift from the "
        f"offline engine {drift:.3e} (tol 1e-5); launches {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not all(st == "ok" for st in statuses):
        fail(f"[12c] statuses {statuses}")
    if h["status"] != "degraded" or not (
            h["resilience"]["degradations"]
            or h["requests"]["full_recoveries"]):
        fail(f"[12c] health {h['status']}, degradations "
             f"{h['resilience']['degradations']}, recoveries "
             f"{h['requests']['full_recoveries']}")
    if not drift <= 1e-5:
        fail(f"[12c] drift {drift} > 1e-5")
    out["chaos"] = dict(statuses=statuses, health=h["status"],
                        degradations=h["resilience"]["degradations"],
                        full_recoveries=h["requests"]["full_recoveries"],
                        drift=drift, launches=launches,
                        phase_s=time.perf_counter() - t_phase)
    del svc, gv, off
    torch.cuda.empty_cache()
    return out


def lm_phase(torch, np, dev, entries) -> dict:
    """[8]: the flash-attention kernel and the LM serving path at the full
    width of qwen3-1.7b. Returns the serving numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeConfig

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    # --- the kernel against its plain version on the card
    # a barrier hang in a kernel blocks in C, where no Python timeout
    # reaches: past this limit the process ends with a traceback
    faulthandler.dump_traceback_later(300, exit=True)
    path_case = (1, 16, 2048, 128, True, None)
    # (the JAX tests' shapes, a ragged length, windows, non-causal, the
    # head dims of phi3-mini (96) and smollm-360m (64), a 4096-token
    # prompt and a served prompt's length (2039: ragged last q and key
    # tiles) at the path's width, then the path's shape)
    for dtype in (torch.float32, torch.bfloat16):
        for case in ((1, 2, 64, 16, True, None), (2, 1, 128, 32, True, None),
                     (1, 2, 96, 16, True, 32), (1, 1, 64, 16, False, None),
                     (1, 2, 200, 64, True, None),
                     (1, 2, 200, 64, False, None),
                     (1, 2, 200, 64, False, 48), (1, 2, 200, 64, True, 48),
                     (1, 32, 2048, 96, True, None),
                     (1, 16, 2048, 64, True, None),
                     (1, 16, 4096, 128, True, None),
                     (1, 16, 2039, 128, True, None), path_case):
            q, k, v, err = hold_flash(torch, gen, dev, "[8]", *case, dtype)
            b_, h_, s_, d_, causal_, window_ = case
            if dtype == torch.bfloat16 and s_ >= 2048 and case != path_case:
                ms = cuda_ms(torch, lambda: flash_attention_cuda(
                    q, k, v, causal=causal_, window=window_), reps=10)
                bnd, _ = flash_bound_ms(b_, h_, s_, s_, d_, causal_,
                                        window_, 2)
                rate = 4.0 * b_ * h_ * d_ * visible_pairs(
                    s_, s_, causal_, window_) / (ms * 1e-3) / 1e12
                log(f"[8] flash_attention {case[:4]} bf16 causal: kernel "
                    f"{ms:.4f} ms = {rate:.1f} TFLOP/s, bound {bnd:.4f} ms")
    faulthandler.cancel_dump_traceback_later()
    # q, k, v, err: the path's shape, (1, 16, 2048, 128) bf16 causal
    fa_ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v), reps=20)
    fa_plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v),
                          reps=5)
    sdpa_ms = cuda_ms(torch, lambda: torch.nn.functional.
                      scaled_dot_product_attention(q, k, v, is_causal=True),
                      reps=20)
    bound, by = flash_bound_ms(1, 16, 2048, 2048, 128, True, None, 2)
    # the function's operations over the kernel's time (the hi + lo split
    # makes the kernel's own tensor work 1.5x this)
    tflops = 4.0 * 16 * 128 * visible_pairs(2048, 2048, True, None) / (
        fa_ms * 1e-3) / 1e12
    entries["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72",
        max_abs_err=err, ms=fa_ms, plain_ms=fa_plain_ms, bound_ms=bound,
        bound_by=by, library_ms=sdpa_ms,
        shape="b=1 h=16 s=2048 d=128 bf16 causal")
    log(f"[8] flash_attention (1, 16, 2048, 128) bf16 causal: kernel "
        f"{fa_ms:.4f} ms = {tflops:.1f} TFLOP/s, plain {fa_plain_ms:.3f} "
        f"ms, scaled_dot_product_attention {sdpa_ms:.4f} ms "
        f"({fa_ms / sdpa_ms:.2f}x), bound {bound:.4f} ms ({by})")
    del q, k, v
    torch.cuda.empty_cache()
    # the bf16 kernel must be the Hopper one: wgmma (HGMMA) and TMA loads
    # (UTMALDG) in its SASS
    bf16_sass = {n: t for n, t in build.sass("flash_attention").items()
                 if "flash_attention_wgmma_kernel" in n}
    for name, text in bf16_sass.items():
        dp = name.split("ILi")[-1].split("E")[0]
        log(f"[8] SASS of flash_attention_wgmma_kernel<{dp}>: HGMMA "
            f"{text.count('HGMMA')}, UTMALDG {text.count('UTMALDG')}")
    if not bf16_sass or not all("HGMMA" in t and "UTMALDG" in t
                                for t in bf16_sass.values()):
        fail("[8] the bf16 flash-attention kernel's SASS holds no HGMMA or "
             "no UTMALDG")

    cfg = get_config("qwen3-1.7b")
    with torch.no_grad():
        # --- prefill/decode consistency through the kernel: full width,
        # 4 layers, f32
        cfg4 = cfg.replace(num_layers=4, dtype=torch.float32)
        m4 = build_model(cfg4)
        p4 = m4.init(gen, device=dev)
        b, s = 2, 300
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                             device=dev)
        launches0 = flash_attention_cuda.launches
        full, _, _, _ = m4._fwd(p4, {"tokens": toks}, "train")
        _, caches = m4.prefill(p4, {"tokens": toks[:, :s]})
        if flash_attention_cuda.launches - launches0 != 2 * cfg4.num_layers:
            fail("the consistency check did not run the kernel once a layer")
        pool = grow_caches(torch, m4, caches, b, s, s + 8, dev)
        dec, _ = m4.decode_step(p4, {"tokens": toks[:, s:s + 1],
                                     "caches": pool, "index": s})
        # the real vocab only: the padded columns are -1e30 on both sides
        nv = cfg.vocab_size
        if not (bool((full[:, -1, nv:] == -1e30).all())
                and bool((dec[:, 0, nv:] == -1e30).all())):
            fail("padded vocab columns are not -1e30")
        want, got = full[:, -1, :nv], dec[:, 0, :nv]
        cerr = float((got - want).abs().max())
        cscale = float(want.abs().max())
        same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
        # f32 throughout (no TF32): the kernel's tiles and the decode
        # path's one softmax sum in other orders; 1e-4 of the largest
        # |logit| admits that rounding through 4 layers of d_model 2048
        log(f"[8] prefill/decode consistency (qwen3-1.7b width, 4 layers, "
            f"f32, b={b}, s={s}): decode logits vs forward over s + 1: "
            f"max_abs_err {cerr:.3e} (max |ref| {cscale:.3e}, tol 1e-4 of "
            f"it); argmax equal {same_argmax}")
        if not (cerr <= 1e-4 * cscale and same_argmax):
            fail(f"prefill/decode disagree: {cerr}, argmax {same_argmax}")
        del p4, full, caches, pool, dec, want, got
        torch.cuda.empty_cache()

    # --- the serving path: full width and depth, bf16 activations, f32
    # params drawn on the card
    gen0 = torch.Generator(device=dev)
    gen0.manual_seed(0)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(gen0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(max_slots=4, max_len=2112, eos_id=-1)
    rng = np.random.default_rng(0)
    lens = rng.integers(1984, 2049, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    out = serve_measure(torch, np, dev, "[8]", cfg, model, params, scfg,
                        prompts, busy_steps=3)
    entries["flash_attention"]["launches"] = out["flash_launches"]
    out.update(init_s=init_s, flash_tflops=tflops)
    log(f"[8] parameters drawn on the card in {init_s:.2f} s")
    del params
    torch.cuda.empty_cache()
    return out


def serve_measure(torch, np, dev, label, cfg, model, params, scfg,
                  prompts, busy_steps, want_flash=None):
    """`Engine(cfg, scfg, params)` serving `prompts` greedily to
    scfg.max_len - 1: each request must return max_len - its prompt length
    tokens, all in the vocab, no sampled logit row NaN, and (default: one
    a layer and a prompt) `want_flash` flash-attention launches. Returns
    prefill ms per request, decode ms per step, tokens/s, peak memory and
    the device busy share over one prefill of the longest prompt and
    `busy_steps` decode steps of the pool (torch.profiler, against the
    unprofiled times)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.serving.engine import Engine

    lens = np.array([len(p) for p in prompts])
    eng = Engine(cfg, scfg, params)
    rids = [eng.submit(p) for p in prompts]
    # instrumentation of this run only: host time of each admission (the
    # prefills) and each decode step, each ending in a synchronize, and a
    # device-side NaN flag over every logit row sampled
    timing = {"admit_s": 0.0, "steps": 0, "step_s": 0.0}
    nan_seen = torch.zeros((), dtype=torch.bool, device=dev)
    admit, step, sample = eng._admit, eng._step, eng._sample

    def timed(fn, key):
        def run():
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            timing[key] += time.perf_counter() - t
            if key == "step_s":
                timing["steps"] += 1
        return run

    def checked_sample(logits):
        nan_seen.logical_or_(torch.isnan(logits).any())
        return sample(logits)

    eng._admit, eng._step = timed(admit, "admit_s"), timed(step, "step_s")
    eng._sample = checked_sample
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = flash_attention_cuda.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(r) for r in results.values())
    out = dict(
        arch=cfg.name, layers=cfg.num_layers, params=model.num_params(),
        requests=len(prompts), prompt_lens=[int(n) for n in lens],
        generated_tokens=n_tok, serve_s=serve_s,
        prefill_ms_per_request=1e3 * timing["admit_s"] / len(prompts),
        decode_steps=timing["steps"],
        decode_ms_per_step=1e3 * timing["step_s"] / max(timing["steps"], 1),
        tokens_per_s=n_tok / serve_s, peak_gib=peak_gib,
        flash_launches=launches)
    log(f"{label} served {len(results)} requests through {cfg.name} "
        f"({cfg.num_layers} layers, {model.num_params() / 1e9:.3f} B "
        f"params): {n_tok} tokens in {serve_s:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; prefill "
        f"{out['prefill_ms_per_request']:.1f} ms per request (prompts "
        f"{int(lens.min())}-{int(lens.max())}), decode "
        f"{out['decode_ms_per_step']:.2f} ms per step over "
        f"{timing['steps']} steps of {scfg.max_slots} slots; peak device "
        f"memory {peak_gib:.2f} GiB; flash_attention launches {launches}")
    if want_flash is None:
        want_flash = cfg.num_layers * len(prompts)
    if launches != want_flash:
        fail(f"{label} expected {want_flash} flash-attention launches, got "
             f"{launches}")
    if bool(nan_seen):
        fail(f"{label} a sampled logit row held NaN")
    for rid, n in zip(rids, lens):
        toks_r = results.get(rid)
        if toks_r is None or len(toks_r) != scfg.max_len - int(n):
            fail(f"{label} request {rid} (prompt {n}) returned "
                 f"{None if toks_r is None else len(toks_r)} tokens, "
                 f"expected {scfg.max_len - int(n)}")
        if not all(0 <= t < cfg.vocab_size for t in toks_r):
            fail(f"{label} request {rid} returned a token outside the vocab")
    # where a request's time goes on the card: one prefill of the longest
    # prompt and `busy_steps` decode steps of the pool, under
    # torch.profiler. Device busy time is the sum of the kernels' and
    # copies' durations in the trace; the share of wall time is taken
    # against the unprofiled times above (profiling slows the host, not
    # the kernels).
    with torch.no_grad():
        toks = torch.from_numpy(prompts[int(np.argmax(lens))][None]).to(dev)
        dec_toks = torch.zeros((scfg.max_slots, 1), dtype=torch.int64,
                               device=dev)
        busy = {
            "prefill": device_busy(torch, lambda: model.prefill(
                params, {"tokens": toks})),
            "decode": device_busy(torch, lambda: [model.decode_step(
                params, {"tokens": dec_toks, "caches": eng.caches,
                         "index": scfg.max_len - 2})
                for _ in range(busy_steps)]),
        }
    if all(v is not None for v in busy.values()):
        busy["decode"]["busy_ms"] /= busy_steps
        busy["decode"]["flash_ms"] /= busy_steps
        busy["decode"]["top"] = [(nm, ms / busy_steps)
                                 for nm, ms in busy["decode"]["top"]]
        for key, wall in (("prefill", out["prefill_ms_per_request"]),
                          ("decode", out["decode_ms_per_step"])):
            busy[key]["busy_share"] = busy[key]["busy_ms"] / wall
            log(f"{label} {key}: device busy {busy[key]['busy_ms']:.2f} ms "
                f"of {wall:.2f} ms wall "
                f"({100 * busy[key]['busy_share']:.1f} %), flash attention "
                f"{busy[key]['flash_ms']:.3f} ms; top kernels (ms): "
                + ", ".join(f"{nm[:48]} {ms:.2f}"
                            for nm, ms in busy[key]["top"]))
    else:
        log(f"{label} torch.profiler traced no device time: busy share not "
            f"measured")
    out["device_busy"] = busy
    del eng
    return out


def blocks_err(torch, got, want, rows: int = 4096, got_diag=None,
               want_diag=None) -> tuple[float, float]:
    """(max |got - want|, max |want|) over (n, n) matrices taken 4096 rows
    at a time; with `got_diag`, `got`'s diagonal reads from it instead."""
    err = scale = 0.0
    for r0 in range(0, want.shape[0], rows):
        g = got[r0:r0 + rows].clone()
        w = want[r0:r0 + rows]
        idx = torch.arange(g.shape[0], device=g.device)
        if got_diag is not None:
            g[idx, r0 + idx] = got_diag[r0:r0 + rows]
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return err, scale


def distributed_phase(torch, np, dev, c) -> dict:
    """[13]: the "distributed" engine at the paper configuration's full
    width on [4]'s data, on a (data 2, model 2) grid of the one card, held
    against [4]'s phi; sii on a (2, 2) grid at n = 8192 against the fused
    engine; `make_sti_step_fn` at full width against [4]'s sums."""
    from repro_torch import get_method
    from repro_torch.core.valuation import make_sti_step_fn
    from repro_torch.distributed.sharding import DeviceGrid

    out = {}
    n, t, k = c.n, int(c.x_test.shape[0]), c.k
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    # [4]'s phi again: [4]'s call on [4]'s inputs through the same kernels
    ref = get_method("sti")(c.x_train, c.y_train, c.x_test, c.y_test, k=k,
                            engine="fused", test_batch=c.tb,
                            device=dev).phi
    grid = DeviceGrid((dev,) * 4, (2, 2))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    c.zero_counts()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    ev0.record()
    res = get_method("sti")(c.x_train, c.y_train, c.x_test, c.y_test, k=k,
                            engine="distributed", mesh=grid)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = c.read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    c.expect("[13] sti distributed (2, 2)", got, distance=4, rank_sort=4,
             sti_fill_acc_rect=4)
    phi = res.phi
    if tuple(phi.shape) != (n, n) or res.meta["mesh"] != {"data": 2,
                                                          "model": 2}:
        fail(f"[13] phi {tuple(phi.shape)}, mesh {res.meta['mesh']}")
    err, scale = blocks_err(torch, phi, ref)
    derr = float((phi.diagonal() - ref.diagonal()).abs().max())
    dscale = float(ref.diagonal().abs().max())
    symmetric = all(bool(torch.equal(phi[r0:r0 + 4096],
                                     phi[:, r0:r0 + 4096].T))
                    for r0 in range(0, n, 4096))
    out["sti"] = dict(grid=[2, 2], ms=ev0.elapsed_time(ev1), wall_s=wall_s,
                      peak_gib=peak, held_before_gib=base,
                      max_abs_err=err, max_abs_ref=scale,
                      diag_max_abs_err=derr, symmetric=symmetric,
                      launches=got)
    log(f"[13] sti distributed on a (data 2, model 2) grid of one card, "
        f"n={n} d={c.d} k={k} t={t}: {out['sti']['ms']:.2f} ms (CUDA "
        f"events; {wall_s:.3f} s wall), peak device memory {peak:.2f} GiB "
        f"({base:.2f} GiB held before, [4]'s phi among it; {held:.2f} before "
        f"that), launches {got}; phi vs [4]'s: max_abs_err {err:.3e} (max "
        f"|ref| {scale:.3e}, tol 1e-6 of it); diagonal max_abs_err "
        f"{derr:.3e} (max |ref| {dscale:.3e}); exactly symmetric "
        f"{symmetric}")
    if not err <= 1e-6 * scale:
        fail(f"[13] distributed phi disagrees with [4]'s: {err} > 1e-6 * "
             f"{scale}")
    if not derr <= 1e-6 * dscale:
        fail(f"[13] distributed diagonal disagrees: {derr}")
    if not symmetric:
        fail("[13] the distributed phi is not exactly symmetric")
    del res, phi
    # the call again, the allocator warm (the first call's CUDA events
    # also hold the host's allocation of the 16 GiB phi), and one cell's
    # rect fill alone at the cell's shape: (n/2, n) at t/2 test points
    out["sti"]["warm_ms"] = cuda_ms(torch, lambda: get_method("sti")(
        c.x_train, c.y_train, c.x_test, c.y_test, k=k,
        engine="distributed", mesh=grid), reps=1)
    from repro_torch.core.sti_knn import ranks_from_order, superdiagonal_g
    from repro_torch.kernels.distance import distance_cuda
    from repro_torch.kernels.sti_fill import (
        rect_row_view, sti_fill_acc_rect_cuda)

    xtr, ytr = c.x_train.to(dev), c.y_train.to(dev)
    xt, yt = c.x_test[:t // 2].to(dev), c.y_test[:t // 2].to(dev)
    order = torch.sort(distance_cuda(xt, xtr), dim=-1, stable=True).indices
    ranks = ranks_from_order(order)
    g = superdiagonal_g((ytr[order] == yt[:, None]).float() / k, k)
    block = torch.zeros((n // 2, n), device=dev)
    rows = rect_row_view(ranks, n // 2, n // 2)
    out["sti"]["cell_fill_ms"] = cuda_ms(
        torch, lambda: sti_fill_acc_rect_cuda(block, g, rows, ranks), reps=2)
    log(f"[13] the call again, allocator warm: "
        f"{out['sti']['warm_ms']:.2f} ms; one cell's rect fill "
        f"({n // 2}, {n}) at {t // 2} test points: "
        f"{out['sti']['cell_fill_ms']:.2f} ms (x4 cells)")
    del block, order, ranks, g, xtr
    torch.cuda.empty_cache()

    # sii on a (2, 2) grid at n = 8192, against the fused engine's sii
    ns = 8192
    c.zero_counts()
    sii = get_method("sii")(c.x_train[:ns], c.y_train[:ns], c.x_test,
                            c.y_test, k=k, engine="distributed", mesh=grid)
    torch.cuda.synchronize()
    got = c.read_counts()
    c.expect("[13] sii distributed (2, 2)", got, distance=4, rank_sort=4,
             sti_fill_acc_rect=4)
    want = get_method("sii")(c.x_train[:ns], c.y_train[:ns], c.x_test,
                             c.y_test, k=k, engine="fused", test_batch=c.tb,
                             device=dev).phi
    serr = float((sii.phi - want).abs().max())
    sscale = float(want.abs().max())
    out["sii"] = dict(n=ns, max_abs_err=serr, max_abs_ref=sscale,
                      launches=got)
    log(f"[13] sii distributed (2, 2) n={ns}: vs the fused engine "
        f"max_abs_err {serr:.3e} (max |ref| {sscale:.3e}, tol 1e-6 of it), "
        f"launches {got}")
    if not serr <= 1e-6 * sscale:
        fail(f"[13] distributed sii disagrees with fused: {serr}")
    del sii, want

    # make_sti_step_fn at full width: one distance, one rank sort and one
    # square fill launch over all t test points, against [4]'s phi x t
    c.zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev0.record()
    phi_sum, diag_sum = make_sti_step_fn(k, "sti", device=dev)(
        c.x_train, c.y_train, c.x_test, c.y_test)
    ev1.record()
    torch.cuda.synchronize()
    got = c.read_counts()
    c.expect("[13] make_sti_step_fn", got, distance=1, rank_sort=1,
             sti_fill_acc=1)
    phi_sum.div_(t)
    err, scale = blocks_err(torch, phi_sum, ref, got_diag=diag_sum / t)
    del phi_sum
    warm_ms = cuda_ms(torch, lambda: make_sti_step_fn(k, "sti", device=dev)(
        c.x_train, c.y_train, c.x_test, c.y_test), reps=1)
    out["step_fn"] = dict(ms=ev0.elapsed_time(ev1), warm_ms=warm_ms,
                          max_abs_err=err,
                          max_abs_ref=scale, launches=got,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[13] make_sti_step_fn n={n} t={t}: {out['step_fn']['ms']:.2f} ms "
        f"({warm_ms:.2f} ms again, allocator warm), launches {got}; (phi_sum, diag_sum) / t vs [4]'s phi: max_abs_err "
        f"{err:.3e} (max |ref| {scale:.3e}, tol 1e-6 of it)")
    if not err <= 1e-6 * scale:
        fail(f"[13] make_sti_step_fn disagrees with [4]: {err}")
    del diag_sum, ref
    torch.cuda.empty_cache()
    return out


def _loss_and_grads(torch, model, params, batch):
    """(loss, gradient leaves) of `model.loss_fn` by autograd."""
    from repro_torch.configs.base import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


def card_vs_cpu_inputs(torch, np, rng):
    """[14a]'s model, CPU parameters (seed 14) and batch (1 x 256 tokens
    drawn from `rng`): qwen3-1.7b's width with 2 layers, f32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3-1.7b").replace(num_layers=2, dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(14), device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (1, 257)).astype(np.int32)
    return model, params, {"tokens": torch.from_numpy(toks[:, :-1]),
                           "labels": torch.from_numpy(toks[:, 1:])}


def cpu_host() -> dict:
    """The host CPU as /proc/cpuinfo names it (vendor, model, the vector
    and matrix extensions that pick the CPU kernels) and its core count."""
    info = {}
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return {"cores": os.cpu_count()}
    for line in text.splitlines():
        key, _, val = line.partition(":")
        key = key.strip()
        if key in ("vendor_id", "model name", "flags") and key not in info:
            info[key] = val.strip()
    flags = set(info.pop("flags", "").split())
    return dict(info, cores=os.cpu_count(), extensions=sorted(
        flags & {"avx2", "avx512f", "avx512_bf16", "avx512_vnni",
                 "amx_tile", "amx_bf16", "fma"}))


CPU_ENV = ("ATEN_CPU_CAPABILITY", "MKL_CBWR", "OMP_NUM_THREADS",
           "MKL_NUM_THREADS")


def cpu_settings(torch) -> dict:
    """The CPU math settings of this process and its host."""
    return {"cpu_threads": torch.get_num_threads(),
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "mkl": torch.backends.mkl.is_available(),
            "env": {k: os.environ.get(k) for k in CPU_ENV},
            "host": cpu_host()}


def grads_ref(torch, np) -> dict:
    """[14a]'s CPU side: the loss and gradient leaves."""
    model, params, batch = card_vs_cpu_inputs(
        torch, np, np.random.default_rng(14))
    loss, grads = _loss_and_grads(torch, model, params, batch)
    return {"loss": float(loss), "grads": list(grads)}


def moe_ref(torch, np) -> dict:
    model, params, toks = moe_case_inputs(torch, np)
    return {which: moe_case_run(torch, model, params, toks, which)
            for which in SCALES}


def xlstm_ref(torch, np) -> dict:
    model, params, toks = xlstm_case_inputs(torch, np)
    return {which: xlstm_case_run(torch, model, params, toks, which)
            for which in XLSTM_SCALES}


def mamba_ref(torch, np) -> dict:
    return mamba_case_run(torch, *mamba_case_inputs(torch, np))


CPU_REFS = {"grads": grads_ref, "moe": moe_ref, "xlstm": xlstm_ref,
            "mamba": mamba_ref}


def cpu_ref_main(cases: str, out_dir: str) -> None:
    """`chip_smoke.py --cpu-ref CASE[,CASE...] DIR`: the CPU sides of the
    card-vs-CPU checks ([14a] "grads", [15a] "moe", [16a] "xlstm", [17a]
    "mamba", [18a] "whisper", [19a] "internvl", [20a] "grads_<case>"), in
    a process of its own so that nothing an earlier phase
    left in the parent (threads, allocator, floating-point state) touches
    the reference. Saves DIR/CASE.pt for each case in turn (written whole,
    then renamed), with its seconds, the CPU settings and the host."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    for case in cases.split(","):
        t0 = time.perf_counter()
        res = CPU_REFS[case](torch, np)
        res.update(seconds=time.perf_counter() - t0,
                   settings=cpu_settings(torch))
        part = Path(out_dir) / f"{case}.part"
        torch.save(res, part)
        part.rename(Path(out_dir) / f"{case}.pt")


class CpuRefs:
    """One `cpu_ref_main` child computing `cases` in order, each saved to
    a temporary directory; `get` waits for a case, `close` ends the child
    and removes the directory. The child runs MKL in its conditional
    numerical reproducibility mode: by default MKL's f32 products come out
    one of two ways from process to process on one host, one of them
    1.85e-4 of its max off in a gradient (grad_reference_probe.py)."""

    def __init__(self, cases: str):
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_cpu_refs_")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-ref", cases,
             self.tmp], env=dict(os.environ, MKL_CBWR="AVX2"))

    def get(self, torch, case: str, limit_s: float = 900):
        """The child's result for `case`, once written; fails if the child
        ended without it or `limit_s` passed."""
        path = Path(self.tmp) / f"{case}.pt"
        t0 = time.perf_counter()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                fail(f"the CPU-side child ended ({self.proc.returncode}) "
                     f"without {case}")
            if time.perf_counter() - t0 > limit_s:
                fail(f"the CPU side of {case} took over {limit_s} s")
            time.sleep(0.2)
        return torch.load(path)

    def close(self) -> None:
        """Let the child end (it exits after its last result), or end it."""
        if self.proc.poll() is None:
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def restart_drill(torch, np, dev, c, label, cfg) -> dict:
    """The restart drill of `cfg` (a reduced config): 6 Trainer steps on
    `launch.train.synthetic_batch`es of 4 x 256 tokens (and the family's
    patches or frames) with ckpt_every 3; a fresh Trainer, its params drawn
    from another seed, restores step 6 bit for bit; one checkpoint write
    and restore timed. No flash launch (training differentiates the
    blockwise attention)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import tree_leaves
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    ck_root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        tcfg = TrainerConfig(steps=6, log_every=1, ckpt_every=3,
                             ckpt_dir=str(ck_root / "run"),
                             opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                             total_steps=6))
        tr = Trainer(cfg, tcfg, device=dev)
        params, opt_state = tr.init_state(0)
        c.zero_counts()
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        params, opt_state, hist = tr.fit(
            params, opt_state, lambda step: synthetic_batch(cfg, step, 4,
                                                            256))
        fit_s = time.perf_counter() - t0
        got = dict(c.read_counts(),
                   flash_attention=flash_attention_cuda.launches)
        c.expect(label, got, flash_attention=0)
        t0 = time.perf_counter()
        Checkpointer(ck_root / "timed").save(6, (params, opt_state))
        write_s = time.perf_counter() - t0
        tr2 = Trainer(cfg, tcfg, device=dev)
        p2, o2 = tr2.init_state(1)
        t0 = time.perf_counter()
        p2, o2, start = tr2.maybe_restore(p2, o2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(a.device == b.device and torch.equal(a, b)
                   for a, b in zip(tree_leaves((p2, o2)),
                                   tree_leaves((params, opt_state))))
        size_gib = sum(a.numel() * a.element_size()
                       for a in tree_leaves((params, opt_state))) / 2**30
        out = dict(arch=cfg.name, params=tr.model.num_params(),
                   losses=[h["loss"] for h in hist], fit_s=fit_s,
                   start=start, bit_identical=same, checkpoint_gib=size_gib,
                   write_s=write_s, restore_s=restore_s, launches=got)
        shown = ", ".join(f"{v:.4f}" for v in out["losses"])
        log(f"{label} restart drill, reduced {cfg.name} "
            f"({tr.model.num_params() / 1e6:.1f} M params): 6 steps in "
            f"{fit_s:.2f} s (checkpoints at 3 and 6), losses {shown}; a "
            f"fresh Trainer resumed at step {start}, leaves bit-identical "
            f"{same}; one {size_gib:.2f} GiB checkpoint written (snapshot, "
            f"np.save, sha256) in {write_s:.2f} s, restored (sha256, load, "
            f"copy to the card) in {restore_s:.2f} s")
        if start != 6 or not same:
            fail(f"{label} restart at {start}, bit-identical {same}")
        if not all(np.isfinite(out["losses"])):
            fail(f"{label} a loss is not finite")
        del params, opt_state, p2, o2, tr, tr2
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def training_phase(torch, np, dev, c, refs) -> dict:
    """[14]: the LM training path of qwen3-1.7b: card against CPU at full
    width with 2 layers (the CPU side from `refs`, a `CpuRefs` child);
    4 Trainer steps at full width and depth; the restart drill at the
    reduced config."""
    from repro_torch.checkpoint.checkpointer import _flatten, _keystr
    from repro_torch.configs.base import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.train import reduced_config
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    out = {}
    full = get_config("qwen3-1.7b")
    rng = np.random.default_rng(14)

    def zero_counts():
        c.zero_counts()
        flash_attention_cuda.launches = 0

    def read_counts():
        return dict(c.read_counts(),
                    flash_attention=flash_attention_cuda.launches)

    def tokens(b, s, vocab):
        toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        return {"tokens": torch.from_numpy(toks[:, :-1]),
                "labels": torch.from_numpy(toks[:, 1:])}

    # [14a] the card against the CPU: full width, 2 layers, f32, TF32 off;
    # the CPU side in a process of its own (`cpu_ref_main`), its MKL in the
    # conditional numerical reproducibility mode: by default MKL's f32
    # products here come out one of two ways from run to run on one host,
    # one of them 1.85e-4 of its max off in ffn.w1's gradient
    # (grad_reference_probe.py)
    model, params, batch = card_vs_cpu_inputs(torch, np, rng)
    ref = refs.get(torch, "grads")
    closs, cgrads, cpu_s = ref["loss"], ref["grads"], ref["seconds"]
    gparams = tree_map(lambda p: p.to(dev), params)
    zero_counts()
    gloss, ggrads = _loss_and_grads(
        torch, model, gparams, {k_: v.to(dev) for k_, v in batch.items()})
    torch.cuda.synchronize()
    rel = abs(float(gloss) - float(closs)) / abs(float(closs))
    errs = []
    for (path, _), g, w in zip(_flatten(params), ggrads, cgrads):
        scale = float(w.abs().max())
        errs.append((float((g.cpu() - w).abs().max()) / max(scale, 1e-30),
                     _keystr(path)))
    worst, worst_leaf = max(errs)
    got = read_counts()
    settings = ref["settings"]
    out["card_vs_cpu"] = dict(layers=2, tokens=256, loss_cpu=float(closs),
                              loss_card=float(gloss), loss_rel_err=rel,
                              worst_leaf_rel_err=worst,
                              worst_leaf=worst_leaf, cpu_s=cpu_s,
                              leaf_rel_errs={nm: e for e, nm in errs},
                              settings=settings, launches=got)
    log(f"[14a] qwen3-1.7b width, 2 layers, f32, 1 x 256 tokens: loss card "
        f"{float(gloss):.6f} vs CPU {float(closs):.6f} (rel {rel:.2e}, tol "
        f"1e-4); worst gradient leaf max_abs_err / max |value| {worst:.2e} "
        f"({worst_leaf}; tol 1e-4) over {len(cgrads)} leaves; CPU side "
        f"{cpu_s:.1f} s in a process of its own ({settings}); launches "
        f"{got}")
    if not rel <= 1e-4 or not worst <= 1e-4:
        fail(f"[14a] card and CPU disagree: loss rel {rel}, worst leaf "
             f"{worst}")
    c.expect("[14a]", got, flash_attention=0)
    del params, gparams, cgrads, ggrads, model, ref
    torch.cuda.empty_cache()

    # [14b] full width and depth: bf16 activations, f32 params and AdamW,
    # remat "block"; 4 steps on one fixed batch of 2 x 2048 tokens
    fixed = tokens(2, 2048, full.vocab_size)
    tcfg = TrainerConfig(steps=4, log_every=1, opt=AdamWConfig(
        warmup_steps=1, total_steps=4))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(full, tcfg, device=dev)
    t0 = time.perf_counter()
    params, opt_state = tr.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    zero_counts()
    params, opt_state, hist = tr.fit(params, opt_state, lambda s: fixed)
    got = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    step_s = [h["time_s"] for h in hist]
    steady = sum(step_s[1:]) / len(step_s[1:])
    n_tok = 2 * 2048
    out["full"] = dict(arch=full.name, layers=full.num_layers,
                       params=tr.model.num_params(), tokens_per_step=n_tok,
                       losses=losses, grad_norms=norms, step_s=step_s,
                       steady_step_ms=1e3 * steady,
                       tokens_per_s=n_tok / steady, peak_gib=peak,
                       held_before_gib=held, init_s=init_s, launches=got)
    log(f"[14b] {full.name} full width and depth "
        f"({tr.model.num_params() / 1e9:.3f} B params), bf16 activations, "
        f"f32 params and AdamW, remat {full.remat}: losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; grad norms "
        f"{', '.join(f'{v:.3f}' for v in norms)}; step s "
        f"{', '.join(f'{v:.3f}' for v in step_s)} (steps 1-3 "
        f"{1e3 * steady:.1f} ms = {n_tok / steady:.0f} tokens/s); peak "
        f"device memory {peak:.2f} GiB ({held:.2f} held before); init "
        f"{init_s:.2f} s; launches {got}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        fail(f"[14b] losses {losses}, grad norms {norms}: not finite and "
             f"decreasing")
    c.expect("[14b]", got, flash_attention=0)
    # where a step's time goes: one more step under torch.profiler
    batch = {k_: v.to(dev) for k_, v in fixed.items()}
    busy = device_busy(torch, lambda: tr.step(params, opt_state, batch),
                       top=10)
    if busy is None:
        log("[14b] torch.profiler traced no device time: busy share not "
            "measured")
    else:
        busy["busy_share"] = busy["busy_ms"] / (1e3 * steady)
        log(f"[14b] one step: device busy {busy['busy_ms']:.1f} ms of "
            f"{1e3 * steady:.1f} ms wall ({100 * busy['busy_share']:.1f} %); "
            f"top kernels (ms): " + ", ".join(
                f"{nm[:48]} {ms:.1f}" for nm, ms in busy["top"]))
    out["full"]["device_busy"] = busy
    del params, opt_state, tr, batch
    torch.cuda.empty_cache()

    # [14c] the restart drill at reduced_config(qwen3-1.7b)
    out["restart"] = restart_drill(torch, np, dev, c, "[14c]",
                                   reduced_config(full))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------- [15]-[17]: the families
# the parameter scales [15a] and [16a] run at: the port's init, which
# draws each stacked weight at 1/sqrt(num_groups) as the reference does
# (ROADMAP.md queue C 1.6), the fan-in scale that init means, and (xlstm)
# that scale with every normal leaf at 1/16 of it, as the CPU parity
# tests hold whole models (tests/test_torch_families.py)
SCALES = ("init", "fan_in")
XLSTM_SCALES = ("init", "fan_in", "fan_in/16")


def fan_in_factor(pd) -> float:
    """What takes a leaf of description `pd` from the port's init scale
    to the fan-in scale: a stacked default-scale normal weight matrix is
    drawn at 1/sqrt(num_groups) (the reference's `_leaf_init` reads the
    fan-in off the stacked layers axis), meant as 1/sqrt(its input
    dimension, shape[-2]); every other leaf keeps its scale (1.0)."""
    if (pd.init == "normal" and not pd.scale and pd.axes[0] == "layers"
            and len(pd.shape) >= 3):
        return (pd.shape[0] / pd.shape[-2]) ** 0.5
    return 1.0


def at_scale(torch, model, params, which: str):
    """`params` as drawn ("init"), at the fan-in scale ("fan_in"), or at
    it with every normal leaf times 1/16 ("fan_in/16"); new tensors."""
    from repro_torch.configs.base import PD, tree_map

    if which == "init":
        return params
    tame = 1.0 / 16 if which == "fan_in/16" else 1.0
    return tree_map(
        lambda p, pd: p * fan_in_factor(pd) * (
            tame if pd.init == "normal" else 1.0),
        params, model.desc(), is_leaf=lambda x: isinstance(x, PD))


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want|, on the host in f32."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def moe_case_inputs(torch, np):
    """[15a]'s model, CPU parameters (seed 15) and tokens (1 x 256, numpy
    seed 15): mixtral-8x7b's full width with 1 layer, f32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config("mixtral-8x7b").replace(num_layers=1,
                                             dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(15), device="cpu")
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, (1, 256))
    return model, params, torch.from_numpy(toks)


def moe_case_run(torch, model, params, toks, which) -> dict:
    """[15a] on the device of `params` at the scale `which`: the train
    forward's logits (the real vocab) and aux loss, and its MoE layer's
    routing (expert indices, queue positions, keep mask), on the host."""
    from repro_torch.configs.base import tree_leaves
    from repro_torch.models import moe as MOE

    dev = tree_leaves(params)[0].device
    params = at_scale(torch, model, params, which)
    seen, route = [], MOE.route

    def recording(xg, router, cfg):
        seen.append(route(xg, router, cfg))
        return seen[-1]

    MOE.route = recording
    try:
        with torch.no_grad():
            logits, _, _, aux = model._fwd(params, {"tokens": toks.to(dev)},
                                           "train")
    finally:
        MOE.route = route
    (r,) = seen
    return {"logits": logits[..., :model.cfg.vocab_size].cpu(),
            "aux": float(aux), "gate_idx": r.gate_idx.cpu(),
            "pos": r.pos.cpu(), "keep": r.keep.cpu()}


def xlstm_case_inputs(torch, np):
    """[16a]'s model, CPU parameters (seed 16) and tokens (1 x 608, numpy
    seed 16): xlstm-1.3b's full width with one group (7 mLSTM + 1
    sLSTM), f32; 600 tokens are three mLSTM chunks, the last ragged."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config("xlstm-1.3b").replace(num_layers=8, dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(16), device="cpu")
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (1, 608))
    return model, params, torch.from_numpy(toks)


def xlstm_case_run(torch, model, params, toks, which) -> dict:
    """[16a] on the device of `params` at the scale `which`: the train
    forward over 600 tokens, a prefill of 600, then 8 decode steps of the
    fixed tokens 600-607; the real vocab's logits on the host."""
    from repro_torch.configs.base import tree_leaves

    dev = tree_leaves(params)[0].device
    params = at_scale(torch, model, params, which)
    toks, nv, s = toks.to(dev), model.cfg.vocab_size, 600
    with torch.no_grad():
        train = model._fwd(params, {"tokens": toks[:, :s]}, "train")[0]
        last, caches = model.prefill(params, {"tokens": toks[:, :s]})
        dec = []
        for t in range(8):
            lg, caches = model.decode_step(params, {
                "tokens": toks[:, s + t:s + t + 1], "caches": caches,
                "index": s + t})
            dec.append(lg)
    return {"train": train[..., :nv].cpu(), "prefill": last[..., :nv].cpu(),
            "decode": torch.cat(dec, 1)[..., :nv].cpu()}


def mamba_case_inputs(torch, np):
    """[17a]'s Mamba mixer at jamba-v0.1-52b's full width (d_model 4096,
    d_inner 8192, state 16, dt_rank 256, conv 4), f32, its CPU parameters
    (seed 17), a 1 x 1100 input (chunks 512, 512, 76) and 8 one-token
    decode inputs (numpy seed 17)."""
    from repro_torch.configs.base import init_params
    from repro_torch.configs.registry import get_config
    from repro_torch.models import ssm as S

    cfg = get_config("jamba-v0.1-52b").replace(dtype=torch.float32)
    params = init_params(S.mamba_desc(cfg), torch.Generator().manual_seed(17),
                         device="cpu")
    rng = np.random.default_rng(17)
    x = rng.normal(size=(1, 1100, cfg.d_model)).astype(np.float32)
    xs = rng.normal(size=(8, 1, 1, cfg.d_model)).astype(np.float32)
    return cfg, params, torch.from_numpy(x), torch.from_numpy(xs)


def mamba_case_run(torch, cfg, params, x, xs) -> dict:
    """[17a] on the device of `params`: the forward over x from no state,
    then 8 decode steps from its state; outputs and the final state on
    the host."""
    from repro_torch.models import ssm as S

    dev = params["in_proj"].device
    with torch.no_grad():
        y, st = S.mamba_forward(params, x.to(dev), cfg)
        ys = []
        for x1 in xs.to(dev):
            y1, st = S.mamba_decode_step(params, x1, cfg, st)
            ys.append(y1)
    return {"y": y.cpu(), "decode": torch.cat(ys, 1).cpu(),
            "conv": st.conv.cpu(), "ssm": st.ssm.cpu()}


def free_phase(torch, label: str) -> None:
    """Collect what a phase left and log the card's memory after it."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{label} device memory after: {device_gib(torch)}")


def mixer_share(torch, model, params, toks, kind: str) -> dict:
    """Host seconds of one prefill of `toks` and of its `kind` mixers
    within it (each call fenced by synchronizes, so their sum is the time
    the card and host spend in them)."""
    from repro_torch.models import transformer as T

    mixer = T._MIXERS[kind]
    spent = [0.0]

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mixer.forward(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    T._MIXERS[kind] = mixer._replace(forward=timed)
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
    finally:
        T._MIXERS[kind] = mixer
    return {"prefill_ms": 1e3 * total, f"{kind}_ms": 1e3 * spent[0],
            "share": spent[0] / total}


def serve_family(torch, np, dev, label, name, layers, max_len, n_req, lo,
                 hi, seed, param_dtype, want_flash, share_kind=None) -> dict:
    """Serve `n_req` greedy requests of lo..hi prompt tokens through
    `name` at full width with `layers` layers (params of `param_dtype`
    drawn on the card from seed 0, at the fan-in scale), 4 slots,
    `max_len`; with `share_kind`, the share of that mixer in one prefill
    of the longest prompt."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import ServeConfig

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, model, params = draw_on_card(torch, dev, label, name, param_dtype,
                                      num_layers=layers)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    out = serve_measure(torch, np, dev, label, cfg, model, params,
                        ServeConfig(max_slots=4, max_len=max_len, eos_id=-1),
                        prompts, busy_steps=8, want_flash=want_flash)
    out.update(init_s=init_s, param_dtype=str(param_dtype)[6:],
               full_layers=get_config(name).num_layers)
    if share_kind:
        toks = torch.from_numpy(prompts[int(np.argmax(lens))][None]).to(dev)
        out["mixer_share"] = mixer_share(torch, model, params, toks,
                                         share_kind)
        sh = out["mixer_share"]
        log(f"{label} one prefill of {int(lens.max())} tokens, each "
            f"{share_kind} call fenced: {sh['prefill_ms']:.1f} ms, "
            f"{share_kind} layers {sh[share_kind + '_ms']:.1f} ms "
            f"({100 * sh['share']:.1f} %)")
    del params, model
    return out


def families_phase(torch, np, dev, c, refs) -> dict:
    """[15]-[17]: the MoE, xLSTM and hybrid decoder families at full
    width: each card-vs-CPU check (the CPU sides from `refs`, a
    `CpuRefs` child started first and read as each check needs it), the
    flash kernel at mixtral's attention shape, and each family served."""
    from repro_torch.configs.base import tree_map
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)

    out, phase_s = {}, {}
    # [15a] mixtral's full width, 1 layer, f32, TF32 off, 1 x 256
    # tokens, at the init scale (logged) and the fan-in scale (held)
    t = time.perf_counter()
    log(f"[15a] device memory before: {device_gib(torch)}")
    model, host, toks = moe_case_inputs(torch, np)
    params = tree_map(lambda t: t.to(dev), host)
    del host
    gc.collect()
    host_gib = host_peak_gib()
    c.zero_counts()
    flash_attention_cuda.launches = 0
    got = {which: moe_case_run(torch, model, params, toks, which)
           for which in SCALES}
    launches = dict(c.read_counts(),
                    flash_attention=flash_attention_cuda.launches)
    del params
    ref = refs.get(torch, "moe")
    res = {}
    for which in SCALES:
        g, r = got[which], ref[which]
        res[which] = dict(
            logits_rel_err=rel_err(torch, g["logits"], r["logits"]),
            aux_card=g["aux"], aux_cpu=r["aux"],
            aux_rel_err=abs(g["aux"] - r["aux"]) / abs(r["aux"]),
            routing_equal={k: bool(torch.equal(g[k], r[k]))
                           for k in ("gate_idx", "pos", "keep")},
            dropped_choices=int((~g["keep"]).sum()))
        log(f"[15a] mixtral-8x7b width, 1 layer, f32, 1 x 256 tokens, "
            f"{which} scale: logits max_abs_err / max |CPU| "
            f"{res[which]['logits_rel_err']:.3e}; aux card "
            f"{g['aux']:.7f} vs CPU {r['aux']:.7f} (rel "
            f"{res[which]['aux_rel_err']:.2e}); routing equal "
            f"{res[which]['routing_equal']} "
            f"({res[which]['dropped_choices']} of {g['keep'].numel()} "
            f"choices dropped)")
    out["moe_card_vs_cpu"] = dict(
        res, cpu_s=ref["seconds"], settings=ref["settings"],
        host_peak_gib=host_gib, launches=launches)
    log(f"[15a] CPU side {ref['seconds']:.1f} s in the child; host peak "
        f"{host_gib:.2f} GiB; launches {launches} (both scales)")
    # held at the fan-in scale (tol: logits 1e-4 of max |CPU|, aux 1e-5
    # relative, routing equal); at the init scale attention saturates
    # and the error is the rounding noise it amplifies
    held = res["fan_in"]
    if not (held["logits_rel_err"] <= 1e-4
            and held["aux_rel_err"] <= 1e-5
            and all(held["routing_equal"].values())):
        fail(f"[15a] card and CPU disagree at the fan-in scale: {held}")
    if launches["flash_attention"] != len(SCALES):
        fail(f"[15a] expected {len(SCALES)} flash launches, got "
             f"{launches}")
    del model, got, ref
    free_phase(torch, "[15a]")
    phase_s["[15a]"] = time.perf_counter() - t

    # [15b] flash at mixtral's attention shape: 32 heads of 128,
    # 8192 tokens, causal, window 4096
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(151)
    shape = (1, 32, 8192, 128)
    flash = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, ferr = hold_flash(torch, gen, dev, "[15b]", *shape,
                                   True, 4096, dtype)
        elt = 4 if dtype == torch.float32 else 2
        ms = cuda_ms(torch, lambda: flash_attention_cuda(
            q, k, v, causal=True, window=4096), reps=10)
        bound, by = flash_bound_ms(*shape[:3], shape[2], shape[3], True,
                                   4096, elt)
        rec = dict(max_abs_err=ferr, ms=ms, bound_ms=bound, bound_by=by)
        if dtype == torch.bfloat16:
            rec["plain_ms"] = cuda_ms(torch, lambda: flash_attention_plain(
                q, k, v, causal=True, window=4096), reps=2)
            i = torch.arange(shape[2], device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] >
                                                 i[:, None] - 4096)
            rec["library_ms"] = cuda_ms(
                torch, lambda: torch.nn.functional.
                scaled_dot_product_attention(q, k, v, attn_mask=mask),
                reps=10)
            del mask
        rate = 4.0 * shape[0] * shape[1] * shape[3] * visible_pairs(
            shape[2], shape[2], True, 4096) / (ms * 1e-3) / 1e12
        rec["tflops"] = rate
        flash[str(dtype)[6:]] = rec
        log(f"[15b] flash_attention {shape} {str(dtype)[6:]} causal "
            f"window 4096: kernel {ms:.4f} ms = {rate:.1f} TFLOP/s, "
            f"bound {bound:.4f} ms ({by})"
            + (f", plain {rec['plain_ms']:.3f} ms, "
               f"scaled_dot_product_attention with the mask "
               f"{rec['library_ms']:.4f} ms" if "plain_ms" in rec
               else ""))
        del q, k, v
    out["flash_window"] = flash
    free_phase(torch, "[15b]")
    phase_s["[15b]"] = time.perf_counter() - t

    # [15c], [15d] the MoE family served at full width, bf16
    t = time.perf_counter()
    # 4 requests (8 before [18]-[20] were added: one wave of the 4 slots
    # instead of two, for the script's time)
    log("[15c] cut: 4 requests (was 8)")
    out["mixtral"] = serve_family(
        torch, np, dev, "[15c]", "mixtral-8x7b", 8, 4224, 4, 3968, 4090,
        15, torch.bfloat16, want_flash=8 * 4)
    free_phase(torch, "[15c]")
    phase_s["[15c]"] = time.perf_counter() - t
    t = time.perf_counter()
    out["phi35_moe"] = serve_family(
        torch, np, dev, "[15d]", "phi3.5-moe-42b-a6.6b", 4, 2112, 4, 1985,
        2039, 151, torch.bfloat16, want_flash=4 * 4)
    free_phase(torch, "[15d]")
    phase_s["[15d]"] = time.perf_counter() - t

    # [16a] xlstm's full width, one group, f32, at each scale; the
    # card's own sensitivity at each: the train logits again with
    # every parameter times (1 + 1e-7 N(0, 1)), f32 rounding's size
    t = time.perf_counter()
    model, host, toks = xlstm_case_inputs(torch, np)
    params = tree_map(lambda t: t.to(dev), host)
    del host
    flash_attention_cuda.launches = 0
    got = {which: xlstm_case_run(torch, model, params, toks, which)
           for which in XLSTM_SCALES}
    launches = flash_attention_cuda.launches
    noise = torch.Generator(device=dev).manual_seed(161)
    nudged = tree_map(lambda p: p * (1 + 1e-7 * torch.randn(
        p.shape, generator=noise, device=dev)), params)
    sens = {which: rel_err(torch, xlstm_case_run(
        torch, model, nudged, toks, which)["train"], got[which]["train"])
        for which in XLSTM_SCALES}
    del params, nudged
    ref = refs.get(torch, "xlstm")
    errs = {which: {part: rel_err(torch, got[which][part],
                                  ref[which][part])
                    for part in ("train", "prefill", "decode")}
            for which in XLSTM_SCALES}
    out["xlstm_card_vs_cpu"] = dict(rel_errs=errs, card_sensitivity=sens,
                                    cpu_s=ref["seconds"],
                                    flash_launches=launches)
    for which in XLSTM_SCALES:
        log(f"[16a] xlstm-1.3b width, one group, f32, {which} scale: "
            f"logits max_abs_err / max |CPU|: train (600) "
            f"{errs[which]['train']:.3e}, prefill "
            f"{errs[which]['prefill']:.3e}, 8 decode steps "
            f"{errs[which]['decode']:.3e}; the card's train logits "
            f"move {sens[which]:.3e} when its parameters move 1e-7")
    log(f"[16a] CPU side {ref['seconds']:.1f} s in the child; flash "
        f"launches {launches}")
    # held where the stack is well conditioned (tol 1e-4 of max |CPU|);
    # at the other scales the error is rounding noise it amplifies
    held = errs["fan_in/16"]
    if not all(e <= 1e-4 for e in held.values()) or launches:
        fail(f"[16a] card and CPU disagree at 1/16 of the fan-in "
             f"scale: {held}, flash launches {launches}")
    del model, got, ref
    free_phase(torch, "[16a]")
    phase_s["[16a]"] = time.perf_counter() - t

    # [16b] xlstm served at full width and depth: f32 params, bf16
    # activations; no attention, so no flash launch
    t = time.perf_counter()
    # 4 requests (8 before [18]-[20] were added), for the script's time
    log("[16b] cut: 4 requests (was 8)")
    out["xlstm"] = serve_family(
        torch, np, dev, "[16b]", "xlstm-1.3b", 48, 1088, 4, 960, 1024, 16,
        torch.float32, want_flash=0, share_kind="slstm")
    free_phase(torch, "[16b]")
    phase_s["[16b]"] = time.perf_counter() - t

    # [17a] one Mamba mixer at jamba's full width, f32
    t = time.perf_counter()
    cfg, host, x, xs = mamba_case_inputs(torch, np)
    params = tree_map(lambda t: t.to(dev), host)
    del host
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    c.zero_counts()
    got = mamba_case_run(torch, cfg, params, x, xs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    # the forward of 1100 positions through the fused scan; the decode
    # steps (s = 1) through the chunked path's one step
    c.expect("[17a]", c.read_counts(), selective_scan=1)
    del params
    ref = refs.get(torch, "mamba")
    errs = {k: rel_err(torch, got[k], ref[k])
            for k in ("y", "decode", "conv", "ssm")}
    out["mamba_card_vs_cpu"] = dict(rel_errs=errs, cpu_s=ref["seconds"],
                                    forward_peak_gib=peak, scan_launches=1)
    log(f"[17a] Mamba mixer at jamba-v0.1-52b width, f32, 1 x 1100 "
        f"(chunks 512, 512, 76), then 8 decode steps: max_abs_err / "
        f"max |CPU| {errs} (tol 1e-4); peak {peak:.2f} GiB above the "
        f"params; CPU side {ref['seconds']:.1f} s in the child")
    if not all(e <= 1e-4 for e in errs.values()):
        fail(f"[17a] card and CPU disagree: {errs}")
    del got, ref
    free_phase(torch, "[17a]")
    phase_s["[17a]"] = time.perf_counter() - t

    # [17b] jamba served at full width, one group of 8 of 32 layers, bf16
    t = time.perf_counter()
    c.zero_counts()
    out["jamba"] = serve_family(
        torch, np, dev, "[17b]", "jamba-v0.1-52b", 8, 2112, 4, 1985, 2039, 17,
        torch.bfloat16, want_flash=1 * 4, share_kind="mamba")
    torch.cuda.synchronize()
    # 7 Mamba layers of the 8 in each prefill: the 4 requests', the busy
    # share's and the mixer share's (the decode steps scan no kernel)
    scans = c.read_counts()["selective_scan"]
    out["jamba"]["scan_launches"] = scans
    log(f"[17b] selective_scan launches {scans}")
    c.expect("[17b]", c.read_counts(), selective_scan=7 * (4 + 1 + 1))
    free_phase(torch, "[17b]")
    phase_s["[17b]"] = time.perf_counter() - t
    out["phase_s"] = phase_s
    return out


# ------------------------------------ [18]-[20]: audio, VLM, family training
# Whisper's decoder prompt: start-of-transcript, English, transcribe, no
# timestamps
WHISPER_PROMPT = (50258, 50259, 50359, 50363)


def grow_caches(torch, model, caches, b: int, n: int, max_len: int, dev):
    """A decode pool of `max_len` positions (`Model.init_caches`) holding a
    prefill's caches of `n` positions: KV caches copied into its first n
    slots (tests/test_models_smoke.py's `grow`), cross (xkv) caches and SSM
    states taken as they are."""
    pool = model.init_caches(b, max_len, device=dev)
    for pc, one in zip(pool, caches):
        if "kv" in pc:
            pc["kv"].k[..., :n, :] = one["kv"].k
            pc["kv"].v[..., :n, :] = one["kv"].v
            pc["kv"].pos[..., :n] = one["kv"].pos
        for key in ("xkv", "ssm"):
            if key in pc:
                pc[key] = one[key]
    return pool


def enc_vlm_case_inputs(torch, np, name: str):
    """[18a] / [19a]'s model, CPU parameters and inputs, f32 at full width:
    whisper-small with 2 encoder and 2 decoder layers, 1 x 1500 frames and
    72 tokens (64 prompt + 8 decoded); internvl2-2b with 2 layers, 1 x 256
    patch embeddings and 264 tokens (256 + 8). Seeds 18 / 19."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    seed = 18 if name == "whisper-small" else 19
    cfg = get_config(name).replace(num_layers=2, dtype=torch.float32)
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        extra = {"frames": rng.normal(size=(1, cfg.encoder_seq, cfg.d_model))}
        s = 64
    else:
        extra = {"patch_embeds": rng.normal(
            size=(1, cfg.num_patches, cfg.d_model))}
        s = 256
    extra = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in extra.items()}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s + 8)))
    return model, params, extra, toks, s


def enc_vlm_case_run(torch, model, params, extra, toks, s, which) -> dict:
    """[18a] / [19a] on the device of `params` at the scale `which`: the
    prefill's logits at every position (the real vocab), then 8 greedy-free
    decode steps of the fixed tokens s..s+7 from the prefill's caches; for
    audio also the encoder output. On the host."""
    from repro_torch.configs.base import tree_leaves
    from repro_torch.models import whisper as W

    dev = tree_leaves(params)[0].device
    params = at_scale(torch, model, params, which)
    cfg, nv = model.cfg, model.cfg.vocab_size
    extra = {k: v.to(dev) for k, v in extra.items()}
    toks = toks.to(dev)
    n = s + (cfg.num_patches if "patch_embeds" in extra else 0)
    out = {}
    with torch.no_grad():
        if cfg.family == "audio":
            out["encoder"] = W.encode(params, cfg, extra["frames"]).cpu()
        logits, _, caches, _ = model._fwd(
            params, dict(extra, tokens=toks[:, :s]), "prefill")
        pool = grow_caches(torch, model, caches, 1, n, n + 8, dev)
        dec = []
        for t in range(8):
            lg, pool = model.decode_step(params, {
                "tokens": toks[:, s + t:s + t + 1], "caches": pool,
                "index": n + t})
            dec.append(lg)
    out.update(prefill=logits[..., :nv].cpu(),
               decode=torch.cat(dec, 1)[..., :nv].cpu())
    return out


def whisper_ref(torch, np) -> dict:
    model, params, extra, toks, s = enc_vlm_case_inputs(torch, np,
                                                        "whisper-small")
    return {which: enc_vlm_case_run(torch, model, params, extra, toks, s,
                                    which) for which in SCALES}


def internvl_ref(torch, np) -> dict:
    model, params, extra, toks, s = enc_vlm_case_inputs(torch, np,
                                                        "internvl2-2b")
    return {which: enc_vlm_case_run(torch, model, params, extra, toks, s,
                                    which) for which in SCALES}


# [20a]'s models: (arch, cut, tokens, the scale held); each also runs at
# the init scale (logged). xlstm is held at 1/16 of the fan-in scale, as
# [16a] is: at the fan-in scale the card moves its own logits by 1.1e-4
# under 1e-7 parameter noise.
GRAD_CASES = {
    "whisper": ("whisper-small", dict(num_layers=1, encoder_layers=1), 128,
                "fan_in"),
    "internvl": ("internvl2-2b", dict(num_layers=2), 256, "fan_in"),
    "mixtral": ("mixtral-8x7b", dict(num_layers=1), 128, "fan_in"),
    "xlstm": ("xlstm-1.3b", dict(num_layers=8), 256, "fan_in/16"),
}


def grad_case_inputs(torch, np, key: str):
    """[20a]'s model, CPU parameters (seed 20) and batch (numpy seed 20):
    `GRAD_CASES[key]` at full width, f32; the VLM's 256 patch embeddings
    and the audio family's 1500 frames besides the tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    name, cut, s, _ = GRAD_CASES[key]
    cfg = get_config(name).replace(dtype=torch.float32, **cut)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(20), device="cpu")
    rng = np.random.default_rng(20)
    toks = rng.integers(0, cfg.vocab_size, (1, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(1, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return model, params, {k: torch.from_numpy(v) for k, v in batch.items()}


def grad_case_run(torch, model, params, batch, which) -> dict:
    """The loss and every gradient leaf of `model.loss_fn` at the scale
    `which`, on the device of `params`; the gradients on the host."""
    from repro_torch.configs.base import tree_leaves

    dev = tree_leaves(params)[0].device
    loss, grads = _loss_and_grads(
        torch, model, at_scale(torch, model, params, which),
        {k: v.to(dev) for k, v in batch.items()})
    return {"loss": float(loss), "grads": [g.cpu() for g in grads]}


def mamba_grad_inputs(torch, np):
    """[20a]'s Mamba mixer at jamba-v0.1-52b's full width, f32, its CPU
    parameters (seed 20), a 1 x 512 input and the fixed weights of its
    scalar loss sum(y * w) (numpy seed 20)."""
    from repro_torch.configs.base import init_params
    from repro_torch.configs.registry import get_config
    from repro_torch.models import ssm as S

    cfg = get_config("jamba-v0.1-52b").replace(dtype=torch.float32)
    params = init_params(S.mamba_desc(cfg), torch.Generator().manual_seed(20),
                         device="cpu")
    rng = np.random.default_rng(20)
    x, w = (torch.from_numpy(rng.normal(size=(1, 512, cfg.d_model)).astype(
        np.float32)) for _ in range(2))
    return cfg, params, x, w


def mamba_grad_run(torch, cfg, params, x, w) -> dict:
    """The loss sum(mamba_forward(x) * w) and its gradients (every
    parameter leaf, then x) on the device of `params`, on the host."""
    from repro_torch.configs.base import tree_leaves
    from repro_torch.models import ssm as S

    dev = params["in_proj"].device
    x = x.to(dev).requires_grad_(True)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    y, _ = S.mamba_forward(params, x, cfg)
    loss = (y * w.to(dev)).sum()
    grads = torch.autograd.grad(loss, leaves + [x])
    for p in leaves:
        p.requires_grad_(False)
    return {"loss": float(loss.detach()),
            "grads": [g.cpu() for g in grads]}


def grads_case_ref(key: str):
    """The CPU side of [20a]'s case `key`: each of its scales."""
    def ref(torch, np) -> dict:
        if key == "mamba":
            return {"plain": mamba_grad_run(torch,
                                            *mamba_grad_inputs(torch, np))}
        model, params, batch = grad_case_inputs(torch, np, key)
        return {which: grad_case_run(torch, model, params, batch, which)
                for which in ("init", GRAD_CASES[key][3])}
    return ref


CPU_REFS.update({"whisper": whisper_ref, "internvl": internvl_ref,
                 **{f"grads_{key}": grads_case_ref(key)
                    for key in (*GRAD_CASES, "mamba")}})
# the child's cases in the order [14]-[20] read them
REF_CASES = ",".join(
    ["grads", "moe", "xlstm", "mamba", "whisper", "internvl"]
    + [f"grads_{key}" for key in (*GRAD_CASES, "mamba")])


def host_free_gib() -> float:
    """MemAvailable of /proc/meminfo, GiB (nan where it cannot be read)."""
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return float("nan")


def batch_serve(torch, np, dev, label, model, params, batch, max_len,
                want_flash) -> dict:
    """Prefill `batch` (tokens, and the family's frames or patches) as one
    batch through `Model.prefill`, grow its caches to `max_len` positions
    (`grow_caches`) and decode greedily through `Model.decode_step` until
    position max_len - 1 is filled. Fails unless the prefill launches the
    flash kernel `want_flash` times, decode none, no logit row is NaN and
    every token is in the vocab. The prefill is timed after one untimed
    warm-up prefill of the same batch. Returns prefill ms, decode ms per
    step,
    tokens/s, peak memory and the device busy share (torch.profiler over
    one prefill and 8 decode steps against the unprofiled times)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cfg = model.cfg
    b = batch["tokens"].shape[0]
    n = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1]
                                    if "patch_embeds" in batch else 0)
    with torch.no_grad():
        # one untimed prefill first: the first call of each shape pays for
        # the libraries' set-up (cuBLAS handles, kernel selection)
        model.prefill(params, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        last, caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = flash_attention_cuda.launches
        pool = grow_caches(torch, model, caches, b, n, max_len, dev)
        del caches
        tok = last[:, 0].argmax(-1)
        nan_seen = torch.isnan(last).any()
        made = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for index in range(n, max_len - 1):
            logits, pool = model.decode_step(params, {
                "tokens": tok[:, None], "caches": pool, "index": index})
            nan_seen |= torch.isnan(logits).any()
            tok = logits[:, 0].argmax(-1)
            made.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    steps = max_len - 1 - n
    made = torch.stack(made, 1).cpu()
    decode_launches = flash_attention_cuda.launches - prefill_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = made.numel()
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               params=model.num_params(), batch=b, prompt_positions=n,
               decode_steps=steps, generated_tokens=n_tok,
               prefill_ms=1e3 * prefill_s,
               decode_ms_per_step=1e3 * decode_s / max(steps, 1),
               tokens_per_s=n_tok / (prefill_s + decode_s), peak_gib=peak,
               flash_launches=prefill_launches,
               decode_flash_launches=decode_launches)
    log(f"{label} {cfg.name} ({cfg.num_layers} layers, "
        f"{model.num_params() / 1e9:.3f} B params): one batch of {b} x {n} "
        f"prompt positions prefilled in {out['prefill_ms']:.1f} ms "
        f"({prefill_launches} flash launches), {steps} greedy decode steps "
        f"at {out['decode_ms_per_step']:.2f} ms a step ({decode_launches} "
        f"flash launches), {n_tok} tokens = {out['tokens_per_s']:.1f} "
        f"tokens/s; peak device memory {peak:.2f} GiB")
    if prefill_launches != want_flash or decode_launches:
        fail(f"{label} expected {want_flash} flash launches in the prefill "
             f"and none in decode, got {prefill_launches} and "
             f"{decode_launches}")
    if bool(nan_seen):
        fail(f"{label} a logit row held NaN")
    if not bool(((made >= 0) & (made < cfg.vocab_size)).all()):
        fail(f"{label} a token outside the vocab")
    with torch.no_grad():
        dec_batch = {"tokens": tok[:, None], "caches": pool,
                     "index": max_len - 2}
        busy = {"prefill": device_busy(torch, lambda: model.prefill(
                    params, batch)),
                "decode": device_busy(torch, lambda: [model.decode_step(
                    params, dec_batch) for _ in range(8)])}
    if all(v is not None for v in busy.values()):
        for key in ("busy_ms", "flash_ms"):
            busy["decode"][key] /= 8
        busy["decode"]["top"] = [(nm, ms / 8)
                                 for nm, ms in busy["decode"]["top"]]
        for key, wall in (("prefill", out["prefill_ms"]),
                          ("decode", out["decode_ms_per_step"])):
            busy[key]["busy_share"] = busy[key]["busy_ms"] / wall
            log(f"{label} {key}: device busy {busy[key]['busy_ms']:.2f} ms "
                f"of {wall:.2f} ms wall "
                f"({100 * busy[key]['busy_share']:.1f} %), flash attention "
                f"{busy[key]['flash_ms']:.3f} ms; top kernels (ms): "
                + ", ".join(f"{nm[:48]} {ms:.2f}"
                            for nm, ms in busy[key]["top"]))
    else:
        log(f"{label} torch.profiler traced no device time: busy share not "
            f"measured")
    out["device_busy"] = busy
    del pool
    return out


def to_fan_in(model, params) -> None:
    """`params` (as `model.init` draws them, or laid out over a grid as
    `Sharded` blocks, each distinct block scaled once) taken to the
    fan-in scale in place: at the init scale the activations of the
    stacks grow by orders of magnitude a layer (ROADMAP.md queue C
    1.6)."""
    from repro_torch.configs.base import PD, tree_leaves

    for p, pd in zip(tree_leaves(params), tree_leaves(
            model.desc(), is_leaf=lambda x: isinstance(x, PD))):
        for b in (p.tensors() if hasattr(p, "tensors") else (p,)):
            b.mul_(fan_in_factor(pd))


def draw_on_card(torch, dev, label, name, param_dtype, **cut):
    """`name`'s config (with `cut`), its model, and params of
    `param_dtype` drawn on the card from seed 0 at the fan-in scale."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    cfg = get_config(name).replace(**cut)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dtype=param_dtype, device=dev)
    to_fan_in(model, params)
    torch.cuda.synchronize()
    log(f"{label} {name}: {cfg.num_layers} of "
        f"{get_config(name).num_layers} decoder layers"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else "")
        + f", num_params() = {model.num_params()} "
        f"({model.num_params() / 1e9:.3f} B {str(param_dtype)[6:]}), drawn "
        f"on the card at the fan-in scale in {time.perf_counter() - t0:.2f} "
        f"s; {device_gib(torch)}")
    return cfg, model, params


def card_vs_cpu_enc_vlm(torch, np, dev, label, name, refs, case) -> dict:
    """[18a] / [19a]: `enc_vlm_case_run` on the card at each scale against
    the CPU child's, held at the fan-in scale within 1e-4 of max |CPU|."""
    from repro_torch.configs.base import tree_map
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    model, host, extra, toks, s = enc_vlm_case_inputs(torch, np, name)
    params = tree_map(lambda t: t.to(dev), host)
    del host
    flash_attention_cuda.launches = 0
    got = {which: enc_vlm_case_run(torch, model, params, extra, toks, s,
                                   which) for which in SCALES}
    launches = flash_attention_cuda.launches
    del params
    ref = refs.get(torch, case)
    errs = {which: {part: rel_err(torch, got[which][part], ref[which][part])
                    for part in got[which]} for which in SCALES}
    for which in SCALES:
        log(f"{label} {name} width, {model.cfg.num_layers} layers, f32, "
            f"{which} scale: max_abs_err / max |CPU| "
            + ", ".join(f"{part} {e:.3e}" for part, e in errs[which].items()))
    log(f"{label} CPU side {ref['seconds']:.1f} s in the child; flash "
        f"launches {launches} (both scales)")
    cfg = model.cfg
    per_prefill = cfg.num_layers + (2 * cfg.encoder_layers + cfg.num_layers
                                    if cfg.family == "audio" else 0)
    if not all(e <= 1e-4 for e in errs["fan_in"].values()):
        fail(f"{label} card and CPU disagree at the fan-in scale: "
             f"{errs['fan_in']}")
    if launches != per_prefill * len(SCALES):
        fail(f"{label} expected {per_prefill * len(SCALES)} flash launches, "
             f"got {launches}")
    return dict(rel_errs=errs, cpu_s=ref["seconds"], flash_launches=launches,
                settings=ref["settings"])


def audio_phase(torch, np, dev, refs) -> dict:
    """[18]: whisper-small: card vs CPU at full width with 2 + 2 layers,
    the flash kernel at whisper's encoder and cross shapes, and a batch
    served at full width and depth."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.models import whisper as W

    out, phase_s = {}, {}
    t = time.perf_counter()
    out["card_vs_cpu"] = card_vs_cpu_enc_vlm(torch, np, dev, "[18a]",
                                             "whisper-small", refs,
                                             "whisper")
    free_phase(torch, "[18a]")
    phase_s["[18a]"] = time.perf_counter() - t

    # [18b] flash, non-causal, at the encoder's (4, 16, 1500, 64) and the
    # cross (4, 16, 448, 64) x (4, 16, 1500, 64): 12 heads padded to 16,
    # the ragged key edge at 1500 = 23 x 64 + 28 masked by index
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(181)
    flash = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.float32, torch.bfloat16):
        elt = 4 if dtype == torch.float32 else 2
        for part, s, sk in (("encoder", 1500, 1500), ("cross", 448, 1500)):
            q, k, v, err = hold_flash(torch, gen, dev, "[18b]", 4, 16, s, 64,
                                      False, None, dtype, sk=sk)
            ms = cuda_ms(torch, lambda: flash_attention_cuda(
                q, k, v, causal=False), reps=20)
            plain_ms = cuda_ms(torch, lambda: flash_attention_plain(
                q, k, v, causal=False), reps=3)
            lib_ms = cuda_ms(torch, lambda: sdpa(q, k, v), reps=20)
            bound, by = flash_bound_ms(4, 16, s, sk, 64, False, None, elt)
            rate = 4.0 * 4 * 16 * 64 * s * sk / (ms * 1e-3) / 1e12
            flash[f"{part}_{str(dtype)[6:]}"] = dict(
                shape=f"({4}, {16}, {s}, 64) x sk {sk}", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, tflops=rate)
            log(f"[18b] flash_attention (4, 16, {s}, 64) x sk {sk} "
                f"{str(dtype)[6:]} non-causal ({part}): kernel {ms:.4f} ms = "
                f"{rate:.1f} TFLOP/s, plain {plain_ms:.3f} ms, "
                f"scaled_dot_product_attention {lib_ms:.4f} ms "
                f"({ms / lib_ms:.2f}x), bound {bound:.4f} ms ({by})")
            del q, k, v
    out["flash"] = flash
    free_phase(torch, "[18b]")
    phase_s["[18b]"] = time.perf_counter() - t

    # [18c] full width and depth (12 + 12 layers, bf16): 4 requests of
    # 1500 frames and Whisper's 4-token prompt prefilled as one batch,
    # decoded greedily to position 447 (the decoder's 448 positions)
    t = time.perf_counter()
    cfg, model, params = draw_on_card(torch, dev, "[18c]", "whisper-small",
                                      torch.bfloat16)
    frames = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev).to(cfg.dtype)
    toks = torch.tensor(WHISPER_PROMPT, device=dev).expand(4, -1)
    served = batch_serve(torch, np, dev, "[18c]", model, params,
                         {"tokens": toks, "frames": frames}, 448,
                         want_flash=cfg.encoder_layers + 2 * cfg.num_layers)
    with torch.no_grad():
        served["encoder_ms"] = cuda_ms(
            torch, lambda: W.encode(params, cfg, frames), reps=3)
    log(f"[18c] the encoder alone over 4 x 1500 frames: "
        f"{served['encoder_ms']:.2f} ms")
    out["serve"] = served
    del params, model, frames
    free_phase(torch, "[18c]")
    phase_s["[18c]"] = time.perf_counter() - t
    out["phase_s"] = phase_s
    return out


def vlm_phase(torch, np, dev, refs) -> dict:
    """[19]: internvl2-2b: card vs CPU at full width with 2 layers, a
    batch of image + text prompts served at full width and depth, and the
    Engine on text-only prompts."""
    from repro_torch.serving.engine import ServeConfig

    out, phase_s = {}, {}
    t = time.perf_counter()
    out["card_vs_cpu"] = card_vs_cpu_enc_vlm(torch, np, dev, "[19a]",
                                             "internvl2-2b", refs,
                                             "internvl")
    free_phase(torch, "[19a]")
    phase_s["[19a]"] = time.perf_counter() - t

    # [19b] full width and depth (24 layers, bf16): 4 requests of one
    # 448 x 448 tile's 256 patch embeddings + 256 tokens as one batch, 128
    # greedy decode steps; then the Engine on 4 text-only prompts
    t = time.perf_counter()
    cfg, model, params = draw_on_card(torch, dev, "[19b]", "internvl2-2b",
                                      torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(191)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 256),
                                     generator=gen, device=dev),
             "patch_embeds": torch.randn(
                 (4, cfg.num_patches, cfg.d_model), generator=gen,
                 device=dev).to(cfg.dtype)}
    out["serve"] = batch_serve(torch, np, dev, "[19b]", model, params, batch,
                               512 + 128 + 1, want_flash=cfg.num_layers)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(500, 513, 4)]
    out["engine"] = serve_measure(
        torch, np, dev, "[19b] Engine", cfg, model, params,
        ServeConfig(max_slots=4, max_len=640, eos_id=-1), prompts,
        busy_steps=8)
    del params, model, batch
    free_phase(torch, "[19b]")
    phase_s["[19b]"] = time.perf_counter() - t
    out["phase_s"] = phase_s
    return out


# [20b]'s runs: (arch, cut, batch, tokens, steps)
TRAIN_RUNS = (("whisper-small", {}, 2, 448, 4),
              ("internvl2-2b", {}, 2, 1792, 4),
              ("mixtral-8x7b", {"num_layers": 1}, 1, 2048, 3),
              ("xlstm-1.3b", {"num_layers": 8}, 1, 1024, 3))


def family_training_phase(torch, np, dev, c, refs) -> dict:
    """[20]: training on the card of the families ported since [14]: the
    loss and every gradient leaf card vs CPU ([20a]), a few Trainer steps
    at full width ([20b]) and the restart drill ([20c])."""
    from repro_torch.checkpoint.checkpointer import _flatten, _keystr
    from repro_torch.configs.base import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.train import reduced_config, synthetic_batch
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    out, phase_s = {"card_vs_cpu": {}, "full": {}, "restart": {}}, {}

    def zero_counts():
        c.zero_counts()
        flash_attention_cuda.launches = 0

    def read_counts():
        return dict(c.read_counts(),
                    flash_attention=flash_attention_cuda.launches)

    def held(label, key, which, got, ref, names) -> dict:
        loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        errs = sorted(((rel_err(torch, g, w), nm) for g, w, nm in zip(
            got["grads"], ref["grads"], names)), reverse=True)
        log(f"{label} {key}, {which} scale: loss card {got['loss']:.6f} vs "
            f"CPU {ref['loss']:.6f} (rel {loss_rel:.2e}); worst gradient "
            f"leaves max_abs_err / max |CPU| "
            + ", ".join(f"{nm} {e:.2e}" for e, nm in errs[:3])
            + f" ({len(names)} leaves)")
        return dict(loss_card=got["loss"], loss_cpu=ref["loss"],
                    loss_rel_err=loss_rel, worst_leaf_rel_err=errs[0][0],
                    worst_leaf=errs[0][1])

    # [20a] card vs CPU, f32, TF32 off; the CPU sides from the child
    t = time.perf_counter()
    log(f"[20a] host memory available: {host_free_gib():.1f} GiB")
    for key in (*GRAD_CASES, "mamba"):
        zero_counts()
        if key == "mamba":
            cfg, host, x, w = mamba_grad_inputs(torch, np)
            names = [_keystr(p) for p, _ in _flatten(host)] + ["x"]
            params = tree_map(lambda t_: t_.to(dev), host)
            del host
            got = {"plain": mamba_grad_run(torch, cfg, params, x, w)}
            scales, hold = ("plain",), "plain"
        else:
            model, host, batch = grad_case_inputs(torch, np, key)
            names = [_keystr(p) for p, _ in _flatten(host)]
            params = tree_map(lambda t_: t_.to(dev), host)
            del host
            hold = GRAD_CASES[key][3]
            scales = ("init", hold)
            got = {which: grad_case_run(torch, model, params, batch, which)
                   for which in scales}
        torch.cuda.synchronize()
        launches = read_counts()
        del params
        log(f"[20a] {key}: host memory available {host_free_gib():.1f} GiB "
            f"before reading the CPU side")
        ref = refs.get(torch, f"grads_{key}")
        res = {which: held("[20a]", key, which, got[which], ref[which],
                           names) for which in scales}
        res.update(held_scale=hold, cpu_s=ref["seconds"], launches=launches)
        out["card_vs_cpu"][key] = res
        log(f"[20a] {key}: CPU side {ref['seconds']:.1f} s in the child; "
            f"launches {launches}")
        if not (res[hold]["loss_rel_err"] <= 1e-4
                and res[hold]["worst_leaf_rel_err"] <= 1e-4):
            fail(f"[20a] {key}: card and CPU disagree at the {hold} scale: "
                 f"{res[hold]}")
        c.expect(f"[20a] {key}", launches, flash_attention=0)
        del got, ref
        gc.collect()
        free_phase(torch, f"[20a] {key}")
    phase_s["[20a]"] = time.perf_counter() - t

    # [20b] Trainer steps at full width: f32 params and AdamW, bf16
    # activations, remat "block", one fixed batch, params at the fan-in
    # scale (ROADMAP.md queue C 1.6)
    for name, cut, b, s, steps in TRAIN_RUNS:
        t = time.perf_counter()
        cfg = get_config(name).replace(**cut)
        tcfg = TrainerConfig(steps=steps, log_every=1, opt=AdamWConfig(
            warmup_steps=1, total_steps=steps))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, tcfg, device=dev)
        params, opt_state = tr.init_state(0)
        to_fan_in(tr.model, params)
        fixed = synthetic_batch(cfg, 0, b, s)
        positions = b * (s + (cfg.num_patches if cfg.family == "vlm" else 0)
                         + (cfg.encoder_seq if cfg.family == "audio" else 0))
        zero_counts()
        params, opt_state, hist = tr.fit(params, opt_state, lambda _: fixed)
        got = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in hist]
        step_s = [h["time_s"] for h in hist]
        steady = sum(step_s[1:]) / len(step_s[1:])
        rec = dict(arch=name, layers=cfg.num_layers,
                   encoder_layers=cfg.encoder_layers,
                   params=tr.model.num_params(), batch=b, tokens=s,
                   positions_per_step=positions, losses=losses,
                   grad_norms=[h["grad_norm"] for h in hist], step_s=step_s,
                   steady_step_ms=1e3 * steady,
                   tokens_per_s=b * s / steady,
                   positions_per_s=positions / steady, peak_gib=peak,
                   launches=got)
        out["full"][name] = rec
        log(f"[20b] {name}, {cfg.num_layers} layers"
            + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers
               else "")
            + f" ({tr.model.num_params() / 1e9:.3f} B params), {b} x {s} "
            f"tokens ({positions} positions a step): losses "
            + ", ".join(f"{v:.4f}" for v in losses) + "; step s "
            + ", ".join(f"{v:.3f}" for v in step_s)
            + f" (steps 1-{steps - 1} {1e3 * steady:.1f} ms = "
            f"{b * s / steady:.0f} tokens/s, {positions / steady:.0f} "
            f"positions/s); peak device memory {peak:.2f} GiB; launches "
            f"{got}")
        if not all(np.isfinite(losses + rec["grad_norms"])) \
                or not losses[-1] < losses[0]:
            fail(f"[20b] {name}: losses {losses}: not finite and decreasing")
        c.expect(f"[20b] {name}", got, flash_attention=0)
        del params, opt_state, tr, fixed
        free_phase(torch, f"[20b] {name}")
        phase_s[f"[20b] {name}"] = time.perf_counter() - t

    # [20c] the restart drill: jamba (MoE, Mamba and attention) and
    # whisper (frames in the batch) at reduced_config
    for name in ("jamba-v0.1-52b", "whisper-small"):
        t = time.perf_counter()
        out["restart"][name] = restart_drill(
            torch, np, dev, c, f"[20c] {name}",
            reduced_config(get_config(name)))
        phase_s[f"[20c] {name}"] = time.perf_counter() - t
    out["phase_s"] = phase_s
    return out


# ------------------------------------ [21]: the LM on a device grid
# [21a]'s cells: (arch, cut, strategy, batch, tokens); f32, params at the
# fan-in scale, the MoE at capacity factor 0.5 so that tokens drop
GRID_CASES = {"moe": ("mixtral-8x7b", {"num_layers": 1,
                                       "capacity_factor": 0.5}, "fsdp",
                      2, 64),
              "dense": ("qwen3-1.7b", {"num_layers": 2}, "tp_dp", 2, 128)}


def grid_of(torch, dev, shape=(2, 2)):
    """A (D, M) `DeviceGrid` whose every cell is `dev`."""
    from repro_torch.distributed.sharding import DeviceGrid

    return DeviceGrid((dev,) * (shape[0] * shape[1]), shape)


def place_train_state(torch, grid, in_sh, params):
    """`params` (whole tensors) laid out by lm_cell's in specs, and zero
    AdamW moments laid out as they are (made on the blocks' devices)."""
    from repro_torch.distributed.grid_step import zero_moments
    from repro_torch.distributed.sharding import place_tree

    placed = place_tree(grid, in_sh[0], params)
    return placed, zero_moments(placed, grid.device(0, 0))


def counting_drops(torch):
    """Wrap `moe.route` to count (choices, dropped choices) of every call;
    returns (counts dict, restore function)."""
    from repro_torch.models import moe as MOE

    counts, route = {"choices": 0, "dropped": 0}, MOE.route

    def counted(xg, router, cfg):
        r = route(xg, router, cfg)
        counts["choices"] += r.keep.numel()
        counts["dropped"] += int((~r.keep).sum())
        return r

    MOE.route = counted
    return counts, lambda: setattr(MOE, "route", route)


def lm_grid_case_inputs(torch, np, key):
    """[21a]'s config, CPU params (seed 21, at the fan-in scale) and
    batch (numpy seed 21)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    name, cut, _, b, s = GRID_CASES[key]
    cfg = get_config(name).replace(dtype=torch.float32, **cut)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(21), device="cpu")
    to_fan_in(model, params)
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (b, s + 1))
    return cfg, params, {"tokens": torch.from_numpy(toks[:, :-1]),
                         "labels": torch.from_numpy(toks[:, 1:])}


def lm_grid_case_run(torch, grid, cfg, params, batch, key) -> dict:
    """One lm_cell train step of [21a]'s case on `grid`: the metrics,
    every updated parameter leaf (whole, on the host) and the MoE drops."""
    from repro_torch.configs.base import ShapeSpec, tree_leaves
    from repro_torch.launch.specs import lm_cell

    _, _, strategy, b, s = GRID_CASES[key]
    step, _, in_sh, _ = lm_cell(cfg, ShapeSpec("t", s, b, "train"), grid,
                                strategy=strategy)
    placed, opt_state = place_train_state(torch, grid, in_sh, params)
    params.clear()
    drops, restore = counting_drops(torch)
    try:
        p2, _, metrics = step(placed, opt_state, batch)
    finally:
        restore()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": [x.gather(torch.device("cpu")) for x in
                       tree_leaves(p2)], **drops}


def lm_grid_ref(key: str):
    """The CPU side of [21a]'s case `key`, on a (2, 2) grid of the CPU."""
    def ref(torch, np) -> dict:
        cfg, params, batch = lm_grid_case_inputs(torch, np, key)
        return lm_grid_case_run(torch, grid_of(torch, "cpu"), cfg, params,
                                batch, key)
    return ref


CPU_REFS.update({f"lm_grid_{key}": lm_grid_ref(key) for key in GRID_CASES})
REF_CASES += "," + ",".join(f"lm_grid_{key}" for key in GRID_CASES)


def lm_grid_phase(torch, np, dev, c, refs) -> dict:
    """[21]: the LM on a (2, 2) `DeviceGrid` of the one card: lm_cell train
    card vs CPU ([21a]), lm_cell train, the grid Trainer, lm_cell prefill
    and decode at full width ([21b]), a checkpoint of the grid Trainer
    restored onto (1, 1) and (4, 1) grids ([21c])."""
    from repro_torch.checkpoint.checkpointer import _flatten, _keystr
    from repro_torch.configs.base import (
        ShapeSpec, tree_leaves, tree_map)
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import (
        Sharded, place_tree, tree_named)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.specs import lm_cell
    from repro_torch.launch.train import reduced_config, synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    out, phase_s = {"card_vs_cpu": {}}, {}
    grid = grid_of(torch, dev)

    def zero_counts():
        c.zero_counts()
        flash_attention_cuda.launches = 0

    def read_counts():
        return dict(c.read_counts(),
                    flash_attention=flash_attention_cuda.launches)

    # [21a] one lm_cell train step card vs CPU, both on (2, 2) grids
    t = time.perf_counter()
    for key in GRID_CASES:
        cfg, host, batch = lm_grid_case_inputs(torch, np, key)
        names = [_keystr(p) for p, _ in _flatten(host)]
        zero_counts()
        got = lm_grid_case_run(torch, grid, cfg, tree_map(
            lambda x: x.to(dev), host), {k: v.to(dev) for k, v in
                                          batch.items()}, key)
        torch.cuda.synchronize()
        launches = read_counts()
        del host
        ref = refs.get(torch, f"lm_grid_{key}")
        errs = sorted(((rel_err(torch, g, w), nm) for g, w, nm in zip(
            got["params"], ref["params"], names)), reverse=True)
        m_errs = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                  for k, v in ref["metrics"].items()}
        rec = dict(arch=GRID_CASES[key][0], strategy=GRID_CASES[key][2],
                   metrics_card=got["metrics"], metrics_cpu=ref["metrics"],
                   metric_rel_errs=m_errs, worst_leaf_rel_err=errs[0][0],
                   worst_leaf=errs[0][1],
                   drops_card=(got["dropped"], got["choices"]),
                   drops_cpu=(ref["dropped"], ref["choices"]),
                   cpu_s=ref["seconds"], launches=launches)
        out["card_vs_cpu"][key] = rec
        log(f"[21a] {key} ({rec['arch']} {cfg.num_layers} layers, "
            f"{rec['strategy']}, f32, {GRID_CASES[key][3]} x "
            f"{GRID_CASES[key][4]} tokens, (2, 2) grid): loss card "
            f"{got['metrics']['loss']:.6f} vs CPU "
            f"{ref['metrics']['loss']:.6f}; metric rel errs "
            + ", ".join(f"{k} {v:.2e}" for k, v in m_errs.items())
            + "; worst updated leaves max_abs_err / max |CPU| "
            + ", ".join(f"{nm} {e:.2e}" for e, nm in errs[:3])
            + f" ({len(names)} leaves; tol 1e-4); MoE choices dropped card "
            f"{got['dropped']} of {got['choices']}, CPU {ref['dropped']} of "
            f"{ref['choices']}; CPU side {ref['seconds']:.1f} s; launches "
            f"{launches}")
        if not (max(m_errs.values()) <= 1e-4 and errs[0][0] <= 1e-4):
            fail(f"[21a] {key}: card and CPU disagree: {rec}")
        if key == "moe" and not got["dropped"]:
            fail("[21a] the MoE case dropped no token")
        c.expect(f"[21a] {key}", launches, flash_attention=0)
        del got, ref
        free_phase(torch, f"[21a] {key}")
    phase_s["[21a]"] = time.perf_counter() - t

    def timed_steps(label, run, n, tokens):
        """n calls of run(), each followed by a synchronize: step times,
        tokens/s over steps 1.., peak memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, last = [], None
        for _ in range(n):
            t0 = time.perf_counter()
            last = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        steady = sum(times[1:]) / len(times[1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{label}: step s " + ", ".join(f"{v:.3f}" for v in times)
            + f" (steps 1-{n - 1} {1e3 * steady:.1f} ms = "
            f"{tokens / steady:.0f} tokens/s); peak device memory "
            f"{peak:.2f} GiB")
        return last, dict(step_s=times, steady_step_ms=1e3 * steady,
                          tokens_per_s=tokens / steady, peak_gib=peak)

    # [21b] mixtral-8x7b, 1 layer, bf16 activations, f32 params and AdamW,
    # fsdp (the cast before the gather, the shmap MoE): lm_cell train
    t = time.perf_counter()
    cfg, model, params = draw_on_card(torch, dev, "[21b]", "mixtral-8x7b",
                                      torch.float32, num_layers=1)
    b, s = 2, 1024
    step, _, in_sh, _ = lm_cell(cfg, ShapeSpec("t", s, b, "train"), grid,
                                strategy="fsdp")
    placed, opt_state = place_train_state(torch, grid, in_sh, params)
    del params
    fixed = {k: v.to(dev) for k, v in synthetic_batch(cfg, 0, b, s).items()
             if k in ("tokens", "labels")}
    state = [placed, opt_state]

    def train_step():
        state[0], state[1], metrics = step(state[0], state[1], fixed)
        return metrics

    zero_counts()
    metrics, rec = timed_steps(
        "[21b] mixtral-8x7b 1 layer lm_cell train (fsdp, (2, 2))",
        train_step, 3, b * s)
    rec.update(launches=read_counts(), loss=float(metrics["loss"]),
               params=model.num_params(), tokens_per_step=b * s)
    # where a grid step's time goes: one more step under torch.profiler
    rec["device_busy"] = busy = device_busy(torch, train_step, top=6)
    if busy is not None:
        log(f"[21b] mixtral one lm_cell step: device busy "
            f"{busy['busy_ms']:.1f} ms of {rec['steady_step_ms']:.1f} ms "
            f"wall; top kernels (ms): " + ", ".join(
                f"{nm[:48]} {ms:.1f}" for nm, ms in busy["top"]))
    out["mixtral_train"] = rec
    if not np.isfinite(rec["loss"]):
        fail(f"[21b] mixtral lm_cell train loss {rec['loss']}")
    c.expect("[21b] mixtral train", rec["launches"], flash_attention=0)
    del placed, opt_state, step, fixed, state
    free_phase(torch, "[21b] mixtral")
    phase_s["[21b] mixtral"] = time.perf_counter() - t

    # [21b] qwen3-1.7b at full depth: the grid Trainer (tp_dp), 3 steps of
    # 2 x 2048 tokens (bf16 activations, f32 params and AdamW)
    t = time.perf_counter()
    full = get_config("qwen3-1.7b")
    tr = Trainer(full, TrainerConfig(steps=3, log_every=1, opt=AdamWConfig(
        warmup_steps=1, total_steps=3)), mesh=grid)
    params, opt_state = tr.init_state(0)
    to_fan_in(tr.model, params)
    fixed = synthetic_batch(full, 0, 2, 2048)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    params, opt_state, hist = tr.fit(params, opt_state, lambda _: fixed)
    step_s = [h["time_s"] for h in hist]
    steady = sum(step_s[1:]) / len(step_s[1:])
    rec = dict(losses=[h["loss"] for h in hist], step_s=step_s,
               steady_step_ms=1e3 * steady, tokens_per_s=2 * 2048 / steady,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=read_counts(), strategy="tp_dp",
               params=tr.model.num_params())
    out["qwen3_trainer"] = rec
    log(f"[21b] qwen3-1.7b 28 layers Trainer(mesh=(2, 2), tp_dp), 2 x 2048 "
        f"tokens: losses " + ", ".join(f"{v:.4f}" for v in rec["losses"])
        + "; step s " + ", ".join(f"{v:.3f}" for v in step_s)
        + f" (steps 1-2 {1e3 * steady:.1f} ms = {2 * 2048 / steady:.0f} "
        f"tokens/s, each step synchronized); peak device memory "
        f"{rec['peak_gib']:.2f} GiB; launches {rec['launches']}")
    if not all(np.isfinite(rec["losses"])) or \
            not rec["losses"][-1] < rec["losses"][0]:
        fail(f"[21b] grid Trainer losses {rec['losses']}")
    c.expect("[21b] qwen3 Trainer", rec["launches"], flash_attention=0)
    del opt_state, tr
    free_phase(torch, "[21b] qwen3 Trainer")
    phase_s["[21b] qwen3 Trainer"] = time.perf_counter() - t

    # [21b] lm_cell prefill of 4 x 2048 and 32 decode steps from
    # seq-sharded caches, f32 (TF32 off) on the trained params, against
    # the single-device Model.prefill / decode_step on the card
    t = time.perf_counter()
    f32 = full.replace(dtype=torch.float32)
    single = build_model(f32)
    b, s, n_dec = 4, 2048, 32
    toks = np.random.default_rng(211).integers(0, full.vocab_size,
                                               (b, s + n_dec))
    toks = torch.from_numpy(toks).to(dev)
    pstep, _, p_in, _ = lm_cell(f32, ShapeSpec("p", s, b, "prefill"), grid)
    dstep, _, d_in, _ = lm_cell(f32, ShapeSpec("d", s + n_dec, b,
                                               "decode"), grid)
    if [x.placement.spec for x in tree_leaves(params)] != \
            [x.spec for x in tree_leaves(tree_named(grid, p_in[0]))]:
        fail("[21b] the Trainer's tp_dp layout is not lm_cell's")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = pstep(params, {"tokens": toks[:, :s]})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_launches = read_counts()
    whole = tree_map(lambda x: x.gather(), params)
    want_last, want_caches = single.prefill(whole, {"tokens": toks[:, :s]})
    vocab = full.vocab_size   # the padded columns are -1e30 on both sides
    pre_err = rel_err(torch, last[..., :vocab], want_last[..., :vocab])
    cache_err = max(rel_err(torch, a, w) for a, w in zip(
        tree_leaves(caches), tree_leaves(want_caches)))

    def grown(pc):
        """Decode caches of s + n_dec positions holding prefill's."""
        dc = single.init_caches(b, s + n_dec, device=dev)
        for d, p in zip(tree_leaves(dc), tree_leaves(pc)):
            if d.ndim == 5:    # k, v (g, b, kv, S, hd)
                d[..., :s, :].copy_(p)
            else:              # pos (g, b, S)
                d[..., :s].copy_(p)
        return dc

    single_caches = grown(want_caches)
    grid_caches = place_tree(grid, d_in[1]["caches"], grown(caches))
    del caches, want_caches
    kv = grid_caches[0]["kv"].k
    kv_blocks = len(kv.tensors())
    zero_counts()
    dec_err, dec_s = 0.0, []
    for i in range(n_dec):
        tk = toks[:, s + i:s + i + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, grid_caches = dstep(params, {"tokens": tk, "caches":
                                         grid_caches, "index": s + i})
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        with torch.no_grad():
            want, single_caches = single.decode_step(
                whole, {"tokens": tk, "caches": single_caches,
                        "index": s + i})
        dec_err = max(dec_err, rel_err(torch, lg[..., :vocab],
                                       want[..., :vocab]))
    dec_launches = read_counts()
    steady = sum(dec_s[1:]) / len(dec_s[1:])
    logits_max = float(want[..., :vocab].abs().max())
    busy = device_busy(torch, lambda: dstep(params, {
        "tokens": tk, "caches": grid_caches, "index": s + n_dec - 1}))
    out["qwen3_serve"] = dict(
        batch=b, prompt=s, decode_steps=n_dec, prefill_s=prefill_s,
        prefill_tokens_per_s=b * s / prefill_s,
        prefill_last_logits_rel_err=pre_err, prefill_cache_rel_err=cache_err,
        decode_ms=1e3 * steady, decode_tokens_per_s=b / steady,
        decode_logits_rel_err=dec_err, logits_max=logits_max,
        kv_blocks_per_leaf=kv_blocks, decode_device_busy=busy,
        prefill_launches=pre_launches, decode_launches=dec_launches,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[21b] qwen3-1.7b 28 layers f32 on (2, 2): lm_cell prefill of "
        f"{b} x {s} in {prefill_s:.3f} s ({b * s / prefill_s:.0f} tokens/s), "
        f"last logits max_abs_err / max {pre_err:.2e} and caches "
        f"{cache_err:.2e} against the single-device Model.prefill (tol "
        f"1e-5); {n_dec} decode steps from caches seq-sharded over model "
        f"({kv_blocks} KV blocks a leaf), {1e3 * steady:.2f} ms a step "
        f"({b / steady:.0f} tokens/s; device busy "
        f"{busy['busy_ms'] if busy else float('nan'):.1f} ms of a step), "
        f"logits {dec_err:.2e} of the single-device decode_step (the "
        f"real vocab, max |logit| {logits_max:.3e}; tol 1e-5); launches "
        f"prefill "
        f"{pre_launches}, decode {dec_launches}; {device_gib(torch)}")
    want_flash = 2 * full.num_layers   # one a layer for each data row
    c.expect("[21b] prefill", pre_launches, flash_attention=want_flash)
    c.expect("[21b] decode", dec_launches, flash_attention=0)
    if not (pre_err <= 1e-5 and cache_err <= 1e-5 and dec_err <= 1e-5):
        fail(f"[21b] grid prefill / decode off the single device: "
             f"{out['qwen3_serve']}")
    del params, whole, grid_caches, single_caches, last, want_last
    free_phase(torch, "[21b] qwen3 prefill/decode")
    phase_s["[21b] qwen3 prefill/decode"] = time.perf_counter() - t

    # [21c] a checkpoint of the (2, 2) grid Trainer (fsdp) restored onto
    # (1, 1) and (4, 1) grids of the card, bit for bit
    t = time.perf_counter()
    ck_root = Path(tempfile.mkdtemp(prefix="chip_smoke_grid_"))
    try:
        small = reduced_config(full)
        tcfg = TrainerConfig(steps=2, log_every=1, ckpt_every=2,
                             ckpt_dir=str(ck_root), strategy="fsdp",
                             opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=2))
        tr = Trainer(small, tcfg, mesh=grid)
        p, o = tr.init_state(0)
        p, o, hist = tr.fit(p, o, lambda st: synthetic_batch(small, st, 4,
                                                             256))
        written = [x.gather() if isinstance(x, Sharded) else x
                   for x in tree_leaves((p, o))]
        same = {}
        for shape in ((1, 1), (4, 1)):
            tr2 = Trainer(small, tcfg, mesh=grid_of(torch, dev, shape))
            p2, o2, start = tr2.maybe_restore(*tr2.init_state(1))
            same[str(shape)] = start == 2 and all(
                torch.equal(x.gather() if isinstance(x, Sharded) else x, w)
                for x, w in zip(tree_leaves((p2, o2)), written))
            del tr2, p2, o2
        out["restore"] = dict(losses=[h["loss"] for h in hist],
                              bit_identical=same)
        log(f"[21c] reduced qwen3-1.7b Trainer on (2, 2), fsdp: losses "
            + ", ".join(f"{h['loss']:.4f}" for h in hist)
            + f"; its step-2 checkpoint restored bit for bit onto {same}")
        if not all(same.values()):
            fail(f"[21c] restore across grid shapes: {same}")
        del tr, p, o, written
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)
    free_phase(torch, "[21c]")
    phase_s["[21c]"] = time.perf_counter() - t
    out["phase_s"] = phase_s
    return out


def tooling_phase(torch, np, dev, c, smi: str) -> dict:
    """[22]: the port's tooling on the card. [22a] `python -m
    repro_torch.launch.lint --strict --device cuda` in a child (exit 0);
    [22b] `check_contracts(device="cuda")` here (no finding), then the
    fill registries and the megakernel contract again, each from zeroed
    counts, held to the launches C101-C103 and C601 imply; [22c] the dry
    run of qwen3-1.7b train_4k on the 16 x 16 production grid's meta cells
    (`launch/dryrun.py`) at full width, 2 of its 28 layers (the whole
    depth takes ~2 minutes of host time, the CLI's `--arch qwen3-1.7b
    --shape train_4k`); [22d] [21b]'s mixtral cell (1 layer, fsdp, 2 x
    1024) run on a (2, 2) meta grid and placed for real on the card's
    (2, 2) grid: the fullest cell's argument bytes equal its placed
    blocks' exactly, and the meta run's temp bytes x busy cells lie within
    `TEMP_BYTES_BOUND` of one real step's peak above the placed state."""
    from repro_torch.analysis import contracts as C
    from repro_torch.configs.base import ShapeSpec, tree_leaves, tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import DeviceGrid, Sharded, tree_named
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.stream_kernels import (
        accumulator_spec, stream_methods)
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import lm_cell

    out, phase_s = {}, {}
    t_all = t = time.perf_counter()
    # [22a] the lint, both layers, strict, in a child
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--strict",
         "--device", "cuda", "--json"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if p.returncode != 0:
        fail(f"[22a] the lint exited {p.returncode}:\n{p.stdout[-3000:]}\n"
             f"{p.stderr[-3000:]}")
    out["lint"] = {k: len(v) for k, v in json.loads(p.stdout).items()}
    phase_s["[22a]"] = time.perf_counter() - t
    log(f"[22a] python -m repro_torch.launch.lint --strict --device cuda: "
        f"exit 0, findings {out['lint']} in {phase_s['[22a]']:.1f} s ({smi})")

    # [22b] the contract checker on the card, in this process
    t = time.perf_counter()
    c.zero_counts()
    flash_attention_cuda.launches = 0
    findings = C.check_contracts(device="cuda")
    torch.cuda.synchronize()
    if findings:
        fail("[22b] check_contracts(device='cuda'): " + "; ".join(
            f.render() for f in findings[:5]))
    out["launches"] = dict(c.read_counts(),
                           flash_attention=flash_attention_cuda.launches)
    c.zero_counts()
    C.check_fill_registries(device="cuda")
    torch.cuda.synchronize()
    c.expect("[22b] C101-C103", c.read_counts(), sti_fill_acc=2,
             sti_fill_acc_rect=2)
    methods = stream_methods()
    inter = sum(accumulator_spec(m).kind == "interaction" for m in methods)
    c.zero_counts()
    C.check_megakernel_contract(device="cuda")
    torch.cuda.synchronize()
    c.expect("[22b] C601", c.read_counts(), sti_megakernel=2 * inter,
             point_megakernel=2 * (len(methods) - inter))
    phase_s["[22b]"] = time.perf_counter() - t
    log(f"[22b] check_contracts(device='cuda') = [] at n = 64, tb = 8, d = "
        f"8, k = 4; launches {out['launches']}; C101-C103 launched the fill "
        f"2 and the rect fill 2, C601 the megakernels {2 * inter} + "
        f"{2 * (len(methods) - inter)} and nothing else; "
        f"{phase_s['[22b]']:.1f} s")

    # [22c] the dry run of one production cell on meta
    t = time.perf_counter()
    rec = run_cell("qwen3-1.7b", "train_4k", multi_pod=False,
                   cfg_overrides={"num_layers": 2}, verbose=False)
    phase_s["[22c]"] = time.perf_counter() - t
    out["dryrun_qwen3"] = rec
    r = rec["roofline"]
    log(f"[22c] dry run qwen3-1.7b (2 layers) x train_4k x {rec['mesh']} "
        f"(meta, "
        f"{rec['compile_s']} s): memory {rec['memory_analysis']}, "
        f"collectives {rec['collectives']}, per device {r['flops_per_chip']:.4e}"
        f" FLOP, {r['bytes_per_chip']:.4e} B; roofline compute "
        f"{r['t_compute']:.4f} s, memory {r['t_memory']:.4f} s, collective "
        f"{r['t_collective']:.4f} s -> {r['bottleneck']}, useful "
        f"{r['useful_ratio']:.4f} (H100 data-sheet peaks; {smi})")

    # [22d] the dry run's memory accounting against the card
    t = time.perf_counter()
    shape = ShapeSpec("t", 1024, 2, "train")
    meta = run_cell("mixtral-8x7b", shape, strategy="fsdp",
                    grid=DeviceGrid((torch.device("meta"),) * 4, (2, 2)),
                    cfg_overrides={"num_layers": 1}, verbose=False)
    cfg = get_config("mixtral-8x7b").replace(num_layers=1)
    grid = grid_of(torch, dev)
    step, args, in_specs, _ = lm_cell(cfg, shape, grid, strategy="fsdp")
    gc.collect()
    torch.cuda.empty_cache()
    placed = tree_map(lambda pl, a: pl.place(torch.zeros(
        a.shape, dtype=a.dtype, device=dev)), tree_named(grid, in_specs),
        args)
    cell = tuple(meta["fullest_cell"])
    blocks = sum(s.block(*cell).numel() * s.block(*cell).element_size()
                 for s in tree_leaves(placed, is_leaf=lambda v: isinstance(
                     v, Sharded)))
    arg = meta["memory_analysis"]["argument_bytes"]
    if blocks != arg:
        fail(f"[22d] the dry run's argument_bytes {arg} of cell {cell} != "
             f"the {blocks} bytes of its blocks placed on the card")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    metrics = step(*placed)[2]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if not np.isfinite(float(metrics["loss"])):
        fail(f"[22d] the step on the placed zeros gave loss "
             f"{float(metrics['loss'])}")
    temp = meta["memory_analysis"]["temp_bytes"]
    ratio = temp * meta["cells_busy"] / peak
    out["memory"] = dict(argument_bytes=arg, placed_block_bytes=blocks,
                         cell=list(cell), temp_bytes=temp,
                         cells_busy=meta["cells_busy"],
                         card_step_peak_bytes=peak, ratio=ratio,
                         meta=meta["memory_analysis"])
    del placed, step, args
    free_phase(torch, "[22d]")
    phase_s["[22d]"] = time.perf_counter() - t
    lo, hi = TEMP_BYTES_BOUND
    log(f"[22d] mixtral-8x7b 1 layer fsdp 2 x 1024 on (2, 2): argument_bytes "
        f"of cell {cell} {arg} = its placed blocks' {blocks} (exact); "
        f"temp_bytes {temp} a cell x {meta['cells_busy']} busy cells = "
        f"{temp * meta['cells_busy'] / 2**30:.4f} GiB against the card's "
        f"peak above the placed state over one real step, "
        f"{peak / 2**30:.4f} GiB: {ratio:.4f}x (bound {lo}-{hi}x); "
        f"{phase_s['[22d]']:.1f} s ({smi})")
    if not lo <= ratio <= hi:
        fail(f"[22d] the dry run's temp_bytes x cells_busy is {ratio:.4f}x "
             f"the card's step peak, outside {lo}-{hi}x")
    phase_s["[22]"] = time.perf_counter() - t_all
    if phase_s["[22]"] > 60:
        fail(f"[22] took {phase_s['[22]']:.1f} s, more than its 60 s")
    out["phase_s"] = phase_s
    return out


# the examples of the port that [23d] runs: the line that ends the output
# of each when it passes, and the kernels its path must launch
EXAMPLES = (("quickstart_torch", "wknn vs knn_shapley rank agreement",
             ("distance", "sti_fill_acc")),
            ("end_to_end_valuation_torch", "[ok] end-to-end pipeline complete",
             ("distance", "sti_fill_acc")),
            ("distributed_valuation_torch",
             "[ok] sharded streaming engine matches the single-host "
             "algorithm", ("distance", "sti_fill_acc_rect")),
            ("serve_lm_torch", "[ok] all requests served",
             ("flash_attention",)))


def entry_points_phase(torch, np, dev, c, smi: str) -> dict:
    """[23]: the last entry points of the port on the card. [23a]
    `launch/valuate.py` in this process, wknn at n = 65536, t = 512 with
    each `--weights` kind, on the streamed engine and with `--fill
    megakernel`, the two within 1e-5 of max |value|; the launcher's
    first test batch through the megakernel session against the eager
    point step on the distance kernel's distances (the circles are
    continuous: plain distances reorder near-tied ranks, so this one is
    held on the kernel's f32 distances, which the megakernel shares bit
    for bit), and a batch of integer-valued features, where no distance
    rounds, through the megakernel session against the eager step on the
    plain distances, both at 1e-5; [23b] `--stream` for sti as is, with
    `--engine sharded --shards 4 --devices cuda` and with `--fill
    megakernel`, knn_shapley with `--stream`, and knn_shapley and sti
    with `--stream --engine approx --top-m 64`, each against the one-shot
    run of the same invocation (without `--stream`) at 1e-6 of max |ref|
    ([4]/[7]'s tolerance; the same kernels in the same order), the
    megakernel's one-shot phi beside the three-stage one's logged, each
    16 GiB result freed once held; [23c] `ops.pairwise_distance` at
    (256, 65536, 768) and `ops.sti_fill` at t = 256, n = 65536,
    bit-equal to `distance_cuda` / `sti_fill_cuda`; [23d] the four
    `examples/*_torch.py` in this process, one after another, with
    `--device cuda` at their default sizes, each ending with its closing
    line and launching the kernels `EXAMPLES` names for it. Each path's
    counts are zeroed just before it and read just after; [23] takes at
    most 90 s."""
    from repro_torch import ValuationSession, get_method
    from repro_torch.data import flip_labels, make_circles
    from repro_torch.kernels import ops
    from repro_torch.kernels.distance import distance_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.sti_fill import sti_fill_cuda
    from repro_torch.launch import valuate

    n, t, tb, k = 65536, 512, 256, 5
    base = ["--n", str(n), "--t", str(t), "--test-batch", str(tb)]
    out = {"launches": {}, "errors": {}}
    phase_s = {}
    t_all = time.perf_counter()

    def launch(label, argv, must, never):
        """valuate.main(argv) from zeroed counts: the kernels in `must`
        launched, those in `never` not; returns the result."""
        c.zero_counts()
        t0 = time.perf_counter()
        res = valuate.main(base + argv)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        got = c.read_counts()
        out["launches"][label] = got
        log(f"{label}: valuate {' '.join(argv)}: {s:.2f} s, launches {got}")
        for name in must:
            if not got[name]:
                fail(f"{label}: {name} was not launched: {got}")
        for name in never:
            if got[name]:
                fail(f"{label}: {name} was launched: {got}")
        return res

    def hold(label, got, want, rel):
        err = max_abs_diff(torch, got.reshape(got.shape[0], -1),
                           want.reshape(want.shape[0], -1))
        scale = max_abs(torch, want.reshape(want.shape[0], -1))
        same = bool(torch.equal(got, want))
        out["errors"][label] = {"max_abs_err": err, "max_ref": scale,
                                "bit_equal": same}
        log(f"{label}: max_abs_err {err:.3e} (max |ref| "
            f"{scale:.3e}, tol {rel:g} of it), bit-equal {same}")
        if not err <= rel * scale:
            fail(f"{label} disagrees: {err} > {rel} * {scale}")

    # [23a] wknn with each weight kind, streamed and megakernel
    t0 = time.perf_counter()
    x, y_clean = make_circles(n // 2, noise=0.08, seed=0)
    y, _ = flip_labels(y_clean, 0.1, 2, seed=1)
    xt, yt = make_circles(t // 2, noise=0.08, seed=2)
    x, y, xb, yb = x.to(dev), y.to(dev), xt[:tb].to(dev), yt[:tb].to(dev)
    points = ("distance", "point_megakernel")
    # integer-valued features in [-128, 128]: every squared distance is an
    # integer below 2^18, exact in f32 on both the kernel and plain paths
    rng = np.random.default_rng(23)
    xi, xqi = (torch.from_numpy(rng.integers(-128, 129, (m, 2)).astype(
        np.float32)).to(dev) for m in (n, tb))
    yi, yqi = (torch.from_numpy(rng.integers(0, 2, m).astype(
        np.int32)).to(dev) for m in (n, tb))
    for w in ("rbf", "inverse", "uniform"):
        wk = ["--method", "wknn", "--weights", w]
        streamed = launch(f"[23a] wknn {w} streamed",
                          wk + ["--engine", "streamed"],
                          ("distance", "point_update"),
                          ("point_megakernel", "sti_megakernel",
                           "sti_fill_acc", "sti_fill_acc_rect"))
        mega = launch(f"[23a] wknn {w} megakernel",
                      wk + ["--fill", "megakernel"], points,
                      ("sti_megakernel", "sti_fill_acc",
                       "sti_fill_acc_rect", "point_update"))
        hold(f"[23a] wknn {w}: megakernel vs streamed", mega.point_values,
             streamed.point_values, 1e-5)
        c.zero_counts()
        first = ValuationSession(
            x, y, k=k, mode="wknn", test_batch=tb, fill="megakernel",
            method_opts={"weights": w}, device=dev).update(xb, yb).finalize()
        torch.cuda.synchronize()
        c.expect(f"[23a] wknn {w} first batch", c.read_counts(),
                 point_megakernel=1)
        plain = get_method("wknn")(x, y, xb, yb, k=k, engine="eager",
                                   weights=w, distance="cuda", device=dev)
        hold(f"[23a] wknn {w} first batch: megakernel vs the eager step "
             f"on the distance kernel's distances", first.point_values,
             plain.point_values, 1e-5)
        c.zero_counts()
        first = ValuationSession(
            xi, yi, k=k, mode="wknn", test_batch=tb, fill="megakernel",
            method_opts={"weights": w}, device=dev).update(
                xqi, yqi).finalize()
        torch.cuda.synchronize()
        c.expect(f"[23a] wknn {w} integer batch", c.read_counts(),
                 point_megakernel=1)
        plain = get_method("wknn")(xi, yi, xqi, yqi, k=k, engine="eager",
                                   weights=w, distance="plain", device=dev)
        hold(f"[23a] wknn {w} integer batch: megakernel vs the plain step",
             first.point_values, plain.point_values, 1e-5)
        del streamed, mega, first, plain
    phase_s["[23a]"] = time.perf_counter() - t0
    log(f"[23a] {phase_s['[23a]']:.1f} s ({smi})")

    # [23b] --stream against the one-shot run of the same invocation
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fills = ("sti_fill_acc", "sti_fill_acc_rect", "sti_megakernel",
             "point_megakernel")

    def sti(label, extra, kernel):
        return launch(f"[23b] sti {label}", ["--method", "sti"] + extra,
                      (kernel,), tuple(f for f in fills if f != kernel))

    three = sti("one-shot", [], "sti_fill_acc")
    res = sti("--stream", ["--stream"], "sti_fill_acc")
    hold("[23b] sti --stream vs one-shot", res.phi, three.phi, 1e-6)
    del res
    mk = ["--fill", "megakernel"]
    mega = sti("--fill megakernel one-shot", mk, "sti_megakernel")
    # the two step forms on the launcher's data, logged: [5] holds them
    # at 1e-6 of max on its blob data
    diff = (mega.phi - three.phi).abs_()
    at = divmod(int(diff.argmax()), n)
    out["errors"]["[23b] sti megakernel vs three-stage one-shot"] = {
        "max_abs_err": float(diff[at]), "at": list(at),
        "three_stage": float(three.phi[at]), "megakernel": float(
            mega.phi[at]), "max_ref": max_abs(torch, three.phi),
        "diagonal_max_abs_err": float(diff.diagonal().max())}
    log(f"[23b] sti megakernel vs three-stage one-shot (logged): "
        f"{out['errors']['[23b] sti megakernel vs three-stage one-shot']}")
    del diff, three
    free_phase(torch, "[23b] sti three-stage")
    res = sti("--stream --fill megakernel", ["--stream"] + mk,
              "sti_megakernel")
    hold("[23b] sti --stream --fill megakernel vs its one-shot", res.phi,
         mega.phi, 1e-6)
    del res, mega
    free_phase(torch, "[23b] sti megakernel")
    sh = ["--engine", "sharded", "--shards", "4", "--devices", "cuda"]
    sharded = sti("--engine sharded one-shot", sh, "sti_fill_acc_rect")
    res = sti("--stream --engine sharded", ["--stream"] + sh,
              "sti_fill_acc_rect")
    hold("[23b] sti --stream --engine sharded vs its one-shot", res.phi,
         sharded.phi, 1e-6)
    del res, sharded
    free_phase(torch, "[23b] sti sharded")
    ks = ["--method", "knn_shapley"]
    oneshot = launch("[23b] knn_shapley one-shot", ks,
                     ("distance", "point_update"), fills)
    res = launch("[23b] knn_shapley stream", ks + ["--stream"],
                 ("distance", "point_update"), fills)
    hold("[23b] knn_shapley stream vs one-shot", res.point_values,
         oneshot.point_values, 1e-6)
    del oneshot, res
    ap = ["--engine", "approx", "--top-m", "64"]
    for method, field in (("knn_shapley", "point_values"), ("sti", "phi")):
        # sti's runs also value knn_shapley streamed (the launcher's
        # correlation line), so only knn_shapley's exclude the update
        never = fills + (("point_update",) if method == "knn_shapley"
                         else ())
        oneshot = launch(f"[23b] {method} --engine approx one-shot",
                         ["--method", method] + ap, ("distance",), never)
        res = launch(f"[23b] {method} --stream --engine approx",
                     ["--method", method, "--stream"] + ap, ("distance",),
                     never)
        if res.meta["approx_exact"] or res.meta["top_m"] != 64:
            fail(f"[23b] {method} --stream --engine approx did not "
                 f"preselect 64 candidates: {res.meta}")
        hold(f"[23b] {method} --stream --engine approx vs one-shot",
             getattr(res, field), getattr(oneshot, field), 1e-6)
        del oneshot, res
        free_phase(torch, f"[23b] {method} approx")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    phase_s["[23b]"] = time.perf_counter() - t0
    log(f"[23b] {phase_s['[23b]']:.1f} s, peak {out['peak_gib']:.2f} GiB "
        f"({smi})")

    # [23c] kernels.ops at the main path's shapes
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    xq = torch.randn((tb, 768), generator=gen, device=dev)
    xn = torch.randn((n, 768), generator=gen, device=dev)
    g = torch.randn((tb, n), generator=gen, device=dev)
    ranks = torch.argsort(torch.rand((tb, n), generator=gen, device=dev),
                          dim=1)
    c.zero_counts()
    d2 = ops.pairwise_distance(xq, xn)
    fill = ops.sti_fill(g, ranks)
    torch.cuda.synchronize()
    got = c.read_counts()
    out["launches"]["[23c] ops"] = got
    c.expect("[23c] ops.pairwise_distance + ops.sti_fill", got, distance=1,
             sti_fill_acc=1)
    if not torch.equal(d2, distance_cuda(xq, xn)):
        fail("[23c] ops.pairwise_distance is not bit-equal to distance_cuda")
    want = sti_fill_cuda(g, ranks)
    if not torch.equal(fill, want):
        fail("[23c] ops.sti_fill is not bit-equal to sti_fill_cuda")
    del xq, xn, g, ranks, d2, fill, want
    free_phase(torch, "[23c]")
    phase_s["[23c]"] = time.perf_counter() - t0
    log(f"[23c] ops.pairwise_distance ({tb}, {n}, 768) and ops.sti_fill "
        f"(t={tb}, n={n}): one launch each ({got}), bit-equal to "
        f"distance_cuda / sti_fill_cuda; {phase_s['[23c]']:.1f} s ({smi})")

    # [23d] the port's examples, default sizes, in this process
    t0 = time.perf_counter()
    out["examples_s"] = {}
    for name, last, must in EXAMPLES:
        path = ROOT / "examples" / f"{name}.py"
        label = f"[23d] examples/{name}.py"
        buf, argv = io.StringIO(), sys.argv
        c.zero_counts()
        flash_attention_cuda.launches = 0
        t1 = time.perf_counter()
        try:
            sys.argv = [str(path), "--device", "cuda"]
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(path), run_name="__main__")
            torch.cuda.synchronize()
        except (Exception, SystemExit) as e:
            fail(f"{label} --device cuda raised {e!r}:\n"
                 f"{buf.getvalue()[-2000:]}")
        finally:
            sys.argv = argv
        out["examples_s"][name] = time.perf_counter() - t1
        got = dict(c.read_counts(),
                   flash_attention=flash_attention_cuda.launches)
        out["launches"][label] = got
        text = buf.getvalue()
        if last not in text:
            fail(f"{label} --device cuda ended without {last!r}:\n"
                 f"{text[-2000:]}")
        missing = [kernel for kernel in must if not got[kernel]]
        if missing:
            fail(f"{label}: {missing} not launched: {got}")
        log(f"{label} --device cuda: {out['examples_s'][name]:.1f} s, "
            f"launches {got}; its last line: {text.strip().splitlines()[-1]}")
        free_phase(torch, label)
    phase_s["[23d]"] = time.perf_counter() - t0
    log(f"[23d] the four examples one after another in "
        f"{phase_s['[23d]']:.1f} s "
        f"({smi})")
    phase_s["[23]"] = time.perf_counter() - t_all
    out["phase_s"] = phase_s
    if phase_s["[23]"] > 90:
        fail(f"[23] took {phase_s['[23]']:.1f} s, more than its 90 s")
    return out


def rank_sort_phase(torch, dev, smi: str) -> dict:
    """[24]: the rank stage's kernel against its plain version at the two
    cells' shapes (module doc). Returns the kernel table's figures: those
    of the larger shape, the knn cell's, and each shape's under
    `shapes`."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.distance import distance_cuda
    from repro_torch.kernels.rank_sort import (
        rank_order_cuda, rank_order_plain, sort_passes)

    ha = _costs()
    out = {"max_abs_err": 0.0, "shapes": {}}
    gen = torch.Generator(device=dev).manual_seed(24)
    for tb, n in ((256, 92160), (256, 1281167)):
        x = torch.randn((n, 768), device=dev, generator=gen) * 3.44
        xb = torch.randn((tb, 768), device=dev, generator=gen) * 3.44
        d2 = distance_cuda(xb, x)
        del x, xb
        passes = torch.zeros((tb,), dtype=torch.int32, device=dev)
        before = rank_order_cuda.launches
        order, ranks = rank_order_cuda(d2, passes=passes)
        want_o, want_r = rank_order_plain(d2)
        torch.cuda.synchronize()
        if rank_order_cuda.launches != before + 1:
            fail(f"[24] rank_order_cuda launched "
                 f"{rank_order_cuda.launches - before} times, not once")
        if not (torch.equal(order, want_o) and torch.equal(ranks, want_r)):
            fail(f"[24] rank sort at ({tb}, {n}) differs from torch.sort + "
                 f"ranks_from_order")
        if not torch.equal(passes, sort_passes(d2)):
            fail(f"[24] the kernel's passes at ({tb}, {n}) are not "
                 f"sort_passes'")
        del order, ranks, want_o, want_r
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rank_order_cuda(d2)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rank_order_cuda(d2)
            torch.cuda.synchronize()
        calls = sorted(e.name for e in prof.events()
                       if e.name.startswith(("cudaLaunchKernel",
                                             "cudaMemset", "cuLaunchKernel")))
        ms = cuda_ms(torch, lambda: rank_order_cuda(d2), reps=10)
        plain_ms = cuda_ms(torch, lambda: rank_order_plain(d2), reps=3)
        lib_ms = cuda_ms(torch, lambda: torch.sort(d2, dim=-1, stable=True),
                         reps=3)
        bound, by = ha.rank_sort_cost(tb, n).bound_ms()
        traffic_ms = 1e3 * ha.sort_traffic(n, passes.tolist(), ranks=True) \
            / ha.HBM_BYTES_PER_S
        rows = {int(p): int(c) for p, c in zip(*torch.unique(
            passes, return_counts=True))}
        log(f"[24] rank sort ({tb}, {n}): bit-equal to torch.sort + "
            f"ranks_from_order; rows by passes {rows}; {ms:.3f} ms (the "
            f"stage's floor {bound:.3f} ms by {by}, {100 * bound / ms:.1f} "
            f"%; the radix passes' own traffic {traffic_ms:.3f} ms, "
            f"{100 * traffic_ms / ms:.1f} %), plain {plain_ms:.3f} ms, "
            f"torch.sort alone {lib_ms:.3f} ms; peak +{peak:.3f} GiB; "
            f"runtime launches and memsets in one call: {len(calls)} "
            f"({smi})")
        if len(calls) > 8:
            fail(f"[24] one rank sort made {len(calls)} runtime launches: "
                 f"{calls}")
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=lib_ms, shape=f"t={tb} n={n} f32")
        out["shapes"][f"{tb}x{n}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by, "traffic_ms": traffic_ms,
            "rows_by_passes": rows, "peak_gib": peak,
            "runtime_launches": len(calls)}
        del d2, passes
        torch.cuda.empty_cache()
    return out


def selective_scan_phase(torch, dev, smi: str) -> dict:
    """[25]: Mamba's fused selective scan (`kernels/selective_scan.py`)
    at the Jamba cell's shapes against its plain version, then counted
    on the embed and prefill paths of jamba2-mini's period (module doc).
    Returns the kernel table's figures."""
    from portbench.costs_jamba import PERIOD, scan_cost
    from portbench.kinds.lm_embed import Reviews
    from repro_torch.kernels.selective_scan import (
        selective_scan_cuda, selective_scan_plain)
    from repro_torch.models.transformer import layer_schedule

    mix = json.loads((ROOT / "portbench" / "traffic" /
                      "reviews32.json").read_text())
    reviews = Reviews(mix, {"vocab": 65536}, 5, 25, dev)
    lens = reviews.host(0)[0]
    lens[int(torch.argmin(lens))] = int(mix["length_max"])
    b, s, di, ds = len(lens), int(lens.max()), PERIOD["di"], PERIOD["ds"]
    gen = torch.Generator(device=dev).manual_seed(25)
    # x contiguous as the conv leaves it; z the gate half of in_proj's
    # (b, s, 2 di) output, read in place with its row stride; dt before
    # the softplus near Mamba's initial dt (log-uniform in [1e-3, 1e-1]);
    # A = -(1..16) (S4D-real); B and C at the unit RMS of their norms
    x = torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16)
    z = torch.randn((b, s, 2 * di), generator=gen, device=dev).to(
        torch.bfloat16)[..., di:]
    dt = (0.5 * torch.randn((b, s, di), generator=gen, device=dev)
          - 4.6).to(torch.bfloat16)
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        di, ds).contiguous()
    B, C = (torch.randn((b, s, ds), generator=gen, device=dev)
            for _ in range(2))
    D = torch.randn((di,), generator=gen, device=dev)
    lengths = lens.to(dev)
    before = selective_scan_cuda.launches
    y, h = selective_scan_cuda(x, z, dt, A, B, C, D, None, lengths)
    yw, hw = selective_scan_plain(x, z, dt, A, B, C, D, None, lengths)
    torch.cuda.synchronize()
    if selective_scan_cuda.launches != before + 1:
        fail(f"[25] selective_scan_cuda launched "
             f"{selective_scan_cuda.launches - before} times, not once")
    # both write y in bf16: past one unit in the last place of the plain
    # y, the kernel may differ by its f32 sums' order, 1e-3 of the
    # largest |y|; the state is f32 throughout, 1e-4 of its largest
    top, htop = max_abs(torch, yw.reshape(-1, di)), max_abs(torch, hw)
    over = float((((y.float() - yw.float()).abs()
                   - bf16_ulp(torch, yw.float())).clamp_min(0)).max())
    herr = float((h - hw).abs().max())
    past = torch.arange(s, device=dev)[None, :] >= lengths[:, None]
    zero_past = not bool(y[past].any())
    differ = float((y != yw).float().mean())
    log(f"[25] selective scan ({b}, {s}, {di}) bf16, lengths "
        f"{int(lens.min())}-{int(lens.max())} (sum {int(lens.sum())}), z "
        f"read in place (row stride {z.stride(1)}): y past one ulp of the "
        f"plain y {over:.3e} (max |y| {top:.3e}, tol 1e-3 of it; "
        f"{100 * differ:.3f} % of entries differ), final state "
        f"max_abs_err {herr:.3e} (max |h| {htop:.3e}, tol 1e-4 of it), y "
        f"zero past every length {zero_past}")
    if not (over <= 1e-3 * top and herr <= 1e-4 * htop and zero_past):
        fail(f"[25] the fused scan disagrees with selective_scan_plain: y "
             f"{over} > 1e-3 * {top} or h {herr} > 1e-4 * {htop}, or y "
             f"not zero past a length")
    del yw, hw
    ms = cuda_ms(torch, lambda: selective_scan_cuda(x, z, dt, A, B, C, D,
                                                    None, lengths), reps=10)
    plain_ms = cuda_ms(torch, lambda: selective_scan_plain(
        x, z, dt, A, B, C, D, None, lengths), reps=1, warmup=0)
    cost = scan_cost(float(lens.sum()), dict(PERIOD, mamba_layers=1))
    bound, by = cost.bound_ms(), cost.bound_by()
    log(f"[25] selective scan: {ms:.3f} ms (bound {bound:.3f} ms by {by} "
        f"at the real tokens, `costs_jamba.scan_cost`: "
        f"{100 * bound / ms:.1f} %), plain {plain_ms:.1f} ms ({smi})")
    out = dict(max_abs_err=over, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=None,
               shape=f"b={b} s={s} di={di} bf16 lengths "
                     f"{int(lens.min())}-{int(lens.max())}")
    del x, z, dt, B, C, y, h
    torch.cuda.empty_cache()

    # the embed path: jamba2-mini's period (8 layers, 7 of them Mamba) on
    # the cell's batch 0, then a prefill of its longest review
    cfg, model, params = draw_on_card(torch, dev, "[25]", "jamba2-mini",
                                      torch.bfloat16, num_layers=8)
    mamba = (cfg.num_layers // cfg.group_size) * sum(
        e.mixer == "mamba" for e in layer_schedule(cfg))
    ids, _ = reviews.batch(0)
    batch = {"tokens": ids, "lengths": (ids >= 0).sum(1)}
    selective_scan_cuda.launches = 0
    emb = model.embed(params, batch)
    torch.cuda.synchronize()
    embed_launches = selective_scan_cuda.launches
    longest = ids[int(torch.argmax(batch["lengths"]))]
    with torch.no_grad():
        model.prefill(params, {"tokens": longest[longest >= 0][None]})
    torch.cuda.synchronize()
    prefill_launches = selective_scan_cuda.launches - embed_launches
    embed_ms = cuda_ms(torch, lambda: model.embed(params, batch), reps=3)
    log(f"[25] jamba2-mini's period (8 layers, {mamba} Mamba) on the "
        f"cell's batch 0 ({tuple(ids.shape)}, {int(batch['lengths'].sum())} "
        f"real tokens): Model.embed {embed_ms:.1f} ms, {embed_launches} "
        f"scan launches; a prefill of its longest review "
        f"{prefill_launches}; embeddings finite "
        f"{bool(torch.isfinite(emb).all())}")
    if embed_launches != mamba or prefill_launches != mamba:
        fail(f"[25] scan launches: embed {embed_launches}, prefill "
             f"{prefill_launches}, expected {mamba} each")
    if not bool(torch.isfinite(emb).all()):
        fail("[25] jamba2-mini's embeddings are not finite")
    out.update(launches=embed_launches, prefill_launches=prefill_launches,
               embed_ms=embed_ms)
    del emb, params, model
    torch.cuda.empty_cache()
    return out


def point_update_phase(torch, dev, smi: str) -> dict:
    """[26]: the knn point update's kernel at the two cells' shapes
    against its plain version (module doc). Returns the kernel table's
    figures: those of the knn cell's shape, and each shape's under
    `shapes`."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.wknn import distance_weights
    from repro_torch.kernels.point_update import (
        point_update_cuda, point_update_plain)

    ha = _costs()
    out = {"max_abs_err": 0.0, "shapes": {}}
    gen = torch.Generator(device=dev).manual_seed(26)
    for tb, n in ((32, 650000), (256, 1281167)):
        # the step's u: a sorted label match (10 % of the train labels
        # match) and wknn's rbf-weighted one, the last row a padded one;
        # ranks a permutation of each row
        match = (torch.rand((tb, n), generator=gen, device=dev) < 0.1).float()
        match[-1] = 0.0
        d2 = torch.sort(torch.rand((tb, n), generator=gen, device=dev)
                        * 4e4).values
        ranks = torch.argsort(torch.rand((tb, n), generator=gen,
                                         device=dev), dim=1)
        errs = {}
        for kind, u in (("knn_shapley", match),
                        ("wknn", distance_weights(d2, "rbf") * match)):
            before = point_update_cuda.launches
            got = point_update_cuda(torch.zeros(n, device=dev), u, ranks, 5)
            again = point_update_cuda(torch.zeros(n, device=dev), u, ranks,
                                      5)
            want = point_update_plain(torch.zeros(n, device=dev), u, ranks,
                                      5)
            torch.cuda.synchronize()
            if point_update_cuda.launches != before + 2:
                fail(f"[26] point_update_cuda launched "
                     f"{point_update_cuda.launches - before} times, not 2")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            same = bool(torch.equal(got, again))
            errs[kind] = err
            log(f"[26] point update {kind} ({tb}, {n}): max_abs_err "
                f"{err:.3e} (max |plain| {scale:.3e}, tol 1e-6 of it); two "
                f"runs bit-identical {same}")
            if not (err <= 1e-6 * scale and same):
                fail(f"[26] point update {kind} at ({tb}, {n}): error {err}"
                     f" > 1e-6 * {scale}, or two runs differ")
            del got, again, want
        u = match
        vec = torch.zeros(n, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        point_update_cuda(vec, u, ranks, 5)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.reset_peak_memory_stats()
        point_update_plain(vec, u, ranks, 5)
        torch.cuda.synchronize()
        plain_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                point_update_cuda(vec, u, ranks, 5)
            torch.cuda.synchronize()
        calls = [e.name for e in prof.events() if e.name.startswith((
            "cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaMemset",
            "cuLaunchKernel"))]
        split = {e.key.split("::")[-1].split("(")[0]: e.device_time_total
                 / 3e3 for e in prof.key_averages()
                 if e.device_time_total > 0}
        ms = cuda_ms(torch, lambda: point_update_cuda(vec, u, ranks, 5),
                     reps=10)
        plain_ms = cuda_ms(torch, lambda: point_update_plain(vec, u, ranks,
                                                             5), reps=3)
        bound, by = ha.point_update_cost(tb, n).bound_ms()
        by_kernel = ({k: round(v, 4) for k, v in split.items()} if split
                     else "not measured: the profiler traced no device time")
        log(f"[26] point update ({tb}, {n}): {ms:.3f} ms (its bound "
            f"{bound:.3f} ms by {by}, {100 * bound / ms:.1f} %; by kernel "
            f"{by_kernel}), plain "
            f"{plain_ms:.3f} ms; peak +{peak:.3f} GiB (plain +"
            f"{plain_peak:.3f}); runtime launches and memsets in one call: "
            f"{len(calls) / 3:g} ({smi})")
        if len(calls) != 9:
            fail(f"[26] three point updates made {len(calls)} runtime "
                 f"launches and memsets, not 9: {calls}")
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=None, shape=f"t={tb} n={n} f32",
                   max_abs_err=max(out["max_abs_err"], *errs.values()))
        out["shapes"][f"{tb}x{n}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "by_kernel_ms": split, "max_abs_err": errs,
            "peak_gib": peak, "plain_peak_gib": plain_peak}
        del match, d2, ranks, u, vec
        torch.cuda.empty_cache()
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"{src / 'repro_torch'} is missing: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(src))
    # the tuning cache of this run only, empty until [10] tunes: every
    # "auto" of [1]-[9] resolves from the heuristic, whatever an earlier
    # run left in ~/.cache
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(tune_dir) / "autotune.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    import numpy as np

    from repro_torch import (
        ShardedValuationSession, ValuationSession, get_method)
    from repro_torch.configs.sti_knn_paper import CONFIG
    from repro_torch.core.sti_baseline import (
        brute_force_shapley, brute_force_sii, brute_force_sti,
        brute_force_wknn_shapley)
    from repro_torch.core.sti_knn import (
        ranks_from_distances, ranks_from_order, superdiagonal_g)
    from repro_torch.data import flip_labels, make_gaussian_blobs
    from repro_torch.kernels import build
    from repro_torch.kernels.distance import distance_cuda, distance_plain
    from repro_torch.kernels.point_update import point_update_cuda
    from repro_torch.kernels.rank_sort import rank_order_cuda
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    from repro_torch.kernels.sti_fill import TILE as FILL_TILE
    from repro_torch.kernels.sti_fill import (
        fill_tile_walk, rect_row_view, sti_fill_acc_cuda, sti_fill_acc_plain,
        sti_fill_acc_rect_cuda, sti_fill_acc_rect_plain, sti_fill_cuda,
        sti_fill_plain, sti_fill_rect_cuda, sti_fill_rect_plain)
    from repro_torch.kernels.sti_megakernel import (
        megakernel_rank_phase_cuda, megakernel_rank_phase_plain,
        point_megakernel_cuda, point_megakernel_plain, radix_passes,
        sti_megakernel_cuda, sti_megakernel_plain)
    from repro_torch.kernels.sti_pipeline import (
        pad_test_batch, prepare_stream_step, stream_point_values)

    # ---------------------------------------------------- 1. build, device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[1] built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    for name, rep in reports.items():
        for ln in rep.splitlines():
            if any(k in ln for k in ("registers", "spill", "wgmma")):
                log(f"    {name}: {ln.strip()}")
    # registers and spills of the two kernels that run the fill tile
    fill_usage = {}
    for src_name, pattern in (("sti_fill", r"fill_acc_kernel"),
                              ("sti_megakernel", r"\d+megakernelE")):
        for fn, use in ptxas_usage(reports.get(src_name, "")).items():
            if re.search(pattern, fn):
                fill_usage[src_name] = use
        log(f"[1] {src_name} fill kernel (ptxas -v): "
            f"{fill_usage.get(src_name, 'not measured: not built here')}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # ------------------------------------- 2. kernels vs plain on the card
    n_full, d_full, k = CONFIG.n_train, CONFIG.feat_dim, CONFIG.k
    tb = 256
    entries = {}

    def check_distance(t, n, d, dtype, rel_tol, gen=gen):
        xt = torch.randn((t, d), generator=gen, device=dev).to(dtype)
        xn = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        got, want = distance_cuda(xt, xn), distance_plain(xt, xn)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        log(f"[2] distance {dtype} ({t}, {n}, {d}): max_abs_err {err:.3e} "
            f"(max |ref| {scale:.1f}, tol {rel_tol:g} relative)")
        if not err <= rel_tol * scale:
            fail(f"distance kernel disagrees with plain at ({t},{n},{d}) "
                 f"{dtype}: {err} > {rel_tol} * {scale}")
        return xt, xn, err

    # 1e-5 relative for f32 and for bf16 inputs alike: both sides read the
    # same tensors, form exact products in f32 (a bf16 product fits in an
    # f32 mantissa) and sum them in f32, in another order
    check_distance(tb, 8192, d_full, torch.float32, 1e-5)
    check_distance(tb, 8192, d_full, torch.bfloat16, 1e-5)
    check_distance(33, 65, 7, torch.float32, 1e-5)
    xt, xn, derr = check_distance(tb, n_full, d_full, torch.float32, 1e-5)
    # the bf16 cases draw from a generator of their own, so every other
    # check sees the same inputs as before they were added
    gen16 = torch.Generator(device=dev)
    gen16.manual_seed(16)
    check_distance(33, 65, 7, torch.bfloat16, 1e-5, gen16)
    xtb, xnb, _ = check_distance(tb, n_full, d_full, torch.bfloat16, 1e-5,
                                 gen16)
    # integer features in [-8, 8]: every product and sum is exact in f32,
    # so distances and ranks must be bit-equal to the plain version
    xi = torch.randint(-8, 9, (tb, d_full), generator=gen, device=dev).float()
    xni = torch.randint(-8, 9, (8192, d_full), generator=gen,
                        device=dev).float()
    di, dp = distance_cuda(xi, xni), distance_plain(xi, xni)
    if not torch.equal(di, dp):
        fail("distance kernel is not bit-equal to plain on integer features")
    if not torch.equal(ranks_from_distances(di), ranks_from_distances(dp)):
        fail("ranks differ from plain on integer features")
    log("[2] integer features: distances and ranks bit-equal to plain")
    # the kernel's times beside its plain version and torch.cdist, each
    # the faster of two timings taken in turns (kernel, plain, cdist,
    # cdist, plain, kernel)
    timed = (lambda: distance_cuda(xt, xn), lambda: distance_plain(xt, xn),
             lambda: torch.cdist(xt, xn))
    first = [cuda_ms(torch, fn, reps=20) for fn in timed]
    second = [cuda_ms(torch, fn, reps=20) for fn in reversed(timed)][::-1]
    dist_ms, dist_plain_ms, cdist_ms = map(min, first, second)
    bound, by = distance_bound_ms(tb, n_full, d_full, 4)
    entries["distance"] = dict(
        name="distance", route="cuda", source="src/repro_torch/csrc/distance.cu",
        replaces="src/repro/kernels/distance.py:73", max_abs_err=derr,
        ms=dist_ms, plain_ms=dist_plain_ms, bound_ms=bound, bound_by=by,
        library_ms=cdist_ms, shape=f"t={tb} n={n_full} d={d_full} f32",
    )
    log(f"[2] distance ({tb}, {n_full}, {d_full}) f32: kernel "
        f"{dist_ms:.4f} ms, plain {dist_plain_ms:.4f} ms, torch.cdist "
        f"{cdist_ms:.4f} ms ({cdist_ms / dist_ms:.2f}x the kernel), bound "
        f"{bound:.4f} ms ({by}; 2tnd at "
        f"{_costs().TF32_FLOP_PER_S / 1e12:g} TFLOP/s "
        f"TF32 {distance_ops_ms(tb, n_full, d_full, 4):.4f} ms; "
        f"{distance_other_bounds_ms(tb, n_full, d_full, 4)})")
    # where a call's device time goes: the norm pre-pass and the main
    # kernel, from a torch.profiler trace of 5 calls
    for label, a_, b_ in (("f32", xt, xn), ("bf16", xtb, xnb)):
        busy = device_busy(torch, lambda: [distance_cuda(a_, b_)
                                           for _ in range(5)])
        if busy is None:
            log("[2] torch.profiler traced no device time: the distance "
                "breakdown is not measured")
            break
        log(f"[2] distance {label} device time per call: " + ", ".join(
            f"{nm.split(')::')[-1].split('(')[0][:40]} {ms / 5:.4f} ms"
            for nm, ms in busy["top"]))
    dist_bf16_ms = cuda_ms(torch, lambda: distance_cuda(xtb, xnb), reps=20)
    dist_bf16_plain_ms = cuda_ms(torch, lambda: distance_plain(xtb, xnb),
                                 reps=20)
    bound16, by16 = distance_bound_ms(tb, n_full, d_full, 2)
    distance_bf16 = dict(ms=dist_bf16_ms, plain_ms=dist_bf16_plain_ms,
                         bound_ms=bound16, bound_by=by16)
    log(f"[2] distance ({tb}, {n_full}, {d_full}) bf16: kernel "
        f"{dist_bf16_ms:.4f} ms, plain {dist_bf16_plain_ms:.4f} ms, bound "
        f"{bound16:.4f} ms ({by16}; "
        f"{distance_other_bounds_ms(tb, n_full, d_full, 2)})")
    # the kernels must be the Hopper ones: wgmma (HGMMA) and TMA loads
    # (UTMALDG) in both distance entry kernels, wgmma in the megakernel
    dist_sass = {nm: txt for nm, txt in build.sass("distance").items()
                 if "sq_dist_kernel" in nm}
    mk_sass = build.sass("sti_megakernel")
    for label, kernels in (("distance", dist_sass),
                           ("sti_megakernel", mk_sass)):
        for nm, txt in kernels.items():
            log(f"[2] SASS of {label} {nm[:48]}: HGMMA "
                f"{txt.count('HGMMA')}, UTMALDG {txt.count('UTMALDG')}")
    if len(dist_sass) != 2 or not all("HGMMA" in x and "UTMALDG" in x
                                      for x in dist_sass.values()):
        fail("[2] a distance entry kernel's SASS holds no HGMMA or no "
             "UTMALDG")
    if not mk_sass or not all("HGMMA" in x for x in mk_sass.values()):
        fail("[2] the megakernel's SASS holds no HGMMA")
    del xt, xn, xtb, xnb, xi, xni, di, dp

    def fill_inputs(t, n):
        g = torch.randn((t, n), generator=gen, device=dev)
        ranks = torch.argsort(torch.rand((t, n), generator=gen, device=dev),
                              dim=1)
        return g, ranks

    # The kernel sums the test points from zero in the plain version's
    # order (p = 0, 1, ...) and adds the sum once, as plain does, so the
    # two should agree to the bit (logged); the tolerance, 1e-6 of the
    # largest |value| as for the JAX fills, would admit only rounding. The
    # accumulators are not symmetric, so a mirrored tile that landed in the
    # wrong place, or twice, would show.
    fill_tol = 1e-6
    for n in (4099, 8192):
        g, ranks = fill_inputs(tb, n)
        acc0 = torch.randn((n, n), generator=gen, device=dev)
        got = sti_fill_acc_cuda(acc0.clone(), g, ranks)
        want = sti_fill_acc_plain(acc0.clone(), g, ranks)
        got0, want0 = sti_fill_cuda(g, ranks), sti_fill_plain(g, ranks)
        torch.cuda.synchronize()
        for label, a, b in (("acc", got, want), ("zero-init", got0, want0)):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            log(f"[2] fill {label} (t={tb}, n={n}): max_abs_err {err:.3e} "
                f"(max |ref| {scale:.1f}); bit-equal to plain "
                f"{bool(torch.equal(a, b))}")
            if not err <= fill_tol * scale:
                fail(f"fill {label} kernel disagrees with plain at n={n}: "
                     f"{err} > {fill_tol} * {scale}")
        del g, ranks, acc0, got, want, got0, want0

    # the tiles the square computes: the kernel's own count (its schedule,
    # host side) and the Python copy of its walk, against all (n/128)^2
    tiles_c = build.library("sti_fill").sti_fill_tiles
    tiles_c.argtypes = [ctypes.c_int] * 3
    tiles_c.restype = ctypes.c_longlong
    fill_tiles = int(tiles_c(n_full, n_full, 0))
    walked = sum(1 for _ in fill_tile_walk(n_full, n_full, 0))
    all_tiles = (-(-n_full // FILL_TILE)) ** 2
    log(f"[2] fill square n={n_full}: {fill_tiles} tiles computed (the "
        f"Python walk: {walked}) of {all_tiles} = (n/128)^2, "
        f"{fill_tiles / all_tiles:.4f} of them")
    if fill_tiles != walked:
        fail(f"the kernel's tile count {fill_tiles} is not the Python "
             f"walk's {walked}")

    # the main path's shape: (t, n) = (256, 65536), one call each
    g, ranks = fill_inputs(tb, n_full)
    acc_k = torch.zeros((n_full, n_full), device=dev)
    sti_fill_acc_cuda(acc_k, g, ranks)
    acc_p = torch.zeros((n_full, n_full), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sti_fill_acc_plain(acc_p, g, ranks)
    torch.cuda.synchronize()
    fill_plain_ms = 1e3 * (time.perf_counter() - t0)
    ferr = max_abs_diff(torch, acc_k, acc_p)
    fscale = max_abs(torch, acc_p)
    fbits = all(bool(torch.equal(acc_k[r0:r0 + 4096], acc_p[r0:r0 + 4096]))
                for r0 in range(0, n_full, 4096))
    log(f"[2] fill acc (t={tb}, n={n_full}): max_abs_err {ferr:.3e} "
        f"(max |ref| {fscale:.1f}); bit-equal to plain {fbits}; plain "
        f"{fill_plain_ms:.1f} ms")
    if not ferr <= fill_tol * fscale:
        fail(f"fill kernel disagrees with plain at n={n_full}: {ferr}")
    del acc_p
    torch.cuda.empty_cache()
    fill_ms, clocks = with_clocks(
        lambda: cuda_ms(torch, lambda: sti_fill_acc_cuda(acc_k, g, ranks),
                        reps=5))
    bound, by = fill_bound_ms(tb, n_full)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    updates = fill_tiles * FILL_TILE * FILL_TILE * tb
    per_clock = (updates / (fill_ms * 1e-3 * sms * clocks["sm_mhz"] * 1e6)
                 if clocks["sm_mhz"] else None)
    fill_sass = {nm: txt for nm, txt in build.sass("sti_fill").items()
                 if "fill_acc_kernel" in nm}
    mk_fill_sass = {nm: txt for nm, txt in build.sass(
        "sti_megakernel").items() if re.search(r"\d+megakernelE", nm)}
    # each test point adds 64 pair-point updates to a thread's 8 x 8
    # micro-tile, as two predicated FADDs each: the per-point loop (the
    # ragged last stage's) holds 128 FADDs, the unrolled stage of 16 points
    # (with its copies and barrier) 2048
    loops = {}
    for label, kern in (("sti_fill", fill_sass),
                        ("sti_megakernel", mk_fill_sass)):
        for scope, need, per in (("point", 128, 64), ("stage", 2048, 1024)):
            hist = sass_loop(next(iter(kern.values()), ""), "FADD", need)
            loops[f"{label} {scope}"] = dict(
                instructions=sum(hist.values()), updates=per,
                per_update={op: c / per for op, c in sorted(
                    hist.items(), key=lambda kv: -kv[1])})
    fill_tile_report = dict(
        tiles=fill_tiles, all_tiles=all_tiles, updates=updates,
        clocks=clocks, sms=sms, updates_per_sm_per_clock=per_clock,
        ptxas=fill_usage, hot_loop=loops)
    log(f"[2] fill acc timing window: SM clock {clocks['sm_mhz']} MHz, "
        f"power {clocks['power_w']} W ({clocks['samples']} nvidia-smi "
        f"samples); {updates:.4g} pair-point updates in {fill_ms:.2f} ms on "
        f"{sms} SMs = {per_clock} updates per SM per clock")
    for label, loop in loops.items():
        log(f"[2] {label} loop SASS: {loop['instructions']} instructions "
            f"for {loop['updates']} updates a thread; per update "
            f"{ {op: round(c, 4) for op, c in loop['per_update'].items()} }")
    entries["sti_fill_acc"] = dict(
        name="sti_fill_acc", route="cuda",
        source="src/repro_torch/csrc/sti_fill.cu",
        replaces="src/repro/kernels/sti_fill.py:205", max_abs_err=ferr,
        ms=fill_ms, plain_ms=fill_plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, shape=f"t={tb} n={n_full}",
    )
    log(f"[2] fill acc (t={tb}, n={n_full}): kernel {fill_ms:.2f} ms, "
        f"plain {fill_plain_ms:.1f} ms (one call), bound {bound:.2f} ms "
        f"({by}); no single PyTorch call computes it")
    del acc_k, g, ranks
    torch.cuda.empty_cache()

    # ------------------------------- 2b. the megakernels vs plain on the card
    # Integer features: their distances are exact in the kernel and in the
    # plain version's cuBLAS product alike, so the ranks -- ties included,
    # and at d = 768 in [-8, 8] ties are common -- must agree and only the
    # order of float sums differs (the kernel's suffix scans run in another
    # order than torch.cumsum). State starts at zero, so what is compared is
    # the step's own increment, held to 1e-6 of its largest |value|
    # (rounding only). On continuous data the two products round
    # differently and may swap near-equal neighbours; paths [5] and [6]
    # hold the kernels there against the three-stage step, whose distance
    # kernel gives the same bits.
    mk_tol = 1e-6

    def mk_problem(t, n, d, real, lo=-8, hi=8):
        xb = torch.randint(lo, hi + 1, (t, d), generator=gen,
                           device=dev).float()
        xs = torch.randint(lo, hi + 1, (n, d), generator=gen,
                           device=dev).float()
        yb = torch.randint(0, 3, (t,), generator=gen, device=dev)
        ys = torch.randint(0, 3, (n,), generator=gen, device=dev)
        mask = (torch.arange(t, device=dev) < real).float()
        return xb, yb, mask, xs, ys

    point_cases = (("knn_shapley", None), ("wknn", {"weights": "rbf"}),
                   ("wknn", {"weights": "inverse"}), ("loo", None))

    def hold(label, got, want):
        """Fail unless each kernel output agrees with the plain one to
        mk_tol of its largest |value|; returns the largest error."""
        torch.cuda.synchronize()
        errs = []
        for g_, w_ in zip(got, want):
            err = max_abs_diff(torch, g_.reshape(g_.shape[0], -1),
                               w_.reshape(w_.shape[0], -1))
            scale = max(max_abs(torch, w_.reshape(w_.shape[0], -1)), 1e-30)
            log(f"[2b] {label}: max_abs_err {err:.3e} (max |ref| "
                f"{scale:.3e}, tol {mk_tol:g} of it)")
            if not err <= mk_tol * scale:
                fail(f"{label}: kernel disagrees with plain: {err} > "
                     f"{mk_tol} * {scale}")
            errs.append(err)
        return max(errs)

    def zeros_state(nr, n):
        return (torch.zeros((nr, n), device=dev),
                torch.zeros((nr,), device=dev))

    for (t, n, d, real) in ((tb, 8192, d_full, tb), (33, 65, 7, 20)):
        xb, yb, mask, xs, ys = mk_problem(t, n, d, real)
        for mode in ("sti", "sii"):
            for cd in ("float32", "bfloat16"):
                kw = dict(k=k, mode=mode, compute_dtype=cd)
                got = sti_megakernel_cuda(*zeros_state(n, n), xb, yb, mask,
                                          xs, ys, **kw)
                want = sti_megakernel_plain(*zeros_state(n, n), xb, yb, mask,
                                            xs, ys, **kw)
                hold(f"sti_megakernel {mode} {cd} ({t}, {n}, {d})", got,
                     want)
                del got, want
        # a misaligned row block (every tile computed) and one at a
        # multiple of 128 (its diagonal square mirrored)
        for off, nr in ((n // 3, n // 4), (n // 2 // 128 * 128, n // 4)):
            got = sti_megakernel_cuda(*zeros_state(nr, n), xb, yb, mask, xs,
                                      ys, k=k, row_offset=off)
            want = sti_megakernel_plain(*zeros_state(nr, n), xb, yb, mask,
                                        xs, ys, k=k, row_offset=off)
            hold(f"sti_megakernel rows [{off}, {off + nr}) ({t}, {n}, {d})",
                 got, want)
        for method, opts in point_cases:
            kw = dict(method=method, k=k, opts=opts)
            got = point_megakernel_cuda(torch.zeros((n,), device=dev), xb, yb,
                                        mask, xs, ys, **kw)
            want = point_megakernel_plain(torch.zeros((n,), device=dev), xb,
                                          yb, mask, xs, ys, **kw)
            hold(f"point_megakernel {method} {opts or ''} ({t}, {n}, {d})",
                 (got,), (want,))
        del xb, yb, mask, xs, ys, got, want

    # the main path's shape, (t, n, d) = (256, 65536, 768): one call of each
    # kernel and of its plain version, from zero; the plain call is timed
    xb, yb, mask, xs, ys = mk_problem(tb, n_full, d_full, tb)
    mk_kw = dict(k=k, mode=CONFIG.mode)
    acc_k, diag_k = sti_megakernel_cuda(*zeros_state(n_full, n_full), xb, yb,
                                        mask, xs, ys, **mk_kw)
    acc_p, diag_p = zeros_state(n_full, n_full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sti_megakernel_plain(acc_p, diag_p, xb, yb, mask, xs, ys, **mk_kw)
    torch.cuda.synchronize()
    sti_mk_plain_ms = 1e3 * (time.perf_counter() - t0)
    sti_mk_err = hold(
        f"sti_megakernel {CONFIG.mode} float32 ({tb}, {n_full}, {d_full})",
        (acc_k, diag_k), (acc_p, diag_p))
    del acc_p, diag_p
    torch.cuda.empty_cache()
    sti_mk_ms = cuda_ms(torch, lambda: sti_megakernel_cuda(
        acc_k, diag_k, xb, yb, mask, xs, ys, **mk_kw), reps=3)
    del acc_k, diag_k
    torch.cuda.empty_cache()
    bound, by = sti_megakernel_bound_ms(tb, n_full, d_full)
    entries["sti_megakernel"] = dict(
        name="sti_megakernel", route="cuda",
        source="src/repro_torch/csrc/sti_megakernel.cu",
        replaces="src/repro/kernels/sti_megakernel.py:360",
        max_abs_err=sti_mk_err, ms=sti_mk_ms, plain_ms=sti_mk_plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        shape=f"t={tb} n={n_full} d={d_full} {CONFIG.mode}",
    )
    log(f"[2b] sti_megakernel step (t={tb}, n={n_full}, d={d_full}): kernel "
        f"{sti_mk_ms:.2f} ms, plain {sti_mk_plain_ms:.1f} ms (one call), "
        f"bound {bound:.2f} ms ({by}); no single PyTorch call computes it")
    pt_err = 0.0
    for method, opts in point_cases:
        kw = dict(method=method, k=k, opts=opts)
        got = point_megakernel_cuda(torch.zeros((n_full,), device=dev), xb,
                                    yb, mask, xs, ys, **kw)
        want = point_megakernel_plain(torch.zeros((n_full,), device=dev), xb,
                                      yb, mask, xs, ys, **kw)
        pt_err = max(pt_err, hold(
            f"point_megakernel {method} {opts or ''} ({tb}, {n_full}, "
            f"{d_full})", (got,), (want,)))
    vec_m = torch.zeros((n_full,), device=dev)
    pt_kw = dict(method="knn_shapley", k=k)
    pt_ms = cuda_ms(torch, lambda: point_megakernel_cuda(
        vec_m, xb, yb, mask, xs, ys, **pt_kw), reps=10)
    pt_plain_ms = cuda_ms(torch, lambda: point_megakernel_plain(
        vec_m, xb, yb, mask, xs, ys, **pt_kw), reps=10)
    bound, by = point_megakernel_bound_ms(tb, n_full, d_full)
    entries["point_megakernel"] = dict(
        name="point_megakernel", route="cuda",
        source="src/repro_torch/csrc/sti_megakernel.cu",
        replaces="src/repro/kernels/sti_megakernel.py:429",
        max_abs_err=pt_err, ms=pt_ms, plain_ms=pt_plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        shape=f"t={tb} n={n_full} d={d_full} knn_shapley",
    )
    log(f"[2b] point_megakernel step (knn_shapley, t={tb}, n={n_full}, "
        f"d={d_full}): kernel {pt_ms:.3f} ms, plain {pt_plain_ms:.3f} ms, "
        f"bound {bound:.3f} ms ({by}; the distance phase's 3xTF32 floor "
        f"{3 * distance_ops_ms(tb, n_full, d_full, 4):.3f} ms); no single "
        f"PyTorch call computes it")
    del xb, yb, mask, xs, ys, got, want, vec_m
    torch.cuda.empty_cache()
    # the rank phase is a stable sort: bit-equal to torch.sort(stable=True)
    # of distance_cuda's d2 on tie-heavy features, and bf16 on integer
    # features gives the f32 bits
    for lo, hi in ((-2, 2), (-8, 8)):
        xb, _, _, xs, _ = mk_problem(tb, 8192, d_full, tb, lo, hi)
        want = torch.sort(distance_cuda(xb, xs), dim=-1, stable=True)
        for cd in ("float32", "bfloat16"):
            d2s, order = megakernel_rank_phase_cuda(xb, xs, compute_dtype=cd)
            torch.cuda.synchronize()
            if not (torch.equal(order, want.indices)
                    and torch.equal(d2s, want.values)):
                fail(f"rank phase ({cd}, features in [{lo}, {hi}]) is not "
                     f"bit-equal to torch.sort(stable=True)")
        log(f"[2b] rank phase on features in [{lo}, {hi}] (t={tb}, n=8192, "
            f"d={d_full}): f32 and bf16 bit-equal to torch.sort(stable=True)"
            f" of distance_cuda")
    # bf16 on continuous data: the sorted distances match the plain bf16
    # ones (a near-tie swap leaves sorted values in place) and differ from
    # f32 by more than ten times that tolerance (bf16 operands move d2 by
    # ~3e-4 of its size here), so the cross term really was rounded
    xb = torch.randn((tb, d_full), generator=gen, device=dev)
    xs = torch.randn((8192, d_full), generator=gen, device=dev)
    got, _ = megakernel_rank_phase_cuda(xb, xs, compute_dtype="bfloat16")
    want, _ = megakernel_rank_phase_plain(xb, xs, compute_dtype="bfloat16")
    f32, _ = megakernel_rank_phase_cuda(xb, xs)
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    moved = float((got - f32).abs().max())
    log(f"[2b] bf16 rank phase on continuous data: sorted d2 max_abs_err "
        f"{err:.3e} vs plain (max |ref| {scale:.1f}); {moved:.3e} from f32")
    if not (err <= 1e-5 * scale and moved > 1e-4 * scale):
        fail(f"bf16 rank phase: err {err}, distance from f32 {moved}")
    del xb, xs, got, want, f32
    torch.cuda.empty_cache()

    # ------------------------------- 2c. the rect fill vs plain on the card
    # The rect kernel runs the square kernel's tile code, summing the test
    # points in plain's order, so it should agree with plain to the bit; the
    # tolerance, 1e-6 of the largest |value| as for the fills, would admit
    # only rounding.
    rect_tol = 1e-6

    def rect_inputs(t, nr, nc, n, off):
        g = torch.randn((t, n), generator=gen, device=dev)
        if off is None:  # independent row and column tables, ranks < n
            rr = torch.randint(0, n, (t, nr), generator=gen, device=dev)
            rc = torch.randint(0, n, (t, nc), generator=gen, device=dev)
        else:  # the sharded engine's call: a row window of the table
            rc = torch.argsort(torch.rand((t, n), generator=gen, device=dev),
                               dim=1)
            rr = rect_row_view(rc, off, nr)
        return g, rr, rc

    def hold_rect(label, got, want):
        torch.cuda.synchronize()
        err, scale = max_abs_diff(torch, got, want), max_abs(torch, want)
        log(f"[2c] rect fill {label}: max_abs_err {err:.3e} (max |ref| "
            f"{scale:.3e}, tol {rect_tol:g} of it)")
        if not err <= rect_tol * scale:
            fail(f"rect fill {label}: kernel disagrees with plain: {err} > "
                 f"{rect_tol} * {scale}")
        return err

    for (t, nr, nc, n, off) in ((33, 40, 65, 70, None),
                                (tb, 1000, 8192, 8192, 3000)):
        g, rr, rc = rect_inputs(t, nr, nc, n, off)
        acc0 = torch.randn((nr, nc), generator=gen, device=dev)
        label = f"({t}, {nr}, {nc}) g {n} wide" + (
            " independent tables" if off is None else f" rows at {off}")
        hold_rect(label, sti_fill_acc_rect_cuda(acc0.clone(), g, rr, rc),
                  sti_fill_acc_rect_plain(acc0.clone(), g, rr, rc))
        hold_rect(label + " zero-init", sti_fill_rect_cuda(g, rr, rc),
                  sti_fill_rect_plain(g, rr, rc))
        del g, rr, rc, acc0
    # the main path's call: the last (16384, 65536) row block of a D = 4
    # step, rows at 3 * 16384, from zero; one call each, the plain timed
    shards = 4
    nl = n_full // shards
    g, rr, rc = rect_inputs(tb, nl, n_full, n_full, (shards - 1) * nl)
    acc_k = torch.zeros((nl, n_full), device=dev)
    sti_fill_acc_rect_cuda(acc_k, g, rr, rc)
    acc_p = torch.zeros((nl, n_full), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sti_fill_acc_rect_plain(acc_p, g, rr, rc)
    torch.cuda.synchronize()
    rect_plain_ms = 1e3 * (time.perf_counter() - t0)
    rect_err = hold_rect(f"({tb}, {nl} rows at {(shards - 1) * nl}, "
                         f"{n_full})", acc_k, acc_p)
    log(f"[2c] full-width block bit-equal to plain: "
        f"{bool(torch.equal(acc_k, acc_p))}")
    del acc_p
    torch.cuda.empty_cache()
    rect_ms = cuda_ms(torch, lambda: sti_fill_acc_rect_cuda(acc_k, g, rr, rc),
                      reps=5)
    bound, by = rect_fill_bound_ms(tb, nl, n_full)
    entries["sti_fill_acc_rect"] = dict(
        name="sti_fill_acc_rect", route="cuda",
        source="src/repro_torch/csrc/sti_fill.cu",
        replaces="src/repro/kernels/sti_fill.py:258", max_abs_err=rect_err,
        ms=rect_ms, plain_ms=rect_plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None,
        shape=f"t={tb} rows={nl} at {(shards - 1) * nl} n={n_full}",
    )
    rect_tiles = int(tiles_c(nl, n_full, (shards - 1) * nl))
    log(f"[2c] rect fill block (t={tb}, {nl} x {n_full}): kernel "
        f"{rect_ms:.2f} ms, plain {rect_plain_ms:.1f} ms (one call), bound "
        f"{bound:.2f} ms ({by}; {shards} blocks {shards * bound:.1f} ms); "
        f"{rect_tiles} tiles computed of "
        f"{(nl // FILL_TILE) * (n_full // FILL_TILE)}; no single PyTorch "
        f"call computes it")
    del acc_k, g, rr, rc
    torch.cuda.empty_cache()

    # --------------------------------- 3. exactness against the O(2^n) oracle
    # float64 features, as numpy gives them: the entry point casts them to
    # the float32 the distance kernel takes
    rng = np.random.default_rng(3)
    n12, t12, k12 = 12, 6, 3
    x12 = rng.integers(-8, 9, (n12, 4)).astype(np.float64)
    y12 = rng.integers(0, 2, n12).astype(np.int32)
    xt12 = rng.integers(-8, 9, (t12, 4)).astype(np.float64)
    yt12 = rng.integers(0, 2, t12).astype(np.int32)
    oracles = {"sti": brute_force_sti, "sii": brute_force_sii}
    distance_cuda.launches = sti_fill_acc_cuda.launches = 0
    for method, oracle in oracles.items():
        want = oracle(x12, y12, xt12, yt12, k12)
        for engine in ("fused", "scan"):
            res = get_method(method)(x12, y12, xt12, yt12, k=k12,
                                     engine=engine, test_batch=4, device=dev)
            err = float(np.abs(res.phi.cpu().numpy() - want).max())
            log(f"[3] {method} {engine} n={n12} vs O(2^n) oracle: "
                f"max_abs_err {err:.3e} (tol 1e-5)")
            if not err <= 1e-5:
                fail(f"{method} {engine} disagrees with the oracle: {err}")
    if distance_cuda.launches == 0 or sti_fill_acc_cuda.launches == 0:
        fail("the n=12 runs did not go through both kernels")
    sti_megakernel_cuda.launches = point_megakernel_cuda.launches = 0
    for method, oracle in oracles.items():
        res = get_method(method)(x12, y12, xt12, yt12, k=k12, engine="fused",
                                 fill="megakernel", test_batch=4, device=dev)
        err = float(np.abs(res.phi.cpu().numpy()
                           - oracle(x12, y12, xt12, yt12, k12)).max())
        log(f"[3] {method} megakernel n={n12} vs O(2^n) oracle: max_abs_err "
            f"{err:.3e} (tol 1e-5)")
        if not err <= 1e-5:
            fail(f"{method} megakernel disagrees with the oracle: {err}")
    for method, opts, want in (
            ("knn_shapley", None,
             brute_force_shapley(x12, y12, xt12, yt12, k12)),
            ("wknn", {"weights": "rbf"},
             brute_force_wknn_shapley(x12, y12, xt12, yt12, k12))):
        for fill in (None, "megakernel"):
            got = stream_point_values(method, x12, y12, xt12, yt12, k12,
                                      test_batch=4, fill=fill,
                                      method_opts=opts, distance="cuda",
                                      device=dev)
            err = float(np.abs(got.cpu().numpy() - want).max())
            log(f"[3] {method} {fill or 'three-stage'} n={n12} vs O(2^n) "
                f"oracle: max_abs_err {err:.3e} (tol 1e-5)")
            if not err <= 1e-5:
                fail(f"{method} ({fill}) disagrees with the oracle: {err}")
    if not (sti_megakernel_cuda.launches and point_megakernel_cuda.launches):
        fail("the n=12 runs did not go through both megakernels")

    # ----------------------------------------------------- 4. full width
    t_full = 384  # cut from the configuration's test_chunk = 4096
    x_all, y_all = make_gaussian_blobs((n_full + t_full) // 2, num_classes=2,
                                       dim=d_full, seed=0)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(
        n_full + t_full))
    x_train, y_train = x_all[perm[:n_full]], y_all[perm[:n_full]]
    x_test, y_test = x_all[perm[n_full:]], y_all[perm[n_full:]]
    y_train, _ = flip_labels(y_train, 0.1, 2, seed=1)
    del x_all, y_all
    distance_cuda.launches = sti_fill_acc_cuda.launches = 0
    rank_order_cuda.launches = 0
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = get_method(CONFIG.mode)(
        x_train, y_train, x_test, y_test, k=k, engine="fused",
        test_batch=tb, device=dev,
    )
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    main_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {"distance": distance_cuda.launches,
                "rank_sort": rank_order_cuda.launches,
                "sti_fill_acc": sti_fill_acc_cuda.launches}
    log(f"[4] {CONFIG.mode} fused n={n_full} d={d_full} k={k} t={t_full} "
        f"(test_batch {tb}): {total_s:.3f} s total, resolved "
        f"fill={result.meta['fill']} distance={result.meta['distance']}, "
        f"launches {launches}, peak device memory {main_peak_gib:.2f} GiB "
        f"({held_gib:.2f} GiB held before by this script)")
    n_steps = -(-t_full // tb)
    # the rank stage's entry: [24] measures the kernel at the cells' shapes
    entries["rank_sort"] = dict(
        name="rank_sort", route="cuda",
        source="src/repro_torch/csrc/rank_sort.cu",
        replaces="no TPU kernel (jnp.argsort + ranks_from_order)")
    # the knn point update: [7], [9f], [10], [12b] and [23] count it on
    # the streamed point paths, [26] measures it at the cells' shapes
    entries["point_update"] = dict(
        name="point_update", route="cuda",
        source="src/repro_torch/csrc/point_update.cu",
        replaces="no TPU kernel (knn_shapley_from_sorted and the gather "
                 "through ranks, left to XLA)")
    # Mamba's scan: [17a], [17b] and [25] count it, [25] measures it
    entries["selective_scan"] = dict(
        name="selective_scan", route="cuda",
        source="src/repro_torch/csrc/selective_scan.cu",
        replaces="no TPU kernel (lax.associative_scan in models/ssm.py)")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")
        entries[name]["launches"] = count
    if launches != {"distance": n_steps, "rank_sort": n_steps,
                    "sti_fill_acc": n_steps}:
        fail(f"expected {n_steps} launches of each kernel, got {launches}")
    phi = result.phi
    if phi.shape != (n_full, n_full) or phi.device.type != "cuda":
        fail(f"phi has shape {tuple(phi.shape)} on {phi.device}")
    if not all(bool(torch.isfinite(phi[r0:r0 + 4096]).all())
               for r0 in range(0, n_full, 4096)):
        fail("phi holds non-finite values")

    # a plain computation of 64 rows of phi. Ranks come from the distance
    # kernel's d2: on continuous data near-equal distances can swap ranks
    # between two summation orders, which is no fault (the distance kernel
    # is held against plain above and bit-equal on integer features).
    xtr, ytr = x_train.to(dev), y_train.to(dev)
    rows = torch.from_numpy(np.sort(np.random.default_rng(2).choice(
        n_full, 64, replace=False))).to(dev)
    acc_rows = torch.zeros((64, n_full), device=dev)
    diag = torch.zeros((n_full,), device=dev)
    v_sum = 0.0
    for start in range(0, t_full, tb):
        xb, yb, mask = pad_test_batch(x_test[start:start + tb].to(dev),
                                      y_test[start:start + tb].to(dev), tb)
        d2 = distance_cuda(xb, xtr)
        order = torch.sort(d2, dim=-1, stable=True).indices
        ranks = ranks_from_order(order)
        u = (ytr[order] == yb[:, None]).float() * (mask / k)[:, None]
        g = superdiagonal_g(u, k, mode=CONFIG.mode)
        gt = torch.gather(g, 1, ranks)
        rr, gr = ranks[:, rows], gt[:, rows]
        step_sum = torch.zeros_like(acc_rows)  # from zero, then added
        for p in range(tb):
            step_sum += torch.where(rr[p, :, None] >= ranks[p, None, :],
                                    gr[p, :, None], gt[p, None, :])
        acc_rows += step_sum
        diag += torch.gather(u, 1, ranks).sum(0)
        v_sum += float(u[:, :k].sum(dtype=torch.float64))
    want_rows = acc_rows / t_full
    want_rows[torch.arange(64, device=dev), rows] = diag[rows] / t_full
    rerr = float((phi[rows] - want_rows).abs().max())
    rscale = float(want_rows.abs().max())
    log(f"[4] 64 sampled rows vs plain: max_abs_err {rerr:.3e} (max |ref| "
        f"{rscale:.3e}, tol 1e-6 relative: the same f32 adds in the same "
        f"order)")
    if not rerr <= 1e-6 * rscale:
        fail(f"sampled rows of phi disagree with plain: {rerr}")
    # the square fill computes the upper tiles and mirrors them: phi must
    # be exactly symmetric (its diagonal, diag / t, is symmetric anyway)
    symmetric = all(bool(torch.equal(phi[r0:r0 + 4096],
                                     phi[:, r0:r0 + 4096].T))
                    for r0 in range(0, n_full, 4096))
    log(f"[4] phi exactly symmetric off the diagonal: {symmetric}")
    if not symmetric:
        fail("[4]'s phi is not exactly symmetric")

    # efficiency: sum(diag) + sum(upper triangle) = v(N), the likelihood
    # valuation. Exact in real arithmetic; in f32 the large terms the
    # matrix sums cancel leave a residue proportional to their mass
    # sum|phi| (CPU runs of this pipeline: 5e-8 of it at n=2048, 1.3e-7 at
    # n=8192), so the tolerance is 2e-6 of that mass.
    v_n = v_sum / t_full
    gap = float(result.efficiency_gap(v_n))
    mass = sum(float(torch.triu(phi[r0:r0 + 4096], diagonal=r0).abs().sum(
        dtype=torch.float64)) for r0 in range(0, n_full, 4096))
    log(f"[4] efficiency gap |sum(triu phi) - v(N)| = {gap:.3e} (float64 "
        f"sum; v(N) = {v_n:.6f}, sum|phi| = {mass:.1f}, ratio "
        f"{gap / mass:.2e}, tol 2e-6 of the mass)")
    if not gap <= 2e-6 * mass:
        fail(f"efficiency gap {gap} exceeds 2e-6 * {mass}")

    # ------------------------- 5. the megakernel path at full width (sti)
    xb, yb, mask = pad_test_batch(x_test[:tb].to(dev), y_test[:tb].to(dev),
                                  tb)
    # the rank phase at full width on the blob data: bit-equal to
    # torch.sort(stable=True) of distance_cuda's d2, continuous data and
    # all, and the passes each row took those that radix_passes counts
    d2s, order, passes = megakernel_rank_phase_cuda(xb, xtr, with_passes=True)
    want = torch.sort(distance_cuda(xb, xtr), dim=-1, stable=True)
    torch.cuda.synchronize()
    if not (torch.equal(order, want.indices)
            and torch.equal(d2s, want.values)):
        fail("full-width rank phase is not bit-equal to torch.sort(stable="
             "True) of distance_cuda")
    if not torch.equal(passes, radix_passes(want.values)):
        fail(f"the sort's passes per row {passes.tolist()} differ from "
             f"radix_passes of the same distances")
    passes = passes.tolist()
    del d2s, order, want
    rank_ms = cuda_ms(torch, lambda: megakernel_rank_phase_cuda(xb, xtr),
                      reps=5)
    sort_ms = cuda_ms(torch, lambda: torch.sort(distance_cuda(xb, xtr),
                                                dim=-1, stable=True), reps=5)
    floor_ms = sort_floor_ms(n_full, passes)
    by_passes = {p_: passes.count(p_) for p_ in sorted(set(passes))}
    mk_use = fill_usage.get("sti_megakernel", "not measured: not built here")
    log(f"[5] rank phase (t={tb}, n={n_full}, d={d_full}): bit-equal to "
        f"torch.sort(stable=True) of distance_cuda; {rank_ms:.3f} ms vs "
        f"{sort_ms:.3f} ms for distance_cuda + torch.sort; the sort's "
        f"traffic floor {floor_ms:.4f} ms (rows by radix passes taken: "
        f"{by_passes}); the distance's bound "
        f"{distance_bound_ms(tb, n_full, d_full, 4)[0]:.4f} ms; megakernel "
        f"(ptxas -v) {mk_use}")

    distance_cuda.launches = sti_fill_acc_cuda.launches = 0
    sti_megakernel_cuda.launches = point_megakernel_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mega = get_method(CONFIG.mode)(
        x_train, y_train, x_test, y_test, k=k, engine="fused",
        fill="megakernel", test_batch=tb, device=dev,
    )
    torch.cuda.synchronize()
    mega_s = time.perf_counter() - t0
    mega_launches = {"sti_megakernel": sti_megakernel_cuda.launches,
                     "distance": distance_cuda.launches,
                     "sti_fill_acc": sti_fill_acc_cuda.launches,
                     "point_megakernel": point_megakernel_cuda.launches}
    log(f"[5] {CONFIG.mode} fused fill=megakernel n={n_full} d={d_full} "
        f"k={k} t={t_full}: {mega_s:.3f} s total, resolved "
        f"fill={mega.meta['fill']} distance={mega.meta['distance']}, "
        f"launches {mega_launches}")
    if mega_launches != {"sti_megakernel": n_steps, "distance": 0,
                         "sti_fill_acc": 0, "point_megakernel": 0}:
        fail(f"the megakernel path must launch sti_megakernel once per step "
             f"({n_steps}) and nothing else: {mega_launches}")
    entries["sti_megakernel"]["launches"] = mega_launches["sti_megakernel"]
    # the same distances and ranks on both sides, the g tables scanned in
    # another order: rounding only, held to 1e-6 of the largest |phi|
    merr = max_abs_diff(torch, mega.phi, phi)
    mscale = max_abs(torch, phi)
    log(f"[5] megakernel phi vs the three-stage phi of [4]: max_abs_err "
        f"{merr:.3e} over all {n_full}^2 entries (max |ref| {mscale:.3e}, "
        f"tol 1e-6 of it)")
    if not merr <= 1e-6 * mscale:
        fail(f"megakernel phi disagrees with the three-stage phi: {merr} > "
             f"1e-6 * {mscale}")
    del mega
    torch.cuda.empty_cache()

    # -------------------- 6. ValuationSession per point method, megakernel
    point_total = 0
    exact_points = {}
    for method in ("knn_shapley", "wknn", "loo"):
        distance_cuda.launches = point_megakernel_cuda.launches = 0
        sti_megakernel_cuda.launches = sti_fill_acc_cuda.launches = 0
        point_update_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = ValuationSession(x_train, y_train, k=k, mode=method,
                                test_batch=tb, fill="megakernel", device=dev)
        vals = sess.update(x_test, y_test).finalize().point_values
        torch.cuda.synchronize()
        sess_s = time.perf_counter() - t0
        counts = (point_megakernel_cuda.launches, distance_cuda.launches,
                  sti_megakernel_cuda.launches, sti_fill_acc_cuda.launches,
                  point_update_cuda.launches)
        if counts != (n_steps, 0, 0, 0, 0):
            fail(f"{method} session launched (point_megakernel, distance, "
                 f"sti_megakernel, fill, point_update) = {counts}, "
                 f"expected ({n_steps}, 0, 0, 0, 0)")
        point_total += counts[0]
        want = stream_point_values(method, x_train, y_train, x_test, y_test,
                                   k, test_batch=tb, distance="cuda",
                                   device=dev)
        torch.cuda.synchronize()
        if vals.shape != (n_full,) or not bool(torch.isfinite(vals).all()):
            fail(f"{method} session values: shape {tuple(vals.shape)} or "
                 f"non-finite")
        # the values sum to the mean test utility, so most of the n are
        # tiny: the tolerance is 1e-6 of the largest |value| (rounding
        # only), far below a typical value (~1/n)
        perr = float((vals - want).abs().max())
        pscale = float(want.abs().max())
        log(f"[6] {method} ValuationSession fill=megakernel n={n_full} "
            f"t={t_full}: {sess_s:.3f} s, {counts[0]} launches; vs the "
            f"three-stage step (distance=cuda): max_abs_err {perr:.3e} "
            f"(max |ref| {pscale:.3e}, tol 1e-6 of it)")
        if not perr <= 1e-6 * pscale:
            fail(f"{method} megakernel session disagrees: {perr} > 1e-6 * "
                 f"{pscale}")
        exact_points[method] = want
        del sess, vals, want
    entries["point_megakernel"]["launches"] = point_total

    # ---------------- 7. the sharded engine at full width, 4 shards, 1 card
    devs = [dev] * shards
    counted = {"distance": distance_cuda, "rank_sort": rank_order_cuda,
               "sti_fill_acc": sti_fill_acc_cuda,
               "sti_fill_acc_rect": sti_fill_acc_rect_cuda,
               "sti_megakernel": sti_megakernel_cuda,
               "point_megakernel": point_megakernel_cuda,
               "selective_scan": selective_scan_cuda,
               "point_update": point_update_cuda}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    def expect(label, got, **want):
        full = {name: 0 for name in counted}
        full.update(want)
        if got != full:
            fail(f"[7] {label} launched {got}, expected {full}")

    def hold_sharded(label, got, want, rel=1e-6):
        err, scale = max_abs_diff(torch, got.reshape(got.shape[0], -1),
                                  want.reshape(want.shape[0], -1)), \
            max_abs(torch, want.reshape(want.shape[0], -1))
        log(f"[7] {label}: max_abs_err {err:.3e} (max |ref| {scale:.3e}, "
            f"tol {rel:g} of it)")
        if not err <= rel * scale:
            fail(f"[7] {label} disagrees: {err} > {rel} * {scale}")
        return err

    steps_x_shards = n_steps * shards
    sharded = {}
    for fill in ("auto", "megakernel"):
        torch.cuda.synchronize()
        base_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = get_method(CONFIG.mode)(
            x_train, y_train, x_test, y_test, k=k, engine="sharded",
            fill=fill, test_batch=tb, devices=devs,
        )
        torch.cuda.synchronize()
        sh_s = time.perf_counter() - t0
        got = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if fill == "megakernel":
            expect("sti fill=megakernel", got,
                   sti_megakernel=steps_x_shards)
        else:
            expect("sti three-stage", got, distance=steps_x_shards,
                   rank_sort=steps_x_shards,
                   sti_fill_acc_rect=steps_x_shards)
            entries["sti_fill_acc_rect"]["launches"] = got["sti_fill_acc_rect"]
        log(f"[7] {CONFIG.mode} sharded fill={fill} on {shards} shards of one "
            f"card n={n_full} t={t_full}: {sh_s:.3f} s total, resolved "
            f"fill={res.meta['fill']} distance={res.meta['distance']} "
            f"shards={res.meta['shards']}, launches {got}, peak device memory "
            f"{peak_gib:.2f} GiB ({base_gib:.2f} GiB held before, [4]'s phi "
            f"among it)")
        if tuple(res.phi.shape) != (n_full, n_full) or res.meta["shards"] != \
                shards:
            fail(f"[7] phi {tuple(res.phi.shape)}, shards {res.meta['shards']}")
        err = hold_sharded(f"sti fill={fill} phi vs [4]'s", res.phi, phi)
        # the off-diagonal entries add the same values in the same order
        # as [4]'s fill; the diagonal is a reduce-scatter of 4 partials
        offdiag_equal, rows_ = True, 4096
        for r0 in range(0, n_full, rows_):
            diff = res.phi[r0:r0 + rows_] - phi[r0:r0 + rows_]
            idx = torch.arange(diff.shape[0], device=dev)
            diff[idx, r0 + idx] = 0.0
            offdiag_equal = offdiag_equal and not bool(diff.any())
        diag_err = float((res.phi.diagonal() - phi.diagonal()).abs().max())
        log(f"[7] sti fill={fill}: off-diagonal bit-equal to [4]: "
            f"{offdiag_equal}; diagonal max_abs_err {diag_err:.3e}")
        sharded[fill] = dict(total_s=sh_s, peak_gib=peak_gib,
                             held_before_gib=base_gib, max_abs_err=err,
                             offdiag_bit_equal=offdiag_equal,
                             diag_max_abs_err=diag_err, launches=got)
        del res, diff
        torch.cuda.empty_cache()
    # where the off-diagonal bits can part: each shard ranks and scans
    # only its tb/D test rows, so a stage whose rounding depends on the
    # number of rows it is given differs from [4]'s whole-batch call
    part = tb // shards
    d2_all = distance_cuda(xb, xtr)
    u_all = (ytr[torch.sort(d2_all, dim=-1, stable=True).indices]
             == yb[:, None]).float() * (mask / k)[:, None]
    same_d2 = bool(torch.equal(distance_cuda(xb[:part], xtr), d2_all[:part]))
    same_g = bool(torch.equal(superdiagonal_g(u_all[:part], k),
                              superdiagonal_g(u_all, k)[:part]))
    log(f"[7] the first {part} rows alone vs within the {tb}-row batch: "
        f"distance_cuda bit-equal {same_d2}, superdiagonal_g (torch.cumsum) "
        f"bit-equal {same_g}")
    sharded["slice_bit_equal"] = {"distance": same_d2, "g": same_g}
    del d2_all, u_all
    want = stream_point_values("knn_shapley", x_train, y_train, x_test,
                               y_test, k, test_batch=tb, distance="cuda",
                               device=dev)
    for fill in ("auto", "megakernel"):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = ShardedValuationSession(
            x_train, y_train, k=k, mode="knn_shapley", test_batch=tb,
            fill=fill, distance="cuda", devices=devs)
        vals = sess.update(x_test, y_test).finalize().point_values
        torch.cuda.synchronize()
        pt_s = time.perf_counter() - t0
        got = read_counts()
        if fill == "megakernel":
            expect("knn_shapley fill=megakernel", got,
                   point_megakernel=steps_x_shards)
        else:
            expect("knn_shapley three-stage", got, distance=steps_x_shards,
                   rank_sort=steps_x_shards, point_update=steps_x_shards)
            entries["point_update"]["launches"] = got["point_update"]
        if vals.shape != (n_full,) or not bool(torch.isfinite(vals).all()):
            fail(f"[7] knn_shapley values: shape {tuple(vals.shape)} or "
                 f"non-finite")
        err = hold_sharded(f"knn_shapley sharded fill={fill} vs the "
                           f"single-device step ({pt_s:.3f} s, launches "
                           f"{got})", vals, want)
        sharded[f"knn_shapley_{fill}"] = dict(total_s=pt_s, max_abs_err=err,
                                              launches=got)
        entries["point_megakernel"]["launches"] += got["point_megakernel"]
        del sess, vals
    # step times: one full batch into a sharded session, CUDA events
    for fill in ("auto", "megakernel"):
        sess = ShardedValuationSession(x_train, y_train, k=k,
                                       mode=CONFIG.mode, test_batch=tb,
                                       fill=fill, devices=devs)
        sharded[fill]["step_ms"] = cuda_ms(
            torch, lambda: sess.update(xb, yb), reps=2)
        log(f"[7] sharded {CONFIG.mode} step fill={fill} ({shards} shards, "
            f"t={tb}, n={n_full}): {sharded[fill]['step_ms']:.2f} ms")
        del sess
        torch.cuda.empty_cache()

    # ------------------------ 9. the approx engine at full width ([4]'s data)
    def expect_counts(label, got, **want):
        full = {name: 0 for name in counted}
        full.update(want)
        if got != full:
            fail(f"{label} launched {got}, expected {full}")

    ctx = types.SimpleNamespace(
        k=k, tb=tb, n=n_full, d=d_full, n_steps=n_steps, x_train=x_train,
        y_train=y_train, x_test=x_test, y_test=y_test, xtr=xtr, ytr=ytr,
        phi=phi, exact_points=exact_points, zero_counts=zero_counts,
        read_counts=read_counts, expect=expect_counts,
        pad=lambda xs, ys: pad_test_batch(xs.to(dev).contiguous(),
                                          ys.to(dev), tb),
        mega_step_ms=entries["sti_megakernel"]["ms"], scale_n=1 << 20)
    t9 = time.perf_counter()
    approx = approx_phase(torch, dev, ctx)
    approx["phase_s"] = time.perf_counter() - t9
    log(f"[9] phase {approx['phase_s']:.1f} s")
    ctx.phi = None

    # step time at full width, reusing phi's buffer as the accumulator
    step, _, _ = prepare_stream_step(CONFIG.mode, n_full, d_full, k,
                                     test_batch=tb, device=dev)
    diag.zero_()
    step_ms = cuda_ms(torch, lambda: step((phi, diag), xb, yb, mask, xtr,
                                          ytr), reps=3)
    log(f"[4] fused step (t={tb}, n={n_full}, d={d_full}): {step_ms:.2f} ms "
        f"({n_steps} steps on the main path; {1e3 * total_s - n_steps * step_ms:.1f}"
        f" ms of the main path's wall time lies outside the steps)")
    # where a step's time goes: the stages of the fused step body
    # (kernels/sti_pipeline.py::step_head and the update), one CUDA event
    # between each
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    marks[0].record()
    d2 = distance_cuda(xb, xtr)
    marks[1].record()
    order, ranks = rank_order_cuda(d2)
    marks[2].record()
    u = (ytr[order] == yb[:, None]).float() * (mask / k)[:, None]
    g = superdiagonal_g(u, k, mode=CONFIG.mode)
    marks[3].record()
    sti_fill_acc_cuda(phi, g, ranks)
    marks[4].record()
    diag += torch.gather(u, 1, ranks).sum(0)
    marks[5].record()
    torch.cuda.synchronize()
    stages = ("distance", "sort+rank", "u+g", "fill", "diag")
    log("[4] step stages (ms): " + ", ".join(
        f"{nm} {marks[i].elapsed_time(marks[i + 1]):.3f}"
        for i, nm in enumerate(stages)))
    del result, phi, diag, step, d2, order, ranks, u, g, xtr, ytr, xb, yb, \
        mask
    torch.cuda.empty_cache()

    # ------------------ 8. flash attention and the LM serving path
    t8 = time.perf_counter()
    log(f"[8] device memory held before: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    serving = lm_phase(torch, np, dev, entries)
    serving["phase_s"] = time.perf_counter() - t8
    log(f"[8] phase {serving['phase_s']:.1f} s")

    # ------------------ 9f. the approx engine at n = 2^20; 10. the tuner
    t9 = time.perf_counter()
    approx_1m = approx_scale_phase(torch, dev, ctx)
    approx_1m["phase_s"] = time.perf_counter() - t9
    log(f"[9f] phase {approx_1m['phase_s']:.1f} s")
    ctx.step_ms = step_ms
    t10 = time.perf_counter()
    autotune = tuner_phase(torch, dev, ctx)
    autotune["phase_s"] = time.perf_counter() - t10
    log(f"[10] phase {autotune['phase_s']:.1f} s")
    shutil.rmtree(tune_dir, ignore_errors=True)

    # ------------- 11. the resilient session; 12. the online service
    # a fresh, empty tuning cache again: "auto" resolves from the heuristic
    # (the CUDA distance and fill), whatever [10] cached
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(tune_dir) / "autotune.json")
    ctx.extra = blob_points(np, 1024, d_full, seed=5)
    # [12c]'s correctness drill: n, t, test batch, capacity (n + 512)
    ctx.chaos = (4096, 64, 16, 4608)
    t11 = time.perf_counter()
    resilient = resilient_phase(torch, np, dev, ctx)
    resilient["phase_s"] = time.perf_counter() - t11
    log(f"[11] phase {resilient['phase_s']:.1f} s")
    t12 = time.perf_counter()
    service = service_phase(torch, np, dev, ctx)
    service["phase_s"] = time.perf_counter() - t12
    log(f"[12] phase {service['phase_s']:.1f} s")
    shutil.rmtree(tune_dir, ignore_errors=True)
    for name in ("distance", "rank_sort", "sti_fill_acc",
                 "sti_fill_acc_rect", "point_update"):
        entries[name]["resilient_service_launches"] = {
            "[11]": resilient["launches"][name],
            "[12a]": service["sti"]["launches"][name],
            "[12b]": service["knn_shapley"]["launches"][name],
            "[12c]": service["chaos"]["launches"][name]}
    log("[11]-[12] launches by path: " + ", ".join(
        f"{name} {entries[name]['resilient_service_launches']}"
        for name in ("distance", "rank_sort", "sti_fill_acc",
                     "sti_fill_acc_rect", "point_update")))
    for name, want in (("distance", "[12a]"), ("rank_sort", "[12a]"),
                       ("sti_fill_acc", "[12a]"),
                       ("sti_fill_acc_rect", "[12c]"),
                       ("point_update", "[12b]")):
        if not entries[name]["resilient_service_launches"][want]:
            fail(f"{name} was not launched on {want}'s path")

    # ------------- 13. the distributed engine; 14. the LM training path
    # the CPU sides of [14] and [15]-[20] in one child, started here so
    # that it computes while the card runs [13]-[14]; ended at exit too
    refs = CpuRefs(REF_CASES)
    atexit.register(refs.close)
    # earlier phases' objects caught in reference cycles would otherwise
    # be freed at some later collection, in the middle of a phase's peak
    gc.collect()
    log(f"[13] device memory held before: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t13 = time.perf_counter()
    distributed = distributed_phase(torch, np, dev, ctx)
    distributed["phase_s"] = time.perf_counter() - t13
    log(f"[13] phase {distributed['phase_s']:.1f} s")
    t14 = time.perf_counter()
    training = training_phase(torch, np, dev, ctx, refs)
    training["phase_s"] = time.perf_counter() - t14
    log(f"[14] phase {training['phase_s']:.1f} s")
    for name, entry in entries.items():
        entry["distributed_training_launches"] = {
            "[13]": sum(distributed[key]["launches"].get(name, 0)
                        for key in ("sti", "sii", "step_fn")),
            "[14]": sum(training[key]["launches"].get(name, 0)
                        for key in ("card_vs_cpu", "full", "restart"))}
    log("[13]-[14] launches by path: " + ", ".join(
        f"{name} {entry['distributed_training_launches']}"
        for name, entry in entries.items()))
    for name in ("distance", "rank_sort", "sti_fill_acc_rect"):
        if not entries[name]["distributed_training_launches"]["[13]"]:
            fail(f"{name} was not launched on [13]'s path")

    # ------------- 15-17. the MoE, xLSTM and hybrid families at full width
    gc.collect()
    log(f"[15] device memory held before: {device_gib(torch)}")
    t15 = time.perf_counter()
    families = families_phase(torch, np, dev, ctx, refs)
    families["phase_s"]["[15]-[17]"] = time.perf_counter() - t15
    log("[15]-[17] phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in families["phase_s"].items()))
    # ---------- 18-19. the audio and VLM families; 20. family training
    t18 = time.perf_counter()
    audio = audio_phase(torch, np, dev, refs)
    vlm = vlm_phase(torch, np, dev, refs)
    fam_training = family_training_phase(torch, np, dev, ctx, refs)
    fam_training["phase_s"]["[18]-[20]"] = time.perf_counter() - t18
    log("[18]-[20] phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in {**audio["phase_s"],
                                    **vlm["phase_s"],
                                    **fam_training["phase_s"]}.items()))
    # ---------- 21. the LM on a device grid of the card
    t21 = time.perf_counter()
    lm_grid = lm_grid_phase(torch, np, dev, ctx, refs)
    lm_grid["phase_s"]["[21]"] = time.perf_counter() - t21
    log("[21] phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in lm_grid["phase_s"].items()))
    refs.close()
    # ---------- 22. the tooling: lint, contracts, the meta dry run
    tooling = tooling_phase(torch, np, dev, ctx, smi)
    log("[22] phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in tooling["phase_s"].items()))
    for name, entry in entries.items():
        entry["tooling_launches"] = {"[22b]": tooling["launches"][name]}
    entries["flash_attention"]["tooling_launches"][
        "[22c] meta (abstract)"] = tooling["dryrun_qwen3"]["kernel_calls"].get(
            "flash_attention", 0)
    entries["flash_attention"]["lm_grid_launches"] = {
        "[21b] prefill": lm_grid["qwen3_serve"]["prefill_launches"][
            "flash_attention"]}
    entries["flash_attention"]["families_launches"] = {
        "[15a]": families["moe_card_vs_cpu"]["launches"]["flash_attention"],
        "[15c]": families["mixtral"]["flash_launches"],
        "[15d]": families["phi35_moe"]["flash_launches"],
        "[16a]": families["xlstm_card_vs_cpu"]["flash_launches"],
        "[16b]": families["xlstm"]["flash_launches"],
        "[17b]": families["jamba"]["flash_launches"]}
    log(f"[15]-[17] flash_attention launches by path: "
        f"{entries['flash_attention']['families_launches']}")
    entries["flash_attention"]["audio_vlm_launches"] = {
        "[18a]": audio["card_vs_cpu"]["flash_launches"],
        "[18c]": audio["serve"]["flash_launches"],
        "[19a]": vlm["card_vs_cpu"]["flash_launches"],
        "[19b]": vlm["serve"]["flash_launches"],
        "[19b] Engine": vlm["engine"]["flash_launches"],
        "[20]": sum(r["launches"]["flash_attention"]
                    for part in ("card_vs_cpu", "full", "restart")
                    for r in fam_training[part].values())}
    entries["flash_attention"]["whisper_shapes"] = audio["flash"]
    log(f"[18]-[20] flash_attention launches by path: "
        f"{entries['flash_attention']['audio_vlm_launches']}")
    # ---------- 23. the last entry points: valuate's flags, ops, examples
    gc.collect()
    log(f"[23] device memory held before: {device_gib(torch)}")
    entry_points = entry_points_phase(torch, np, dev, ctx, smi)
    log("[23] phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in entry_points["phase_s"].items()))
    for name, entry in entries.items():
        by_path = {label: counts[name]
                   for label, counts in entry_points["launches"].items()
                   if counts.get(name)}
        if by_path:
            entry["entry_point_launches"] = by_path
    log("[23] launches by path: " + ", ".join(
        f"{name} {entry['entry_point_launches']}"
        for name, entry in entries.items()
        if "entry_point_launches" in entry))
    # ---------- 24. the rank stage's kernel at the cells' shapes
    gc.collect()
    rank_sort = rank_sort_phase(torch, dev, smi)
    entries["rank_sort"].update(rank_sort)
    # ---------- 25. Mamba's fused scan at the Jamba cell's shapes
    gc.collect()
    log(f"[25] device memory held before: {device_gib(torch)}")
    entries["selective_scan"].update(selective_scan_phase(torch, dev, smi))
    # ---------- 26. the knn point update's kernel at the cells' shapes
    gc.collect()
    entries["point_update"].update(point_update_phase(torch, dev, smi))
    log(f"whole smoke run {time.perf_counter() - t_start:.1f} s")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")

    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{**{key: e[key] for key in keys},
                                   **({"resilient_service_launches":
                                       e["resilient_service_launches"]}
                                      if "resilient_service_launches" in e
                                      else {}),
                                   **{key: e[key] for key in (
                                       "families_launches",
                                       "audio_vlm_launches",
                                       "lm_grid_launches",
                                       "tooling_launches",
                                       "entry_point_launches",
                                       "whisper_shapes", "shapes")
                                      if key in e},
                                   "distributed_training_launches":
                                       e["distributed_training_launches"]}
                                  for e in entries.values()],
                      "step_ms": step_ms, "total_s": total_s,
                      "megakernel_total_s": mega_s,
                      "distance_bf16": distance_bf16,
                      "rank_phase": {"ms": rank_ms,
                                     "distance_and_torch_sort_ms": sort_ms,
                                     "sort_floor_ms": floor_ms,
                                     "rows_by_passes": by_passes,
                                     "megakernel_ptxas": mk_use,
                                     "shape": f"t={tb} n={n_full} "
                                              f"d={d_full}"},
                      "main_path_peak_gib": main_peak_gib,
                      "fill_tile": fill_tile_report,
                      "phi_symmetric": symmetric,
                      "sharded": sharded,
                      "serving": serving,
                      "approx": approx,
                      "approx_1m": approx_1m,
                      "autotune": autotune,
                      "resilient": resilient,
                      "service": service,
                      "distributed": distributed,
                      "training": training,
                      "families": families,
                      "audio": audio,
                      "vlm": vlm,
                      "family_training": fam_training,
                      "lm_grid": lm_grid,
                      "tooling": tooling,
                      "entry_points": entry_points,
                      "power": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--cpu-ref":
        cpu_ref_main(sys.argv[2], sys.argv[3])
    else:
        main()
