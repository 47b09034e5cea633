#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
`src/repro_torch/csrc/`, holds each kernel against its plain PyTorch
version on the card, checks sti/sii against the O(2^n) oracle through the
kernels, and drives the main path -- `get_method("sti")` on the fused
engine -- at the full width of the paper configuration
(`configs/sti_knn_paper.py`: n = 65536, d = 768, k = 5) with t = 384 test
points (one full batch of 256 and one ragged batch padded to 256). Every
phase fails the run with a non-zero exit. It imports nothing of JAX or of
the JAX package. The line before the last is one JSON object describing
each kernel (launches on the main path, error against the plain version,
kernel / plain / bound / library times); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (NVIDIA), dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # FMA counted as two operations
SIMPLE_OPS_PER_S = F32_FLOP_PER_S / 2  # one f32/int instruction per lane


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


def distance_bound_ms(t, n, d, elt) -> tuple[float, str]:
    nbytes = (t * d + n * d) * elt + t * n * 4
    ops = 2.0 * t * n * d
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes > by_ops else \
        "operations"


def fill_bound_ms(t, n) -> tuple[float, str]:
    # acc read and written once, g and ranks read once. The increment is
    # symmetric, so the function needs only the n(n+1)/2 pairs on and above
    # the diagonal -- per test point one compare, one select and one add
    # each -- and one add per element to mirror them into the other half
    # (the kernel itself computes all n^2 pairs)
    nbytes = 2 * n * n * 4 + 2 * t * n * 4
    ops = 3.0 * t * n * (n + 1) / 2 + float(n) * n
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / SIMPLE_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes > by_ops else \
        "operations"


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    import numpy as np

    from repro_torch import get_method
    from repro_torch.configs.sti_knn_paper import CONFIG
    from repro_torch.core.sti_baseline import brute_force_sii, brute_force_sti
    from repro_torch.core.sti_knn import (
        ranks_from_distances, ranks_from_order, superdiagonal_g)
    from repro_torch.data import flip_labels, make_gaussian_blobs
    from repro_torch.kernels import build
    from repro_torch.kernels.distance import distance_cuda, distance_plain
    from repro_torch.kernels.sti_fill import (
        sti_fill_acc_cuda, sti_fill_acc_plain, sti_fill_cuda, sti_fill_plain)
    from repro_torch.kernels.sti_pipeline import (
        pad_test_batch, prepare_fused_step)

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
            if "registers" in ln or "spill" in ln:
                log(f"    {name}: {ln.strip()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # ------------------------------------- 2. kernels vs plain on the card
    n_full, d_full, k = CONFIG.n_train, CONFIG.feat_dim, CONFIG.k
    tb = 256
    entries = {}

    def check_distance(t, n, d, dtype, rel_tol):
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
    dist_ms = cuda_ms(torch, lambda: distance_cuda(xt, xn), reps=20)
    dist_plain_ms = cuda_ms(torch, lambda: distance_plain(xt, xn), reps=20)
    cdist_ms = cuda_ms(torch, lambda: torch.cdist(xt, xn), reps=20)
    bound, by = distance_bound_ms(tb, n_full, d_full, 4)
    entries["distance"] = dict(
        name="distance", route="cuda", source="src/repro_torch/csrc/distance.cu",
        replaces="src/repro/kernels/distance.py:73", max_abs_err=derr,
        ms=dist_ms, plain_ms=dist_plain_ms, bound_ms=bound, bound_by=by,
        library_ms=cdist_ms, shape=f"t={tb} n={n_full} d={d_full} f32",
    )
    log(f"[2] distance ({tb}, {n_full}, {d_full}) f32: kernel "
        f"{dist_ms:.3f} ms, plain {dist_plain_ms:.3f} ms, torch.cdist "
        f"{cdist_ms:.3f} ms, bound {bound:.3f} ms ({by})")
    del xt, xn, xi, xni, di, dp

    def fill_inputs(t, n):
        g = torch.randn((t, n), generator=gen, device=dev)
        ranks = torch.argsort(torch.rand((t, n), generator=gen, device=dev),
                              dim=1)
        return g, ranks

    # The kernel adds the test points to each element in the plain
    # version's order (p = 0, 1, ...), so the two should agree to the bit;
    # the tolerance, 1e-6 of the largest |value| as for the JAX fills,
    # would admit only rounding.
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
                f"(max |ref| {scale:.1f})")
            if not err <= fill_tol * scale:
                fail(f"fill {label} kernel disagrees with plain at n={n}: "
                     f"{err} > {fill_tol} * {scale}")
        del g, ranks, acc0, got, want, got0, want0

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
    log(f"[2] fill acc (t={tb}, n={n_full}): max_abs_err {ferr:.3e} "
        f"(max |ref| {fscale:.1f}); plain {fill_plain_ms:.1f} ms")
    if not ferr <= fill_tol * fscale:
        fail(f"fill kernel disagrees with plain at n={n_full}: {ferr}")
    del acc_p
    torch.cuda.empty_cache()
    fill_ms = cuda_ms(torch, lambda: sti_fill_acc_cuda(acc_k, g, ranks),
                      reps=5)
    bound, by = fill_bound_ms(tb, n_full)
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
    torch.cuda.synchronize()
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
                "sti_fill_acc": sti_fill_acc_cuda.launches}
    log(f"[4] {CONFIG.mode} fused n={n_full} d={d_full} k={k} t={t_full} "
        f"(test_batch {tb}): {total_s:.3f} s total, resolved "
        f"fill={result.meta['fill']} distance={result.meta['distance']}, "
        f"launches {launches}, peak device memory {main_peak_gib:.2f} GiB")
    n_steps = -(-t_full // tb)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")
        entries[name]["launches"] = count
    if launches != {"distance": n_steps, "sti_fill_acc": n_steps}:
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
        for p in range(tb):
            acc_rows += torch.where(rr[p, :, None] >= ranks[p, None, :],
                                    gr[p, :, None], gt[p, None, :])
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

    # step time at full width, reusing phi's buffer as the accumulator
    step, _ = prepare_fused_step(n_full, d_full, k, mode=CONFIG.mode,
                                 test_batch=tb, device=dev)
    xb, yb, mask = pad_test_batch(x_test[:tb].to(dev), y_test[:tb].to(dev),
                                  tb)
    diag.zero_()
    step_ms = cuda_ms(torch, lambda: step(phi, diag, xb, yb, mask, xtr, ytr),
                      reps=3)
    log(f"[4] fused step (t={tb}, n={n_full}, d={d_full}): {step_ms:.2f} ms "
        f"({n_steps} steps on the main path; {1e3 * total_s - n_steps * step_ms:.1f}"
        f" ms of the main path's wall time lies outside the steps)")
    # where a step's time goes: the stages of the fused step body
    # (kernels/sti_pipeline.py::_stream_body), one CUDA event between each
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    marks[0].record()
    d2 = distance_cuda(xb, xtr)
    marks[1].record()
    order = torch.sort(d2, dim=-1, stable=True).indices
    ranks = ranks_from_order(order)
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
    log(f"[4] whole smoke run {time.perf_counter() - t_start:.1f} s")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")

    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{key: e[key] for key in keys}
                                  for e in entries.values()],
                      "step_ms": step_ms, "total_s": total_s,
                      "main_path_peak_gib": main_peak_gib,
                      "power": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
