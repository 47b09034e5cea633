#!/usr/bin/env python3
"""Design probe of the STI-KNN fill tile (`src/repro_torch/csrc/fill_tile.cuh`)
on one NVIDIA card.

    python3 fill_variants.py                      # the design steps, timed
    python3 fill_variants.py --peak SRC [SRC ...]  # [4]'s peak memory per tree

Run from the root of a checkout. The first form builds the fill's two
sources (`sti_fill.cu`, `sti_megakernel.cu`) as they stand and as variants
that each take one step of the tile's design back (a text patch on a copy
of `csrc/`), swaps each in under the port's wrappers, holds it bit-equal to
the shipped kernel, and times it in turns (every variant, then every
variant in reverse order) on the square fill at (t, n) = (256, 65536), the
last (16384, 65536) row block of D = 4 and the sti megakernel step at d =
768, beside the square computed without the mirror (the rect entry on an
independent copy of the row table walks all (n/128)^2 tiles). It prints
each build's registers and spills and its per-test-point loop's SASS, and
the card's name, power limit and SM clock.

The second form runs `chip_smoke.py`'s [4] call (the paper configuration,
t = 384) once per source tree, each in a process of its own, and prints
its peak device memory: `SRC` is the `src` directory of a checkout, such
as one of the parent commit unpacked with `git archive`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ADD_BY_RANK = """  asm("{\\n"
      " .reg .pred p;\\n"
      " setp.ge.s32 p, %1, %2;\\n"
      " @p add.rn.f32 %0, %0, %3;\\n"
      " @!p add.rn.f32 %0, %0, %4;\\n"
      "}\\n"
      : "+f"(a)
      : "r"(ra), "r"(rb), "f"(ga), "f"(gb));"""
UNROLLED = """    if (np == PCHUNK) {  // a full stage, unrolled: loads run ahead of use
#pragma unroll
      for (int pp = 0; pp < PCHUNK; ++pp) add_point(a, s, st, pp, tx, ty);
    } else {
      for (int pp = 0; pp < np; ++pp) add_point(a, s, st, pp, tx, ty);
    }"""
COPY_BODY = """  const int c = threadIdx.x % TILE, pp0 = threadIdx.x / TILE;
  const bool rok = row0 + c < rows.count, cok = col0 + c < cols.count;
  const int2* r =
      rows.pk + (rok ? (size_t)(p0 + pp0) * rows.ld + row0 + c : 0);
  const int2* q =
      cols.pk + (cok ? (size_t)(p0 + pp0) * cols.ld + col0 + c : 0);
  const size_t rstep = rok ? 2 * (size_t)rows.ld : 0;
  const size_t cstep = cok ? 2 * (size_t)cols.ld : 0;
  uint32_t dr = sm90::smem_u32(&s.stage[st].rows[pp0][c]);
  uint32_t dc = sm90::smem_u32(&s.stage[st].cols[pp0][c]);
#pragma unroll
  for (int k = 0; k < PCHUNK / 2; ++k) {
    if (pp0 + 2 * k < np) {
      sm90::cp_async8(dr, r, rok ? 8u : 0u);
      sm90::cp_async8(dc, q, cok ? 8u : 0u);
    }
    r += rstep;
    q += cstep;
    dr += 2 * TILE * sizeof(int2);
    dc += 2 * TILE * sizeof(int2);
  }"""
FLAT_COPY = """  for (int e = threadIdx.x; e < np * TILE; e += THREADS) {
    const int pp = e / TILE, c = e % TILE;
    const bool rok = row0 + c < rows.count, cok = col0 + c < cols.count;
    sm90::cp_async8(sm90::smem_u32(&s.stage[st].rows[pp][c]),
                    rok ? rows.pk + (size_t)(p0 + pp) * rows.ld + row0 + c
                        : rows.pk, rok ? 8u : 0u);
    sm90::cp_async8(sm90::smem_u32(&s.stage[st].cols[pp][c]),
                    cok ? cols.pk + (size_t)(p0 + pp) * cols.ld + col0 + c
                        : cols.pk, cok ? 8u : 0u);
  }"""
PACK_RANK = "pk[i] = make_int2((int)rk, "
TWO_BLOCKS = "__launch_bounds__(THREADS, 2)"

# each variant: [(file, shipped text, replacement)], and whether the
# megakernel takes it too
VARIANTS = {
    "shipped": ([], True),
    # compare, select and add: two of the three on the ALU pipe
    "select": ([("fill_tile.cuh", ADD_BY_RANK,
                 "  a += ra >= rb ? ga : gb;")], True),
    # ranks as floats, the 0/1 saturated differences as FMA weights
    "fma_weights": ([
        ("fill_tile.cuh", ADD_BY_RANK,
         "  const float fa = __int_as_float(ra), fb = __int_as_float(rb);\n"
         "  a = __fmaf_rn(__saturatef(fa + 1.f - fb), ga, a);\n"
         "  a = __fmaf_rn(__saturatef(fb - fa), gb, a);"),
        ("sti_fill.cu", PACK_RANK,
         "pk[i] = make_int2(__float_as_int((float)rk), ")], False),
    # the test-point loop rolled in every stage
    "rolled": ([("fill_tile.cuh", UNROLLED,
                 "    for (int pp = 0; pp < np; ++pp)"
                 " add_point(a, s, st, pp, tx, ty);")], True),
    # no minimum of two blocks per SM for the standalone kernel
    "no_two_block_bound": ([("sti_fill.cu", TWO_BLOCKS,
                             "__launch_bounds__(THREADS)")], False),
    # each copy's address worked out from a flat entry index
    "flat_copy_index": ([("fill_tile.cuh", COPY_BODY, FLAT_COPY)], True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build_variants(tmp: Path, build, smoke) -> dict:
    """{(variant, source): loaded library}, every build in parallel."""
    procs = {}
    for name, (patches, mega) in VARIANTS.items():
        d = tmp / name
        shutil.copytree(build.CSRC, d)
        for fname, old, new in patches:
            text = (d / fname).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {fname} no longer holds the "
                                   f"text this variant patches")
            (d / fname).write_text(text.replace(old, new))
        for src in ("sti_fill", "sti_megakernel") if mega else ("sti_fill",):
            lib = d / f"lib{src}.so"
            procs[name, src] = (lib, subprocess.Popen(
                [build._nvcc(), *build._FLAGS, "-o", str(lib),
                 str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    libs = {}
    for (name, src), (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {src}:\n{out}")
        kernel = "fill_acc_kernel" if src == "sti_fill" else "10megakernelE"
        usage = [u for fn, u in smoke.ptxas_usage(out).items()
                 if kernel in fn]
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        body = next((part for part in sass.split("Function : ")[1:]
                     if kernel in part.partition("\n")[0]), "")
        for marker in ("FADD", "FFMA"):
            loop = smoke.sass_loop(body, marker, 64)
            if loop:
                break
        log(f"[build] {name} {src}: {usage}; per-point loop "
            f"{sum(loop.values())} instructions for 64 updates a thread: "
            f"{dict(sorted(loop.items(), key=lambda kv: -kv[1]))}")
        libs[name, src] = ctypes.CDLL(str(lib))
    return libs


def in_turns(torch, smoke, names, use, fn, reps) -> dict:
    """{name: [ms, ms]}: every variant timed, then every one in reverse."""
    times = {nm: [] for nm in names}
    for order in (names, names[::-1]):
        for nm in order:
            use(nm)
            times[nm].append(smoke.cuda_ms(torch, fn, reps=reps))
    return times


def design_steps() -> None:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import sti_fill as fill
    from repro_torch.kernels import sti_megakernel as mega

    if not torch.cuda.is_available():
        sys.exit("fill_variants.py: needs a CUDA card")
    dev = torch.device("cuda", 0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), build, smoke)
        shipped_f, shipped_m = fill.library, mega.library

        def use(name):
            fill.library = lambda _: libs[name, "sti_fill"]
            mega.library = lambda _: libs.get((name, "sti_megakernel"),
                                              shipped_m("sti_megakernel"))

        try:
            measure(torch, smoke, fill, mega, libs, use, dev)
        finally:
            fill.library, mega.library = shipped_f, shipped_m


def rows_equal(torch, a, b) -> bool:
    return all(bool(torch.equal(a[r:r + 4096], b[r:r + 4096]))
               for r in range(0, a.shape[0], 4096))


def measure(torch, smoke, fill, mega, libs, use, dev) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t, n, d = 256, 65536, 768
    g = torch.randn((t, n), generator=gen, device=dev)
    ranks = torch.argsort(torch.rand((t, n), generator=gen, device=dev),
                          dim=1)
    names = [nm for nm, src in libs if src == "sti_fill"]
    ref = torch.zeros((n, n), device=dev)
    use("shipped")
    fill.sti_fill_acc_cuda(ref, g, ranks)
    acc = torch.zeros((n, n), device=dev)
    for nm in names:
        acc.zero_()
        use(nm)
        fill.sti_fill_acc_cuda(acc, g, ranks)
        torch.cuda.synchronize()
        log(f"[square] {nm}: bit-equal to shipped "
            f"{rows_equal(torch, acc, ref)}")
    del ref
    square, clocks = smoke.with_clocks(lambda: in_turns(
        torch, smoke, names, use,
        lambda: fill.sti_fill_acc_cuda(acc, g, ranks), reps=3))
    use("shipped")
    copy = ranks.clone()
    all_tiles = [smoke.cuda_ms(torch, lambda: fill.sti_fill_acc_rect_cuda(
        acc, g, copy, ranks), reps=3) for _ in range(2)]
    log(f"[square] (t={t}, n={n}), ms in turns (SM clock "
        f"{clocks['sm_mhz']} MHz, {clocks['power_w']} W):")
    for nm, ms in square.items():
        log(f"    {nm}: {ms}")
    log(f"    shipped without the mirror (all {(n // 128) ** 2} tiles, the "
        f"rect entry on a copied row table): {all_tiles}")
    del acc, copy
    torch.cuda.empty_cache()
    nl = n // 4
    rows = fill.rect_row_view(ranks, 3 * nl, nl)
    block = torch.zeros((nl, n), device=dev)
    rect = in_turns(torch, smoke, names, use,
                    lambda: fill.sti_fill_acc_rect_cuda(block, g, rows,
                                                        ranks), reps=3)
    log(f"[rect] ({nl} rows at {3 * nl}, {n}), ms in turns:")
    for nm, ms in rect.items():
        log(f"    {nm}: {ms}")
    del block, g, ranks
    torch.cuda.empty_cache()
    xb = torch.randint(-8, 9, (t, d), generator=gen, device=dev).float()
    xs = torch.randint(-8, 9, (n, d), generator=gen, device=dev).float()
    yb = torch.randint(0, 3, (t,), generator=gen, device=dev)
    ys = torch.randint(0, 3, (n,), generator=gen, device=dev)
    mask = torch.ones((t,), device=dev)
    acc, diag = torch.zeros((n, n), device=dev), torch.zeros((n,), device=dev)
    mk_names = [nm for nm in names if (nm, "sti_megakernel") in libs]
    ref = torch.zeros((n, n), device=dev)
    use("shipped")
    mega.sti_megakernel_cuda(ref, diag, xb, yb, mask, xs, ys, k=5)
    for nm in mk_names:
        acc.zero_()
        use(nm)
        mega.sti_megakernel_cuda(acc, diag, xb, yb, mask, xs, ys, k=5)
        torch.cuda.synchronize()
        log(f"[megakernel] {nm}: bit-equal to shipped "
            f"{rows_equal(torch, acc, ref)}")
    del ref
    step = in_turns(torch, smoke, mk_names, use,
                    lambda: mega.sti_megakernel_cuda(acc, diag, xb, yb, mask,
                                                     xs, ys, k=5), reps=2)
    log(f"[megakernel] sti step (t={t}, n={n}, d={d}), ms in turns:")
    for nm, ms in step.items():
        log(f"    {nm}: {ms}")


def peak(src: str) -> None:
    """[4]'s call of chip_smoke.py on the package under `src`."""
    sys.path.insert(0, str(Path(src).resolve()))
    import numpy as np
    import torch
    from repro_torch import get_method
    from repro_torch.configs.sti_knn_paper import CONFIG
    from repro_torch.data import flip_labels, make_gaussian_blobs
    from repro_torch.kernels import build

    build.build_all()
    dev = torch.device("cuda", 0)
    n, t = CONFIG.n_train, 384
    x_all, y_all = make_gaussian_blobs((n + t) // 2, num_classes=2,
                                       dim=CONFIG.feat_dim, seed=0)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n + t))
    x_train, y_train = x_all[perm[:n]], y_all[perm[:n]]
    y_train, _ = flip_labels(y_train, 0.1, 2, seed=1)
    torch.cuda.reset_peak_memory_stats()
    get_method(CONFIG.mode)(x_train, y_train, x_all[perm[n:]],
                            y_all[perm[n:]], k=CONFIG.k, engine="fused",
                            test_batch=256, device=dev)
    torch.cuda.synchronize()
    log(f"[peak] {src}: {torch.cuda.max_memory_allocated() / 2**30:.4f} GiB")


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--peak-of"]:
        peak(args[1])
    elif args[:1] == ["--peak"]:
        for src in args[1:]:
            subprocess.run([sys.executable, __file__, "--peak-of", src],
                           check=True, env=dict(os.environ))
    else:
        design_steps()


if __name__ == "__main__":
    main()
