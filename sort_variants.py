#!/usr/bin/env python3
"""Design probe of the megakernel's rank and table phases (`radix_pass`,
`radix_sort_row` and `tables_row` in `src/repro_torch/csrc/sti_megakernel.cu`)
on one NVIDIA card.

    python3 sort_variants.py

Run from the root of a checkout. It builds `sti_megakernel.cu` as it stands
and as variants that each take one step of the design back (a text patch on
a copy of `csrc/`), swaps each in under the port's wrappers, holds each
one's sorted stream and knn_shapley step bit-equal to the shipped kernel's,
and times the rank phase and the knn_shapley step in turns (every variant,
then every variant in reverse order) at (t, n, d) = (256, 65536, 768) on the
paper configuration's data, the rows `chip_smoke.py` [5] sorts. A further
build, "sections", reads clock64 in one thread of each block at the seams
of the sort's tile steps and of the knn_shapley table phase and prints the
cycles a row spends in each. It prints each build's registers and spills,
the passes the rows took, and the card's name, power limit and SM clock.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = "sti_megakernel.cu"

MATCH_BATCHED = """#pragma unroll
    for (int i0 = 0; i0 < KPT; i0 += BATCH) {  // match BATCH rounds at once
#pragma unroll
      for (int r = 0; r < BATCH; ++r)
        if (dig[i0 + r] != NO_DIGIT)
          atomicOr(&s.match[r][warp][dig[i0 + r]], 1u << lane);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < BATCH; ++r)
        peers[i0 + r] =
            dig[i0 + r] != NO_DIGIT ? s.match[r][warp][dig[i0 + r]] : 0u;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < BATCH; ++r)  // the lowest lane clears the word
        if (dig[i0 + r] != NO_DIGIT && lane == __ffs(peers[i0 + r]) - 1)
          s.match[r][warp][dig[i0 + r]] = 0u;
      __syncwarp();
    }"""
MATCH_ANY = """#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const unsigned int pm = __match_any_sync(0xffffffffu, dig[i]);
      peers[i] = dig[i] != NO_DIGIT ? pm : 0u;
    }"""
MATCH_BALLOT = """#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      unsigned int pm = __ballot_sync(0xffffffffu, dig[i] != NO_DIGIT);
#pragma unroll
      for (int bit = 0; bit < RADIX_BITS; ++bit) {
        const bool on = (dig[i] >> bit) & 1u;
        const unsigned int m = __ballot_sync(0xffffffffu, on);
        pm &= on ? m : ~m;
      }
      peers[i] = dig[i] != NO_DIGIT ? pm : 0u;
    }"""
STAGE_AHEAD = "    if (t + 1 < tiles) stage(t + 1);\n"
TILE_END = """#pragma unroll
      for (int w = 0; w < WARPS; ++w) s.cnt[w][tid] = 0u;
    }
  }
}"""

# each variant: [(shipped text, replacement)]
VARIANTS = {
    "shipped": [],
    # one __match_any_sync a round instead of batched atomicOr match words
    "match_any": [(MATCH_BATCHED, MATCH_ANY)],
    # eight ballots a round (one a digit bit)
    "ballot_match": [(MATCH_BATCHED, MATCH_BALLOT)],
    # keys as they are: no subtraction of the row minimum before the digits
    "raw_keys": [("  const uint32_t span = hi - lo;",
                  "  lo = 0u;\n  const uint32_t span = hi - lo;")],
    # tiles of 2048 keys (8 a thread)
    "tile_2048": [("constexpr int KPT = 16; ", "constexpr int KPT = 8; ")],
    # 4 rounds matched at once
    "batch_4": [("constexpr int BATCH = 8; ", "constexpr int BATCH = 4; ")],
    # the next tile staged after this one is written out, not before
    "no_prefetch": [(STAGE_AHEAD, ""),
                    (TILE_END, TILE_END.replace(
                        "    }\n  }\n}", "    }\n" + STAGE_AHEAD + "  }\n}"))],
    # labels gathered from ytr a position, not from the row's bitmask
    "label_gather": [("constexpr int MATCH_BITS = 1 << 18;",
                      "constexpr int MATCH_BITS = 0;")],
    # the step coefficients divided out a position in every row
    "coef_divisions": [("      const float c = s.coef[b][hc + j];",
                        "      const float c = step_coef(kind, j, k);")],
}

SECTIONS = ["stage", "load", "match", "count", "column", "scatter",
            "write-out", "min/max", "histogram", "t:stage", "t:u",
            "t:scan", "t:carry", "t:out", "t:bits"]
PROBE = """
__device__ unsigned long long g_sections[32];
#define MARK_INIT() unsigned long long marks_[32] = {}; \\
  long long last_ = clock64();
#define MARK(k) { const long long now_ = clock64(); \\
  marks_[k] += now_ - last_; last_ = now_; }
#define MARK_FLUSH(a, b) if (threadIdx.x == 0) \\
  for (int k_ = a; k_ < b; ++k_) atomicAdd(&g_sections[k_], marks_[k_]);
extern "C" int read_sections(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_sections, sizeof(g_sections));
}
extern "C" int zero_sections() {
  unsigned long long z[32] = {};
  return cudaMemcpyToSymbol(g_sections, z, sizeof(z));
}
namespace {
"""
SECTION_MARKS = [
    ("namespace {\n", PROBE),
    ("  const int tiles = (n + TILE - 1) / TILE;\n",
     "  const int tiles = (n + TILE - 1) / TILE;\n  MARK_INIT();\n"),
    (STAGE_AHEAD, STAGE_AHEAD + "    MARK(0);\n"),
    (MATCH_BATCHED, "    MARK(1);\n" + MATCH_BATCHED + "\n    MARK(2);"),
    ("    {  // thread b = digit b", "    MARK(3);\n    {  // thread b = digit b"),
    ("    {  // reorder the tile in place, by digit",
     "    MARK(4);\n    {  // reorder the tile in place, by digit"),
    ("    {  // each digit's run in order, coalesced",
     "    MARK(5);\n    {  // each digit's run in order, coalesced"),
    (TILE_END, TILE_END.replace("    }\n  }\n}",
                                "    }\n    MARK(6);\n  }\n  MARK_FLUSH(0, 7)\n}")),
    ("  uint32_t lo = 0xffffffffu, hi = 0u;\n",
     "  MARK_INIT();\n  uint32_t lo = 0xffffffffu, hi = 0u;\n"),
    ("  const uint32_t span = hi - lo;", "  MARK(7);\n  const uint32_t span = hi - lo;"),
    ("  unsigned int todo = 0u;", "  MARK(8);\n  MARK_FLUSH(7, 9)\n  unsigned int todo = 0u;"),
    ("  const bool weighted = kind == WKNN_RBF || kind == WKNN_INVERSE;\n",
     "  const bool weighted = kind == WKNN_RBF || kind == WKNN_INVERSE;\n"
     "  MARK_INIT();\n"),
    ("  auto matches = [&](int i) -> bool {",
     "  MARK(14);\n  auto matches = [&](int i) -> bool {"),
    ("    if (c_hi - TILE >= 0) stage(c_hi - TILE, b ^ 1);\n",
     "    if (c_hi - TILE >= 0) stage(c_hi - TILE, b ^ 1);\n    MARK(9);\n"),
    ("    // the step term at position j: su(j) is u at position j",
     "    MARK(10);\n    // the step term at position j: su(j) is u at position j"),
    ("    if (warp == 0) {  // each chunk's later-warp sums and total",
     "    MARK(11);\n    if (warp == 0) {  // each chunk's later-warp sums and total"),
    ("    // the tile's carry-out:", "    MARK(13);\n    // the tile's carry-out:"),
    ("#pragma unroll\n    for (int q = 0; q < CHUNKS; ++q) {\n      if (q >= nq) break;\n"
     "      const int j = c_hi - q * THREADS + tid;\n      const float cq",
     "    MARK(12);\n#pragma unroll\n    for (int q = 0; q < CHUNKS; ++q) {\n"
     "      if (q >= nq) break;\n      const int j = c_hi - q * THREADS + tid;\n"
     "      const float cq"),
    ("                      __fadd_rn(s.warp[nq - 1][0], s.later[nq - 1][0]));\n  }\n}",
     "                      __fadd_rn(s.warp[nq - 1][0], s.later[nq - 1][0]));\n"
     "  }\n  MARK_FLUSH(9, 15)\n}"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def build_variants(tmp: Path, build, smoke) -> dict:
    """{variant: loaded library}, every build in parallel."""
    procs = {}
    for name, patches in [*VARIANTS.items(), ("sections", SECTION_MARKS)]:
        d = tmp / name
        shutil.copytree(build.CSRC, d)
        text = (d / SRC).read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {SRC} no longer holds the text "
                                   f"this variant patches: {old[:60]!r}")
            text = text.replace(old, new, 1)
        (d / SRC).write_text(text)
        lib = d / "libsti_megakernel.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build._FLAGS, "-o", str(lib), str(d / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        usage = [u for fn, u in smoke.ptxas_usage(out).items()
                 if "10megakernelE" in fn]
        log(f"[build] {name}: {usage}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke
    from repro_torch.configs.sti_knn_paper import CONFIG
    from repro_torch.data import make_gaussian_blobs
    from repro_torch.kernels import build
    from repro_torch.kernels import sti_megakernel as mega

    if not torch.cuda.is_available():
        sys.exit("sort_variants.py: needs a CUDA card")
    dev = torch.device("cuda", 0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    build.build_all()
    # the paper configuration's data, as chip_smoke.py [4]-[5] draw it
    t, n, d = 256, CONFIG.n_train, CONFIG.feat_dim
    x_all, y_all = make_gaussian_blobs((n + 384) // 2, num_classes=2, dim=d,
                                       seed=0)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n + 384))
    xs, ys = x_all[perm[:n]].to(dev), y_all[perm[:n]].to(dev)
    xb, yb = x_all[perm[n:n + t]].to(dev), y_all[perm[n:n + t]].to(dev)
    mask = torch.ones((t,), device=dev)
    vec = torch.zeros((n,), device=dev)
    rank = lambda: mega.megakernel_rank_phase_cuda(xb, xs, with_passes=True)
    step = lambda: mega.point_megakernel_cuda(
        vec.zero_(), xb, yb, mask, xs, ys, method="knn_shapley", k=CONFIG.k)
    shipped = mega.library
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), build, smoke)
        try:
            mega.library = lambda _: libs["shipped"]
            want_rank = rank()
            want_step = step().clone()
            torch.cuda.synchronize()
            passes = want_rank[2].tolist()
            log(f"[rows] radix passes taken: "
                f"{ {p: passes.count(p) for p in sorted(set(passes))} }")
            names = list(VARIANTS)
            for name in [*names, "sections"]:
                mega.library = lambda _, lib=libs[name]: lib
                got_rank, got_step = rank(), step()
                torch.cuda.synchronize()
                same = all(bool(torch.equal(a, b))
                           for a, b in zip(got_rank[:2], want_rank[:2]))
                log(f"[check] {name}: sorted stream bit-equal {same}, "
                    f"knn_shapley step bit-equal "
                    f"{bool(torch.equal(got_step, want_step))}")
            sections(torch, libs["sections"], mega, rank, step, t)

            def timed(fn):
                times = {nm: [] for nm in names}
                for order in (names, names[::-1]):
                    for nm in order:
                        mega.library = lambda _, lib=libs[nm]: lib
                        times[nm].append(smoke.cuda_ms(torch, fn, reps=5))
                return times

            (rank_ms, step_ms), clocks = smoke.with_clocks(
                lambda: (timed(rank), timed(step)))
            log(f"[time] (t={t}, n={n}, d={d}) ms in turns, rank phase | "
                f"knn_shapley step (SM clock {clocks['sm_mhz']} MHz, "
                f"{clocks['power_w']} W):")
            for nm in names:
                log(f"    {nm}: {rank_ms[nm]} | {step_ms[nm]}")
        finally:
            mega.library = shipped


def sections(torch, lib, mega, rank, step, rows) -> None:
    """Cycles a row in each marked section, as one thread of each block
    saw them, for the rank phase and the knn_shapley step."""
    mega.library = lambda _: lib
    for label, fn in (("rank phase", rank), ("knn_shapley step", step)):
        fn()
        torch.cuda.synchronize()
        lib.zero_sections()
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        lib.read_sections(buf)
        per_row = {nm: round(buf[i] / rows) for i, nm in enumerate(SECTIONS)
                   if buf[i]}
        log(f"[sections] {label}, cycles a row: {per_row}")


if __name__ == "__main__":
    main()
