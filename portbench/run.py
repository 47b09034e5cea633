"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload sti-imagenet-92k.batch256 --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout: the harness puts the checkout and its
`src/` on the path. It needs an NVIDIA card (exit 2 without one, or
with fewer than the cell asks for) and prints, as the last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` also `breakdown`, and last
`checks`, each number the check compared beside its limit. The same
numbers close standard error. Kernels build once into
`src/repro_torch/_build/` inside the checkout; the only other file a
run writes, the port's tuning cache, goes to a temporary directory under
TMPDIR that the run removes (the profiler's trace is read in memory).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the checkout, not this folder, is the import root
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != ROOT / "portbench"]

    import torch

    from portbench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.resolve(spec, args.workload, ROOT)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails without the checkout's src/)

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    found = harness.banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    line = out["line"]
    print("set-up, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["records"]["setup_phases"].items()),
        file=sys.stderr)
    print(f"the program's answer and the reference took "
          f"{out['records']['check_s']:.3f} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
