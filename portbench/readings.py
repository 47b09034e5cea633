"""Readings that the limits of the check are set from, on the card.

    python3 portbench/readings.py --workload sti-imagenet-92k.batch256 \
        --seeds 11,12,13 --seconds 10

For each seed, in one process: one run of the cell as `run.py` makes it
(window and check), and the control, the reference computed in TF32 in
the program's place, folded over the same inputs and compared by the
same comparison. One JSON line per seed: the numbers the check compared
(`numbers`), the control's (`control`), the end-to-end metrics and the
run's seconds. The limit of each number lies between the largest sound
reading and the smallest control reading (see `PERF.md`).
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
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False,
                               device="cuda", t_start=t_start,
                               control=True)
        rec = out["records"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "numbers": out["numbers"], "control": out["control"],
            "correct": out["line"]["correct"],
            "metrics": {k: v["value"]
                        for k, v in out["line"]["metrics"].items()},
            "attempted": out["line"]["attempted"],
            "failed": out["line"]["failed"],
            "window_s": rec["window_s"], "points": rec["points"],
            "check_s": rec["check_s"],
            "run_s": time.perf_counter() - t0}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
