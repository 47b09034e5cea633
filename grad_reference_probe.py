"""Where does the CPU reference of chip_smoke.py's [14a] come from?

[14a] holds the loss and every gradient leaf of qwen3-1.7b's width with 2
layers (f32, 1 x 256 tokens) on the card against the same computation on
the CPU, within 1e-4 of each leaf's max |value|. This probe computes the
card side twice (is the card deterministic?) and the CPU side in fresh
processes (`chip_smoke.py --cpu-ref grads`) under several CPU settings:

  default x3          the same settings again (does the CPU
                      reference move within one host?)
  threads 4           OMP_NUM_THREADS / MKL_NUM_THREADS 4
  aten avx2           ATEN_CPU_CAPABILITY=avx2 (ATen's AVX2 kernels, as on
                      a host without AVX-512)
  mkl avx2            MKL_CBWR=AVX2 (MKL's AVX2 code path in its
                      conditional numerical reproducibility mode)
  aten+mkl avx2       both
  mkl compatible      MKL_CBWR=COMPATIBLE (MKL's SSE2 path, the same on
                      every x86-64 host)

and prints, for each, the loss, every leaf's error against the card and
against the first run, the seconds taken and the host CPU. Needs a CUDA
card:

  python3 grad_reference_probe.py [--out chiprun_out/grad_reference_probe.json]
  python3 grad_reference_probe.py --variants default "mkl avx2" --repeat 8
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

VARIANTS = {
    "default": {},
    "threads 4": {"OMP_NUM_THREADS": "4", "MKL_NUM_THREADS": "4"},
    "aten avx2": {"ATEN_CPU_CAPABILITY": "avx2"},
    "mkl avx2": {"MKL_CBWR": "AVX2"},
    "aten+mkl avx2": {"ATEN_CPU_CAPABILITY": "avx2", "MKL_CBWR": "AVX2"},
    "mkl compatible": {"MKL_CBWR": "COMPATIBLE"},
}
DEFAULT_RUNS = ["default"] * 3 + [v for v in VARIANTS if v != "default"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/grad_reference_probe.json")
    ap.add_argument("--variants", nargs="+", default=DEFAULT_RUNS,
                    choices=sorted(VARIANTS), metavar="NAME",
                    help=f"variants to run, in order: {sorted(VARIANTS)}")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run each listed variant this many times")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("grad_reference_probe: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.checkpoint.checkpointer import _flatten, _keystr
    from repro_torch.configs.base import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params, batch = cs.card_vs_cpu_inputs(
        torch, np, np.random.default_rng(14))
    names = [_keystr(path) for path, _ in _flatten(params)]
    gparams = tree_map(lambda p: p.to("cuda"), params)
    gbatch = {k: v.to("cuda") for k, v in batch.items()}
    card = []
    for _ in range(2):
        loss, grads = cs._loss_and_grads(torch, model, gparams, gbatch)
        card.append((float(loss), [g.cpu() for g in grads]))
    card_same = card[0][0] == card[1][0] and all(
        torch.equal(a, b) for a, b in zip(card[0][1], card[1][1]))
    closs, cgrads = card[0]
    print(f"card: loss {closs!r}, bit-identical on a second run: "
          f"{card_same}", flush=True)
    print(f"host: {cs.cpu_host()}", flush=True)
    print("torch", torch.__version__, "BLAS:", [
        ln.strip() for ln in torch.__config__.show().splitlines()
        if "BLAS" in ln or "MKL" in ln][:4], flush=True)

    runs, first = [], None
    with tempfile.TemporaryDirectory(prefix="grad_probe_") as tmp:
        for i, name in enumerate([v for v in args.variants
                                  for _ in range(args.repeat)]):
            env = VARIANTS[name]
            run_dir = Path(tmp) / str(i)
            run_dir.mkdir()
            subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-ref",
                 "grads", str(run_dir)], env=dict(os.environ, **env),
                check=True, timeout=600)
            ref = torch.load(run_dir / "grads.pt")
            grads = ref["grads"]
            first = first or grads
            vs_card = [float((g - w).abs().max() / w.abs().max())
                       for g, w in zip(cgrads, grads)]
            vs_first = [float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(first, grads)]
            worst = max(range(len(names)), key=lambda j: vs_card[j])
            run = dict(variant=name, env=env, loss=ref["loss"],
                       loss_rel_vs_card=abs(ref["loss"] - closs) / closs,
                       worst_leaf_vs_card=vs_card[worst],
                       worst_leaf=names[worst],
                       worst_vs_first_run=max(vs_first),
                       seconds=ref["seconds"], settings=ref["settings"],
                       leaf_vs_card=dict(zip(names, vs_card)))
            runs.append(run)
            print(f"{name:15s} loss {ref['loss']!r} (rel vs card "
                  f"{run['loss_rel_vs_card']:.2e}); worst leaf vs card "
                  f"{vs_card[worst]:.2e} ({names[worst]}); vs the first "
                  f"run {max(vs_first):.2e}; {ref['seconds']:.1f} s; "
                  f"capability {ref['settings']['cpu_capability']}, "
                  f"threads {ref['settings']['cpu_threads']}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card_loss=closs, card_deterministic=
                                   card_same, host=cs.cpu_host(),
                                   runs=runs), indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
