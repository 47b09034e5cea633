"""Serving launcher of the port: batched request serving through the slot
engine, on a CUDA card (or, when asked, the CPU).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --requests 8 --max-len 256
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --requests 4

Parameters are drawn from `--seed` on the device. On the card, prefill
attention runs the flash-attention kernel (`csrc/flash_attention.cu`);
the line it prints names the device its rates were taken on.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import reduced_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine, ServeConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"serve: {e}")
    # f32 matmuls (the logits) stay f32 on the card, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen, device=dev)
    print(f"serving {cfg.name} ({model.num_params() / 1e6:.1f}M params) on "
          f"{name}, {args.slots} slots, max_len {args.max_len}")

    eng = Engine(cfg, ServeConfig(max_slots=args.slots,
                                  max_len=args.max_len,
                                  temperature=args.temperature,
                                  eos_id=-1), params)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(4, 16))))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tok = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {tok} tokens in {dt:.2f} s "
          f"({tok / dt:.1f} tok/s on {name})")


if __name__ == "__main__":
    main()
