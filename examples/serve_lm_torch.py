"""Serve a small LM with batched requests through the PyTorch port's
continuous-batching engine (prefill/decode split, slot pool, greedy
sampling), on an NVIDIA card (or, when asked, the CPU).

    PYTHONPATH=src python examples/serve_lm_torch.py
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
        --requests 2 --max-len 16

The port's counterpart of `examples/serve_lm.py`; on the card every
prefill's attention runs the flash-attention kernel.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine, ServeConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
ap.add_argument("--requests", type=int, default=10)
ap.add_argument("--max-len", type=int, default=48)
args = ap.parse_args()

cfg = ModelConfig(
    name="serve-demo", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1024,
    tp_pad_heads=1, vocab_pad=64, dtype=torch.float32)
model = build_model(cfg)
gen = torch.Generator(device=args.device).manual_seed(0)
params = model.init(gen, device=args.device)

engine = Engine(cfg, ServeConfig(max_slots=4, max_len=args.max_len,
                                 eos_id=-1), params)

rng = np.random.default_rng(0)
rids = [engine.submit(rng.integers(0, 1024, size=rng.integers(4, 12)))
        for _ in range(args.requests)]
print(f"submitted {len(rids)} requests into a 4-slot pool")
results = engine.run()
for rid in rids:
    toks = results[rid]
    print(f"  request {rid}: generated {len(toks)} tokens, first 8: "
          f"{toks[:8]}")
print("[ok] all requests served")
