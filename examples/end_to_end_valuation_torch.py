"""End-to-end driver of the PyTorch port for the paper's pipeline (its
production use case), on an NVIDIA card (or, when asked, the CPU):

  1. TRAIN a backbone LM (~100M-param class, reduced dims by default) on
     synthetic token streams with the port's `Trainer` (checkpointing +
     fault-tolerant loop);
  2. EXTRACT mean-pooled embeddings for a labeled corpus with
     `Model.embed` (the paper's "pre-trained feature extractor" pattern,
     Sec. 1);
  3. VALUATE the corpus with STI-KNN via a streaming `ValuationSession`
     (test batches arrive incrementally, constant accumulator memory;
     the distance and fill kernels on the card) and flag mislabeled
     examples from the `ValuationResult` artifact.

    PYTHONPATH=src python examples/end_to_end_valuation_torch.py \
        --steps 300 --d-model 128   # full driver (~100M: --d-model 768)

The port's counterpart of `examples/end_to_end_valuation.py`, with its
flags and sizes, plus `--device`.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ValuationSession
from repro_torch.data import flip_labels, make_token_batch
from repro_torch.models import build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--d-model", type=int, default=96)
ap.add_argument("--layers", type=int, default=4)
ap.add_argument("--vocab", type=int, default=512)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--batch", type=int, default=16)
ap.add_argument("--ckpt-dir", default=None)
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()

cfg = ModelConfig(
    name="backbone", family="dense", num_layers=args.layers,
    d_model=args.d_model, num_heads=4, num_kv_heads=2,
    head_dim=args.d_model // 4, d_ff=args.d_model * 4,
    vocab_size=args.vocab, tp_pad_heads=1, vocab_pad=64,
    dtype=torch.float32)
model = build_model(cfg)

# ---- 1. train ------------------------------------------------------------
tcfg = TrainerConfig(
    steps=args.steps, log_every=max(1, args.steps // 6),
    ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 2),
    opt=AdamWConfig(lr=1e-3, warmup_steps=args.steps // 10,
                    total_steps=args.steps))
tr = Trainer(cfg, tcfg, device=args.device)
params, opt_state = tr.init_state(0)


def batch_fn(step):
    toks, labels = make_token_batch(
        torch.Generator().manual_seed(step), args.batch, args.seq,
        cfg.vocab_size)
    return {"tokens": toks, "labels": labels}


params, _, hist = tr.fit(params, opt_state, batch_fn)
print(f"[train] loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

# ---- 2. a labeled corpus: two token "dialects" + 10% label noise ---------
n, t = 256, 64


def corpus(count, seed):
    r = np.random.default_rng(seed)
    labels = r.integers(0, 2, count).astype(np.int32)
    # class 0 draws from the low half of the vocab, class 1 from the high
    toks = np.where(
        labels[:, None] == 0,
        r.integers(0, args.vocab // 2, (count, args.seq)),
        r.integers(args.vocab // 2, args.vocab, (count, args.seq)),
    ).astype(np.int32)
    return torch.from_numpy(toks), torch.from_numpy(labels)


train_toks, train_labels_clean = corpus(n, 1)
test_toks, test_labels = corpus(t, 2)
train_labels, flipped = flip_labels(train_labels_clean, 0.1, 2, seed=3)

# ---- 3. embed + valuate (streaming: test points arrive in batches) --------
dev = tr.device


@torch.no_grad()
def embed(toks):
    return model.embed(params, {"tokens": toks.to(dev)})


x_train = embed(train_toks)
sess = ValuationSession(x_train, train_labels, k=5, test_batch=32,
                        device=dev)
for start in range(0, t, 32):
    sess.update(embed(test_toks[start:start + 32]),
                test_labels[start:start + 32])
result = sess.finalize()
print(f"[valuate] streamed t={result.meta['t']} through "
      f"engine={result.meta['engine']} fill={result.meta['fill']} "
      f"device={result.meta['device_kind']}")
scores = result.mislabel_scores(train_labels, 2).cpu().numpy()
order = np.argsort(-scores)
nf = int(flipped.sum())
prec = float(flipped.numpy()[order[:nf]].mean())
print(f"[valuate] mislabel precision@{nf}: {prec:.2f} "
      f"(chance: {nf / n:.2f})")
assert prec > 2 * nf / n, "valuation should beat chance by 2x"
print("[ok] end-to-end pipeline complete")
