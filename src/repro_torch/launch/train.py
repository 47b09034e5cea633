"""Training launcher of the port: counterpart of `repro.launch.train`.

On the card, at full width (a dense, audio or VLM arch; the MoE, SSM
and hybrid archs hold more than one card at full depth):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 10 --batch 2 --seq 2048 --ckpt-dir CKPT
On the CPU, reduced dims:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --steps 4 --batch 2 --seq 64

The `Trainer` runs on `make_local_mesh(--device)`, as the reference's
on its local mesh: every local card as an (n_cards, 1) grid, a named card
or the CPU as (1, 1), laid out by `strategy_for`. `--production-mesh`
lays it over the reference's 16 x 16 production grid instead, one local
card a cell, and raises with fewer than 256 (`make_production_mesh`).
`reduced_config` is also what the serve launcher and the tests use.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["reduced_config", "synthetic_batch", "main"]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """~100M-param member of the same family for a local run: the fields
    of `repro.launch.train.reduced_config`, f32."""
    kw = dict(d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
              vocab_size=min(cfg.vocab_size, 32000), tp_pad_heads=1,
              dtype=torch.float32, mlstm_chunk=32, mamba_chunk=32,
              moe_group_size=512)
    kw["num_layers"] = cfg.group_size * max(2, 16 // cfg.group_size)
    kw["d_ff"] = 0 if cfg.d_ff == 0 else 1536
    if cfg.num_experts:
        kw["num_experts"] = 4
    if cfg.family == "audio":
        kw["encoder_layers"] = 4
        kw["encoder_seq"] = 128
    if cfg.family == "vlm":
        kw["num_patches"] = 16
    if cfg.sliding_window:
        kw["sliding_window"] = 512
    return cfg.replace(**kw)


def synthetic_batch(cfg: ModelConfig, step: int, batch: int, seq: int
                    ) -> dict:
    """The launcher's batch of `step`, on the host, from a generator seeded
    with `step`: (batch, seq) tokens and labels, and the VLM's patch
    embeddings (batch, num_patches, d_model) or the audio family's frames
    (batch, encoder_seq, d_model), standard normal in the activation type
    (the reference draws them from keys of their own)."""
    from repro_torch.data import make_token_batch

    gen = torch.Generator().manual_seed(step)
    toks, labels = make_token_batch(gen, batch, seq, cfg.vocab_size)
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn(
            (batch, cfg.num_patches, cfg.d_model), generator=gen
        ).to(cfg.dtype)
    if cfg.family == "audio":
        out["frames"] = torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=gen
        ).to(cfg.dtype)
    return out


def main(argv=None):
    """Parse the CLI, restore from --ckpt-dir if it holds a checkpoint,
    and train on `synthetic_batch`es."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink to ~100M params for a local run")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 production grid (needs 256 devices)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.production_mesh:
        local = make_local_mesh(args.device)
        mesh = make_production_mesh(devices=tuple(dict.fromkeys(
            local.devices)))
    else:
        mesh = make_local_mesh(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainerConfig(
        steps=args.steps, grad_accum=args.grad_accum,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                        total_steps=args.steps),
    )
    tr = Trainer(cfg, tcfg, mesh=mesh)
    params, opt_state = tr.init_state(seed=0)
    params, opt_state, start = tr.maybe_restore(params, opt_state)
    n_params = tr.model.num_params()
    name = (torch.cuda.get_device_name(tr.device)
            if tr.device.type == "cuda" else "cpu")
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={name} "
          f"mesh={mesh.axis_sizes}")

    def batch_fn(step):
        return synthetic_batch(cfg, step, args.batch, args.seq)

    return tr.fit(params, opt_state, batch_fn, start_step=start)


if __name__ == "__main__":
    main()
