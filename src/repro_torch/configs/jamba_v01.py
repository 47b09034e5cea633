"""Jamba v0.1 52B [arXiv:2403.19887; hf]: 32L, d4096, 32H GQA kv8,
d_ff 14336, vocab 65536; Mamba+attention 1:7 interleave, 16 experts
top-2 MoE every other layer.

Copy of `repro.configs.jamba_v01` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_period=2,
    group_size=8, attn_layer_in_group=(4,), ssm_kind="mamba",
)
