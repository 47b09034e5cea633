"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
32L, d4096, 32H GQA kv8, expert d_ff 6400, vocab 32064, 16 experts top-2.

Copy of `repro.configs.phi35_moe` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=6400, vocab_size=32064,
    num_experts=16, experts_per_token=2,
)
