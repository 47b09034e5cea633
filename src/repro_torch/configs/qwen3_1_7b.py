"""Qwen3-1.7B [hf:Qwen/Qwen3-1.7B]: 28L, d2048, 16H GQA kv8, d_ff 6144,
vocab 151936, qk-norm, head_dim 128.

Copy of `repro.configs.qwen3_1_7b` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=8, d_ff=6144, vocab_size=151936,
    qk_norm=True, head_dim=128, rope_theta=1e6,
)
