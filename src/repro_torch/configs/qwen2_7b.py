"""Qwen2-7B [arXiv:2407.10671; hf]: 28L, d3584, 28H GQA kv4, d_ff 18944,
vocab 152064, QKV bias.

Copy of `repro.configs.qwen2_7b` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
)
