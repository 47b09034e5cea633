"""Phi-3-mini 3.8B [arXiv:2404.14219]: 32L, d3072, 32H GQA kv32 (MHA),
d_ff 8192, vocab 32064, RoPE + SwiGLU.

Copy of `repro.configs.phi3_mini` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
)
