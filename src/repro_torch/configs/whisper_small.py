"""Whisper-small [arXiv:2212.04356]: enc-dec, 12L each, d768, 12H,
d_ff 3072, vocab 51865; conv frontend STUBBED (precomputed frame
embeddings, 1500 positions); LayerNorm + GELU, learned positions.

Copy of `repro.configs.whisper_small` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500, norm_kind="layernorm", act="gelu",
)
