"""InternVL2-2B [arXiv:2404.16821; hf]: InternViT frontend STUBBED
(precomputed patch embeddings); InternLM2 backbone 24L, d2048, 16H GQA
kv8, d_ff 8192, vocab 92553.

Copy of `repro.configs.internvl2_2b` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92553,
    num_patches=256,
)
