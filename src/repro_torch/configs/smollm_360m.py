"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]: llama-arch small --
32L, d960, 15H GQA kv5, d_ff 2560, vocab 49152.

Copy of `repro.configs.smollm_360m` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense", num_layers=32, d_model=960,
    num_heads=15, num_kv_heads=5, d_ff=2560, vocab_size=49152,
)
