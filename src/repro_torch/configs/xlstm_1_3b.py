"""xLSTM 1.3B [arXiv:2405.04517]: 48 blocks, d2048, 4 heads, no FFN
(blocks carry internal projections); 7:1 mLSTM:sLSTM interleave.

Copy of `repro.configs.xlstm_1_3b` for the PyTorch port."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    group_size=8, slstm_layer_in_group=(7,), ssm_kind="mlstm",
)
