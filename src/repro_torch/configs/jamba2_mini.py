"""AI21-Jamba2-Mini [hf: ai21labs/AI21-Jamba2-Mini config.json;
arXiv:2403.19887]: 32 layers in blocks of 8, d 4096, GQA 32 heads / 8 KV
heads of 128, no positional encoding, attention at offset 4 of each
block and Mamba-1 elsewhere (d_state 16, expand 2, dt_rank 256, conv 4,
RMSNorm on dt, B and C), 16 experts top-2 (softmax over all 16, the pair
not renormalised, no capacity) every other layer from layer 1, SwiGLU of
14336, RMSNorm eps 1e-6, vocab 65536, untied head.

A port-only architecture: the JAX package has no counterpart."""
from repro_torch.configs.base import PortConfig

CONFIG = PortConfig(
    name="jamba2-mini", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_period=2,
    group_size=8, attn_layer_in_group=(4,), ssm_kind="mamba",
    ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2, dt_rank=256,
    norm_eps=1e-6, tie_embeddings=False, max_seq_len=262144,
    rope=False, ssm_dbc_norm=True, moe_dropless=True, moe_renorm=False,
)
