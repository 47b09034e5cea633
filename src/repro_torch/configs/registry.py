"""Architecture registry of the port: --arch <id> -> config (counterpart
of `repro.configs.registry`), every architecture of the JAX package:
the dense, MoE, SSM (xLSTM), hybrid (Jamba), audio (Whisper) and VLM
(InternVL2) families. `PORT_ARCHS` holds the architectures the port has
and the JAX package does not (`get_config` finds both); `ARCHS` stays
the JAX package's registry, name for name, which its parity tests hold.
"""

from repro_torch.configs import (
    internvl2_2b, jamba2_mini, jamba_v01, mixtral_8x7b, phi35_moe, phi3_mini,
    qwen2_7b, qwen3_1_7b, smollm_360m, sti_knn_paper, whisper_small,
    xlstm_1_3b,
)

__all__ = ["ARCHS", "PORT_ARCHS", "PAPER_WORKLOAD", "TRAIN_RECIPES",
           "get_config"]

ARCHS = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
    "phi3-mini-3.8b": phi3_mini.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "whisper-small": whisper_small.CONFIG,
    "internvl2-2b": internvl2_2b.CONFIG,
    "jamba-v0.1-52b": jamba_v01.CONFIG,
}

PORT_ARCHS = {
    "jamba2-mini": jamba2_mini.CONFIG,
}

PAPER_WORKLOAD = sti_knn_paper.CONFIG


def get_config(name: str):
    if name == PAPER_WORKLOAD.name:
        return PAPER_WORKLOAD
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
    return ARCHS[name]


# The reference's production training recipes: (grad_accum, remat) per
# arch for its 16x16 train_4k cell.
TRAIN_RECIPES = {
    "mixtral-8x7b": {"grad_accum": 8, "remat": "dots"},
    "phi3.5-moe-42b-a6.6b": {"grad_accum": 8, "remat": "dots"},
    "jamba-v0.1-52b": {"grad_accum": 16, "remat": "block"},
    "qwen2-7b": {"grad_accum": 8, "remat": "block"},
    "phi3-mini-3.8b": {"grad_accum": 4, "remat": "block"},
    "qwen3-1.7b": {"grad_accum": 8, "remat": "block"},
    "internvl2-2b": {"grad_accum": 8, "remat": "block"},
    "xlstm-1.3b": {"grad_accum": 4, "remat": "block"},
    "smollm-360m": {"grad_accum": 1, "remat": "block"},
    "whisper-small": {"grad_accum": 2, "remat": "block"},
}
