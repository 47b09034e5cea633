"""Architecture registry of the port: --arch <id> -> config (counterpart
of `repro.configs.registry`).

The port runs the dense, MoE, SSM (xLSTM) and hybrid (Jamba) decoder
families. The audio and VLM architectures of the JAX package are known by
name and raise `NotImplementedError` until their slice is ported
(ROADMAP.md queue A 3).
"""

from repro_torch.configs import (
    jamba_v01, mixtral_8x7b, phi35_moe, phi3_mini, qwen2_7b, qwen3_1_7b,
    smollm_360m, sti_knn_paper, xlstm_1_3b,
)

__all__ = ["ARCHS", "NOT_PORTED", "PAPER_WORKLOAD", "get_config"]

ARCHS = {
    "qwen2-7b": qwen2_7b.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
    "phi3-mini-3.8b": phi3_mini.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "jamba-v0.1-52b": jamba_v01.CONFIG,
}

# the JAX package's other architectures, by family
NOT_PORTED = {
    "whisper-small": "audio",
    "internvl2-2b": "vlm",
}

PAPER_WORKLOAD = sti_knn_paper.CONFIG


def get_config(name: str):
    if name == PAPER_WORKLOAD.name:
        return PAPER_WORKLOAD
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is a {NOT_PORTED[name]} model; the port runs the "
            f"dense, moe, ssm and hybrid families only (ROADMAP.md queue "
            f"A 3)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
