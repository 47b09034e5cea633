"""Architecture registry of the port: --arch <id> -> config (counterpart
of `repro.configs.registry`).

The port runs the dense decoder family. The other architectures of the
JAX package (MoE, SSM, hybrid, audio, VLM) are known by name and raise
`NotImplementedError` until their slice is ported (ROADMAP.md queue A 3).
"""

from repro_torch.configs import (
    phi3_mini, qwen2_7b, qwen3_1_7b, smollm_360m, sti_knn_paper,
)

__all__ = ["ARCHS", "NOT_PORTED", "PAPER_WORKLOAD", "get_config"]

ARCHS = {
    "qwen2-7b": qwen2_7b.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
    "phi3-mini-3.8b": phi3_mini.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
}

# the JAX package's other architectures, by family
NOT_PORTED = {
    "mixtral-8x7b": "moe",
    "phi3.5-moe-42b-a6.6b": "moe",
    "xlstm-1.3b": "ssm",
    "whisper-small": "audio",
    "internvl2-2b": "vlm",
    "jamba-v0.1-52b": "hybrid",
}

PAPER_WORKLOAD = sti_knn_paper.CONFIG


def get_config(name: str):
    if name == PAPER_WORKLOAD.name:
        return PAPER_WORKLOAD
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is a {NOT_PORTED[name]} model; the port runs the "
            f"dense family only (ROADMAP.md queue A 3)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
