"""The port's LM substrate (dense, MoE, SSM and hybrid decoders, the
Whisper encoder-decoder and the VLM): layers, attention through the
flash-attention kernel, the MoE FFN, the SSM mixers, the decoder assembly,
the audio encoder and the `Model` API."""

from repro_torch.models import (
    attention, layers, moe, params, ssm, transformer, whisper)
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model", "layers", "attention", "moe", "params",
           "ssm", "transformer", "whisper"]
