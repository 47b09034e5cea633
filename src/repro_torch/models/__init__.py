"""The port's LM substrate (dense, MoE, SSM and hybrid decoders): layers,
attention through the flash-attention kernel, the MoE FFN, the SSM mixers,
the decoder assembly and the `Model` API."""

from repro_torch.models import (
    attention, layers, moe, params, ssm, transformer)
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model", "layers", "attention", "moe", "params",
           "ssm", "transformer"]
