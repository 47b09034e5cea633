"""The port's LM substrate (dense decoders): layers, attention through the
flash-attention kernel, the decoder assembly and the `Model` API."""

from repro_torch.models import attention, layers, params, transformer
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model", "layers", "attention", "params",
           "transformer"]
