"""Serving layer of the port: the LLM slot engine (`serving.engine`)."""

from repro_torch.serving.engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
