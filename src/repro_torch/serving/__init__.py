"""Serving layer of the port: the LLM slot engine (`serving.engine`) and
the online valuation service (`serving.valuation_service`)."""

from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.valuation_service import ValuationService

__all__ = ["Engine", "ServeConfig", "ValuationService"]
