"""Layers and functional surface of the port's serving path."""

from . import functional
from .layers import Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "Embedding", "LayerNorm", "Linear", "RMSNorm"]
