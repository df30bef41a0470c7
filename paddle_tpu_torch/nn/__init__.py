"""Layers and functional surface of the port's serving path."""

from . import functional
from .layers import Embedding, Linear, RMSNorm

__all__ = ["functional", "Embedding", "Linear", "RMSNorm"]
