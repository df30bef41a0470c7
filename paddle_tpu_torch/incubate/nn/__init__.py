"""Fused functionals and layers (``paddle_tpu.incubate.nn``)."""

from . import functional
from .layer import FusedBiasDropoutResidualLayerNorm

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm"]
