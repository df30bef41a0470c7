"""Fused functionals and layers (``paddle_tpu.incubate.nn``)."""

from . import functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
                    FusedMultiTransformer, FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm",
           "FusedDropoutAdd", "FusedFeedForward", "FusedLinear",
           "FusedMultiHeadAttention", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer"]
