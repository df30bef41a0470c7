"""Layers and functional surface of the port's models."""

from . import functional
from .container import LayerList, Sequential
from .layers import (GELU, Dropout, Embedding, LayerNorm, Linear, ReLU,
                     RMSNorm, Tanh)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "Dropout", "Embedding", "GELU", "LayerList",
           "LayerNorm", "Linear", "MultiHeadAttention", "ReLU", "RMSNorm",
           "Sequential", "Tanh", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
