"""The port's ``incubate`` surface: the fused functionals (the FFN and
attention blocks, their epilogues, the fused rotary position embedding,
paged and dense-cache decode attention) and the fused layers."""

from . import nn

__all__ = ["nn"]
