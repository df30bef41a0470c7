"""The port's ``incubate`` surface: the fused FFN epilogue ops and the
fused rotary position embedding."""

from . import nn

__all__ = ["nn"]
