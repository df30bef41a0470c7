"""The port's ``incubate`` surface: the fused FFN epilogue ops."""

from . import nn

__all__ = ["nn"]
