"""Serving: the paged continuous-batching engine."""

from .engine import BlockManager, GenerationEngine, GenRequest

__all__ = ["BlockManager", "GenerationEngine", "GenRequest"]
