"""Serving: the paged continuous-batching engine and its speculative
decoding drafters."""

from .engine import (BlockManager, DeadlineExceededError, GenerationEngine,
                     GenRequest, RequestCancelledError,
                     make_sequence_snapshot)
from .speculative import (DraftModelDrafter, Drafter, NgramDrafter,
                          make_drafter, spec_decode_from_env)

__all__ = ["BlockManager", "DeadlineExceededError", "DraftModelDrafter",
           "Drafter", "GenerationEngine", "GenRequest", "NgramDrafter",
           "RequestCancelledError", "make_drafter", "make_sequence_snapshot",
           "spec_decode_from_env"]
