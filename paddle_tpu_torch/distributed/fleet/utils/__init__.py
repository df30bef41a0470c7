from . import sequence_parallel_utils  # noqa: F401
from .recompute import recompute

__all__ = ["recompute", "sequence_parallel_utils"]
