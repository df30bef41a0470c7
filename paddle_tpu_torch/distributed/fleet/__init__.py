"""``fleet``: ``utils.recompute`` and the ``elastic`` manager."""

from . import elastic, utils
from .utils import recompute

__all__ = ["elastic", "recompute", "utils"]
