"""``fleet``: only its ``utils.recompute`` so far."""

from . import utils
from .utils import recompute

__all__ = ["recompute", "utils"]
