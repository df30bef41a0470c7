"""Framework state of the port: the random generators."""

from . import random

__all__ = ["random"]
