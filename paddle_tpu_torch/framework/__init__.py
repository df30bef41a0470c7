"""Framework state of the port: the random generators and the runtime
flags."""

from . import flags, random
from .flags import get_flag, set_flags

__all__ = ["flags", "get_flag", "random", "set_flags"]
