"""Framework state of the port: the dtypes, the random generators and
the runtime flags."""

from . import dtype, flags, random
from .flags import get_flag, get_flags, set_flags

__all__ = ["dtype", "flags", "get_flag", "get_flags", "random",
           "set_flags"]
