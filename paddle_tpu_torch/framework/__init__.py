"""Framework state of the port: the dtypes, the random generators, the
runtime flags and ``save`` / ``load`` (``io``)."""

from . import dtype, flags, io, random
from .flags import get_flag, get_flags, set_flags
from .io import load, save

__all__ = ["dtype", "flags", "get_flag", "get_flags", "io", "load",
           "random", "save", "set_flags"]
