"""``incubate.distributed``: the counterpart of
``paddle_tpu/incubate/distributed/__init__.py`` (the MoE models)."""

from . import models  # noqa: F401
