"""The port's ``distributed``: activation recompute
(``fleet.utils.recompute``) and single-process checkpoints
(``checkpoint``), the counterparts of ``paddle_tpu.distributed``'s."""

from . import checkpoint, fleet

__all__ = ["checkpoint", "fleet"]
