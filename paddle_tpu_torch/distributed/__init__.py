"""The port's ``distributed``: activation recompute
(``fleet.utils.recompute``), single-process checkpoints (``checkpoint``),
the comm watchdog (``watchdog``), the elastic heartbeat manager
(``fleet.elastic``) and the resilient training loop (``resilient``),
the counterparts of ``paddle_tpu.distributed``'s."""

from . import checkpoint, fleet, resilient, watchdog
from .resilient import (BadStepGuard, PeerFailureError,
                        RestartBudgetExceededError, ResilientTrainer)
from .watchdog import CommTimeoutError, watched_wait

__all__ = ["BadStepGuard", "CommTimeoutError", "PeerFailureError",
           "ResilientTrainer", "RestartBudgetExceededError", "checkpoint",
           "fleet", "resilient", "watchdog", "watched_wait"]
