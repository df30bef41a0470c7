"""Optimizers of the port's training path: the counterparts of
``paddle_tpu.optimizer`` (``Optimizer``, ``Adam``, ``AdamW``), its
regularizers and its gradient clipping. The other optimizers and the
learning-rate schedulers come with later slices."""

from .adam import Adam, AdamW
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import Optimizer
from .regularizer import L1Decay, L2Decay

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "L1Decay", "L2Decay", "Optimizer"]
