"""Optimizers of the port's training path: the counterparts of
``paddle_tpu.optimizer`` — the base and the SGD family, the Adam family,
ASGD, Rprop and LBFGS, the learning-rate schedulers (``optimizer.lr``),
the regularizers and gradient clipping."""

from . import lr
from .adam import (Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, NAdam,
                   RAdam, RMSProp)
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .extra import ASGD, LBFGS, Rprop
from .optimizer import SGD, Momentum, Optimizer
from .regularizer import L1Decay, L2Decay

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "L1Decay", "L2Decay", "LBFGS", "Lamb", "Momentum", "NAdam",
           "Optimizer", "RAdam", "RMSProp", "Rprop", "SGD", "lr"]
