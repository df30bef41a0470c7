"""Regularizers: the counterparts of ``paddle_tpu/optimizer/regularizer.py``
(``L1Decay``, ``L2Decay``). An optimizer that does not decouple its decay
adds ``_apply(p)`` to the gradient."""

from __future__ import annotations

import torch


class WeightDecayRegularizer:
    def _apply(self, p):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _apply(self, p):
        return self.coeff * p

    def __str__(self):
        return f"L2Decay, coeff={self.coeff}"


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _apply(self, p):
        return self.coeff * torch.sign(p)

    def __str__(self):
        return f"L1Decay, coeff={self.coeff}"
