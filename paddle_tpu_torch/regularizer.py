"""paddle.regularizer: the counterpart of ``paddle_tpu/regularizer.py``
(a re-export of ``optimizer.regularizer``)."""
from .optimizer.regularizer import L1Decay, L2Decay  # noqa: F401
