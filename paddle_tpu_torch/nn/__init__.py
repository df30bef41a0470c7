"""``nn`` of the port: the counterpart of ``paddle_tpu.nn`` — the layer
base (``Layer``, ``ParamAttr``), the containers, the functional surface
(``functional``), the initializers (``initializer``), the layers of
``nn.layer`` (activation, common, conv, norm, pooling, loss, the RNNs of
``rnn`` and the rest of the names in ``tail``), the transformer stacks
(``nn.transformer``), ``utils`` (weight and spectral norm,
``parameters_to_vector``) and the gradient clips ``clip_grad_norm_`` /
``clip_grad_value_`` (``paddle_tpu/nn/__init__.py:50, :75``)."""

import torch as _torch

from . import functional, initializer
from .container import LayerList, ParameterList, Sequential
from .layer.activation import (CELU, ELU, GLU, PReLU, RReLU, SELU,
                               Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
                               LeakyReLU, LogSigmoid, LogSoftmax, Maxout,
                               Mish, ReLU6, Sigmoid, Silu, Softmax, Softplus,
                               Softshrink, Softsign, Swish, Tanhshrink,
                               ThresholdedReLU)
from .layer.common import (AlphaDropout, Bilinear, ChannelShuffle,
                           CosineSimilarity, Dropout2D, Dropout3D, Flatten,
                           Fold, Identity, Pad1D, Pad2D, Pad3D, PixelShuffle,
                           PixelUnshuffle, Unfold, Upsample,
                           UpsamplingBilinear2D, UpsamplingNearest2D,
                           ZeroPad2D)
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                         Conv3D, Conv3DTranspose)
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                         CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss,
                         HuberLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                         MSELoss, NLLLoss, SmoothL1Loss, TripletMarginLoss)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         GroupNorm, InstanceNorm1D, InstanceNorm2D,
                         InstanceNorm3D, LocalResponseNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, LPPool2D, MaxPool1D,
                            MaxPool2D, MaxPool3D)
from .layers import (GELU, Dropout, Embedding, Layer, LayerNorm, Linear,
                     ParamAttr, ReLU, RMSNorm, Tanh)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .layer.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,
                        RNNCellBase, SimpleRNN, SimpleRNNCell)
from .layer.tail import *  # noqa: E402,F401,F403
from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                              ClipGradByValue)


def _grads(parameters):
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    return [p for p in params if p.grad is not None]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place by min(max_norm / (total + 1e-6), 1),
    total the norm_type norm of their norms; returns total (0 with no
    gradients). error_if_nonfinite is taken and ignored, as in JAX."""
    params = _grads(parameters)
    if not params:
        return _torch.zeros([])
    total = _torch.linalg.vector_norm(_torch.stack([
        _torch.linalg.vector_norm(p.grad.reshape(-1), norm_type)
        for p in params]), norm_type)
    coef = _torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(coef.to(p.grad.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients in place to [-clip_value, clip_value]."""
    for p in _grads(parameters):
        p.grad.clamp_(-clip_value, clip_value)


from . import utils  # noqa: E402,F401

__all__ = [n for n in dir() if not n.startswith("_")]
