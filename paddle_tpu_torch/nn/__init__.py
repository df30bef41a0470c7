"""``nn`` of the port: the counterpart of ``paddle_tpu.nn`` — the layer
base (``Layer``, ``ParamAttr``), the containers, the functional surface
(``functional``), the initializers (``initializer``), the layers of
``nn.layer`` (activation, common, conv, norm, pooling, loss) and the
transformer stacks (``nn.transformer``)."""

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

__all__ = [n for n in dir() if not n.startswith("_")]
