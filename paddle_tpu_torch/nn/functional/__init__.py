"""Functional surface: the counterpart of ``paddle_tpu.nn.functional``, a
package of the same modules — ``common`` (``linear``, the dropouts,
``embedding``, resize, shuffles, ``unfold``/``fold``, grids), ``conv``,
``pooling``, ``norm`` (``layer_norm``, ``rms_norm``, the batch, group,
instance, local-response and spectral norms), ``loss``, ``attention``
(``scaled_dot_product_attention``, ``flash_attention``,
``flashmask_attention``, the paged and ragged attentions,
``softmax_mask_fuse*``) — with the port's own ``fused`` (``swiglu``,
``fused_rope``, ``fused_rope_qk``, ``fused_linear_cross_entropy``) and
``activation`` (``gelu``, ``relu``, ``tanh``); the other activations and
``pad`` are the op surface's functions of the same names. ``tail`` adds
the small losses, ``pairwise_distance``, ``class_center_sample``,
``feature_alpha_dropout``, the packed flash entry points,
``sparse_attention`` and the in-place activations (``relu_`` ...).

Each function takes the JAX function's parameters in its order, with its
names and defaults (``name`` is taken and ignored, as paddle's is);
torch-only extras (``generator=``) are keyword-only after them. The
functions the JAX package registers as ops are registered in
``ops.registry.OP_TABLE`` under the same names: under ``amp.auto_cast``
each casts its inputs as the JAX dispatcher casts them, and operator
stats count it. The kernel ops route to their wrappers in
``ops.kernels`` (the CUDA kernel for CUDA tensors, the plain version for
CPU tensors), the differentiable ones through the kernel's custom op
(``ops.kernels._ops``), always with dense tensors. Functionals that draw
random numbers take ``generator=`` (default: the device's generator in
``framework.random``).
"""

from ...ops.registry import OP_TABLE as _T
from .activation import gelu, relu, tanh
from .attention import (_flashmask_intervals, _sdpa_dense,  # noqa: F401
                        _window_to_indices, flash_attention,
                        flashmask_attention, paged_attention,
                        ragged_paged_attention, scaled_dot_product_attention,
                        softmax_mask_fuse, softmax_mask_fuse_upper_triangle)
from .common import (affine_grid, alpha_dropout, bilinear, channel_shuffle,
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     embedding, fold, grid_sample, interpolate,
                     label_smooth, linear, normalize, one_hot,
                     pixel_shuffle, pixel_unshuffle, temporal_shift, unfold,
                     upsample)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .fused import (_flce_op, fused_linear_cross_entropy,  # noqa: F401
                    fused_rope, fused_rope_qk, swiglu)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, ctc_loss,
                   hinge_embedding_loss, hsigmoid_loss, huber_loss, kl_div,
                   l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   nll_loss, npair_loss, rnnt_loss, sigmoid_focal_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .norm import (batch_norm, batch_norm_infer, batch_norm_train,
                   group_norm, instance_norm, layer_norm,
                   local_response_norm, rms_norm, spectral_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, fractional_max_pool2d,
                      fractional_max_pool3d, lp_pool2d, max_pool1d,
                      max_pool2d, max_pool3d, max_unpool2d, max_unpool3d)

# the activations and pad of the op surface (``ops.impl``), as the JAX
# package's nn.functional takes them from its op table
_SURFACE = ("relu6", "sigmoid", "silu", "swish", "hardswish", "hardsigmoid",
            "hardtanh", "hardshrink", "softshrink", "tanhshrink",
            "thresholded_relu", "leaky_relu", "prelu", "rrelu", "elu",
            "selu", "celu", "mish", "softplus", "softsign", "softmax",
            "log_softmax", "gumbel_softmax", "maxout", "glu", "log_sigmoid",
            "pad")
for _name in _SURFACE:
    globals()[_name] = _T[_name]["api"]
del _name

from . import tail as _tail  # noqa: E402
from .tail import (adaptive_log_softmax_with_loss,  # noqa: E402,F401
                   class_center_sample, dice_loss, feature_alpha_dropout,
                   gaussian_nll_loss, margin_cross_entropy,
                   multi_label_soft_margin_loss, multi_margin_loss,
                   pairwise_distance, poisson_nll_loss, soft_margin_loss,
                   triplet_margin_with_distance_loss)

_tail.install(globals())
