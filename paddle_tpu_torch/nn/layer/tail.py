"""The rest of ``nn``'s layers: the counterpart of
``paddle_tpu/nn/layer/tail.py``, the 26 names of its ``__all__`` (:412)
— thin layers over the functional surface (the tail losses,
``PairwiseDistance``, ``FeatureAlphaDropout``, ``Softmax2D``,
``Unflatten``, the zero pads, ``LPPool1D``, the max unpools, the
fractional max pools), ``HSigmoidLoss`` and
``AdaptiveLogSoftmaxWithLoss`` with their parameters, ``SpectralNorm``
(:252), the containers ``LayerDict`` / ``ParameterDict`` (:281, :330), and
``BeamSearchDecoder`` / ``dynamic_decode`` (:368-395), which decode
greedily over an RNN cell.

Layers with parameters take ``device=`` and ``dtype=`` keyword-only
(``device=None``: the current device).
"""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from ..layers import Layer


def _loss_layer(name, fn_name):
    def __init__(self, reduction="mean", name=None, **kw):
        Layer.__init__(self)
        self.reduction = reduction
        self._kw = dict(kw)

    def forward(self, *args):
        return getattr(F, fn_name)(*args, reduction=self.reduction,
                                   **self._kw)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__doc__": f"``F.{fn_name}`` as a layer: "
                                            f"reduction and the keyword "
                                            f"arguments given here."})


GaussianNLLLoss = _loss_layer("GaussianNLLLoss", "gaussian_nll_loss")
PoissonNLLLoss = _loss_layer("PoissonNLLLoss", "poisson_nll_loss")
SoftMarginLoss = _loss_layer("SoftMarginLoss", "soft_margin_loss")
MultiLabelSoftMarginLoss = _loss_layer("MultiLabelSoftMarginLoss",
                                       "multi_label_soft_margin_loss")
MultiMarginLoss = _loss_layer("MultiMarginLoss", "multi_margin_loss")


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin = margin
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_with_distance_loss(
            input, positive, negative,
            distance_function=self.distance_function, margin=self.margin,
            swap=self.swap, reduction=self.reduction)


class RNNTLoss(Layer):
    """``F.rnnt_loss``; fastemit_lambda is taken and ignored, as in
    JAX."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, logits, labels, input_lengths, label_lengths):
        return F.rnnt_loss(logits, labels, input_lengths, label_lengths,
                           blank=self.blank, reduction=self.reduction)


class HSigmoidLoss(Layer):
    """``F.hsigmoid_loss`` over the default tree: weight
    [num_classes - 1, feature_size] (Xavier-normal), bias zeros."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr, device=device)
        self.bias = self.create_parameter([num_classes - 1], attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, input, label):  # noqa: A002
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, p=self.p, epsilon=self.epsilon,
                                   keepdim=self.keepdim)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """The hierarchical softmax head: ``head_weight`` [in, head classes +
    clusters] (with ``head_bias`` when asked), and per cluster i
    ``tail_proj_i`` [in, in // div_value^(i+1)] and ``tail_out_i`` [proj,
    cluster size], all Xavier-normal."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        self.cutoffs = list(cutoffs)
        self.n_clusters = len(self.cutoffs)
        n_head = (self.cutoffs[0] if self.cutoffs else n_classes) \
            + self.n_clusters
        self.head_weight = self.create_parameter([in_features, n_head],
                                                 device=device)
        self.head_bias = self.create_parameter(
            [n_head], is_bias=True, device=device) if head_bias else None
        self._tails = []
        lo = self.cutoffs[0] if self.cutoffs else n_classes
        for i in range(self.n_clusters):
            hi = self.cutoffs[i + 1] if i + 1 < self.n_clusters \
                else n_classes
            proj = max(1, int(in_features // (div_value ** (i + 1))))
            self.add_parameter(f"tail_proj_{i}", self.create_parameter(
                [in_features, proj], device=device))
            self.add_parameter(f"tail_out_{i}", self.create_parameter(
                [proj, hi - lo], device=device))
            self._tails.append((f"tail_proj_{i}", f"tail_out_{i}"))
            lo = hi

    @property
    def tail_weights(self):
        return [(self._parameters[a], self._parameters[b])
                for a, b in self._tails]

    def forward(self, input, label):  # noqa: A002
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            head_bias=self.head_bias)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, training=self.training)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW inputs."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = list(shape)

    def forward(self, x):
        from ...ops.registry import OP_TABLE
        return OP_TABLE["unflatten"]["api"](x, self.axis, self.shape)


class _ZeroPadNd(Layer):
    def __init__(self, padding, data_format, name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format=self.data_format)


class ZeroPad1D(_ZeroPadNd):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, data_format, name)


class ZeroPad3D(_ZeroPadNd):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, data_format, name)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        n, k, s, p, c = self.args
        return F.lp_pool1d(x, n, k, stride=s, padding=p, ceil_mode=c)


class _MaxUnPoolNd(Layer):
    _FN = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return getattr(F, self._FN)(x, indices, self.kernel_size,
                                    stride=self.stride, padding=self.padding,
                                    output_size=self.output_size)


class MaxUnPool1D(_MaxUnPoolNd):
    _FN = "max_unpool1d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size, name)


class MaxUnPool2D(_MaxUnPoolNd):
    _FN = "max_unpool2d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size, name)


class MaxUnPool3D(_MaxUnPoolNd):
    _FN = "max_unpool3d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size, name)


class _FractionalMaxPoolNd(Layer):
    _FN = None

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.kernel_size = kernel_size
        self.random_u = random_u
        self.return_mask = return_mask

    def forward(self, x):
        return getattr(F, self._FN)(x, self.output_size,
                                    kernel_size=self.kernel_size,
                                    random_u=self.random_u,
                                    return_mask=self.return_mask)


class FractionalMaxPool2D(_FractionalMaxPoolNd):
    _FN = "fractional_max_pool2d"


class FractionalMaxPool3D(_FractionalMaxPoolNd):
    _FN = "fractional_max_pool3d"


class SpectralNorm(Layer):
    """A given weight divided by its largest singular value, estimated by
    power iteration from ``weight_u`` [weight_shape[dim]] and
    ``weight_v`` [the rest] (N(0, 1), parameters with no gradient, as in
    JAX)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", name=None, *, device=None):
        super().__init__(dtype=dtype)
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0), device=device)
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0), device=device)
        self.weight_u.requires_grad_(False)
        self.weight_v.requires_grad_(False)

    def forward(self, x):
        return F.spectral_norm(x, self.weight_u, self.weight_v,
                               dim=self.dim, power_iters=self.power_iters,
                               eps=self.eps)


class LayerDict(Layer):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        for k, v in (sublayers.items() if isinstance(sublayers, dict)
                     else sublayers):
            self.add_sublayer(k, v)


class ParameterDict(Layer):
    """Parameters by name, in insertion order."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            self.update(parameters)

    def __getitem__(self, key):
        return self._parameters[key]

    def __setitem__(self, key, param):
        self.add_parameter(key, param)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def __contains__(self, key):
        return key in self._parameters

    def keys(self):
        return self._parameters.keys()

    def items(self):
        return self._parameters.items()

    def values(self):
        return self._parameters.values()

    def update(self, parameters):
        for k, v in (parameters.items() if isinstance(parameters, dict)
                     else parameters):
            self.add_parameter(k, v)


class BeamSearchDecoder:
    """What ``dynamic_decode`` decodes with: an RNN cell, the start and
    end tokens, an embedding and an output projection (beam_size is kept;
    the decode is greedy, as in JAX)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def dynamic_decode(decoder, inits=None, max_step_num=20, **kwargs):
    """Greedy decoding over the decoder's cell from the states `inits`:
    each step embeds the last token (start_token first; without an
    embedding, the token as one float feature), runs the cell, projects
    and takes the argmax; stops after max_step_num steps or once every
    row emitted end_token. Returns (token ids [B, T] int64, final
    states)."""
    cell = decoder.cell
    state = inits
    leaf = state[0] if isinstance(state, (tuple, list)) else state
    cur = torch.full((leaf.shape[0],), decoder.start_token,
                     dtype=torch.int64, device=leaf.device)
    tokens = []
    for _ in range(max_step_num):
        emb = decoder.embedding_fn(cur) if decoder.embedding_fn else \
            cur.to(torch.float32).unsqueeze(-1)
        out, state = cell(emb, state)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        cur = logits.argmax(dim=-1).to(torch.int64)
        tokens.append(cur)
        if bool((cur == decoder.end_token).all()):
            break
    return torch.stack(tokens, dim=1), state


__all__ = [
    "GaussianNLLLoss", "PoissonNLLLoss", "SoftMarginLoss",
    "MultiLabelSoftMarginLoss", "MultiMarginLoss",
    "TripletMarginWithDistanceLoss", "RNNTLoss", "HSigmoidLoss",
    "PairwiseDistance", "AdaptiveLogSoftmaxWithLoss",
    "FeatureAlphaDropout", "Softmax2D", "Unflatten", "ZeroPad1D",
    "ZeroPad3D", "LPPool1D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "FractionalMaxPool2D", "FractionalMaxPool3D", "SpectralNorm",
    "LayerDict", "ParameterDict", "BeamSearchDecoder", "dynamic_decode",
]
