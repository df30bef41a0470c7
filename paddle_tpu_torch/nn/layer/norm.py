"""Norm layers: the counterparts of ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm`` and ``RMSNorm`` live in ``nn.layers``).

The batch norms keep their running statistics in the buffers ``_mean``
(zeros) and ``_variance`` (ones), the JAX layer's names, so state dicts
and JAX-format checkpoints map one to one. In training (unless
use_global_stats) the output is normalized by the batch statistics and
the buffers are updated outside autograd as ``r = m r + (1 - m) batch``
with momentum m (0.9) and the BIASED batch variance, as JAX updates them
(torch's ``batch_norm`` would take momentum 1 - m and the unbiased
variance); in eval the running statistics normalize.

``SyncBatchNorm``: the port is single-controller (one process drives
every rank, as in ``distributed``), so a layer called on one tensor sees
the global batch and its statistics are already the cross-replica ones.
Called on a list of per-rank shards (the collectives' per-rank form), it
reduces the shards' sums and squared sums over the ranks (in rank order,
on the first shard's device), normalizes each shard by the global
statistics and returns the list.
"""

from __future__ import annotations

import torch

from ...framework import dtype as dtypes
from ...ops.registry import OP_TABLE
from .. import functional as F
from .. import initializer as I
from ..layers import Layer, LayerNorm, RMSNorm


class _BatchNormBase(Layer):
    NORM_SCALES = ("weight",)

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)
        kw = {"dtype": dtypes.convert_dtype(dtype) or self._dtype,
              "device": self._device_of(device)}
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def _device_of(self, device):
        p = self.weight if self.weight is not None else self.bias
        if p is not None:
            return p.device
        from ...device import resolve_device
        return resolve_device(device)

    @torch.no_grad()
    def _update(self, mean, var):
        m = self.momentum
        self._mean.copy_(m * self._mean + (1 - m) * mean.to(self._mean))
        self._variance.copy_(m * self._variance +
                             (1 - m) * var.to(self._variance))

    def forward(self, x):
        if self.training and not self.use_global_stats:
            out, mean, var = OP_TABLE["batch_norm_train"]["api"](
                x, self.weight, self.bias, self.epsilon, self.data_format)
            self._update(mean.detach(), var.detach())
            return out
        return OP_TABLE["batch_norm_infer"]["api"](
            x, self._mean, self._variance, self.weight, self.bias,
            self.epsilon, self.data_format)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    """The legacy ``nn.BatchNorm``: an optional activation after (``act``,
    a functional's name)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=False, *, device=None, dtype=None, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm with cross-replica statistics (see the module
    docstring)."""

    def forward(self, x):
        if not isinstance(x, (list, tuple)):
            return super().forward(x)
        if not self.training or self.use_global_stats:
            return [super().forward(s) for s in x]
        dev = x[0].device
        n = x[0].dim()
        axes = (0,) + tuple(range(2, n)) if \
            self.data_format.startswith("NC") and n > 2 else \
            tuple(range(n - 1))
        count = sum(s.numel() // s.shape[1 if self.data_format.startswith(
            "NC") else -1] for s in x)
        total = sum(s.sum(axes).to(dev) for s in x)
        sq = sum(torch.square(s).sum(axes).to(dev) for s in x)
        mean = total / count
        var = sq / count - torch.square(mean)
        self._update(mean.detach(), var.detach())
        return [OP_TABLE["batch_norm_infer"]["api"](
            s, mean.to(s.device), var.to(s.device), self.weight, self.bias,
            self.epsilon, self.data_format) for s in x]

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm in it replaced by a
        SyncBatchNorm carrying its parameters and statistics."""
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            p = layer.weight if layer.weight is not None else layer._mean
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      data_format=layer.data_format, device=p.device,
                      dtype=p.dtype)
            new.set_state_dict(layer.state_dict())
            return new
        return layer


class GroupNorm(Layer):
    NORM_SCALES = ("weight",)

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    NORM_SCALES = ("weight",)

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon,
                               data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LayerNorm", "LocalResponseNorm", "RMSNorm", "SyncBatchNorm"]
