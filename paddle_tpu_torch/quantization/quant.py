"""The quantization API (the package ``paddle_tpu_torch.quantization``
exports every name of this module; see its docstring)."""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import nn
from ..ops.registry import OP_TABLE as _T
from ..ops.registry import register_op
from .page_quant import dequant_codes, quant_codes

__all__ = ["fake_quant_dequant", "BaseObserver",
           "AbsmaxObserver", "EMAObserver", "FakeQuanterWithAbsMax",
           "ChannelWiseAbsmaxObserver", "FakeChannelWiseQuanter",
           "HistObserver", "KLObserver", "QuantedLinear", "QuantedConv2D",
           "QuantConfig", "QAT", "PTQ", "quant_post_static",
           "cal_kl_threshold", "weight_quantize", "weight_only_linear",
           "quantize_pass", "BaseQuanter", "quanter"]


def _scale_like(scale, x):
    """A Python scale as a tensor of x's type (a weak JAX scalar meets x
    in x's type); a tensor scale as it is."""
    if isinstance(scale, torch.Tensor):
        return scale
    return torch.tensor(float(scale), dtype=x.dtype, device=x.device)


@register_op("fake_quant_dequant", amp=False)
def fake_quant_dequant(x, scale, bit_length=8, name=None):
    """Symmetric per-tensor fake quantization with the straight-through
    gradient: forward ``dequant(quant(x))``, backward the identity."""
    qmax = 2.0 ** (bit_length - 1) - 1
    s = _scale_like(scale, x)
    q = dequant_codes(quant_codes(x, s, qmax), s, qmax)
    return x + (q - x).detach()


def _absmax(x):
    """max |x| as a Python float (a host sync, as JAX's float(jnp.max))."""
    return float(x.detach().abs().max())


def _host(x, dtype=np.float32):
    """x's values as a numpy array of `dtype` (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return np.asarray(x.cpu().numpy(), dtype)
    return np.asarray(x, dtype)


class BaseObserver(nn.Layer):
    def __init__(self, quant_bits=8):
        super().__init__()
        self.quant_bits = quant_bits
        self._scale = None

    def scales(self):
        return self._scale

    def bit_length(self):
        return self.quant_bits


class AbsmaxObserver(BaseObserver):
    """The running max of |x| (a Python float); x passes through."""

    def forward(self, x):
        cur = _absmax(x)
        self._scale = cur if self._scale is None else max(self._scale, cur)
        return x


class EMAObserver(BaseObserver):
    """An exponential moving average of |x|'s max; x passes through."""

    def __init__(self, quant_bits=8, moving_rate=0.9):
        super().__init__(quant_bits)
        self.moving_rate = moving_rate

    def forward(self, x):
        cur = _absmax(x)
        self._scale = cur if self._scale is None else (
            self.moving_rate * self._scale + (1 - self.moving_rate) * cur)
        return x


class FakeQuanterWithAbsMax(BaseObserver):
    """QAT's quanter: the running absmax as the scale, and the fake-quant
    of x under it (straight-through gradient)."""

    def forward(self, x):
        cur = _absmax(x)
        self._scale = cur if self._scale is None else max(self._scale, cur)
        return _T["fake_quant_dequant"]["api"](x, self._scale,
                                               self.quant_bits)


class QuantedLinear(nn.Layer):
    """A Linear whose input and weight pass through the config's
    activation and weight quanters (the wrapped layer is ``inner``)."""

    def __init__(self, linear, q_config):
        super().__init__()
        self.inner = linear
        self.activation_quanter = q_config.make_activation()
        self.weight_quanter = q_config.make_weight()

    def forward(self, x):
        from ..nn import functional as F
        x = self.activation_quanter(x)
        w = self.weight_quanter(self.inner.weight)
        return F.linear(x, w, self.inner.bias)


class QuantConfig:
    """Which quanters a swapped layer gets (deep copies of `activation`
    and `weight`, default ``FakeQuanterWithAbsMax``)."""

    def __init__(self, activation=None, weight=None):
        self._activation = activation
        self._weight = weight
        self._layer_map = {nn.Linear: QuantedLinear,
                           nn.Conv2D: QuantedConv2D}

    def make_activation(self):
        return copy.deepcopy(self._activation) or FakeQuanterWithAbsMax()

    def make_weight(self):
        return copy.deepcopy(self._weight) or FakeQuanterWithAbsMax()

    def add_layer_config(self, layer, activation=None, weight=None):
        pass

    def add_type_config(self, layer_type, activation=None, weight=None):
        pass


def _swap_quant_layers(model, config):
    for name, sub in list(model._modules.items()):
        if sub is None:
            continue
        quanted = None
        for cls, qcls in config._layer_map.items():
            if isinstance(sub, cls):
                quanted = qcls(sub, config)
                break
        if quanted is not None:
            model._modules[name] = quanted
        else:
            _swap_quant_layers(sub, config)
    return model


class QAT:
    """Quantization-aware training: ``quantize`` swaps the model's
    Linear and Conv2D layers for their fake-quant forms (on a deep copy
    unless inplace)."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model, inplace=False):
        if not inplace:
            model = copy.deepcopy(model)
        if isinstance(model, nn.Linear):   # a bare layer, no container
            return QuantedLinear(model, self.config)
        return _swap_quant_layers(model, self.config)

    def convert(self, model, inplace=False):
        return model


class PTQ(QAT):
    """Post-training quantization: the same swap; the observers record
    their scales over calibration batches."""


def quant_post_static(*a, **kw):
    raise NotImplementedError("use PTQ(QuantConfig(...)).quantize(model)")


class ChannelWiseAbsmaxObserver(BaseObserver):
    """Per-channel absmax along `quant_axis` (a tensor of scales)."""

    def __init__(self, quant_bits=8, quant_axis=0):
        super().__init__(quant_bits)
        self.quant_axis = quant_axis

    def forward(self, x):
        axes = [i for i in range(x.dim()) if i != self.quant_axis]
        self._scale = x.detach().abs().amax(dim=axes)
        return x

    def quant_dequant(self, x):
        bound = 2 ** (self.quant_bits - 1) - 1
        shape = [1] * x.dim()
        shape[self.quant_axis] = -1
        s = torch.clamp_min(self._scale.reshape(shape), 1e-8)
        q = torch.clamp(torch.round(x / s * bound), -bound, bound) * s / bound
        # straight-through: identity gradient through the round and clip
        return x + (q - x).detach()


class FakeChannelWiseQuanter(ChannelWiseAbsmaxObserver):
    """QAT's per-channel quanter: observe, then fake-quant x."""

    def forward(self, x):
        super().forward(x)
        return self.quant_dequant(x)


class HistObserver(BaseObserver):
    """A histogram of |x| over the calibration batches (numpy, on the
    host); the scale is the bin edge that covers `percent` of the mass."""

    def __init__(self, quant_bits=8, bins_count=2048, percent=0.999):
        super().__init__(quant_bits)
        self.bins = bins_count
        self.percent = percent
        self._hist = None
        self._edges = None

    def forward(self, x):
        v = np.abs(_host(x))
        mx = float(v.max()) if v.size else 1.0
        if self._hist is None:
            self._edges = np.linspace(0, max(mx, 1e-8), self.bins + 1)
            self._hist = np.histogram(v, bins=self._edges)[0].astype(
                np.float64)
        else:
            if mx > self._edges[-1]:   # grow the range, rebin old mass
                new_edges = np.linspace(0, mx, self.bins + 1)
                centers = (self._edges[:-1] + self._edges[1:]) / 2
                self._hist = np.histogram(
                    centers, bins=new_edges, weights=self._hist)[0]
                self._edges = new_edges
            self._hist += np.histogram(v, bins=self._edges)[0]
        cdf = np.cumsum(self._hist) / max(self._hist.sum(), 1)
        idx = int(np.searchsorted(cdf, self.percent))
        self._scale = torch.tensor(self._edges[min(idx + 1, self.bins)],
                                   dtype=torch.float32, device=x.device)
        return x


class QuantedConv2D(nn.Layer):
    """A Conv2D whose input and weight pass through the quanters (the
    wrapped layer is ``conv``); NCHW, as the JAX layer."""

    def __init__(self, conv, q_config):
        super().__init__()
        self.conv = conv
        self.act_quanter = q_config.make_activation()
        self.w_quanter = q_config.make_weight()

    def forward(self, x):
        from ..nn import functional as F
        if self.act_quanter is not None:
            x = self.act_quanter(x)
        w = self.conv.weight
        if self.w_quanter is not None:
            w = self.w_quanter(w)
        return F.conv2d(x, w, self.conv.bias, stride=self.conv.stride,
                        padding=self.conv.padding,
                        dilation=self.conv.dilation, groups=self.conv.groups)


# ---------------------------------------------------------------------------
# KL-divergence calibration (TensorRT's entropy calibration, in Python
# floats on the host as the JAX package computes it)
# ---------------------------------------------------------------------------

def _expand_quantized_bins(quantized_bins, reference_bins):
    expanded = [0.0] * len(reference_bins)
    num_merged = max(1, int(len(reference_bins) / len(quantized_bins)))
    j_start, j_end = 0, num_merged
    for idx in range(len(quantized_bins)):
        seg = reference_bins[j_start:j_end]
        zero_count = sum(1 for v in seg if v == 0)
        nm = j_end - j_start
        avg = 0.0 if zero_count == nm else quantized_bins[idx] / (
            nm - zero_count)
        for j in range(j_start, j_end):
            expanded[j] = 0.0 if reference_bins[j] == 0 else avg
        j_start += nm
        j_end += nm
        if (idx + 1) == len(quantized_bins) - 1:
            j_end = len(reference_bins)
    return expanded


def _safe_entropy(p, p_sum, q, q_sum):
    import math
    s1 = s2 = 0.0
    for pi, qi in zip(p, q):
        if pi == 0:
            continue
        qi = max(qi, 1e-12)
        s1 += pi * math.log(q_sum * pi)
        s2 += pi * math.log(p_sum * qi)
    return (s1 - s2) / p_sum


def cal_kl_threshold(hist, bin_width, bits=8):
    """The clip threshold whose quantized distribution is closest (KL) to
    the histogram's: (best bin + 0.5) * bin_width."""
    hist = np.asarray(hist, np.float64)
    hist_bins = hist.shape[0]
    starting = int((hist_bins - 1) * 0.5)
    quant_range = 2 ** (bits - 1) - 1
    p_sum = float(hist.sum())
    best_kl, best_i, inited = 0.0, 0, False
    for i in range(starting, hist_bins):
        ref_p = hist[:i].tolist()
        if ref_p[i - 1] == 0:
            continue
        ref_p[i - 1] += float(hist[i:].sum())
        cand = hist[:i].tolist()
        num_merged = max(1, int(i / quant_range))
        q_quant = [0.0] * quant_range
        j_start, j_end = 0, num_merged
        for idx in range(quant_range):
            q_quant[idx] = sum(cand[j_start:j_end])
            j_start += num_merged
            j_end += num_merged
            if (idx + 1) == quant_range - 1:
                j_end = i
        q = _expand_quantized_bins(q_quant, ref_p)
        kl = _safe_entropy(ref_p, p_sum, q, sum(q))
        if not inited or kl < best_kl:
            best_kl, best_i, inited = kl, i, True
    if best_i == 0:
        best_i = starting or 1
    return (best_i + 0.5) * bin_width


class KLObserver(BaseObserver):
    """A histogram of |x| in float64 over the calibration batches (host
    numpy); ``scales()`` is the KL-optimal clip threshold."""

    def __init__(self, quant_bits=8, bins_count=2048):
        super().__init__(quant_bits=quant_bits)
        self._bins = bins_count
        self._hist = None
        self._edge = 0.0

    def forward(self, x):
        a = np.abs(_host(x, np.float64))
        mx = float(a.max()) if a.size else 0.0
        if self._hist is None:
            self._edge = max(mx, 1e-12)
            self._hist = np.histogram(a, bins=self._bins,
                                      range=(0, self._edge))[0].astype(
                                          np.float64)
        else:
            if mx > self._edge:
                # re-bin the old histogram into the wider range
                ratio = self._edge / mx
                old = self._hist
                self._hist = np.zeros(self._bins, np.float64)
                idx = (np.arange(self._bins) * ratio).astype(np.int64)
                np.add.at(self._hist, np.clip(idx, 0, self._bins - 1), old)
                self._edge = mx
            self._hist += np.histogram(a, bins=self._bins,
                                       range=(0, self._edge))[0]
        return x

    def scales(self):
        from .. import to_tensor
        if self._hist is None:
            return to_tensor(0.0)
        thr = cal_kl_threshold(self._hist, self._edge / self._bins,
                               self.quant_bits)
        return to_tensor(float(thr))


# ---------------------------------------------------------------------------
# weight-only int8 / int4
# ---------------------------------------------------------------------------

@register_op("weight_quantize", amp=False)
def weight_quantize(x, algo="weight_only_int8", arch=80, group_size=-1,
                    name=None):
    """x [k, n] floating -> (codes int8 [n, k] (paddle's transposed
    layout; int4 codes in [-7, 7], unpacked), float32 scales [n], or
    [n, k / group_size] with group_size > 0). Per output channel (or
    group) absmax / qmax, computed in x's type; codes round(w / scale),
    clipped."""
    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise NotImplementedError(f"algo {algo}")
    qmax = 127.0 if algo.endswith("int8") else 7.0
    # absmax * (1 / qmax): the JAX op's compiled division by a constant
    # multiplies by the reciprocal, and equal inputs then give bit-equal
    # scales (and codes)
    inv = 1.0 / qmax
    wt = x.t()                                      # [n, k]
    if group_size and group_size > 0:
        n, k = wt.shape
        g = k // group_size
        wg = wt.reshape(n, g, group_size)
        scale = wg.abs().amax(dim=-1) * inv                     # [n, g]
        q = torch.clamp(torch.round(
            wg / torch.clamp_min(scale[..., None], 1e-9)), -qmax,
            qmax).to(torch.int8).reshape(n, k)
    else:
        scale = wt.abs().amax(dim=-1) * inv                     # [n]
        q = torch.clamp(torch.round(
            wt / torch.clamp_min(scale[:, None], 1e-9)), -qmax,
            qmax).to(torch.int8)
    return q, scale.to(torch.float32)


@register_op("weight_only_linear", amp=False)
def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=80, group_size=-1,
                       name=None):
    """x [..., k] @ dequant(weight [n, k]).T (+ bias) -> [..., n]: the
    codes widen to x's type and take their scales in it, then one
    ``torch.matmul``."""
    w = weight.to(x.dtype)
    if weight_scale is not None:
        if weight_scale.dim() == 2:                 # grouped [n, g]
            n, k = w.shape
            g = weight_scale.shape[1]
            w = (w.reshape(n, g, k // g)
                 * weight_scale[:, :, None].to(x.dtype)).reshape(n, k)
        else:
            w = w * weight_scale[:, None].to(x.dtype)
    out = torch.matmul(x, w.t())
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# PTQ as a graph-compiler rewrite
# ---------------------------------------------------------------------------

def _match_linear_matmul(g):
    """Linear products in a captured ATen graph: ``aten.mm(x, W)`` with W
    a rank-2 floating program input (placeholder or get_attr: a
    parameter), x floating. Batched products (attention's ``bmm``) and
    products whose right operand is computed never match."""
    from ..compiler.patterns import Candidate, val
    out = []
    for n in g.graph.nodes:
        if n.op != "call_function" or n.target is not torch.ops.aten.mm.default:
            continue
        x_n, w_n = n.args[0], n.args[1]
        if not (isinstance(x_n, torch.fx.Node) and
                isinstance(w_n, torch.fx.Node)):
            continue
        if w_n.op not in ("placeholder", "get_attr"):
            continue
        xv, wv = val(x_n), val(w_n)
        if not (isinstance(xv, torch.Tensor) and isinstance(wv, torch.Tensor)):
            continue
        if wv.dim() != 2 or xv.dim() < 2:
            continue
        if not (xv.is_floating_point() and wv.is_floating_point()):
            continue
        out.append(Candidate("quant_linear", n, [x_n, w_n],
                             {"in_features": int(wv.shape[0]),
                              "out_features": int(wv.shape[1])}))
    return out


def quantize_pass(bit_length=8, weight_only=False):
    """A PTQ rewrite pass over captured programs (the compiler's pattern
    engine, ``compiler.rewrites.make_fused_pass``): every linear product
    ``x @ W`` becomes

        fake_quant_dequant(x, absmax(x)) @ fake_quant_dequant(W, absmax(W))

    (per-tensor absmax of the live tensors, straight-through gradient;
    weight_only keeps x unquantized), so plain-op models quantize with no
    change to the model. Use with the compiler::

        pm = compiler.PassManager([quantize_pass(), "dce"])
        qfn = compiler.optimize(fn, pass_manager=pm)
    """
    from ..compiler import rewrites as _rw

    def builder(cand):
        fq = _T["fake_quant_dequant"]["fn"]

        def fused_quant_linear(x, w):
            wq = fq(w, w.abs().amax(), bit_length)
            if not weight_only:
                x = fq(x, x.abs().amax(), bit_length)
            return torch.mm(x, wq)
        return fused_quant_linear

    return _rw.make_fused_pass("quant_linear", _match_linear_matmul, builder)


class BaseQuanter:
    """The quanter-layer contract (observers and fake-quant layers)."""

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        raise NotImplementedError


def quanter(name):
    """Decorator registering a quanter class under a config name."""
    def deco(cls):
        _QUANTER_REGISTRY[name] = cls
        return cls
    return deco


_QUANTER_REGISTRY = {}
