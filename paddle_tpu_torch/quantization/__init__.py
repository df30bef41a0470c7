"""Quantization: the counterpart of ``paddle_tpu/quantization/__init__.py``
(fake quant with the straight-through estimator, the observers and
quanters, ``QuantConfig``, ``QAT`` and ``PTQ`` over swapped layers, KL
calibration, the weight-only int8/int4 ops and ``quantize_pass``, the
PTQ rewrite on the graph compiler), beside ``page_quant`` (the int8 KV
page codes of the serving path).

The API lives in ``quant`` and loads at the first use of one of its
names (importing ``quant`` registers its ops). Everything here is plain
PyTorch on the card too: the JAX package computes it in XLA outside any
Pallas kernel. The quant/dequant pair is
``page_quant``'s ``quant_codes`` / ``dequant_codes``, so calibrated scales
mean one thing in both paths, as in the JAX package.

How it matches the JAX package:

- ``fake_quant_dequant`` returns ``x + (q - x).detach()`` (JAX's
  ``x + stop_gradient(q - x)``): the forward is q, the gradient the
  identity (not clipped, whatever the JAX docstring says). A Python float
  scale takes x's type first, as a weakly typed JAX scalar does;
- the observers read their absmax on the host (``float(...)``, a sync per
  call, as ``float(jnp.max(...))`` is in JAX), ``HistObserver`` and
  ``KLObserver`` keep their histograms in numpy on the host (the JAX
  observers do);
- ``QAT`` and ``PTQ`` swap every port ``nn.Linear`` / ``nn.Conv2D``
  sub-layer for ``QuantedLinear`` / ``QuantedConv2D`` (the wrapped layer
  stays as ``inner`` / ``conv``, so parameter names are the JAX layer's);
  a model reaches the swapped products only where it calls the
  sub-layer, in both packages alike (the Llama's fused loss reads
  ``lm_head.weight`` itself there too);
- ``weight_quantize`` returns paddle's transposed layout, int8 codes
  ``[n, k]`` (int4 codes in int8 storage, unpacked) and float32 scales
  ``[n]`` or ``[n, k / group_size]``; ``torch.round`` rounds half to even
  as ``jnp.round`` does, so equal inputs give bit-equal codes;
- ``quantize_pass`` matches what the JAX matcher matches on an ATen
  graph: an ``aten.mm`` whose right operand is a rank-2 floating program
  input (a parameter placeholder of a module program, a ``get_attr``
  constant), never a batched product (``bmm``) or a computed right-hand
  side (a transposed weight is computed).
"""

from . import page_quant

# the layers and ops (``quant``) load on first use: the kernel modules
# import ``page_quant`` while ``nn`` is itself loading, and ``quant``
# needs a loaded ``nn``
_QUANT_NAMES = frozenset([
    "fake_quant_dequant", "BaseObserver", "AbsmaxObserver", "EMAObserver",
    "FakeQuanterWithAbsMax", "ChannelWiseAbsmaxObserver",
    "FakeChannelWiseQuanter", "HistObserver", "KLObserver", "QuantedLinear",
    "QuantedConv2D", "QuantConfig", "QAT", "PTQ", "quant_post_static",
    "cal_kl_threshold", "weight_quantize", "weight_only_linear",
    "quantize_pass", "BaseQuanter", "quanter"])

__all__ = ["page_quant", *sorted(_QUANT_NAMES)]


def __getattr__(name):
    if name in _QUANT_NAMES or name == "quant":
        import importlib
        quant = importlib.import_module(__name__ + ".quant")
        return quant if name == "quant" else getattr(quant, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
