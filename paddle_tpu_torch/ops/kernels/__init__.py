"""The port's hand-written kernels, one module each, every one beside its
plain PyTorch version and a launch counter (``<wrapper>.launches``, bumped
only where the wrapper launches its CUDA kernel).

A wrapper given a CPU tensor computes the plain version; given a CUDA
tensor it launches the kernel built from ``paddle_tpu_torch/csrc`` (see
``_build``) or raises. Nothing falls back.

The flash and ragged wrappers take one of two routes (``ROUTES``),
counted apart: tensor-core kernels for bf16/f16 with head dim 64 or 128
(ragged: and pages of a multiple of 8 tokens), float32 SIMT kernels for
the rest (``flash_attention.route``, ``ragged_attention.route``).

The differentiable forms (``FlashAttention``, ``FlashmaskAttention``,
``RMSNorm``, ``SwiGLU``, ``FusedRoPE``, ``FusedRoPEQK``,
``BiasDropoutResidualLN``, each with an ``apply``) are ``torch.library``
custom ops in the ``ptt`` namespace (``_ops``), so that a capture records
each kernel as one node with its own backward; each op runs a wrapper
forward. Flash attention's
backward is a kernel too (``flash_attention_bwd``,
``flashmask_attention_bwd``), as the TPU's is, and so is RoPE's
(``fused_rope_bwd``, the RoPE kernel's transposed form); the others'
backwards are plain PyTorch (``*_bwd_plain``), as the JAX package computes
them in XLA outside Pallas. The flashmask wrappers launch
the flash kernels with a range mask and count their launches apart.
"""

from __future__ import annotations

from ._ops import (BiasDropoutResidualLN, FlashAttention,
                   FlashmaskAttention, FusedRoPE, FusedRoPEQK, RMSNorm,
                   SwiGLU)
from .bias_dropout_residual_ln import (bias_dropout_residual_ln,
                                       bias_dropout_residual_ln_bwd_plain,
                                       bias_dropout_residual_ln_plain)
from .decode_attention import (paged_decode_attention,
                               paged_decode_attention_plain,
                               paged_decode_attention_split_plain,
                               split_plan)
from .flash_attention import (flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_fwd_plain,
                              flashmask_attention_bwd,
                              flashmask_attention_bwd_plain,
                              flashmask_attention_fwd,
                              flashmask_attention_fwd_plain)
from .quantized_attention import (paged_decode_attention_int8,
                                  paged_decode_attention_int8_plain,
                                  paged_decode_attention_int8_split_plain,
                                  ragged_paged_attention_int8,
                                  ragged_paged_attention_int8_plain,
                                  ragged_paged_attention_int8_tiled_plain)
from .ragged_attention import (ragged_paged_attention,
                               ragged_paged_attention_plain,
                               ragged_paged_attention_tiled_plain)
from .rms_norm import rms_norm, rms_norm_bwd_plain, rms_norm_plain
from .rope import (fused_rope, fused_rope_bwd,
                   fused_rope_bwd_plain, fused_rope_plain, fused_rope_qk,
                   fused_rope_rows_plain)
from .swiglu import swiglu, swiglu_bwd_plain, swiglu_plain

# wrapper -> (CUDA source it launches, TPU kernel it replaces)
KERNELS = {
    # the tensor-core route; float32 and pages of 4 take SIMT_SOURCES
    "ragged_paged_attention": (
        ragged_paged_attention, "paddle_tpu_torch/csrc/ragged_sm90.cu",
        "paddle_tpu/ops/pallas/ragged_attention.py:204"),
    "paged_decode_attention": (
        paged_decode_attention, "paddle_tpu_torch/csrc/decode_attention.cu",
        "paddle_tpu/ops/pallas/decode_attention.py:202"),
    "rms_norm": (
        rms_norm, "paddle_tpu_torch/csrc/rms_norm.cu",
        "paddle_tpu/ops/pallas/norms.py:61"),
    "swiglu": (
        swiglu, "paddle_tpu_torch/csrc/swiglu.cu",
        "paddle_tpu/ops/pallas/fused_ffn.py:58"),
    # one CUDA kernel for the TPU kernel and the JAX package's
    # Pallas-on-GPU lowering of the same function (the tensor-core route;
    # float32 takes SIMT_SOURCES)
    "flash_attention": (
        flash_attention_fwd, "paddle_tpu_torch/csrc/flash_fwd_sm90.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:183; "
        "paddle_tpu/ops/primitive/lowering_gpu.py:98"),
    # every forward launch of the RoPE kernel: q alone, q and k together,
    # [S, D] tables or per-token rows (the Llama's _rope_rows)
    "fused_rope": (
        fused_rope, "paddle_tpu_torch/csrc/rope.cu",
        "paddle_tpu/ops/pallas/norms.py:131"),
    # the same kernel's transposed form: the vjp the JAX package takes in
    # XLA beside the TPU kernel (_rope_bwd)
    "fused_rope_bwd": (
        fused_rope_bwd, "paddle_tpu_torch/csrc/rope.cu",
        "paddle_tpu/ops/pallas/norms.py:131 (vjp _rope_bwd :150)"),
    # one C entry launching a dQ kernel and a dK/dV kernel, for the TPU
    # backward's two pallas_calls
    "flash_attention_bwd": (
        flash_attention_bwd, "paddle_tpu_torch/csrc/flash_bwd_sm90.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:360; :393"),
    # int8 code pages with per-page scales: the tensor-core kernel's int8
    # instantiation (the SIMT route: the float kernel's template)
    "ragged_paged_attention_int8": (
        ragged_paged_attention_int8, "paddle_tpu_torch/csrc/ragged_sm90.cu",
        "paddle_tpu/ops/pallas/quantized_attention.py:331"),
    "paged_decode_attention_int8": (
        paged_decode_attention_int8,
        "paddle_tpu_torch/csrc/quantized_attention.cu",
        "paddle_tpu/ops/pallas/quantized_attention.py:213"),
    # the flash kernels with the range mask (template over the count of
    # intervals), counted apart from the unmasked launches
    "flashmask_attention": (
        flashmask_attention_fwd, "paddle_tpu_torch/csrc/flash_fwd_sm90.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:183 (_range_mask :208)"),
    "flashmask_attention_bwd": (
        flashmask_attention_bwd,
        "paddle_tpu_torch/csrc/flash_bwd_sm90.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:360; :393 "
        "(_range_mask :208)"),
    "bias_dropout_residual_ln": (
        bias_dropout_residual_ln,
        "paddle_tpu_torch/csrc/bias_dropout_residual_ln.cu",
        "paddle_tpu/ops/pallas/fused_ffn.py:153"),
}


# the flash and ragged wrappers launch one of two routes by type and
# shape (flash_attention.route, ragged_attention.route): "sm90" (tensor
# cores, bf16/f16, D 64 or 128) or "simt" (float32 CUDA cores, every other
# case)
ROUTES = ("sm90", "simt")
ROUTED = ("flash_attention", "flash_attention_bwd", "flashmask_attention",
          "flashmask_attention_bwd", "ragged_paged_attention",
          "ragged_paged_attention_int8")
# the SIMT route's source of each routed wrapper
SIMT_SOURCES = {
    "ragged_paged_attention": "paddle_tpu_torch/csrc/ragged_attention.cu",
    "ragged_paged_attention_int8":
        "paddle_tpu_torch/csrc/quantized_attention.cu",
    "flash_attention": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "flashmask_attention": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flashmask_attention_bwd": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
}


# parts of a kernel's launches counted apart: "<name>.<part>" -> (the
# wrapper holding the count, its attribute); RoPE's q + k launches and
# each RoPE form's launches on the scalar path
PARTS = {"fused_rope.qk": (fused_rope_qk, "launches"),
         "fused_rope.scalar": (fused_rope, "scalar_launches"),
         "fused_rope_bwd.scalar": (fused_rope_bwd, "scalar_launches")}


def launch_counts():
    """{kernel name: launches since the last reset}; the routed kernels
    also by route, as "<name>.sm90" and "<name>.simt", and the PARTS."""
    out = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
    for name in ROUTED:
        fn = KERNELS[name][0]
        for rt in ROUTES:
            out[f"{name}.{rt}"] = getattr(fn, f"{rt}_launches")
    for part, (fn, attr) in PARTS.items():
        out[part] = getattr(fn, attr)
    return out


def reset_launch_counts():
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    for name in ROUTED:
        for rt in ROUTES:
            setattr(KERNELS[name][0], f"{rt}_launches", 0)
    for fn, attr in PARTS.values():
        setattr(fn, attr, 0)


def _counter(key):
    """(wrapper, attribute) holding the count that ``launch_counts``
    names `key`."""
    if key in KERNELS:
        return KERNELS[key][0], "launches"
    if key in PARTS:
        return PARTS[key]
    name, rt = key.rsplit(".", 1)
    return KERNELS[name][0], f"{rt}_launches"


def add_launch_counts(delta, sign=1):
    """Add `sign` times a {name: launches} delta, keyed as
    ``launch_counts`` keys it, to the counters: the launches of a replayed
    CUDA graph, whose wrappers ran only at its capture
    (``inference.programs``)."""
    for key, n in delta.items():
        fn, attr = _counter(key)
        setattr(fn, attr, getattr(fn, attr) + sign * n)


__all__ = ["KERNELS", "PARTS", "ROUTED", "ROUTES", "SIMT_SOURCES",
           "add_launch_counts", "launch_counts", "reset_launch_counts",
           "BiasDropoutResidualLN", "FlashAttention", "FlashmaskAttention",
           "FusedRoPE", "FusedRoPEQK", "RMSNorm", "SwiGLU",
           "bias_dropout_residual_ln",
           "bias_dropout_residual_ln_bwd_plain",
           "bias_dropout_residual_ln_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_fwd_plain",
           "flashmask_attention_bwd", "flashmask_attention_bwd_plain",
           "flashmask_attention_fwd", "flashmask_attention_fwd_plain",
           "fused_rope", "fused_rope_bwd", "fused_rope_bwd_plain",
           "fused_rope_plain", "fused_rope_qk", "fused_rope_rows_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "paged_decode_attention_split_plain",
           "paged_decode_attention_int8", "paged_decode_attention_int8_plain",
           "paged_decode_attention_int8_split_plain",
           "ragged_paged_attention", "ragged_paged_attention_plain",
           "ragged_paged_attention_tiled_plain",
           "ragged_paged_attention_int8", "ragged_paged_attention_int8_plain",
           "ragged_paged_attention_int8_tiled_plain",
           "rms_norm", "rms_norm_bwd_plain", "rms_norm_plain", "split_plan",
           "swiglu",
           "swiglu_bwd_plain", "swiglu_plain"]
