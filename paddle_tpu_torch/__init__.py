"""paddle_tpu_torch — the PyTorch + CUDA counterpart of ``paddle_tpu``.

This package serves Llama and GPT through the paged continuous-batching
engine and trains Llama, GPT and BERT (``model(ids, labels=labels)``,
``compile_train_step``, every optimizer and learning-rate scheduler of
``paddle_tpu``, mixed precision with loss scaling, activation recompute,
checkpoints) on one NVIDIA Hopper card, with flashmask attention, the
transformer layers and the fused ``incubate.nn`` layers beside. The plain tensor code is PyTorch; every kernel that
``paddle_tpu`` writes in Pallas for the TPU is a CUDA C++ kernel written
for ``sm_90a`` under ``csrc/``, built at first use by
``ops.kernels._build`` and launched through ``ctypes``.

Layout (each module names its ``paddle_tpu`` counterpart):

- ``device``: device resolution (CUDA unless the caller asks for the CPU).
- ``ops.kernels``: the kernel wrappers (ragged paged attention, paged
  decode attention and their int8 twins, RMSNorm, SwiGLU, flash attention
  forward and backward with and without a flashmask range mask, fused
  RoPE, bias + dropout + residual + LayerNorm), each beside its plain
  PyTorch version and a launch counter, and the autograd functions over
  them.
- ``framework.random``: a default generator per device and ``seed``.
- ``quantization.page_quant``: int8 KV page codes and the offset-0 scale
  freeze rule.
- ``nn``: functional surface (with the losses, masked attention and
  ``flashmask_attention``), the layers and containers, and
  ``nn.transformer`` (multi-head attention with its caches, the encoder
  and decoder stacks, ``Transformer``).
- ``incubate.nn``: the fused functionals (the FFN and attention blocks,
  their epilogues, RoPE, paged and dense-cache decode attention) and the
  fused layers.
- ``models.llama``, ``models.gpt``: the decoder LMs, their losses and the
  paged-model contract (``apply_llama_remat``: recompute per layer);
  ``models.bert``: the encoder and its heads.
- ``optimizer``: the SGD and Adam families, ASGD, Rprop and LBFGS (fp32
  masters), the learning-rate schedulers (``optimizer.lr``),
  regularizers, gradient clipping.
- ``amp``: ``auto_cast`` (O1/O2 under the JAX op lists), ``decorate``,
  ``GradScaler``.
- ``distributed``: ``fleet.utils.recompute`` (activation recompute that
  replays the port's random draws) and ``checkpoint`` (the JAX package's
  file format, one process).
- ``jit``: ``compile_train_step`` (eager).
- ``weights``: the bridge from ``paddle_tpu`` parameters (as numpy arrays)
  and seeded random weights.
- ``inference.engine``: ``GenerationEngine`` and ``BlockManager``.

Nothing here imports JAX or ``paddle_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
