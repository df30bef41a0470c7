"""paddle_tpu_torch — the PyTorch + CUDA counterpart of ``paddle_tpu``.

This package serves Llama and GPT through the paged continuous-batching
engine (one engine, or a fleet of replicas behind a router) and trains Llama, GPT and BERT (``model(ids, labels=labels)``,
``compile_train_step``, every optimizer and learning-rate scheduler of
``paddle_tpu``, mixed precision with loss scaling, activation recompute,
checkpoints) on one NVIDIA Hopper card, with flashmask attention, the
transformer layers and the fused ``incubate.nn`` layers beside. The plain tensor code is PyTorch; every kernel that
``paddle_tpu`` writes in Pallas for the TPU is a CUDA C++ kernel written
for ``sm_90a`` under ``csrc/``, built at first use by
``ops.kernels._build`` and launched through ``ctypes``.

The op surface is the counterpart of ``import paddle_tpu as paddle;
paddle.<op>(...)``: the JAX package's top-level ops (``ops.impl``:
creation, math, manipulation, reduce, logic, linalg, activation, fused,
extra, and the detection and legacy ops; ``tensor_tail``; the ``fft``,
``signal`` and ``linalg`` namespaces; ``nn.functional``'s ops, loaded at
their first use) as functions over ``torch.Tensor``, with ``autograd``,
``device`` and the dtypes. Its decisions:

1. Functions, no patching. The JAX package installs each op as a method
   of its own ``Tensor``; the port never adds or replaces an attribute of
   ``torch.Tensor`` (that would change torch for every library in the
   process, and clash where a Paddle name means something else than
   torch's method: ``split``, ``gather``, ``scatter``, ``tile``, ``max``).
   A method form's counterpart is the top-level function; ``Tensor`` and
   ``Parameter`` are torch's, exported as names only.
2. In-place forms: ``name_(x, ...)`` writes the result into ``x`` and
   returns ``x`` (the JAX package rebinds ``x``).
3. A new tensor goes to the current device (``set_device``): CUDA unless
   ``set_device("cpu")``, a ``place=`` or a ``device=`` says otherwise;
   with no card and no CPU request, creation raises. Ops over existing
   tensors run where their inputs are.
4. Random ops draw from the port's generators (``seed``), not
   ``jax.random``'s streams.
5. Importing the package builds and launches no kernel: the fused names
   load the kernel modules at their first call.

Every op call goes through ``amp.amp_cast`` under the JAX name
(``ops.registry``): ``auto_cast`` casts it as the JAX dispatcher does,
``amp.debugging``'s operator stats count it and ``FLAGS_check_nan_inf``
checks its outputs.

Layout (each module names its ``paddle_tpu`` counterpart):

- ``device``: places, ``set_device`` / ``get_device``, the card's memory
  statistics, streams and events; ``resolve_device`` (CUDA unless the
  caller asks for the CPU).
- ``ops.registry``, ``ops.impl``, ``tensor_tail``, ``fft``, ``signal``,
  ``linalg``, ``strings``: the op surface; ``autograd`` (``PyLayer``,
  ``grad``, the functional forms) and ``incubate.autograd``;
  ``framework.dtype``: the dtype names and the default float type.
- ``ops.kernels``: the kernel wrappers (ragged paged attention, paged
  decode attention and their int8 twins, RMSNorm, SwiGLU, flash attention
  forward and backward with and without a flashmask range mask, fused
  RoPE, bias + dropout + residual + LayerNorm), each beside its plain
  PyTorch version and a launch counter, and the custom ops over them
  (``torch.ops.ptt.*``, ``ops.kernels._ops``).
- ``compiler``: the graph compiler (fx capture, the pass pipeline,
  pattern fusion onto the kernels' ops).
- ``framework.random``: a default generator per device and ``seed``.
- ``quantization.page_quant``: int8 KV page codes and the offset-0 scale
  freeze rule.
- ``nn``: the ``Layer`` base and ``ParamAttr``, the initializers, the
  functional surface (conv, pooling, norms, resize, losses, masked
  attention and ``flashmask_attention``, the tail losses and the packed
  flash entry points), the layers and containers, the RNNs,
  ``nn.transformer`` (multi-head attention with its caches, the encoder
  and decoder stacks, ``Transformer``), ``nn.utils`` (weight and
  spectral norm) and the gradient clips.
- ``incubate.nn``: the fused functionals (the FFN and attention blocks,
  their epilogues, RoPE, paged and dense-cache decode attention) and the
  fused layers.
- ``vision``: the model zoo (ResNet ... InceptionV3), ``transforms``,
  ``datasets`` and the detection ops; ``hapi``: ``Model`` (``fit``,
  ``evaluate``, ``predict``, ``save`` / ``load``) and ``summary``, also
  top-level names; ``metric``: ``Accuracy``, ``Precision``, ``Recall``,
  ``Auc``.
- ``models.llama``, ``models.gpt``: the decoder LMs, their losses and the
  paged-model contract (``apply_llama_remat``: recompute per layer);
  ``models.bert``: the encoder and its heads; ``models.unet``: the
  diffusion UNet and its DDPM loss.
- ``optimizer``: the SGD and Adam families, ASGD, Rprop and LBFGS (fp32
  masters), the learning-rate schedulers (``optimizer.lr``),
  regularizers, gradient clipping.
- ``amp``: ``auto_cast`` (O1/O2 under the JAX op lists), ``decorate``,
  ``GradScaler``; ``amp.debugging`` (the NaN/Inf checker and operator
  stats at the named op sites, ``compare_accuracy``).
- ``distributed``: ``fleet.utils.recompute`` (activation recompute that
  replays the port's random draws), ``checkpoint`` (the JAX package's
  file format, one process), ``watchdog`` (``watched_wait``,
  ``CommTimeoutError``), ``fleet.elastic`` (heartbeats over a store) and
  ``resilient`` (``ResilientTrainer``, ``BadStepGuard``).
- ``io``: datasets, samplers and ``DataLoader`` (thread prefetch,
  shared-memory workers); ``framework.io``: ``save`` / ``load`` (the
  JAX package's pickle format, top-level names too); ``profiler``: ``Profiler`` on
  ``torch.profiler`` with the JAX scheduler, ``RecordEvent``.
- ``framework``: the random generators and the runtime flags.
- ``jit``: ``compile_train_step`` (eager, or its fused program) and
  ``to_static``.
- ``weights``: the bridge from ``paddle_tpu`` parameters (as numpy arrays)
  and seeded random weights.
- ``inference.engine``: ``GenerationEngine`` and ``BlockManager``, with
  the KV-page surface (export, import, spill and refill);
  ``inference.programs``: its step programs (CUDA graphs on the card).
- ``serving``: the fleet: ``Router``, ``LocalReplica``, ``ProcessReplica``
  and its worker, ``Supervisor``, ``FileStore``, and ``kv_transfer``
  (the kvpages/v1 codec, byte-compatible with ``paddle_tpu``'s, and
  ``PrefixStore``).
- ``observability``: the metrics registry, events, tracing, costs,
  exporters and the doctor (stdlib only; the port's own registry), the
  step-scope ledger ``perf`` (goodput, MFU) and ``xla_introspect``
  (program flops, bytes and the HBM ledger).

Nothing here imports JAX or ``paddle_tpu``.
"""

import numpy as _np

from .device import (CPUPlace, CUDAPlace, CustomPlace, get_device,
                     is_compiled_with_cuda, is_compiled_with_custom_device,
                     is_compiled_with_distribute, is_compiled_with_rocm,
                     is_compiled_with_xpu, resolve_device, set_device)
from .framework.dtype import (bfloat16, complex64, complex128, float16,
                              float32, float64, get_default_dtype, int8,
                              int16, int32, int64, set_default_dtype, uint8)
from .framework.dtype import bool_ as bool  # noqa: A001
from .framework.flags import get_flags, set_flags
from .framework.random import (default_generator, get_rng_state, seed,
                               set_rng_state)

import torch as _torch  # noqa: E402

Tensor = _torch.Tensor
Parameter = _torch.nn.Parameter

from . import autograd  # noqa: E402
from .autograd import (PyLayer, enable_grad, grad,  # noqa: E402
                       is_grad_enabled, no_grad)

# --- the op surface (the registry fills this namespace) ---------------------
from .ops import registry as _registry  # noqa: E402
from .ops.impl import (activation as _activation,  # noqa: E402,F401
                       creation as _creation, detection as _detection,
                       extra as _extra, fused as _fused,
                       fused_inference as _fused_inference,
                       linalg as _linalg_impl, logic as _logic,
                       manipulation as _manipulation, math as _math,
                       misc_legacy as _misc_legacy, reduce as _reduce,
                       sampling_legacy as _sampling_legacy)
from . import tensor_tail as _tensor_tail  # noqa: E402

_registry.export_namespace(globals())
_tensor_tail.install(globals())

from . import fft, linalg, signal, strings  # noqa: E402,F401
from . import version  # noqa: E402,F401
from .version import full_version as __version__  # noqa: E402,F401


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor from `data` (a tensor, a numpy array, a list or a
    scalar), on `place` or the current device (a tensor stays where it
    is). As the JAX package: Python floats take the default float type,
    int32 lists int64, numpy arrays keep their type. stop_gradient=False
    makes it require grad."""
    from .framework.dtype import convert_dtype
    from .ops.impl._common import device_of
    if isinstance(data, _torch.Tensor):
        out = data.detach().clone()
        if place is not None:
            out = out.to(device_of(place=place))
    else:
        arr = _np.asarray(data)
        out = _torch.as_tensor(arr.copy(), device=device_of(place=place))
        if dtype is None and not isinstance(data, _np.ndarray):
            if arr.dtype == _np.float64:
                out = out.to(get_default_dtype())
            elif arr.dtype == _np.int32:
                out = out.to(int64)
    if dtype is not None:
        out = out.to(convert_dtype(dtype))
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def tensor(data, dtype=None, place=None, stop_gradient=True):
    return to_tensor(data, dtype, place, stop_gradient)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A ``torch.nn.Parameter`` of `shape` on the current device: zeros
    for a bias, else Xavier-normal; default_initializer, a callable, fills
    it in place instead (``torch.nn.init`` style)."""
    from .framework.dtype import convert_dtype
    from .ops.impl._common import device_of, shape_of
    t = _torch.empty(shape_of(shape), dtype=convert_dtype(dtype),
                     device=device_of())
    with _torch.no_grad():
        if default_initializer is not None:
            default_initializer(t)
        elif is_bias:
            t.zero_()
        else:
            gen = default_generator(t.device)
            fan_in = t.shape[0] if t.dim() else 1
            fan_out = t.shape[1] if t.dim() > 1 else fan_in
            std = (2.0 / (fan_in + fan_out)) ** 0.5
            t.normal_(0.0, std, generator=gen)
    return Parameter(t)


def in_dynamic_mode():
    return True


def in_dynamic_or_pir_mode():
    return True


def disable_static(place=None):
    pass


def enable_static():
    raise NotImplementedError(
        "paddle_tpu_torch has one execution world: eager torch, captured by "
        "jit.to_static; there is no static Program mode")


def is_grad_enabled_():
    return is_grad_enabled()


# subpackages load on first use, so that ``import paddle_tpu_torch`` stays
# light: ``paddle_tpu_torch.nn.Linear`` works through __getattr__
_LAZY = {"amp", "audio", "compiler", "distributed", "framework",
         "geometric", "hapi", "hub", "incubate", "inference", "io", "jit",
         "metric", "models", "nn", "observability", "onnx", "optimizer",
         "profiler", "quantization", "regularizer", "serving",
         "text", "utils", "vision", "weights"}
# top-level names of lazy subpackages, as the JAX package exports them
_LAZY_NAMES = {"Model": "hapi", "summary": "hapi", "ParamAttr": "nn",
               "DataParallel": "distributed"}

from .framework.io import load, save  # noqa: E402


def __getattr__(name):
    if name in _LAZY or name in _LAZY_NAMES:
        import importlib
        mod = importlib.import_module(f".{_LAZY_NAMES.get(name, name)}",
                                      __name__)
        value = getattr(mod, name) if name in _LAZY_NAMES else mod
        globals()[name] = value
        return value
    if not name.startswith("__"):
        # nn.functional's ops (and the rnn layers' op) are top-level names
        # too, as in the JAX package; importing nn registers them
        from . import nn  # noqa: F401
        entry = _registry.OP_TABLE.get(name)
        if entry is not None:
            globals()[name] = entry["api"]
            return entry["api"]
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"'{name}'")
