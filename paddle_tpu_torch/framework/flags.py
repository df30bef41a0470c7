"""Runtime flags: the counterpart of ``paddle_tpu/framework/flags.py``.

Each flag is defined with a default, overridable through its
``FLAGS_<name>`` environment variable (Paddle's convention) and at run time
through ``set_flags`` / ``get_flag``. The port defines every flag that the
JAX package defines once its modules are imported, under the same name,
default and doc (``_META``); an unknown name raises.

Flags that act in the port:

- ``FLAGS_check_nan_inf``: ``amp.debugging``'s checker and the op
  registry scan op outputs;
- ``FLAGS_benchmark``: the op registry synchronizes the card after each
  surface op (``ops.registry``), as the JAX doc says;
- ``FLAGS_cudnn_deterministic``: sets ``torch.backends.cudnn.deterministic``
  (and clears ``torch.backends.cudnn.benchmark`` when set) at import and
  whenever ``set_flags`` changes it;
- ``FLAGS_comm_timeout_s``: ``distributed.watchdog``'s deadline;
- ``FLAGS_jaxpr_fusion``: the graph compiler's default (``compiler``; its
  default comes from the ``PADDLE_TPU_FUSION`` environment variable, as in
  the JAX package).

The others are kept without effect, as the JAX package keeps its compat
flags: they name TPU mechanisms (Pallas block sizes, the kernel-primitive
backend, per-op jitted executables) that the port does not have, or
behaviour the port always has (``fused_lm_head_ce``: the Llama's loss is
always the fused one).

``FLAGS_EPOCH`` counts the ``set_flags`` calls: a cache of captured
programs that may have read a flag while capturing keys on it, so that a
flag flip captures again (``compiler.optimize``).
"""

from __future__ import annotations

import os

_FLAGS = {}
_META = {}
# bumped on every set_flags (see the module docstring)
FLAGS_EPOCH = [0]


def define_flag(name, default, help=""):  # noqa: A002
    """Define flag `name` (`help` is its doc, kept in ``_META``)."""
    env = os.environ.get(f"FLAGS_{name}")
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _FLAGS[name] = value
    _META[name] = {"default": default, "help": help}
    return value


def _apply_cudnn_deterministic():
    import torch
    on = bool(_FLAGS["cudnn_deterministic"])
    torch.backends.cudnn.deterministic = on
    if on:
        torch.backends.cudnn.benchmark = False


def set_flags(flags: dict):
    for k, v in flags.items():
        k = k.removeprefix("FLAGS_")
        if k not in _FLAGS:
            raise ValueError(f"unknown flag {k}")
        _FLAGS[k] = v
        if k == "cudnn_deterministic":
            _apply_cudnn_deterministic()
    FLAGS_EPOCH[0] += 1


def get_flags(names):
    """{"FLAGS_<name>": value} for a name or a list of names."""
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{n.removeprefix('FLAGS_')}":
            _FLAGS[n.removeprefix("FLAGS_")] for n in names}


def get_flag(name):
    return _FLAGS[name.removeprefix("FLAGS_")]


# --- paddle_tpu/framework/flags.py:61-93 -----------------------------------
define_flag("check_nan_inf", False,
            "scan op outputs for nan/inf each eager op "
            "(ref: FLAGS_check_nan_inf)")
define_flag("benchmark", False, "sync after each op for timing")
define_flag("eager_op_jit", True,
            "cache per-op jitted executables for eager dispatch")
define_flag("use_pallas_kernels", True,
            "use Pallas fused kernels (flash attn, rmsnorm) when on TPU")
define_flag("moe_sorted_dispatch", True,
            "sort-based MoE token dispatch (O(E*C*H) memory) instead of\n"
            "the one-hot [T,E,C] einsum formulation")
define_flag("pallas_force", False,
            "route to Pallas kernels regardless of backend (cross-platform "
            "AOT lowering audits; would crash an actual CPU execution)")
define_flag("jaxpr_fusion",
            os.environ.get("PADDLE_TPU_FUSION", "0").lower()
            in ("1", "true", "yes"),
            "graph-compiler pattern fusion (compiler): captured programs "
            "of jit.to_static and jit.compile_train_step rewrite unfused "
            "attention/rms_norm/swiglu/rope compositions onto the kernels' "
            "custom ops unless a call overrides it (the JAX name kept)")
define_flag("enable_double_grad_capture", True,
            "record re-differentiable pullbacks on the eager tape so "
            "paddle.grad(create_graph=True) works; disable to minimize "
            "eager-mode activation lifetimes")
define_flag("allocator_strategy", "auto_growth",
            "kept for compat; PJRT owns allocation (BFC) on TPU")
define_flag("embedding_deterministic", 0,
            "deterministic embedding grad accumulation")
define_flag("cudnn_deterministic", False,
            "compat no-op on TPU; in the port: torch.backends.cudnn."
            "deterministic (benchmark off while set)")
define_flag("max_inplace_grad_add", 0, "compat")
define_flag("log_level", 0, "VLOG-style verbosity")
# --- the flags other JAX modules define ------------------------------------
# paddle_tpu/ops/pallas/flash_attention.py:49-51
define_flag("flash_block_q", 128,
            "Pallas flash attention query-block size (TPU tuning knob)")
define_flag("flash_block_k", 128,
            "Pallas flash attention kv-block size (TPU tuning knob)")
# paddle_tpu/ops/primitive/core.py:44
define_flag("kernel_backend", "auto",
            "kernel-primitive lowering backend: auto|tpu|gpu|cpu|"
            "interpret|xla (auto: tpu/gpu follow the process backend, "
            "cpu hosts use the xla reference)")
# paddle_tpu/models/llama.py:33
define_flag("fused_lm_head_ce", True,
            "Use the chunked fused linear+cross-entropy lm-head loss "
            "(never materializes [T, vocab] logits)")
# paddle_tpu/distributed/watchdog.py:26
define_flag("comm_timeout_s", 0.0,
            "If > 0, distributed waits raise CommTimeoutError after this "
            "many seconds instead of hanging (ref comm_task_manager).")

if _FLAGS["cudnn_deterministic"]:
    _apply_cudnn_deterministic()
