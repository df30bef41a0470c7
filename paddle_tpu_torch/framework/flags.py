"""Runtime flags: the counterpart of ``paddle_tpu/framework/flags.py``
for the flags the port reads.

Each flag is defined with a default, overridable through its
``FLAGS_<name>`` environment variable (Paddle's convention) and at run time
through ``set_flags`` / ``get_flag``, under the JAX
package's names. The port defines only what it reads:
``FLAGS_comm_timeout_s`` (``distributed.watchdog``),
``FLAGS_check_nan_inf`` (``amp.debugging``'s checker) and
``FLAGS_jaxpr_fusion`` (the graph compiler's default, ``compiler``; its
default comes from the ``PADDLE_TPU_FUSION`` environment variable, as in
the JAX package).

``FLAGS_EPOCH`` counts the ``set_flags`` calls: a cache of captured
programs that may have read a flag while capturing keys on it, so that a
flag flip captures again (``compiler.optimize``).
"""

from __future__ import annotations

import os

_FLAGS = {}
# bumped on every set_flags (see the module docstring)
FLAGS_EPOCH = [0]


def define_flag(name, default, help=""):  # noqa: A002
    """Define flag `name` (`help` documents it at the call site)."""
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
    return value


def set_flags(flags: dict):
    for k, v in flags.items():
        k = k.removeprefix("FLAGS_")
        if k not in _FLAGS:
            raise ValueError(f"unknown flag {k}")
        _FLAGS[k] = v
    FLAGS_EPOCH[0] += 1


def get_flags(names):
    """{"FLAGS_<name>": value} for a name or a list of names."""
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{n.removeprefix('FLAGS_')}":
            _FLAGS[n.removeprefix("FLAGS_")] for n in names}


def get_flag(name):
    return _FLAGS[name.removeprefix("FLAGS_")]


define_flag("check_nan_inf", False,
            "scan the named ops' tensors for nan/inf (ref: "
            "FLAGS_check_nan_inf; see amp.debugging)")
define_flag("comm_timeout_s", 0.0,
            "If > 0, distributed waits raise CommTimeoutError after this "
            "many seconds instead of hanging (ref comm_task_manager).")
define_flag("jaxpr_fusion",
            os.environ.get("PADDLE_TPU_FUSION", "0").lower()
            in ("1", "true", "yes"),
            "graph-compiler pattern fusion (compiler): captured programs "
            "of jit.to_static and jit.compile_train_step rewrite unfused "
            "attention/rms_norm/swiglu/rope compositions onto the kernels' "
            "custom ops unless a call overrides it (the JAX name kept)")
