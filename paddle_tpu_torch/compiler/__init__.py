"""The graph compiler: the counterpart of ``paddle_tpu/compiler/``.

The JAX package's compiler rewrites captured jaxprs so that models
written from plain ops reach its fused kernels. Here the capture is an
ATen-level ``torch.fx`` graph (``capture``, through ``make_fx`` with
fake tensors), the passes are fx passes, and the fused kernels are the
port's CUDA kernels as ``torch.library`` custom ops
(``ops.kernels._ops``): the flash forward (and through its backward, the
flash backward), RMSNorm, SwiGLU and RoPE.

    capture               optimize (this package)              replay
    make_fx  ──►  GraphModule ──passes──► GraphModule  ──►  eager ATen + kernels

- ``pass_manager``: ordered, named passes with per-pass timing in the
  metrics registry and ``PADDLE_TPU_COMPILER_DUMP=<dir>`` before/after
  graph dumps.
- ``patterns`` + ``rewrites``: matchers for unfused attention
  (softmax(QK^T*scale)*V with causal/bool/additive masks and the GQA
  repeat), rms_norm, swiglu and rotate-half rope, spliced onto the
  custom ops after a fake-tensor gate, with a fallback-to-original
  guarantee.
- ``cleanup``: DCE, CSE and constant folding.
- ``remat``: checkpoint names on the fused ops; ``fused_save_policy()``
  drives ``compile_train_step(..., remat_policy="fused")``.

Enablement: ``jit.to_static(..., build_strategy=BuildStrategy(fuse=True))``,
``jit.compile_train_step(..., fuse=True)``, or process-wide through the
``PADDLE_TPU_FUSION=1`` environment variable (flag
``FLAGS_jaxpr_fusion``, the JAX name kept). The pipeline runs once per
input signature (``optimize``), so steady state adds no capture. The
JAX package also fuses eager dispatch and ``generate()`` under the flag;
the port has no op dispatcher and its models call the kernels directly,
so those have no counterpart.
"""

from __future__ import annotations

import functools

import torch
import torch.utils._pytree as pytree

from .pass_manager import (  # noqa: F401
    Pass, FunctionPass, PassContext, PassManager, PASS_REGISTRY,
    register_graph_pass, default_pipeline, default_pass_manager,
)
from . import patterns  # noqa: F401
from . import rewrites  # noqa: F401
from . import cleanup   # noqa: F401  (registers dce/cse/constant_fold)
from . import remat     # noqa: F401  (registers remat_tag)
from .capture import GraphBreak, capture, leaf_key, state_key
from .patterns import Graph, Candidate, find_candidates  # noqa: F401
from .rewrites import PatternFusionPass, make_fused_pass  # noqa: F401
from .remat import (fused_save_policy, FUSED_REMAT_NAMES,  # noqa: F401
                    segmented)
from ..observability.events import EVENTS as _EVENTS
from ..observability.metrics import REGISTRY as _REG

__all__ = [
    "Pass", "FunctionPass", "PassContext", "PassManager", "PASS_REGISTRY",
    "register_graph_pass", "default_pipeline", "default_pass_manager",
    "Graph", "Candidate", "find_candidates", "PatternFusionPass",
    "make_fused_pass", "fused_save_policy", "FUSED_REMAT_NAMES",
    "BuildStrategy", "optimize", "module_program", "fusion_enabled",
    "GraphBreak", "capture",
]

_C_BREAKS = _REG.counter("compiler_graph_breaks_total",
                         "signatures that could not be captured and ran "
                         "eagerly")


class BuildStrategy:
    """Compilation knobs for ``jit.to_static`` (ref: paddle
    static.BuildStrategy). ``fuse=True`` runs the captured program through
    the graph-compiler pipeline; ``fuse=None`` defers to the
    ``FLAGS_jaxpr_fusion`` flag (env ``PADDLE_TPU_FUSION``). Other
    reference attributes are accepted and recorded."""

    def __init__(self, fuse=None, **attrs):
        self.fuse = fuse
        for k, v in attrs.items():
            setattr(self, k, v)


def fusion_enabled():
    """Process-wide fusion default (FLAGS_jaxpr_fusion /
    PADDLE_TPU_FUSION)."""
    from ..framework.flags import get_flag
    return bool(get_flag("jaxpr_fusion"))


def graph_break(program, reason):
    """Count and record a capture that broke (the call runs eagerly)."""
    _C_BREAKS.inc()
    _EVENTS.record("compiler_graph_break", program=program,
                   reason=str(reason)[:300])


_EAGER = object()


def optimize(fn, name=None, pass_manager=None, extra_key=None,
             remat=None):
    """Wrap a function of tensors (any pytree in and out) so that each new
    input signature captures it once (``capture``: fake tensors, no kernel
    runs), runs the pass pipeline, and replays the rewritten GraphModule;
    later calls of the signature only replay. Gradients flow through the
    replay, through the custom ops' own backwards. A signature whose
    capture breaks (data-dependent control flow, an autograd Function, a
    random draw) runs ``fn`` eagerly from then on, counted in
    ``compiler_graph_breaks_total``. ``extra_key()``, when given, adds
    what else the capture reads to the signature (a module's training
    flags). ``remat``, a selective-checkpoint policy from
    ``fused_save_policy``, runs the program cut at the ops it keeps,
    each piece under that policy (``remat.segmented``).
    ``wrapped.programs`` holds the rewritten program of each captured
    signature (``None`` for one that runs eagerly)."""
    pname = name or getattr(fn, "__name__", "program")
    cache = {}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        leaves, tree = pytree.tree_flatten((args, kwargs))
        where = [i for i, x in enumerate(leaves)
                 if isinstance(x, torch.Tensor)]
        key = (tree, tuple(leaf_key(x) for x in leaves), state_key(),
               None if extra_key is None else extra_key())
        entry = cache.get(key)
        if entry is None:
            entry = cache[key] = _build(fn, leaves, tree, where, pname,
                                        pass_manager, remat)
        if entry is _EAGER:
            return fn(*args, **kwargs)
        gm, out_tree = entry
        return pytree.tree_unflatten(gm(*[leaves[i] for i in where]),
                                     out_tree)

    wrapped.programs = _Programs(cache)
    wrapped.__wrapped__ = fn
    return wrapped


class _Programs:
    """A read-only view of an optimized function's programs: signature ->
    the rewritten GraphModule, or None where the capture broke."""

    def __init__(self, cache):
        self._cache = cache

    def __len__(self):
        return len(self._cache)

    def values(self):
        return [None if e is _EAGER else e[0] for e in self._cache.values()]

    def graph_breaks(self):
        return sum(e is _EAGER for e in self._cache.values())


class _Bound(torch.nn.Module):
    """fn(model, ...) as a module call, so that ``functional_call`` swaps
    the model's parameters and buffers for the graph's inputs."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(self.model, *args, **kwargs)


def module_program(model, fn, name=None, pass_manager=None, remat=None):
    """``optimize`` of fn(model, *args, **kwargs) with the model's
    parameters and buffers passed as graph inputs (``torch.func.
    functional_call``): the replay computes with the live tensors, so
    gradients reach the model's own parameters, and an optimizer's
    in-place update needs no new capture. The model's training flags join
    the signature; ``remat`` as in ``optimize``. Returns call(*args,
    **kwargs) with ``.programs``."""
    bound = _Bound(model, fn)

    def program(state, *args, **kwargs):
        return torch.func.functional_call(bound, state, args, kwargs)

    opt = optimize(program, name=name or getattr(fn, "__name__", None),
                   pass_manager=pass_manager, remat=remat,
                   extra_key=lambda: tuple(m.training
                                           for m in model.modules()))

    def call(*args, **kwargs):
        state = {f"model.{n}": t for n, t in model.named_parameters()}
        state.update((f"model.{n}", t) for n, t in model.named_buffers())
        return opt(state, *args, **kwargs)

    call.programs = opt.programs
    return call


def _build(fn, leaves, tree, where, pname, pass_manager, remat=None):
    """(rewritten GraphModule, output treespec), or _EAGER when the
    capture broke."""
    def traced(*tensors):
        full = list(leaves)
        for i, t in zip(where, tensors):
            full[i] = t
        a, k = pytree.tree_unflatten(full, tree)
        return fn(*a, **k)

    from torch.utils._python_dispatch import _disable_current_modes
    try:
        gm, out_tree = capture(traced, [leaves[i] for i in where])
    except GraphBreak as e:
        graph_break(pname, e)
        return _EAGER
    pm = pass_manager if pass_manager is not None \
        else default_pass_manager()
    if pm.names():
        # the passes evaluate builders on fake tensors: no dispatch mode
        # around the call (a counter, a selective checkpoint's cache) may
        # see those ops
        with _disable_current_modes(), torch.no_grad():
            gm = pm.run(gm, program=pname)
    if remat is not None:
        gm = segmented(gm, remat)
    return gm, out_tree
