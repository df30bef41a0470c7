"""``paddle.jit`` in the port: ``to_static``, ``compile_train_step`` and
their knobs, the counterparts of ``paddle_tpu/jit/__init__.py``.

The JAX package traces a function once per input signature into one XLA
program. The port captures it once per signature into one ATen-level fx
graph (``compiler.capture``, fake tensors: no kernel runs) and replays
that graph eagerly; with fusion on, the graph first goes through the
graph compiler's pass pipeline (``compiler``), which splices unfused
attention, RMSNorm, SwiGLU and RoPE compositions onto the kernels' custom
ops. The model's parameters and buffers are graph inputs
(``compiler.module_program``), so gradients reach them and an optimizer's
in-place update needs no new capture.

``to_static(fn_or_layer, build_strategy=BuildStrategy(fuse=...))``
returns a ``StaticFunction``: one captured program per input signature
(shapes, types, devices, the amp state, grad mode, the layer's training
flags). A signature whose capture breaks (Python control flow on a
tensor's value, an autograd Function outside torch, a random draw) runs
eagerly, is counted (``graph_breaks``, ``compiler_graph_breaks_total``)
and warns; past ``_SIG_BREAK_CAP`` such signatures the whole function
runs eagerly. The JAX package first retries with scalar int/bool inputs
baked in as guarded constants; the port does not (each value would be a
signature of its own).

``compile_train_step`` runs forward, backward, the optimizer's gradient
clip and update, and clears the gradients: the eager loop ``loss =
loss_fn(model, *batch); loss.backward(); optimizer.step();
optimizer.clear_grad()``. With ``fuse=True`` (None defers to
``FLAGS_jaxpr_fusion``) the forward is the fused program of the PRIMAL
loss (``paddle_tpu/jit/__init__.py:562-566``): its backward flows through
the kernels' own backwards. ``remat_policy="fused"`` runs that program
cut after each fused op into pieces, each under ``torch.utils.
checkpoint``'s selective checkpoint with ``compiler.fused_save_policy()``
(``compiler.remat.segmented``): the fused ops' outputs are kept and
everything else is recomputed in the backward, piece by piece. Unlike
the JAX program, the step honours AdamW's ``lr_ratio`` and
``apply_decay_param_fun``, and the optimizer's ``state_dict`` stays live
across steps. As the JAX
package's fused program folds the update into its one program, the step
runs the optimizer's update without the "optimizer" phase that an eager
``Optimizer.step`` reports to an active ``perf.StepTimer``. The first
step made while telemetry is enabled runs under an
``observability.xla_introspect`` counter and registers the program as
"train_step" (the first train step of the process; later ones
"train_step#<n>", the JAX labels): its flops, bytes and memory.

``jit.save``, ``jit.load`` and ``TranslatedLayer`` (the deploy path
through ``torch.export`` over the same custom ops) are ROADMAP §A.10:
they raise.
"""

from __future__ import annotations

import functools
import warnings

import torch

from .. import compiler
from ..compiler import BuildStrategy, fusion_enabled

__all__ = ["compile_train_step", "to_static", "StaticFunction",
           "BuildStrategy", "InputSpec", "not_to_static", "ignore_module",
           "enable_to_static", "set_code_level", "set_verbosity", "save",
           "load", "TranslatedLayer"]

# ordinal labels for xla_introspect registration, as in the JAX package
_TRAIN_STEP_IDS = [0]
_TO_STATIC = [True]          # enable_to_static


def _remat_policy(remat_policy):
    """The selective-checkpoint policy of a remat_policy argument (None
    for none); other strings keep their JAX-program error."""
    if remat_policy is None:
        return None
    if remat_policy == "fused":
        return compiler.fused_save_policy()
    raise NotImplementedError(
        f"remat_policy={remat_policy!r}: a JAX checkpoint policy over the "
        "whole traced loss program; the port takes 'fused' (the compiler's "
        "fused_save_policy), or remat the layers with "
        "models.apply_llama_remat or distributed.fleet.utils.recompute")


def compile_train_step(model, loss_fn, optimizer, donate=True,
                       extra_rng=True, fuse=None, remat_policy=None):
    """Returns step(*batch) -> 0-dim loss tensor (detached), which runs
    forward (``loss_fn(model, *batch)``; with fusion, its fused program),
    backward, the optimizer's gradient clip and update, and clears the
    gradients. donate and extra_rng have no counterpart in eager PyTorch
    and are ignored. ``step.program`` is the introspection label;
    ``step.programs`` the captured programs (with fusion or a remat
    policy)."""
    do_fuse = fusion_enabled() if fuse is None else bool(fuse)
    policy = _remat_policy(remat_policy)

    _TRAIN_STEP_IDS[0] += 1
    prog_name = ("train_step" if _TRAIN_STEP_IDS[0] == 1
                 else f"train_step#{_TRAIN_STEP_IDS[0] - 1}")
    registered = [False]
    update = getattr(optimizer, "_step_impl", optimizer.step)
    forward = functools.partial(loss_fn, model)
    programs = None
    if do_fuse or policy is not None:
        forward = compiler.module_program(
            model, loss_fn, name=prog_name,
            pass_manager=None if do_fuse else compiler.PassManager([]),
            remat=policy)
        programs = forward.programs

    def run(*batch):
        loss = forward(*batch)
        loss.backward()
        update()
        optimizer.clear_grad()
        return loss.detach()

    def step(*batch):
        if registered[0]:
            return run(*batch)
        from ..observability import metrics, xla_introspect
        if not metrics.enabled():       # retried at the next step
            return run(*batch)
        registered[0] = True
        try:
            counter = xla_introspect.count(prog_name, args=(
                batch, list(model.parameters()), list(model.buffers()),
                optimizer._accumulators, optimizer._master_weights))
            counter.__enter__()
        except Exception:  # noqa: BLE001 — telemetry never blocks a step
            return run(*batch)
        try:
            loss = run(*batch)
            counter.outputs = loss
        except BaseException as e:
            counter.__exit__(type(e), e, e.__traceback__)
            raise
        counter.__exit__(None, None, None)
        return loss

    step.program = prog_name
    step.programs = programs
    return step


# ---------------- to_static ----------------

class StaticFunction:
    """A function (or a layer's forward) captured once per input signature
    and replayed (ref: program_translator.py:377 StaticFunction); see the
    module docstring. ``graph_breaks`` counts the signatures that run
    eagerly; ``programs()`` gives the captured GraphModules."""

    # past this many graph-broken signatures the whole function runs
    # eagerly: a function with an inherent dynamic branch would otherwise
    # pay a failed capture per new signature
    _SIG_BREAK_CAP = 8

    def __init__(self, fn, layer, input_spec=None, build_strategy=None,
                 backend=None):
        self._fn = fn
        self._layer = layer
        self._build_strategy = build_strategy
        self._programs = {}         # fuse on/off -> optimized callable
        self._all_eager = False
        self.graph_breaks = 0
        functools.update_wrapper(self, fn)

    def _fusion_on(self):
        """BuildStrategy(fuse=...) wins; None defers to FLAGS_jaxpr_fusion
        (env PADDLE_TPU_FUSION)."""
        fuse = getattr(self._build_strategy, "fuse", None)
        return fusion_enabled() if fuse is None else bool(fuse)

    def _program(self):
        fuse = self._fusion_on()
        prog = self._programs.get(fuse)
        if prog is None:
            name = f"to_static:{getattr(self._fn, '__name__', 'fn')}"
            pm = None if fuse else compiler.PassManager([])
            fn = self._fn
            if self._layer is not None:
                prog = compiler.module_program(
                    self._layer, lambda _m, *a, **k: fn(*a, **k), name=name,
                    pass_manager=pm)
            else:
                prog = compiler.optimize(fn, name=name, pass_manager=pm)
            self._programs[fuse] = prog
        return prog

    def __call__(self, *args, **kwargs):
        if self._all_eager or not _TO_STATIC[0] or \
                getattr(self._fn, "_not_to_static", False):
            return self._fn(*args, **kwargs)
        prog = self._program()
        out = prog(*args, **kwargs)
        breaks = sum(p.programs.graph_breaks()
                     for p in self._programs.values())
        if breaks > self.graph_breaks:
            self.graph_breaks = breaks
            warnings.warn(
                f"to_static({getattr(self._fn, '__name__', '?')}): this "
                "input signature cannot be captured as one program (Python "
                "control flow on a tensor's value, an autograd Function or "
                "a random draw); it runs eagerly (graph break)",
                stacklevel=2)
            if breaks >= self._SIG_BREAK_CAP:
                self._all_eager = True
        return out

    def programs(self):
        """The captured (and, with fusion, rewritten) GraphModules."""
        return [g for p in self._programs.values()
                for g in p.programs.values() if g is not None]

    def concrete_program(self, *args, **kwargs):
        raise NotImplementedError(
            "inspect the captured GraphModules through programs()")


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator/wrapper capturing an imperative function or a layer's
    forward into one program per input signature (ref:
    python/paddle/jit/api.py:196). A layer's forward is replaced in place
    and the layer returned."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            layer = fn
            layer.forward = StaticFunction(layer.forward, layer, input_spec,
                                           build_strategy)
            return layer
        layer = getattr(fn, "__self__", None)
        layer = layer if isinstance(layer, torch.nn.Module) else None
        return StaticFunction(fn, layer, input_spec, build_strategy)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """Mark fn to run eagerly even when to_static wraps it."""
    fn._not_to_static = True
    return fn


class ignore_module:
    """Context kept for API parity: the capture records ATen ops of any
    module, so there is nothing to ignore."""

    def __init__(self, modules):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def enable_to_static(flag=True):
    """Turn every StaticFunction's capture on or off (off: eager)."""
    _TO_STATIC[0] = bool(flag)


def set_code_level(level=100):
    """Kept for API parity (the reference's SOT debug knob); a program's
    graph text is what ``PADDLE_TPU_COMPILER_DUMP`` writes."""


def set_verbosity(level=0, also_to_stdout=False):
    """Kept for API parity."""


class InputSpec:
    """ref: python/paddle/static/input.py InputSpec."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=False):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


_SAVE_LATER = ("comes with ROADMAP §A.10 (the deploy path: torch.export "
               "over the kernels' custom ops)")


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(f"jit.save {_SAVE_LATER}")


def load(path, **configs):
    raise NotImplementedError(f"jit.load {_SAVE_LATER}")


class TranslatedLayer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"jit.TranslatedLayer {_SAVE_LATER}")
