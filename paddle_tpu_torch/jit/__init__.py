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
across steps. An optimizer under ZeRO (``distributed.shard_optimizer``,
``fleet.DygraphShardingOptimizer``) updates through its engine, as the
JAX step honours ``optimizer._shard_fn`` (``paddle_tpu/jit/__init__.py:
572-579, 604-619``): stage >= 2 moves each gradient to its owners, the
parameters are all-gathered after the update, and at stage 3 they are
gathered before the forward. As the JAX
package's fused program folds the update into its one program, the step
runs the optimizer's update without the "optimizer" phase that an eager
``Optimizer.step`` reports to an active ``perf.StepTimer``. The first
step made while telemetry is enabled runs under an
``observability.xla_introspect`` counter and registers the program as
"train_step" (the first train step of the process; later ones
"train_step#<n>", the JAX labels): its flops, bytes and memory.

``jit.save``, ``jit.load`` and ``TranslatedLayer`` are the deploy path:
``torch.export`` of the eval forward, where each kernel stays one node of
its custom op, saved as ``<path>.pt2`` beside the weights in the JAX
package's ``.pdiparams`` pickle (see ``save``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import pickle
import time
import warnings

import numpy as np
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

    # ZeRO (``shard_optimizer`` / ``DygraphShardingOptimizer``): the update
    # is the engine's (gradients to their owners, slices updated, the
    # parameters gathered back); stage 3 gathers the parameters on use
    zero = getattr(optimizer, "_zero", None)

    def run(*batch):
        if zero is not None:
            zero.gather_params()
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


# ---------------- save / load (deploy path) ----------------

# the deploy metadata inside <path>.pt2 (an extra file of torch.export's
# archive): the parameter and buffer names in the .pdiparams order and the
# inputs' shapes, types and dynamic ranges
_DEPLOY_META = "ptt_deploy.json"
# the example size of an InputSpec dim of None: export specializes sizes
# 0 and 1, so a dynamic dim is traced at 2
_DYNAMIC_EXAMPLE = 2


def _layer_device(layer):
    from ..device import resolve_device
    for t in itertools.chain(layer.parameters(), layer.buffers()):
        return t.device
    return resolve_device(None)


def _examples(input_spec, device):
    """(example inputs, dynamic_shapes) for ``torch.export.export``: an
    InputSpec becomes zeros of its type with each None dim dynamic (traced
    at _DYNAMIC_EXAMPLE); an example tensor is used as it is (static)."""
    from ..framework.dtype import convert_dtype
    examples, dynamic = [], []
    for spec in input_spec:
        if isinstance(spec, torch.Tensor):
            examples.append(spec.detach().to(device))
            dynamic.append(None)
            continue
        shape = tuple(spec.shape)
        examples.append(torch.zeros(
            [_DYNAMIC_EXAMPLE if d is None else int(d) for d in shape],
            dtype=convert_dtype(spec.dtype), device=device))
        dims = {i: torch.export.Dim.DYNAMIC
                for i, d in enumerate(shape) if d is None}
        dynamic.append(dims or None)
    return examples, dynamic


def _input_meta(program):
    """Each user input's shape (None where dynamic), type, and the range
    export derived for each dynamic dim ({dim: [lo, hi]}, hi None when
    unbounded)."""
    user = set(program.graph_signature.user_inputs)
    out = []
    for node in program.graph.nodes:
        if node.op != "placeholder" or node.name not in user:
            continue
        val = node.meta["val"]
        shape, ranges = [], {}
        for i, d in enumerate(val.shape):
            if isinstance(d, int):
                shape.append(d)
                continue
            shape.append(None)
            vr = program.range_constraints[d.node.expr]
            ranges[str(i)] = [int(vr.lower), int(vr.upper)
                              if vr.upper.is_Integer else None]
        out.append({"shape": shape, "dtype": _dtype_name(val.dtype),
                    "range": ranges})
    return out


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


@contextlib.contextmanager
def _eager_forward(layer):
    """The layer's forward with a ``to_static`` StaticFunction unwrapped
    (the JAX package exports the raw forward, ``StaticFunction._fn``)."""
    static = layer.__dict__.get("forward")
    if not isinstance(static, StaticFunction):
        yield
        return
    layer.forward = static._fn
    try:
        yield
    finally:
        layer.forward = static


def export_layer(layer, examples, dynamic=None):
    """``torch.export.export`` of `layer`'s eval forward (a to_static
    forward unwrapped) on `examples`; the training flag is restored."""
    was_training = layer.training
    layer.eval()
    try:
        with _eager_forward(layer):
            return torch.export.export(
                layer, tuple(examples),
                dynamic_shapes=None if dynamic is None or not any(dynamic)
                else tuple(dynamic), strict=False)
    finally:
        layer.train(was_training)


def save(layer, path, input_spec=None, **configs):
    """jit.save (``paddle_tpu/jit/__init__.py:737``): `layer`'s eval
    forward through ``torch.export`` (each kernel one ``ptt`` op node)
    over `input_spec` (InputSpecs, a dim of None dynamic, or example
    tensors).

    Writes ``<path>.pt2`` (``torch.export.save``; the program's weights
    moved to the CPU, so it loads on a machine without a card),
    ``<path>.pdiparams`` (the JAX package's pickle: ``{"params": [...],
    "buffers": [...]}`` as numpy arrays in ``named_parameters()`` /
    ``named_buffers()`` order, bfloat16 as ``ml_dtypes``), and
    ``<path>.native.json``: for a fully static signature the inputs'
    shapes and types with ``"format": "aoti"`` (``inference.native``
    compiles the program with AOTInductor), else ``{"error": ...}``.
    ``native=False`` writes no ``.native.json``. Returns the seconds of
    the export and of the writing, and the files' bytes
    (``{"export_s", "write_s", "pt2_bytes", "pdiparams_bytes"}``)."""
    from torch.export.passes import move_to_device_pass

    from ..framework.io import _pack
    from ..ops.kernels import _ops  # noqa: F401  (the ptt ops)

    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (list of InputSpec or "
                         "example Tensors)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    examples, dynamic = _examples(input_spec, _layer_device(layer))
    t0 = time.perf_counter()
    program = export_layer(layer, examples, dynamic)
    t1 = time.perf_counter()
    params = list(layer.named_parameters())
    buffers = list(layer.named_buffers())
    meta = {"params": [n for n, _ in params],
            "buffers": [n for n, _ in buffers],
            "inputs": _input_meta(program)}
    program = move_to_device_pass(program, "cpu")
    torch.export.save(program, path + ".pt2",
                      extra_files={_DEPLOY_META: json.dumps(meta)})
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"params": _pack([p for _, p in params]),
                     "buffers": _pack([b for _, b in buffers])}, f)
    if configs.get("native", True):
        dyn = [(i, int(d)) for i, spec in enumerate(meta["inputs"])
               for d in spec["range"]]
        native = {"inputs": [{"shape": spec["shape"], "dtype": spec["dtype"]}
                             for spec in meta["inputs"]],
                  "format": "aoti"} if not dyn else {
            "error": "ValueError: the signature has dynamic dims (input, "
                     f"dim) {dyn}; an AOTInductor program takes static "
                     "shapes"}
        with open(path + ".native.json", "w") as f:
            json.dump(native, f)
    return {"export_s": t1 - t0, "write_s": time.perf_counter() - t1,
            "pt2_bytes": os.path.getsize(path + ".pt2"),
            "pdiparams_bytes": os.path.getsize(path + ".pdiparams")}


class TranslatedLayer:
    """Inference-only layer loaded from a jit.save artifact (ref:
    python/paddle/jit/translated_layer.py): the exported program with the
    ``.pdiparams`` weights, on one device.

    A call checks its inputs against the exported signature: a static dim
    must match, a dynamic one must lie in the range export derived (a
    lower bound of 2 admits 1: export traces dynamic sizes from 2 and its
    program's own guards accept 1); a type or size outside raises
    ValueError naming the input and the dim, never a new export.

    Only the ``.pdiparams`` file is shared with the JAX package: its
    ``<path>.stablehlo`` program cannot be read without JAX."""

    def __init__(self, program, meta, device):
        self._program = program
        self._module = program.module()
        self._meta = meta
        self._inputs = meta["inputs"]
        self.n_inputs = len(self._inputs)
        self.training = False
        self.device = device

    def program(self):
        """The ``torch.export.ExportedProgram``."""
        return self._program

    def _input(self, i, a):
        from ..framework.io import _from_numpy
        t = a if isinstance(a, torch.Tensor) else \
            _from_numpy(np.asarray(a))
        spec = self._inputs[i]
        if _dtype_name(t.dtype) != spec["dtype"]:
            raise ValueError(f"input {i}: type {_dtype_name(t.dtype)}, the "
                             f"program takes {spec['dtype']}")
        if t.dim() != len(spec["shape"]):
            raise ValueError(f"input {i}: rank {t.dim()}, the program takes "
                             f"{len(spec['shape'])}")
        for d, (n, want) in enumerate(zip(t.shape, spec["shape"])):
            if want is None:
                lo, hi = spec["range"][str(d)]
                lo = 1 if lo == 2 else lo
                if n < lo or (hi is not None and n > hi):
                    raise ValueError(
                        f"input {i} dim {d}: size {n} outside the exported "
                        f"range [{lo}, {hi}]")
            elif n != want:
                raise ValueError(f"input {i} dim {d}: size {n}, the program "
                                 f"was exported with {want}")
        return t.to(self.device)

    def __call__(self, *args):
        if len(args) != self.n_inputs:
            raise ValueError(f"expected {self.n_inputs} inputs, got "
                             f"{len(args)}")
        xs = [self._input(i, a) for i, a in enumerate(args)]
        with torch.no_grad():
            return self._module(*xs)

    def eval(self):
        return self

    forward = __call__


def _load_program(path):
    """(the ExportedProgram of <path>.pt2, its deploy metadata)."""
    from ..ops.kernels import _ops  # noqa: F401  (the ptt ops)
    extra = {_DEPLOY_META: ""}
    program = torch.export.load(path + ".pt2", extra_files=extra)
    return program, json.loads(extra[_DEPLOY_META])


def load(path, device=None, **configs):
    """jit.load (``paddle_tpu/jit/__init__.py:851``): the program of
    ``<path>.pt2`` with the weights of ``<path>.pdiparams`` (written by
    this package's or the JAX package's ``jit.save``: the same pickle,
    matched by order to the names the program records), placed on
    `device` (the current device, the card unless the CPU was asked
    for). A weight whose shape or type differs from the program's
    raises ValueError."""
    from torch.export.passes import move_to_device_pass

    from ..device import resolve_device
    from ..framework.io import _from_numpy

    program, meta = _load_program(path)
    with open(path + ".pdiparams", "rb") as f:
        weights = pickle.load(f)
    for kind in ("params", "buffers"):
        names, arrays = meta[kind], weights[kind]
        if len(names) != len(arrays):
            raise ValueError(f"{path}.pdiparams holds {len(arrays)} {kind}, "
                             f"the program {len(names)}")
        for name, arr in zip(names, arrays):
            _set_weight(program, name, _from_numpy(np.asarray(arr)))
    device = resolve_device(device)
    return TranslatedLayer(move_to_device_pass(program, device), meta,
                           device)


def _set_weight(program, name, value):
    """Put `value` in the program's state (parameters, persistent buffers)
    or constants (non-persistent buffers, such as the Llama's RoPE
    tables); a name the program does not hold (a buffer the forward never
    reads) is skipped."""
    table = program.state_dict if name in program.state_dict else \
        program.constants if name in program.constants else None
    if table is None:
        return
    old = table[name]
    if old.shape != value.shape or old.dtype != value.dtype:
        raise ValueError(
            f"weight {name}: {tuple(value.shape)} {_dtype_name(value.dtype)}"
            f", the program holds {tuple(old.shape)} "
            f"{_dtype_name(old.dtype)}")
    if isinstance(old, torch.nn.Parameter):
        value = torch.nn.Parameter(value, requires_grad=old.requires_grad)
    table[name] = value
