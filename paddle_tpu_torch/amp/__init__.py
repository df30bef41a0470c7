"""Mixed precision: the counterpart of ``paddle_tpu/amp/__init__.py``
(``auto_cast`` / ``amp_guard``, ``decorate``, ``GradScaler`` /
``AmpScaler``, ``is_bfloat16_supported``, ``is_float16_supported``,
``white_list``, ``black_list``; the op lists in ``amp.lists``).

The JAX package casts at its dispatcher, per op name
(``paddle_tpu/core/dispatch.py:203-222, :608``): under O1 or O2 a
white-list op gets its float32 inputs cast to the amp type, a black-list
op is left as it is, and under O2 every op on neither list is cast too;
the cast sits inside the recorded op, so a gradient comes back in its
input's type. The port has no dispatcher, so its functionals, layers and
models ask ``amp_cast(name, *tensors)`` under the JAX op names at the
points where the JAX package dispatches them: ``linear``, ``matmul``,
``embedding``, ``add`` (the models' residual and embedding sums),
``layer_norm``, ``rms_norm``, ``dropout``, ``gelu``, ``relu``, ``tanh``,
``swiglu``, ``fused_rope``, ``scaled_dot_product_attention`` (its mask
too), ``flashmask_attention`` and ``fused_linear_cross_entropy``
(``cross_entropy`` is not amp-eligible in JAX either). Reshapes and
indexing are not cast: with the default lists what they read is already
in the amp type or is cast by the op that reads it next. ``.to()`` is
differentiable, so gradients come back in the parameters' own type.
``torch.autocast`` is not this: its lists differ (it runs softmax and
layer_norm in float32, for one).
"""

from __future__ import annotations

import threading

import torch

from .lists import BLACK_LIST, WHITE_LIST

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(d):
    return _DTYPES[d] if isinstance(d, str) else d


class _State(threading.local):
    def __init__(self):
        self.level = "O0"
        self.dtype = torch.bfloat16
        self.white = frozenset()
        self.black = frozenset()


_STATE = _State()


def _target_dtype(name):
    """The type op `name`'s float32 inputs are cast to under the current
    amp state, or None to leave them (``_amp_target_dtype``)."""
    white = (WHITE_LIST | _STATE.white) - _STATE.black
    black = (BLACK_LIST | _STATE.black) - _STATE.white
    if name in white:
        return _STATE.dtype
    if name in black or _STATE.level != "O2":
        return None
    return _STATE.dtype


def amp_cast(name, *tensors):
    """`tensors` as the JAX dispatcher hands them to op `name` under the
    current amp state: float32 tensors cast to the amp type when the op
    is cast, everything else (None, integers, other types) as given. One
    tensor in, one out; several in, a tuple out."""
    if _STATE.level != "O0":
        dt = _target_dtype(name)
        if dt is not None:
            tensors = tuple(
                t.to(dt) if isinstance(t, torch.Tensor)
                and t.dtype == torch.float32 else t for t in tensors)
    return tensors[0] if len(tensors) == 1 else tensors


def amp_add(x, y):
    """x + y as the JAX ``add`` op runs under the amp state: the models'
    residual and embedding sums."""
    x, y = amp_cast("add", x, y)
    return x + y


class auto_cast:
    """Context manager that turns mixed precision on (``amp_guard``):
    level O0 (off), O1 (the white list) or O2 (everything but the black
    list), in `dtype`, with custom lists added to (and removed from) the
    defaults."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0/O1/O2, got {level}")
        self.enable = enable
        self.level = level if enable else "O0"
        self.dtype = _dtype(dtype)
        self.white = frozenset(custom_white_list or [])
        self.black = frozenset(custom_black_list or [])

    def __enter__(self):
        self._saved = (_STATE.level, _STATE.dtype, _STATE.white,
                       _STATE.black)
        _STATE.level, _STATE.dtype = self.level, self.dtype
        _STATE.white, _STATE.black = self.white, self.black
        return self

    def __exit__(self, *exc):
        (_STATE.level, _STATE.dtype, _STATE.white,
         _STATE.black) = self._saved
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast every floating parameter of `models` to `dtype` in place
    (the same ``Parameter`` objects), except those of ``LayerNorm`` layers
    (the port has no batch norm layer), of the layer types in
    `excluded_layers` and of the layer instances in it; and turn the
    optimizers' float32 master weights on unless master_weight is False.
    O1 changes nothing. Returns models, or (models, optimizers)."""
    from ..nn import LayerNorm

    d = _dtype(dtype)
    if level == "O2":
        excluded, type_excl = set(), []
        if excluded_layers:
            layers = excluded_layers if isinstance(
                excluded_layers, (list, tuple)) else [excluded_layers]
            for lay in layers:
                if isinstance(lay, type):
                    type_excl.append(lay)
                else:
                    excluded.update(id(p) for p in lay.parameters())
        skip_types = tuple(type_excl) + (LayerNorm,)
        model_list = models if isinstance(models, (list, tuple)) \
            else [models]
        with torch.no_grad():
            for model in model_list:
                for sub in model.modules():
                    if isinstance(sub, skip_types):
                        continue
                    for p in sub._parameters.values():
                        if p is not None and id(p) not in excluded and \
                                p.is_floating_point():
                            p.data = p.data.to(d)
        if optimizers is not None and master_weight is not False:
            for o in (optimizers if isinstance(optimizers, (list, tuple))
                      else [optimizers]):
                o._multi_precision = True
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (``GradScaler`` / ``AmpScaler``): scale the
    loss, unscale the gradients with one found-inf check (one host read
    for the whole parameter list), skip the step when a gradient is not
    finite, and grow the scale by incr_ratio after incr_every_n_steps good
    steps or shrink it by decr_ratio (not below 1) after
    decr_every_n_nan_or_inf bad ones. ``last_found_inf`` survives the
    ``update`` after a skipped step; ``skipped_steps`` counts the skips."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self.last_found_inf = False
        self.skipped_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Each gradient times 1 / scale (in float32, written back in its
        own type) and whether any is not finite."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            flags.append(torch.isfinite(g).all())
            p.grad.copy_(g)
        self._found_inf = bool(flags) and \
            not bool(torch.stack(flags).all())
        self.last_found_inf = self._found_inf
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        else:
            self.skipped_steps += 1

    def update(self):
        if not self._enable or not self._dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale = self._scale * self._incr_ratio
                self._good_steps = 0
        self._unscaled = False
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        """The caller has run scaled_loss.backward(): unscale, step (or
        skip) and update."""
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def set_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)


AmpScaler = GradScaler


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True


def white_list():
    return {"float16": {"O1": WHITE_LIST, "O2": WHITE_LIST},
            "bfloat16": {"O1": WHITE_LIST, "O2": WHITE_LIST}}


def black_list():
    return {"float16": {"O1": BLACK_LIST, "O2": BLACK_LIST},
            "bfloat16": {"O1": BLACK_LIST, "O2": BLACK_LIST}}


__all__ = ["AmpScaler", "BLACK_LIST", "GradScaler", "WHITE_LIST", "amp_add",
           "amp_cast", "amp_guard", "auto_cast", "black_list", "decorate",
           "is_bfloat16_supported", "is_float16_supported", "white_list"]
