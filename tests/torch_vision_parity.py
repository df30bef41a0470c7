"""Shared harness of the vision parity tests (``test_torch_vision*.py``):
the same model built in both packages, one set of weights in both, and
the forward compared in float64.

The JAX package compiles each initializer draw per parameter shape, so
building its large models takes minutes on a CPU; ``fast_jax_init``
makes its initializers return zeros from numpy (the construction is
otherwise the JAX package's: the same layers, names and shapes), and the
port's own seeded weights are then carried into the JAX model
(``weights.to_numpy_state`` -> JAX ``set_state_dict``),
the bridge's port-to-JAX direction.

The comparisons run in float64, on inputs whose last stage still holds a
few values per channel (4 images at 2x2 or more): a training-mode
BatchNorm over two nearly equal values divides their difference by
sqrt(eps) = 3.2e-3, so over a few such layers even float64 rounding
grows to order one (ResNeXt at 8x8, 2 images, differs by 3.4). Dropout
is set to p = 0 in both for the training-mode forward (the two packages
draw different masks); BatchNorm keeps its training mode. The JAX
forward runs through its ``jit.to_static`` program (one compile, where
its eager mode compiles every op of a new shape).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as JI

from paddle_tpu_torch import nn, weights

# rtol, atol of float64 forwards (a deep net's products in other orders)
F64_TOL = (1e-9, 1e-9)


def _subclasses(cls):
    for s in cls.__subclasses__():
        yield s
        yield from _subclasses(s)


@pytest.fixture
def fast_jax_init(monkeypatch):
    """JAX initializers return zeros (see the module docstring)."""
    import jax.numpy as jnp

    def zeros(self, shape, dtype):
        return jnp.asarray(np.zeros(shape, np.dtype(str(jnp.dtype(dtype)))))

    for cls in [JI.Initializer] + list(_subclasses(JI.Initializer)):
        if "_generate" in vars(cls):
            monkeypatch.setattr(cls, "_generate", zeros)


def names_and_shapes(layer):
    """{name: shape} of a layer's parameters and state-dict entries (the
    persistable buffers), in either package."""
    out = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    out.update({n: tuple(v.shape) for n, v in layer.state_dict().items()})
    return out


def port_to_jax(tmodel, jmodel):
    """Carry the port model's parameters and persistable buffers into the
    JAX model; every name must match."""
    missing, unexpected = jmodel.set_state_dict(
        weights.to_numpy_state(tmodel))
    assert missing == [] and unexpected == [], (missing[:5], unexpected[:5])


def _no_dropout(*models):
    for m in models:
        for sub in m.sublayers():
            if isinstance(sub, (jnn.Dropout, nn.Dropout)):
                sub.p = 0.0


def _outs(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def forward_parity(jmodel, tmodel, x, tol=F64_TOL):
    """Both models in float64, the port's weights in both, the forward on
    x in training mode (dropout off) and in eval mode."""
    jmodel.astype("float64")
    tmodel.astype("float64")
    port_to_jax(tmodel, jmodel)
    _no_dropout(jmodel, tmodel)
    x = x.astype(np.float64)
    jforward = paddle.jit.to_static(jmodel)
    for mode in ("train", "eval"):
        getattr(jmodel, mode)()
        getattr(tmodel, mode)()
        with torch.no_grad():
            got = _outs(tmodel(torch.from_numpy(x)))
        with paddle.no_grad():
            want = _outs(jforward(paddle.to_tensor(x)))
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                       rtol=tol[0], atol=tol[1],
                                       err_msg=f"{mode} output {i}")


def port_forward_modes(tmodel, x, out_shape):
    """The port model's forward in training and eval mode: finite, of
    out_shape (every output)."""
    for mode in ("train", "eval"):
        getattr(tmodel, mode)()
        with torch.no_grad():
            outs = _outs(tmodel(torch.from_numpy(x)))
        for o in outs:
            assert tuple(o.shape) == tuple(out_shape), (mode, o.shape)
            assert bool(torch.isfinite(o).all()), mode


# the input size of each model's parity check (4 images): the last stage
# at 2x2 or more where the model has BatchNorm, else the smallest input
# the model takes (GoogLeNet's auxiliary heads need 189; InceptionV3's
# smallest, 75, leaves 4 values a channel at its last stage)
PARITY_SIZE = {"resnext50_32x4d": 64, "alexnet": 63, "vgg11": 32,
               "mobilenet_v1": 64, "mobilenet_v2": 64,
               "mobilenet_v3_small": 64, "squeezenet1_0": 35,
               "squeezenet1_1": 31, "shufflenet_v2_x0_25": 64,
               "shufflenet_v2_swish": 64, "densenet121": 64,
               "googlenet": 189, "inception_v3": 75}


def check_zoo_model(name, seed=1):
    """``forward_parity`` of zoo model `name` (10 classes) at its
    PARITY_SIZE."""
    import paddle_tpu_torch as ptt
    from paddle_tpu.vision import models as jm
    from paddle_tpu_torch.vision import models as tm
    ptt.seed(seed)
    t = getattr(tm, name)(num_classes=10)
    j = getattr(jm, name)(num_classes=10)
    hw = PARITY_SIZE[name]
    x = np.random.default_rng(seed + 1).standard_normal((4, 3, hw, hw))
    forward_parity(j, t, x)
