"""Zero-bubble support: a layer's (or a stage's) backward split into the
activation-gradient chain (B) and the weight-gradient phase (W): the
counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
zero_bubble.py`` (``LayerSplit`` :73, ``capture_and_split`` :208).

The JAX package slices the jaxpr of the layer's vjp into the equations
``dx`` needs and the rest (the dW GEMMs), and stashes the tensors the
two share (the cuts). The port takes the same split from autograd:

- the forward records the output of every module that holds parameters
  directly (``record_cuts``: a Linear's product, a norm's output), the
  cut tensors;
- **B** (``b_pass``): ``torch.autograd.grad`` of the stage's output with
  respect to its input activation and the cuts, ``retain_graph=True``.
  The engine runs only the nodes on a path to them, and each node only
  the input gradients asked of it (a linear's ``g @ W^T``, not
  ``x^T @ g``); the cuts' gradients lie on that path, so they cost
  nothing more;
- **W** (``w_pass``), later: each cut's local backward into its module's
  own parameters (``torch.autograd.backward(cut, g, inputs=params)``),
  the weight-gradient products alone, which frees those nodes; the
  parameters' ``.grad`` accumulate as one whole backward's would.

No compute is duplicated: B and W run the nodes of the one backward,
partitioned. The stash is the retained graph (autograd's saved tensors)
and the cuts' gradients. ``capture_and_split`` (a functional layer, no
modules to record) splits at the layer: its W backward runs from the
layer's output to the parameters.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch


@contextlib.contextmanager
def record_cuts(layers):
    """Record, while the block runs, each call's output of every module of
    `layers` that holds trainable parameters directly: yields the list
    of (the module's own trainable parameters, output) it fills."""
    found = []
    handles = []
    for layer in layers:
        for mod in layer.modules():
            params = [p for p in mod.parameters(recurse=False)
                      if p.requires_grad]
            if params:
                handles.append(mod.register_forward_hook(
                    lambda m, args, out, params=params: found.append(
                        (params, out))
                    if torch.is_tensor(out) and out.requires_grad
                    else None))
    try:
        yield found
    finally:
        for h in handles:
            h.remove()


def b_pass(y, x, g, cuts=()):
    """B: the activation gradient of output `y` w.r.t. input `x` for the
    incoming gradient `g`, and the gradients of the cut tensors, keeping
    the graph for the W pass. Returns (dx, [cut gradients])."""
    outs = torch.autograd.grad(y, [x] + [c for _, c in cuts], g,
                               retain_graph=True, allow_unused=True)
    return outs[0], list(outs[1:])


def w_pass(cuts, grads):
    """W: each cut's local backward into its module's own parameters,
    accumulated into their ``.grad`` (those nodes are freed)."""
    for (params, c), g in zip(cuts, grads):
        if g is not None:
            torch.autograd.backward(c, g, inputs=params)


@dataclasses.dataclass
class LayerSplit:
    """The split of one captured layer (``capture_and_split``):
    ``chain_fn(g, consts) -> (dx, cuts)`` is B; ``wgrad_fn(g,
    consts_subset, cuts) -> [dparam]`` is W. ``consts`` is the stash,
    ``merge_consts(layer_params, extra, variant)`` rebuilds it from what
    the forward returned, as in the JAX package."""
    n_params: int
    chain_fn: Callable
    wgrad_fn: Callable
    wgrad_const_idx: list
    variant_idx: list

    def merge_consts(self, layer_params, extra, variant_consts):
        return tuple(variant_consts)


def capture_and_split(layer_fn, params, key, x, extra, box):
    """Run ``layer_fn(params, key, x, *extra)`` keeping its graph, and put
    its B / W split in ``box['split']``. Returns (y, the stash). One call
    site per box, as in the JAX package."""
    if box.get("split") is not None:
        raise RuntimeError(
            "capture_and_split: one call site per box — pass a fresh box "
            "for a second layer")
    params = list(params)
    xin = x.detach().requires_grad_(True)
    y = layer_fn(params, key, xin, *extra)

    def chain_fn(g, consts):
        y_, xin_ = consts
        return b_pass(y_, xin_, g)[0], ()

    def wgrad_fn(g, consts_subset, cuts):
        grads = torch.autograd.grad(y, params, g, allow_unused=True)
        return [torch.zeros_like(p) if d is None else d
                for p, d in zip(params, grads)]

    box["split"] = LayerSplit(n_params=len(params), chain_fn=chain_fn,
                              wgrad_fn=wgrad_fn, wgrad_const_idx=[],
                              variant_idx=[0, 1])
    return y, (y, xin)
