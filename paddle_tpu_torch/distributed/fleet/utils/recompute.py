"""Activation recompute: the counterpart of
``paddle_tpu/distributed/fleet/utils/recompute.py`` (``recompute``).

``recompute(function, *args, **kwargs)`` runs ``function`` without
keeping its activations and runs it again in the backward to get them,
through ``torch.utils.checkpoint`` (non-reentrant; ``use_reentrant`` is
taken and ignored, as it changes nothing in the result). With
``preserve_rng_state`` (the default) the replay draws the same random
numbers as the forward: torch's own CPU and CUDA generators through
``torch.utils.checkpoint``, and the port's default generators
(``framework.random``, which dropout and the bdrln seed draw from)
saved at the forward and restored for the replay, then put back. A
generator passed explicitly to a functional (``generator=``) is the
caller's to replay.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ....framework import random as prandom


def _port_rng_contexts(args):
    """(forward context, recompute context) for ``checkpoint``'s
    context_fn: the forward snapshots the port's default generators (made
    first for the CPU and the devices of the tensor arguments, so that a
    generator's first use inside the function is replayed too); the
    recompute sets the snapshot and restores the live states after."""
    box = {}

    @contextlib.contextmanager
    def forward():
        prandom.default_generator("cpu")
        for a in args:
            if isinstance(a, torch.Tensor):
                prandom.default_generator(a.device)
        box["state"] = prandom.get_rng_state()
        yield

    @contextlib.contextmanager
    def recompute():
        live = prandom.get_rng_state()
        prandom.set_rng_state(box["state"])
        try:
            yield
        finally:
            prandom.set_rng_state(live)

    return forward(), recompute()


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward. Outside grad mode it is a plain call."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    ctx = (lambda: _port_rng_contexts(args)) if preserve else \
        noop_context_fn
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, context_fn=ctx, **kwargs)
