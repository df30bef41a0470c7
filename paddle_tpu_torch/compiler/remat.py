"""Remat policy: the fused ops' outputs are what a rematerialized step
keeps. The counterpart of ``paddle_tpu/compiler/remat.py``.

The JAX package names each spliced fused op's output with
``checkpoint_name`` and keeps exactly those under
``save_only_these_names``. PyTorch's counterpart of that policy works on
ops, not on names: ``torch.utils.checkpoint``'s selective checkpoint
(``create_selective_checkpoint_contexts``) asks a policy, for every op the
recomputed region runs, whether to keep its output or to run it again in
the backward. ``fused_save_policy()`` keeps the outputs of the kernels'
custom ops behind each name in ``FUSED_REMAT_NAMES`` (one flash
attention, RMSNorm, SwiGLU and RoPE activation per site: the costly ones
to recompute, whose kernels then launch once a step) and recomputes
everything else. ``jit.compile_train_step(..., fuse=True,
remat_policy="fused")`` runs the fused program under it, cut after each
kept op into pieces that are checkpointed apart (``segmented``), so that
the backward recomputes piece by piece as XLA's remat recomputes value
by value.

``RematTagPass`` (``remat_tag``, in the default pipeline) records each
fused op's checkpoint name on its node (``node.meta["checkpoint_name"]``,
in descended subgraphs too), which the dumps print and readers of a
program count; like the JAX tags outside a checkpoint, the names change
nothing that runs.
"""

from __future__ import annotations

import copy
import functools
import operator

import torch

from .pass_manager import Pass, register_graph_pass

__all__ = ["RematTagPass", "FUSED_REMAT_NAMES", "fused_save_policy",
           "fused_ops", "segmented"]

# names match the fused targets in rewrites.py (+ quantization's, which
# has no op in the port yet: see ROADMAP)
FUSED_REMAT_NAMES = ("fused_attention", "fused_rms_norm", "fused_swiglu",
                     "fused_rope", "fused_quant_linear")


def fused_ops():
    """{checkpoint name: the custom ops (OpOverloads) behind it}."""
    from ..ops.kernels import _ops
    return {
        "fused_attention": (_ops.flash_attention_fwd_op._opoverload,
                            _ops.flashmask_attention_fwd_op._opoverload),
        "fused_rms_norm": (_ops.rms_norm_op._opoverload,),
        "fused_swiglu": (_ops.swiglu_op._opoverload,),
        "fused_rope": (_ops.fused_rope_op._opoverload,
                       _ops.fused_rope_qk_op._opoverload),
        "fused_quant_linear": (),
    }


def _name_of():
    return {op: name for name, ops in fused_ops().items() for op in ops}


def fused_save_policy(extra_names=()):
    """A selective-checkpoint policy (for ``create_selective_checkpoint_
    contexts``) that keeps the outputs of the named fused ops and
    recomputes every other op."""
    from torch.utils.checkpoint import CheckpointPolicy
    names = set(FUSED_REMAT_NAMES) | set(extra_names)
    keep = {op for op, name in _name_of().items() if name in names}

    def policy(ctx, op, *args, **kwargs):
        if op in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    policy.names = tuple(sorted(names))
    policy.ops = frozenset(keep)
    return policy


class _Checkpointed(torch.nn.Module):
    """One segment of a program, run under a selective checkpoint."""

    def __init__(self, segment, policy):
        super().__init__()
        self.segment = segment
        self._policy = policy

    def forward(self, *args):
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)
        # a captured program draws no random number (capture refuses
        # one), so there is no RNG state to keep for the recompute
        return checkpoint(
            self.segment, *args, use_reentrant=False,
            preserve_rng_state=False, determinism_check="none",
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, self._policy))


def segmented(gm, policy):
    """gm cut after each op the policy keeps (``policy.ops``), each piece
    run under its own selective checkpoint with `policy`: the backward
    recomputes a piece's other ops from the piece's inputs and the kept
    outputs, one piece at a time. (One checkpoint around the whole
    program would recompute the whole forward at the backward's first
    use and hold all of it again: no memory saved, where XLA's remat
    recomputes value by value.)"""
    from torch.fx.passes.split_module import split_module
    part, cur = {}, 0
    for n in gm.graph.nodes:
        if n.op == "call_function" and n.target is operator.getitem and \
                isinstance(n.args[0], torch.fx.Node):
            part[n] = part[n.args[0]]          # with its op's outputs
            continue
        part[n] = cur
        if n.op == "call_function" and n.target in policy.ops:
            cur += 1
    out = split_module(gm, gm, lambda n: part[n], keep_original_order=True)
    for name, sub in list(out.named_children()):
        setattr(out, name, _Checkpointed(sub, policy))
    return out


class RematTagPass(Pass):
    name = "remat_tag"
    _MAX_DEPTH = 3

    def run(self, gm, ctx):
        return self._run(gm, _name_of(), 0)

    def _run(self, gm, names, depth):
        from .rewrites import _fetch, replay
        from torch.fx import GraphModule
        tags = {n: names[n.target] for n in gm.graph.nodes
                if n.op == "call_function" and n.target in names
                and n.meta.get("checkpoint_name") != names[n.target]}
        subs = {}
        if depth < self._MAX_DEPTH:
            for n in gm.graph.nodes:
                if n.op == "get_attr":
                    inner = _fetch(gm, n.target)
                    if isinstance(inner, GraphModule):
                        new = self._run(inner, names, depth + 1)
                        if new is not inner:
                            subs[n.target] = new
        if not tags and not subs:
            return gm

        def hook(n, env, g2, attrs):
            if n.op == "get_attr" and n.target in subs:
                attrs[n.target] = subs[n.target]
                rep = g2.get_attr(n.target)
                rep.meta = copy.copy(n.meta)
                return rep
            if n in tags:
                rep = g2.node_copy(n, lambda a: env[a])
                rep.meta = dict(n.meta, checkpoint_name=tags[n])
                return rep
            return None
        return replay(gm, hook)


register_graph_pass("remat_tag", RematTagPass)


def checkpoint_names(gm):
    """The checkpoint names tagged in gm and its subgraphs, in order."""
    from .rewrites import _fetch
    from torch.fx import GraphModule
    out = []
    for n in gm.graph.nodes:
        if "checkpoint_name" in n.meta:
            out.append(n.meta["checkpoint_name"])
        if n.op == "get_attr":
            inner = _fetch(gm, n.target)
            if isinstance(inner, GraphModule):
                out.extend(checkpoint_names(inner))
    return out

