"""Cleanup passes: DCE, CSE and constant folding over rewritten fx graphs,
the counterpart of ``paddle_tpu/compiler/cleanup.py``.

After pattern fusion splices a fused op over a matched subgraph, the
original producer nodes (the softmax chain, the mask's construction, the
rotate-half slices) are left dangling: DCE removes everything no output
or effect depends on. CSE merges identical nodes (a table broadcast once
for q and once for k, a mask built per layer). Constant folding
evaluates constant subgraphs of a small result into stored constants.

All three keep the graph's placeholders and outputs exactly (the
PassManager contract), keep effectful nodes (mutating or random ops, and
anything fx calls impure), and return the input object unchanged when
they find nothing to do. A change is a new GraphModule (``replay``).
CSE and constant folding leave a graph with an in-place op alone: a
merged or stored value could then be written through one of its users
or their views, and the program would see another program's writes.
"""

from __future__ import annotations

import torch
from torch.fx import Node

from .pass_manager import Pass, register_graph_pass
from .patterns import Graph, val
from .rewrites import replay

__all__ = ["DCEPass", "CSEPass", "ConstantFoldPass", "dce", "effectful"]


def effectful(n):
    """Whether node n must stay even when nothing reads it: placeholders,
    the output, mutating or random ops, and what fx calls impure."""
    if n.op in ("placeholder", "output"):
        return True
    t = n.target
    if isinstance(t, torch._ops.OpOverload):
        return (t._schema.is_mutable or
                torch.Tag.nondeterministic_seeded in t.tags)
    if isinstance(t, torch._ops.HigherOrderOperator):
        return False
    return n.op != "get_attr" and n.is_impure()


def _mutates(gm):
    """Whether any op of gm writes one of its inputs in place."""
    return any(isinstance(n.target, torch._ops.OpOverload)
               and n.target._schema.is_mutable for n in gm.graph.nodes)


def dce(gm):
    """Dead-code elimination: keeps every effectful node and everything
    the outputs transitively read; the same object when nothing is
    dead."""
    live = set()
    for n in reversed(gm.graph.nodes):
        if effectful(n) or any(u in live for u in n.users):
            live.add(n)
    if len(live) == len(gm.graph.nodes):
        return gm
    # a dead node stands for nothing: no live node reads it
    return replay(gm, lambda n, env, g2, attrs: None if n in live
                  else _DEAD)


_DEAD = object()


class DCEPass(Pass):
    name = "dce"

    def run(self, gm, ctx):
        return dce(gm)


def _key(n, env_key):
    """Hashable identity of node n's computation (target, arguments by
    their representative), or None when it may not be shared."""
    if n.op != "call_function" or effectful(n):
        return None

    def k(a):
        if isinstance(a, Node):
            return ("node", env_key[a])
        if isinstance(a, (list, tuple)):
            return (type(a).__name__,) + tuple(k(x) for x in a)
        if isinstance(a, (torch.dtype, torch.device, torch.layout,
                          torch.memory_format)):
            return ("const", str(a))
        try:
            hash(a)
        except TypeError:
            raise ValueError("unhashable argument") from None
        return ("const", type(a).__name__, a)
    try:
        return (n.target, k(n.args),
                tuple(sorted((name, k(v)) for name, v in n.kwargs.items())))
    except ValueError:
        return None


class CSEPass(Pass):
    """Common-subexpression elimination: two nodes of one target on the
    same arguments share one result."""

    name = "cse"

    def run(self, gm, ctx):
        if _mutates(gm):
            return gm
        rep, seen = {}, {}
        for n in gm.graph.nodes:
            key = _key(n, rep)
            if key is not None and key in seen:
                rep[n] = seen[key]
                continue
            rep[n] = n
            if key is not None:
                seen[key] = n
        if all(rep[n] is n for n in gm.graph.nodes):
            return gm

        def hook(n, env, g2, attrs):
            return env[rep[n]] if rep[n] is not n else None
        return dce(replay(gm, hook))


class ConstantFoldPass(Pass):
    """Fold nodes whose inputs are all constants (no placeholder behind
    them, nothing random) into stored constants, up to MAX_FOLD_ELEMS
    elements: past that, computing in the graph beats keeping the value
    resident."""

    name = "constant_fold"
    MAX_FOLD_ELEMS = 1 << 16

    def run(self, gm, ctx):
        if _mutates(gm):
            return gm
        g = Graph(gm)
        cache = {}

        def foldable(n):
            if n not in cache:
                v = val(n)
                c = None
                if n.op == "call_function" and not effectful(n) and \
                        isinstance(v, torch.Tensor) and \
                        v.numel() <= self.MAX_FOLD_ELEMS:
                    c = g.concrete(n, max_elems=self.MAX_FOLD_ELEMS)
                    if c is not None and (tuple(c.shape) != tuple(v.shape)
                                          or c.dtype != v.dtype):
                        c = None
                cache[n] = None if c is None else c.to(v.device)
            return cache[n]

        # fold the last constants of each chain: those a computing node
        # (or the output) reads
        folded = {n: foldable(n) for n in gm.graph.nodes
                  if foldable(n) is not None and
                  any(foldable(u) is None for u in n.users)}
        if not folded:
            return gm

        def hook(n, env, g2, attrs):
            c = folded.get(n)
            if c is None:
                return None
            i = len(attrs)
            while f"_folded_constant{i}" in attrs or \
                    hasattr(gm, f"_folded_constant{i}"):
                i += 1
            attrs[f"_folded_constant{i}"] = c
            node = g2.get_attr(f"_folded_constant{i}")
            node.meta = dict(n.meta)
            return node
        return dce(replay(gm, hook))


register_graph_pass("dce", DCEPass)
register_graph_pass("cse", CSEPass)
register_graph_pass("constant_fold", ConstantFoldPass)
