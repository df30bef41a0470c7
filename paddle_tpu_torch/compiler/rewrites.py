"""Graph rewriting: splice matched subgraphs onto the kernels' custom ops,
the counterpart of ``paddle_tpu/compiler/rewrites.py``.

A rewrite *replays* the captured graph into a new one (``replay``): every
node is copied, EXCEPT the head of a validated :class:`~.patterns.
Candidate`, in whose place the fused builder's own small graph is
inlined. The builder is a plain function of the candidate's inputs that
calls the ``ptt`` custom ops (``ops.kernels._ops``): the flash forward,
RMSNorm, SwiGLU, RoPE. It is captured with ``make_fx`` on the inputs'
fake values, so the rewrite costs no kernel launch and the fused op
lands in the program as one ``torch.ops.ptt.*`` node, the counterpart of
the JAX package's ``pjit[name=fused_*]`` equation. The original producer
nodes stay behind for the DCE pass.

Fallback-to-original guarantee (two layers):

1. before the replay, each candidate's builder is evaluated on fake
   tensors (the counterpart of ``jax.eval_shape``); an exception, or an
   output whose shape, dtype or layout disagrees with the head's, drops
   the candidate (counted in ``compiler_fallbacks_total{pattern=}`` and a
   ``compiler_fallback`` event);
2. a splice that raises keeps the original head.

The replay descends into the subgraphs a capture keeps: the graph
arguments of higher-order ops (``torch.cond``'s branches,
``while_loop``'s body and condition), rebinding the op to the rewritten
subgraph when its placeholders and outputs are unchanged. The JAX
package's other descents have no counterpart: a nested ``jax.jit``
(``pjit``) and ``jax.checkpoint`` (``remat2``) are inlined by an ATen
capture (``torch.utils.checkpoint`` leaves no node), and ``lax.scan``'s
counterpart, a Python loop, is unrolled.
"""

from __future__ import annotations

import copy

import torch
from torch.fx import GraphModule, Node

from .pass_manager import Pass, register_graph_pass
from .patterns import Graph, MATCHERS, val
from ..observability.events import EVENTS as _EVENTS
from ..observability.metrics import REGISTRY as _REG

__all__ = ["replay", "PatternFusionPass", "register_builder", "BUILDERS",
           "make_fused_pass", "DEFAULT_PATTERNS", "fused_attention",
           "fused_rms_norm", "fused_swiglu", "fused_rope"]


# --------------------------------------------------------------------------
# replay
# --------------------------------------------------------------------------

def replay(gm, hook=None):
    """A new GraphModule copying gm's graph node by node.

    hook(node, env, graph, attrs) -> a node of the new graph standing for
    `node`, or None to copy it: env maps old nodes to new, graph is the new
    graph, attrs a dict of new module attributes (name -> value) for
    get_attr nodes the hook creates."""
    g2 = torch.fx.Graph()
    g2._codegen = copy.deepcopy(gm.graph._codegen)
    env, attrs = {}, {}
    for n in gm.graph.nodes:
        rep = hook(n, env, g2, attrs) if hook is not None else None
        if rep is None:
            rep = g2.node_copy(n, lambda a: env[a])
        env[n] = rep
    root = {}
    for n in g2.nodes:
        if n.op == "get_attr":
            root[n.target] = attrs[n.target] if n.target in attrs else \
                _fetch(gm, n.target)
    out = GraphModule(root, g2)
    out.meta.update(gm.meta)
    return out


def _fetch(mod, target):
    for part in target.split("."):
        mod = getattr(mod, part)
    return mod


def _fresh_name(attrs, gm, base):
    i = 0
    while f"{base}{i}" in attrs or hasattr(gm, f"{base}{i}"):
        i += 1
    return f"{base}{i}"


def inline(sub, inputs, env_graph, attrs, gm):
    """Copy the graph of `sub` (a captured builder) into env_graph with its
    placeholders bound to `inputs`; returns what its output holds."""
    env = {}
    it = iter(inputs)
    for n in sub.graph.nodes:
        if n.op == "placeholder":
            env[n] = next(it)
        elif n.op == "output":
            out = n.args[0]
            if isinstance(out, (tuple, list)) and len(out) == 1:
                out = out[0]
            return torch.fx.node.map_arg(out, lambda a: env[a])
        elif n.op == "get_attr":
            name = _fresh_name(attrs, gm, "_fused_constant")
            attrs[name] = _fetch(sub, n.target)
            env[n] = env_graph.get_attr(name)
            env[n].meta = copy.copy(n.meta)
        else:
            env[n] = env_graph.node_copy(n, lambda a: env[a])
    raise ValueError("builder graph has no output")


def capture_builder(build, fakes):
    """`build` captured on fake values (the candidate's inputs'), reusing
    their fake mode: the gate's evaluation and the spliced graph at once.
    No kernel runs."""
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(build, tracing_mode="fake")(*fakes)


# --------------------------------------------------------------------------
# fused targets: plain functions of the matched inputs over the custom ops
# --------------------------------------------------------------------------

def _kernel_ops():
    from ..ops.kernels import _ops
    return _ops


def _arrange(x, plan):
    """An attention operand in the kernel's [B, S, H, D] layout from its
    root (``patterns._plan``)."""
    return x.reshape(plan["split"]).permute(plan["perm"]).reshape(
        plan["shape"]).contiguous()


def fused_attention(q, k, v, mask=None, *, causal=False, scale=1.0,
                    mask_mode=None):
    """softmax(QK^T*scale [mask]) @ V on [B, S, H, D] (K/V with fewer
    heads under GQA): the flash forward kernel's op for the unmasked and
    causal forms; the port's plain ``_sdpa_dense`` for masked forms (a
    [B, H, S, T] bool mask, True = attend, or an additive one), as JAX
    sends them to ``_sdpa_xla``."""
    from ..nn.functional import _sdpa_dense
    from ..ops.kernels.flash_attention import MAX_HEAD_DIM
    d = q.shape[-1]
    if mask is None:
        if not (q.dtype == k.dtype == v.dtype) or \
                q.dtype not in (torch.float32, torch.bfloat16,
                                torch.float16) or d % 8 or d > MAX_HEAD_DIM:
            raise ValueError(f"flash attention takes q, k, v of one float "
                             f"type and head dims % 8 up to {MAX_HEAD_DIM}"
                             f", got {q.dtype}/{k.dtype}/{v.dtype}, D {d}")
        return _kernel_ops().flash_attention_fwd_op(q, k, v, bool(causal),
                                                    float(scale))[0]
    if mask_mode in ("keep", "drop"):
        # where-derived masks select, never add: an int 0/1 mask coerces
        if mask.dtype != torch.bool:
            mask = mask != 0
        if mask_mode == "drop":
            mask = ~mask
    return _sdpa_dense(q, k, v, mask, 0.0, False, training=False,
                       scale=scale)


def fused_rms_norm(x, w, b=None, *, eps=1e-6):
    out = _kernel_ops().rms_norm_op(x.contiguous(), w.contiguous(),
                                    float(eps))
    return out if b is None else out + b


def fused_swiglu(x, y):
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"swiglu takes gate and up of one shape and type, "
                         f"got {x.dtype}{tuple(x.shape)}/"
                         f"{y.dtype}{tuple(y.shape)}")
    return _kernel_ops().swiglu_op(x.contiguous(), y.contiguous())


def fused_rope(x, cos, sin):
    """x [B, S, H, D]; cos/sin [S, D]."""
    return _kernel_ops().fused_rope_op(x.contiguous(), cos.contiguous(),
                                       sin.contiguous())


# pattern name -> builder(candidate) -> callable(*input values) whose
# output stands for the head's. Split from the matchers so that other
# subsystems plug rewrites into the same engine (make_fused_pass).
BUILDERS = {}


def register_builder(pattern, fn=None):
    def deco(f):
        BUILDERS[pattern] = f
        return f
    if fn is not None:
        return deco(fn)
    return deco


@register_builder("attention")
def _build_attention(cand):
    p = cand.params
    pq, pk, pv = p["plans"]
    b, s, h, d = pq["shape"]
    t = pk["shape"][1]

    def build(q, k, v, mask=None):
        q, k, v = _arrange(q, pq), _arrange(k, pk), _arrange(v, pv)
        if mask is not None:
            mask = mask.expand(p["logits_shape"]).reshape(b, h, s, t)
        out = fused_attention(q, k, v, mask, causal=p["causal"],
                              scale=p["scale"], mask_mode=p["mask_mode"])
        return out.transpose(1, 2).reshape(b * h, s, d)   # the PV bmm's
    return build


@register_builder("rms_norm")
def _build_rms_norm(cand):
    eps = cand.params["eps"]
    if cand.params.get("has_bias"):
        return lambda x, w, b: fused_rms_norm(x, w, b, eps=eps)
    return lambda x, w: fused_rms_norm(x, w, eps=eps)


@register_builder("swiglu")
def _build_swiglu(cand):
    return fused_swiglu


@register_builder("rope")
def _build_rope(cand):
    if cand.params.get("seq_axis", 1) == 1:
        return fused_rope
    return lambda x, cos, sin: fused_rope(x.transpose(1, 2), cos,
                                          sin).transpose(1, 2)


# --------------------------------------------------------------------------
# the fusion pass
# --------------------------------------------------------------------------

# the default pipeline's pattern set, a FIXED list, so that subsystems
# registering extra rewrites never leak into default fusion
DEFAULT_PATTERNS = ("attention", "rms_norm", "swiglu", "rope")
_MAX_DEPTH = 3


def _counter(name, pattern):
    return _REG.counter(name, "graph pattern-fusion " + name,
                        labels={"pattern": pattern})


class _Pending:
    """Per-(sub)program telemetry buffer: candidates seen, rewrites
    applied, fallbacks recorded. Buffers merge upward only when the
    (sub)program they describe lands in the program shipped."""

    __slots__ = ("candidates", "applied", "fallbacks")

    def __init__(self):
        self.candidates = []
        self.applied = []
        self.fallbacks = []

    def merge(self, other):
        self.candidates.extend(other.candidates)
        self.applied.extend(other.applied)
        self.fallbacks.extend(other.fallbacks)


def _same_layout(out, want):
    """The fused output may stand for the head: same shape and type
    (contiguous, so any view the program takes of the head is valid)."""
    return (isinstance(out, torch.Tensor) and tuple(out.shape) ==
            tuple(want.shape) and out.dtype == want.dtype and
            out.is_contiguous())


class PatternFusionPass(Pass):
    """Find pattern candidates, validate each rewrite on fake tensors,
    splice the survivors. ``patterns`` names a subset of the registered
    matchers (default: DEFAULT_PATTERNS); ``local_rewrites`` maps extra
    pattern names to (matcher, builder) pairs owned by THIS pass only."""

    def __init__(self, name="pattern_fusion", patterns=None, descend=True,
                 local_rewrites=None):
        self.name = name
        self.local = dict(local_rewrites or {})
        self.patterns = list(patterns) if patterns is not None else (
            list(self.local) if self.local else list(DEFAULT_PATTERNS))
        self.descend = descend

    def _pattern_names(self, ctx):
        return ctx.options.get(self.name + ".patterns") or self.patterns

    def _find(self, gm, ctx):
        g = Graph(gm)
        seen, out = set(), []
        for name in self._pattern_names(ctx):
            matcher = self.local[name][0] if name in self.local \
                else MATCHERS[name]
            for c in matcher(g):
                if c.head not in seen:
                    seen.add(c.head)
                    out.append(c)
        return out

    def _builder(self, pattern):
        return self.local[pattern][1] if pattern in self.local \
            else BUILDERS[pattern]

    def run(self, gm, ctx):
        pending = _Pending()
        out = self._run(gm, ctx, 0, pending)
        # commit the telemetry only now: a descended subgraph rewritten and
        # then reverted dropped its entries, so counters, records and
        # events describe the program that ships
        for c in pending.candidates:
            _counter("compiler_candidates_total", c.pattern).inc()
        for c in pending.applied:
            _counter("compiler_rewrites_total", c.pattern).inc()
            rec = dict(c.describe(), status="applied", program=ctx.program)
            ctx.records.append(rec)
            _EVENTS.record("compiler_rewrite", **rec)
        for c, reason in pending.fallbacks:
            _counter("compiler_fallbacks_total", c.pattern).inc()
            rec = dict(c.describe(), status="fallback",
                       reason=reason[:300], program=ctx.program)
            ctx.records.append(rec)
            _EVENTS.record("compiler_fallback", **rec)
        return out

    def _validate(self, c):
        """(captured builder graph, None) or (None, the reason to keep the
        original)."""
        fakes = [val(n) for n in c.inputs]
        if any(not isinstance(f, torch.Tensor) for f in fakes):
            return None, "an input has no recorded value"
        build = self._builder(c.pattern)(c)
        try:
            # contiguous: a view after the head is then valid whatever
            # the builder's own layout (a no-op for a contiguous output)
            sub = capture_builder(lambda *a: build(*a).contiguous(), fakes)
        except Exception as e:  # noqa: BLE001 — fallback guarantee
            return None, f"fake evaluation failed: {type(e).__name__}: {e}"
        outs = [n for n in sub.graph.nodes if n.op == "output"][0].args[0]
        if isinstance(outs, (tuple, list)):
            outs = outs[0] if len(outs) == 1 else None
        got, want = val(outs), c.out_val
        if not _same_layout(got, want):
            return None, (f"fake value mismatch: fused "
                          f"{getattr(got, 'dtype', '?')}"
                          f"{tuple(getattr(got, 'shape', ()))} vs original "
                          f"{want.dtype}{tuple(want.shape)}")
        return sub, None

    def _run(self, gm, ctx, depth, pending):
        valid = {}
        for c in self._find(gm, ctx):
            pending.candidates.append(c)
            sub, reason = self._validate(c)
            if reason is None:
                valid[c.head] = (c, sub)
            else:
                pending.fallbacks.append((c, reason))
        descents = {}
        if self.descend and depth < _MAX_DEPTH:
            for n in gm.graph.nodes:
                if n.op == "get_attr" and isinstance(
                        _fetch(gm, n.target), GraphModule):
                    hit = self._descend(gm, n, ctx, depth)
                    if hit is not None:
                        descents[n.target] = hit
        if not valid and not descents:
            return gm             # identity: nothing to splice

        def hook(n, env, g2, attrs):
            hit = valid.get(n)
            if hit is not None:
                c, sub = hit
                try:
                    rep = inline(sub, [env[i] for i in c.inputs], g2,
                                 attrs, gm)
                    if not isinstance(rep, Node):
                        raise TypeError("fused builder returned no tensor")
                    pending.applied.append(c)
                    return rep
                except Exception as e:  # noqa: BLE001 — keep the original
                    pending.fallbacks.append(
                        (c, f"splice failed: {type(e).__name__}: {e}"))
                    return None
            if n.op == "get_attr" and n.target in descents:
                new_sub, sub_pending = descents[n.target]
                attrs[n.target] = new_sub
                pending.merge(sub_pending)
                rep = g2.get_attr(n.target)
                rep.meta = copy.copy(n.meta)
                return rep
            return None

        return replay(gm, hook)

    def _descend(self, gm, node, ctx, depth):
        """(rewritten subgraph, its pending telemetry) for a graph held by
        a higher-order op, or None. Reverts (None) when the rewrite would
        change the subgraph's placeholders or outputs."""
        inner = _fetch(gm, node.target)
        sub_pending = _Pending()
        ctx.depth += 1
        try:
            new = self._run(inner, ctx, depth + 1, sub_pending)
        except Exception:  # noqa: BLE001 — descent is best-effort
            return None
        finally:
            ctx.depth -= 1
        if new is inner or _signature(new) != _signature(inner):
            return None
        from .cleanup import dce
        return dce(new), sub_pending


def _signature(gm):
    """(placeholder shapes, output count) of a graph."""
    ph = [tuple(getattr(val(n), "shape", ())) for n in gm.graph.nodes
          if n.op == "placeholder"]
    res = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    return ph, len(res) if isinstance(res, (tuple, list)) else 1


register_graph_pass("pattern_fusion", PatternFusionPass)


def make_fused_pass(name, matcher, builder):
    """One-off fusion pass from a (matcher, builder) pair sharing this
    engine. The pair stays LOCAL to the returned pass: it never joins the
    default pipeline's pattern set."""
    return PatternFusionPass(name=name + "_fusion", patterns=[name],
                             local_rewrites={name: (matcher, builder)})
