"""Declarative subgraph matching over captured fx graphs: the counterpart
of ``paddle_tpu/compiler/patterns.py``.

The graph is an ATen-level capture (``compiler.capture``, through
``make_fx``), the counterpart of a jaxpr: ``F.silu(g) * u`` and
``g * torch.sigmoid(g) * u`` both become ATen ops, the rsqrt and
reciprocal-of-sqrt forms of a norm meet there, and ``torch.einsum`` and
``@`` both become ``bmm`` between views. Each matcher walks producer
chains backward from an anchor node (the pattern's last op, its *head*)
and returns :class:`Candidate` records naming the head, the input nodes
the fused replacement consumes, and static params (eps, scale, causal,
the layout plan). Matchers never mutate the graph; ``rewrites`` turns
candidates into spliced custom ops, gated on a fake-tensor evaluation.

Matched compositions:

- ``rms_norm``  : x * rsqrt(mean(x^2, -1) + eps) * w [+ b] (rsqrt or
                  reciprocal(sqrt) or x / sqrt; the mean as ``mean`` or
                  ``sum / n``; optional float32 compute casts around a
                  bf16/f16 x, before or after the weight multiply)
- ``swiglu``    : silu(x) * y (``aten.silu`` or x * sigmoid(x))
- ``rope``      : x*cos + rotate_half(x)*sin with rotate_half ==
                  cat(-x[..., d/2:], x[..., :d/2]) and cos/sin broadcast
                  up from [S, D] tables onto x's sequence and head-dim
                  axes ([B, S, H, D], or [B, H, S, D])
- ``attention`` : softmax(QK^T * scale [causal/bool/additive mask]) @ V,
                  two batched products over any view chain (einsum or
                  matmul, either layout, the GQA repeat of K/V, bf16
                  compute casts)

A batched product's operands are read through ``layout``: the view chain
back to the first op that computes (its *root*), expressed as which
pieces ("atoms") of the root's dims each operand dim holds. That is what
the JAX matcher reads from ``dot_general``'s dimension numbers, the
``swapaxes`` before it and ``jnp.repeat``'s broadcast (``_unrepeat_kv``,
``_to_bshd``). Constant subgraphs are evaluated (``Graph.concrete``) so
that a ``tril`` mask reads as causal rather than as a dense mask.

A call of ``F.scaled_dot_product_attention`` is one ATen op already and
is left alone, as the JAX matcher leaves its own fused op alone.
"""

from __future__ import annotations

import torch
from torch.fx import Node

__all__ = ["Graph", "Candidate", "MATCHERS", "register_matcher",
           "find_candidates", "layout"]

aten = torch.ops.aten


def _ops(*names):
    out = set()
    for n in names:
        packet, _, overload = n.partition(".")
        op = getattr(aten, packet, None)
        if op is not None and hasattr(op, overload or "default"):
            out.add(getattr(op, overload or "default"))
    return frozenset(out)


_CAST = _ops("_to_copy")
_VIEWS = _ops("view", "_unsafe_view", "reshape", "expand", "permute",
              "transpose.int", "t", "unsqueeze", "squeeze.dim",
              "squeeze.dims", "squeeze", "clone", "alias", "detach",
              "lift_fresh_copy")
_MUL = _ops("mul.Tensor")
_DIV = _ops("div.Tensor")
_ADD = _ops("add.Tensor")
_SOFTMAX = _ops("_softmax", "_safe_softmax")


def val(n):
    """The fake value a capture recorded for node n (None for others)."""
    return n.meta.get("val") if isinstance(n, Node) else None


def _is_float(n):
    v = val(n)
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _shape(n):
    return tuple(val(n).shape)


def _is_cast(e):
    """A dtype-only copy (no device change)."""
    return e.target in _CAST and set(e.kwargs) <= {"dtype", "layout",
                                                  "memory_format"}


class Candidate:
    """One matched pattern instance.

    head: the node whose (single) output the rewrite replaces; inputs:
    nodes the fused builder consumes, in order; params: static facts
    (eps/scale/causal/layout plan) for the builder and for reporting.
    """

    __slots__ = ("pattern", "head", "inputs", "params")

    def __init__(self, pattern, head, inputs, params=None):
        self.pattern = pattern
        self.head = head
        self.inputs = list(inputs)
        self.params = dict(params or {})

    @property
    def out_val(self):
        return val(self.head)

    def describe(self):
        v = self.out_val
        return {"pattern": self.pattern,
                "out_shape": tuple(v.shape),
                "out_dtype": str(v.dtype).replace("torch.", ""),
                **{k: w for k, w in self.params.items()
                   if isinstance(w, (str, int, float, bool))}}


class Graph:
    """Producer/consumer index over one captured GraphModule, plus the
    concrete evaluation of constant subgraphs (causal masks)."""

    def __init__(self, gm):
        self.gm = gm
        self.graph = gm.graph
        out = next(n for n in reversed(gm.graph.nodes) if n.op == "output")
        self.out_set = set(out.all_input_nodes)
        self._concrete = {}

    # -- navigation ------------------------------------------------------
    @staticmethod
    def producer(v):
        if isinstance(v, Node) and v.op == "call_function":
            return v
        return None

    def single_consumer(self, v):
        """The one node consuming v, or None (0 or > 1 consumers, or v
        also a program output: then it must stay live and cannot fold into
        a larger head)."""
        if v in self.out_set:
            return None
        users = list(v.users)
        return users[0] if len(users) == 1 else None

    def skip(self, v):
        """Follow dtype casts back to the value they cast."""
        while True:
            e = self.producer(v)
            if e is None or not _is_cast(e):
                return v
            v = e.args[0]

    # -- literals and constants -------------------------------------------
    def scalar(self, v):
        """Python float of a number argument, or of a one-element
        constant subgraph (a ``torch.tensor(-1e30)`` node), else None."""
        if isinstance(v, bool):
            return None
        if isinstance(v, (int, float)):
            return float(v)
        c = self.concrete(v) if isinstance(v, Node) else None
        if c is not None and c.numel() == 1:
            return float(c.reshape(()).item())
        return None

    def concrete(self, v, max_elems=1 << 24, _depth=0):
        """A CPU tensor of v's value when v derives only from constants
        (no placeholder, nothing random), else None. Size-capped."""
        if not isinstance(v, Node):
            return None
        if v in self._concrete:
            return self._concrete[v]
        out = None
        if v.op == "get_attr":
            t = getattr(self.gm, v.target, None)
            if isinstance(t, torch.Tensor):
                out = t.detach().cpu()
        elif v.op == "call_function" and _depth < 64 \
                and isinstance(v.target, torch._ops.OpOverload) \
                and torch.Tag.nondeterministic_seeded not in v.target.tags \
                and not v.target._schema.is_mutable:
            o = val(v)
            if isinstance(o, torch.Tensor) and o.numel() <= max_elems:
                ok = True

                def sub(a):
                    nonlocal ok
                    if isinstance(a, Node):
                        c = self.concrete(a, max_elems, _depth + 1)
                        if c is None:
                            ok = False
                        return c
                    if isinstance(a, torch.device):
                        return torch.device("cpu")
                    return a
                args = torch.fx.node.map_aggregate(v.args, sub)
                kwargs = torch.fx.node.map_aggregate(dict(v.kwargs), sub)
                if ok:
                    try:
                        r = v.target(*args, **kwargs)
                        out = r if isinstance(r, torch.Tensor) else None
                    except Exception:  # noqa: BLE001 — opportunistic only
                        out = None
        self._concrete[v] = out
        return out


# --------------------------------------------------------------------------
# layouts: which pieces of a root value's dims each dim of a view holds
# --------------------------------------------------------------------------

def _merge(atoms):
    """Merge neighbouring atoms that are consecutive pieces of one dim."""
    out = []
    for a in atoms:
        if out:
            p = out[-1]
            if p[0] is None and a[0] is None:
                out[-1] = (None, p[1] * a[1], 1)
                continue
            if p[0] is not None and p[0] == a[0] and p[2] == a[1] * a[2]:
                out[-1] = (p[0], p[1] * a[1], a[2])
                continue
        out.append(a)
    return out


def _size(atoms):
    n = 1
    for a in atoms:
        n *= a[1]
    return n


def _split(a, tail):
    """Atom a cut into (head, tail) pieces, tail of size `tail`."""
    src, n, inner = a
    if src is None:
        return (None, n // tail, 1), (None, tail, 1)
    return (src, n // tail, inner * tail), (src, tail, inner)


def _regroup(atoms, target):
    atoms = list(atoms)
    out, i = [], 0
    for t in target:
        grp, prod = [], 1
        while prod < t:
            if i >= len(atoms) or t % prod:
                return None
            a = atoms[i]
            if prod * a[1] <= t:
                grp.append(a)
                prod *= a[1]
                i += 1
                continue
            need = t // prod
            if a[1] % need:
                return None
            head, tail = _split(a, a[1] // need)
            grp.append(head)
            prod *= need
            atoms[i] = tail
        if prod != t:
            return None
        out.append(_merge(grp))
    return out if i == len(atoms) else None


def _norm(d, nd):
    return d + nd if d < 0 else d


def _full_slice(e):
    if e.target is not aten.slice.Tensor:
        return False
    a = list(e.args) + [None] * (5 - len(e.args))
    x, dim, start, end, step = a[:5]
    dim = 0 if dim is None else dim
    n = val(x).shape[_norm(dim, val(x).dim())]
    return (start in (None, 0) and (end is None or end >= n)
            and step in (None, 1))


def _apply(e, dims):
    """The atoms of e's output dims from those of its input's."""
    t = e.target
    if t in (aten.clone.default, aten.alias.default, aten.detach.default,
             aten.lift_fresh_copy.default) or _is_cast(e) or _full_slice(e):
        return dims
    if t is aten.permute.default:
        nd = len(dims)
        return [dims[_norm(p, nd)] for p in e.args[1]]
    if t is aten.transpose.int:
        nd = len(dims)
        a, b = _norm(e.args[1], nd), _norm(e.args[2], nd)
        dims = list(dims)
        dims[a], dims[b] = dims[b], dims[a]
        return dims
    if t is aten.t.default:
        return list(reversed(dims)) if len(dims) == 2 else dims
    if t is aten.unsqueeze.default:
        dims = list(dims)
        dims.insert(_norm(e.args[1], len(dims) + 1), [])
        return dims
    if t in (aten.squeeze.dim, aten.squeeze.dims, aten.squeeze.default):
        nd = len(dims)
        if t is aten.squeeze.default:
            drop = set(range(nd))
        elif t is aten.squeeze.dim:
            drop = {_norm(e.args[1], nd)}
        else:
            drop = {_norm(d, nd) for d in e.args[1]}
        return [d for i, d in enumerate(dims)
                if not (i in drop and _size(d) == 1)]
    shape = tuple(val(e).shape)
    if t is aten.expand.default:
        dims = [[] for _ in range(len(shape) - len(dims))] + list(dims)
        out = []
        for d, s in zip(dims, shape):
            cur = _size(d)
            if cur == s:
                out.append(d)
            elif cur == 1:
                out.append([(None, s, 1)])
            else:
                return None
        return out
    if t in (aten.view.default, aten._unsafe_view.default,
             aten.reshape.default):
        return _regroup([a for d in dims for a in d], shape)
    return None


def layout(g, v, through_casts=False):
    """(root, dims) of value v: the first computing node behind v's chain
    of views (casts too with `through_casts`), and for each dim of v the
    list of its atoms (src dim of root, size, inner), outermost first; an
    atom of src None is a broadcast. None when the chain does something
    a layout cannot say (a partial slice, an unaligned reshape)."""
    chain, cur = [], v
    while True:
        e = g.producer(cur)
        if e is None or not (e.target in _VIEWS or _full_slice(e) or
                             (through_casts and _is_cast(e))):
            break
        if e.target is aten.lift_fresh_copy.default:
            break
        chain.append(e)
        cur = e.args[0]
    root = cur
    rv = val(root)
    if not isinstance(rv, torch.Tensor):
        return None
    dims = [[(i, s, 1)] if s != 1 else [] for i, s in enumerate(rv.shape)]
    for e in reversed(chain):
        dims = _apply(e, dims)
        if dims is None:
            return None
    return root, [_merge(d) for d in dims]


def _whole(atoms, i, n):
    """atoms == the whole root dim i of size n (or nothing, n == 1)."""
    return atoms == ([(i, n, 1)] if n != 1 else [])


# --------------------------------------------------------------------------
# rms_norm
# --------------------------------------------------------------------------

def _rsqrt_chain(g, v):
    """v == 1/sqrt(inner) in any spelling -> inner, else None."""
    e = g.producer(v)
    if e is None:
        return None
    t = e.target
    if t is aten.rsqrt.default:
        return e.args[0]
    if t is aten.reciprocal.default or (
            t is aten.pow.Tensor_Scalar and g.scalar(e.args[1]) == -1.0):
        se = g.producer(e.args[0])
        if se is not None and se.target is aten.sqrt.default:
            return se.args[0]
    return None


def _mean_sq_last(g, v, xs):
    """v == mean(x^2, -1, keepdim) for the same x (through casts)."""
    nd = val(xs).dim()
    n = val(xs).shape[-1]
    e = g.producer(v)
    if e is None:
        return False
    if e.target is aten.mean.dim:
        src, axes = e.args[0], e.args[1]
        keep = e.args[2] if len(e.args) > 2 else e.kwargs.get("keepdim")
    elif e.target in _DIV | _MUL:
        s = g.scalar(e.args[1])
        ok = s is not None and (
            (e.target in _DIV and s == float(n)) or
            (e.target in _MUL and abs(s - 1.0 / n) < 1e-12))
        se = g.producer(e.args[0]) if ok else None
        if se is None or se.target is not aten.sum.dim_IntList:
            return False
        src, axes = se.args[0], se.args[1]
        keep = se.args[2] if len(se.args) > 2 else se.kwargs.get("keepdim")
    else:
        return False
    if not keep or [_norm(a, nd) for a in axes] != [nd - 1]:
        return False
    sq = g.producer(g.skip(src))
    if sq is None:
        return False
    if sq.target is aten.pow.Tensor_Scalar and g.scalar(sq.args[1]) == 2.0:
        xin = sq.args[0]
    elif sq.target in _MUL and isinstance(sq.args[1], Node) \
            and g.skip(sq.args[0]) is g.skip(sq.args[1]):
        xin = sq.args[0]
    else:
        return False
    return g.skip(xin) is xs


def _rank1(g, v, n):
    """The rank-1 [n] value behind v's casts and broadcasting views, when
    v spreads it over the last dim."""
    if not isinstance(v, Node):
        return None
    lay = layout(g, v, through_casts=True)
    if lay is None:
        return None
    root, dims = lay
    if val(root).dim() != 1 or _shape(root) != (n,):
        return None
    real = [(i, d) for i, d in enumerate(dims) if any(a[0] is not None
                                                      for a in d)]
    if len(real) != 1 or real[0][0] != len(dims) - 1 \
            or real[0][1] != [(0, n, 1)]:
        return None
    return root


def match_rms_norm(g):
    out = []
    for n in g.graph.nodes:
        if n.op != "call_function":
            continue
        if n.target in _MUL:
            c = _match_rms_at(g, n)
        elif n.target in _DIV:
            c = _match_rms_div(g, n)
        else:
            continue
        if c is not None:
            out.append(c)
    return out


def _eps_of(g, inner, xs):
    """inner == mean(x^2) + eps -> eps (0 < eps < 1e-2), else None."""
    ae = g.producer(inner)
    if ae is None or ae.target not in _ADD:
        return None
    for mv, ev in ((ae.args[0], ae.args[1]), (ae.args[1], ae.args[0])):
        eps = g.scalar(ev)
        if eps is None or not 0.0 < eps < 1e-2 or not isinstance(mv, Node):
            continue
        if _mean_sq_last(g, mv, xs):
            return eps
    return None


def _match_rms_at(g, eqn):
    for x_, r_ in ((eqn.args[0], eqn.args[1]), (eqn.args[1], eqn.args[0])):
        if not isinstance(x_, Node) or not isinstance(r_, Node) \
                or not _is_float(x_):
            continue
        inner = _rsqrt_chain(g, g.skip(r_))
        if inner is None:
            continue
        xs = g.skip(x_)
        eps = _eps_of(g, inner, xs)
        if eps is not None:
            return _extend_rms(g, eqn, xs, eps)
    return None


def _match_rms_div(g, eqn):
    x_, d_ = eqn.args[0], eqn.args[1]
    if not isinstance(x_, Node) or not isinstance(d_, Node) \
            or not _is_float(x_):
        return None
    se = g.producer(g.skip(d_))
    if se is None or se.target is not aten.sqrt.default:
        return None
    xs = g.skip(x_)
    eps = _eps_of(g, se.args[0], xs)
    return None if eps is None else _extend_rms(g, eqn, xs, eps)


def _extend_rms(g, eqn, xs, eps):
    """From the normalized x: [cast] * w [cast] [+ b] — the fused op's
    contract needs the weight."""
    h = val(xs).shape[-1]
    head, ov = eqn, eqn
    ce = g.single_consumer(ov)
    if ce is not None and _is_cast(ce):
        head = ov = ce
        ce = g.single_consumer(ov)
    if ce is None or ce.target not in _MUL:
        return None
    other = ce.args[1] if ce.args[0] is ov else ce.args[0]
    w = _rank1(g, other, h)
    if w is None:
        return None
    head = ov = ce
    ce = g.single_consumer(ov)
    if ce is not None and _is_cast(ce):
        head = ov = ce
        ce = g.single_consumer(ov)
    bias = None
    if ce is not None and ce.target in _ADD:
        other = ce.args[1] if ce.args[0] is ov else ce.args[0]
        bias = _rank1(g, other, h)
        if bias is not None:
            head = ce
    inputs = [xs, w] + ([bias] if bias is not None else [])
    return Candidate("rms_norm", head, inputs,
                     {"eps": eps, "has_bias": bias is not None})


# --------------------------------------------------------------------------
# swiglu
# --------------------------------------------------------------------------

def _silu_input(g, v):
    """v == silu(x) -> x (aten.silu or x * sigmoid(x))."""
    e = g.producer(v)
    if e is None:
        return None
    if e.target is aten.silu.default:
        return e.args[0]
    if e.target in _MUL:
        for xi, si in ((e.args[0], e.args[1]), (e.args[1], e.args[0])):
            se = g.producer(si)
            if se is not None and se.target is aten.sigmoid.default \
                    and isinstance(xi, Node) \
                    and g.skip(se.args[0]) is g.skip(xi):
                return xi
    return None


def match_swiglu(g):
    out = []
    for n in g.graph.nodes:
        if n.op != "call_function" or n.target not in _MUL:
            continue
        a, b = n.args[0], n.args[1]
        for s_, y_ in ((a, b), (b, a)):
            if not isinstance(s_, Node) or not isinstance(y_, Node):
                continue
            x = _silu_input(g, s_)
            if x is None or not _is_float(x):
                continue
            if _shape(x) != _shape(y_) or _shape(n) != _shape(x):
                continue
            # x * silu(x) would count the gate operand twice
            if g.skip(y_) is g.skip(x):
                continue
            out.append(Candidate("swiglu", n, [x, y_], {}))
            break
    return out


# --------------------------------------------------------------------------
# rope (rotate-half rotary embedding)
# --------------------------------------------------------------------------

def _slice_last(e, x, start, stop):
    if e is None or e.target is not aten.slice.Tensor or e.args[0] is not x:
        return False
    a = list(e.args) + [None] * (5 - len(e.args))
    nd, d = val(x).dim(), val(x).shape[-1]
    dim = 0 if a[1] is None else _norm(a[1], nd)
    lo = 0 if a[2] is None else a[2]
    hi = d if a[3] is None else min(a[3], d)
    return dim == nd - 1 and lo == start and hi == stop and a[4] in (None, 1)


def _rotate_half_input(g, v):
    """v == cat(-x[..., d/2:], x[..., :d/2], -1) -> x."""
    e = g.producer(v)
    if e is None or e.target is not aten.cat.default:
        return None
    parts = e.args[0]
    dim = e.args[1] if len(e.args) > 1 else e.kwargs.get("dim", 0)
    if len(parts) != 2:
        return None
    ne = g.producer(parts[0])
    if ne is None or ne.target is not aten.neg.default:
        return None
    hi = g.producer(ne.args[0])
    lo = g.producer(parts[1])
    if hi is None or lo is None:
        return None
    x = hi.args[0]
    if not isinstance(x, Node) or _norm(dim, val(x).dim()) != val(x).dim() - 1:
        return None
    d = val(x).shape[-1]
    if d % 2 or not (_slice_last(hi, x, d // 2, d)
                     and _slice_last(lo, x, 0, d // 2)):
        return None
    return x


def _table(g, v, x):
    """The [S, D] table behind a cos/sin operand of x [B, S, H, D] (seq
    axis 1) or [B, H, S, D] (seq axis 2), and that seq axis; else None."""
    if not isinstance(v, Node) or val(x).dim() != 4:
        return None
    lay = layout(g, v, through_casts=True)
    if lay is None:
        return None
    root, dims = lay
    if val(root).dim() != 2 or not _is_float(root):
        return None
    s_, d_ = _shape(root)
    off = 4 - len(dims)
    if off < 0:
        return None
    real = {i + off: d for i, d in enumerate(dims)
            if any(a[0] is not None for a in d)}
    for seq in (1, 2):
        if val(x).shape[seq] == s_ and val(x).shape[3] == d_ and \
                real == {seq: [(0, s_, 1)], 3: [(1, d_, 1)]}:
            return root, seq
    return None


def match_rope(g):
    out = []
    for n in g.graph.nodes:
        if n.op != "call_function" or n.target not in _ADD:
            continue
        m1, m2 = g.producer(n.args[0]), g.producer(n.args[1])
        if m1 is None or m2 is None or m1.target not in _MUL \
                or m2.target not in _MUL:
            continue
        for ce, se in ((m1, m2), (m2, m1)):
            c = _match_rope_at(g, n, ce, se)
            if c is not None:
                out.append(c)
                break
    return out


def _match_rope_at(g, head, cos_mul, sin_mul):
    for rot_v, sin_b in ((sin_mul.args[0], sin_mul.args[1]),
                         (sin_mul.args[1], sin_mul.args[0])):
        x = _rotate_half_input(g, rot_v)
        if x is None or not _is_float(x):
            continue
        for x2, cos_b in ((cos_mul.args[0], cos_mul.args[1]),
                          (cos_mul.args[1], cos_mul.args[0])):
            if x2 is not x:
                continue
            ct, st = _table(g, cos_b, x), _table(g, sin_b, x)
            if ct is None or st is None or ct[1] != st[1] \
                    or _shape(head) != _shape(x):
                return None
            return Candidate("rope", head, [x, ct[0], st[0]],
                             {"seq_axis": ct[1]})
    return None


# --------------------------------------------------------------------------
# attention: softmax(QK^T * scale [+mask]) @ V over two batched products
# --------------------------------------------------------------------------

def _bmm_operand(g, v):
    """A bmm operand [N, R, C] read through its layout: (root, group atoms
    of N without the broadcast, rep, R atoms, C atoms), where rep is the
    size of one trailing broadcast atom of N (the GQA repeat of each K/V
    head), 1 without one; None when another broadcast appears or the
    atoms do not cover the root."""
    lay = layout(g, v)
    if lay is None:
        return None
    root, dims = lay
    if len(dims) != 3:
        return None
    grp, rows, cols = dims
    rep = 1
    if grp and grp[-1][0] is None:
        rep = grp[-1][1]
        grp = grp[:-1]
    atoms = grp + rows + cols
    if any(a[0] is None for a in atoms):
        return None
    if _size(atoms) != val(root).numel():
        return None
    return root, list(grp), rep, list(rows), list(cols)


def _softmax_input(g, v):
    """v == softmax(x, -1) -> x (``_softmax`` or exp(x - max) / sum)."""
    e = g.producer(v)
    if e is None:
        return None
    nd = val(v).dim()
    if e.target in _SOFTMAX:
        return e.args[0] if _norm(e.args[1], nd) == nd - 1 else None
    if e.target not in _DIV:
        return None
    num, den = e.args[0], e.args[1]
    ee = g.producer(num)
    se = g.producer(den)
    if ee is None or se is None or ee.target is not aten.exp.default \
            or se.target is not aten.sum.dim_IntList or se.args[0] is not num \
            or [_norm(a, nd) for a in se.args[1]] != [nd - 1]:
        return None
    sub = g.producer(ee.args[0])
    if sub is None or sub.target is not aten.sub.Tensor:
        return None
    x, m = sub.args[0], sub.args[1]
    me = g.producer(m)
    while me is not None and me.target is aten.detach.default:
        me = g.producer(me.args[0])
    if me is None or me.target is not aten.amax.default or \
            me.args[0] is not x or \
            [_norm(a, nd) for a in me.args[1]] != [nd - 1]:
        return None
    return x


def _big_neg(f):
    return f is not None and f <= -1e29


def _causal_const(c):
    """c (bool, broadcast over leading dims) == the bottom-right causal
    mask tril(ones(S, T), T - S)."""
    if c is None or c.dtype != torch.bool or c.dim() < 2:
        return False
    if any(d != 1 for d in c.shape[:-2]):
        return False
    sq = c.reshape(c.shape[-2:])
    s, t = sq.shape
    return bool(torch.equal(sq, torch.ones(s, t, dtype=torch.bool).tril(
        t - s)))


def _peel_logits(g, logits):
    """Peel mask / cast / scale wrappers off the softmax input down to the
    node the QK product's view chain produces. Returns (node, causal,
    mask node, mask mode, scale) or None."""
    x = logits
    causal, mask, mode, scale = False, None, None, None
    for _ in range(8):
        e = g.producer(x)
        if e is None:
            return None
        t = e.target
        if _is_cast(e):
            x = e.args[0]
            continue
        if t in (aten.where.self, aten.masked_fill.Scalar,
                 aten.masked_fill.Tensor) and mask is None and not causal:
            if t is aten.where.self:
                cond, on_true, on_false = e.args[:3]
                if _big_neg(g.scalar(on_false)) and isinstance(on_true, Node):
                    keep, x = True, on_true
                elif _big_neg(g.scalar(on_true)) and \
                        isinstance(on_false, Node):
                    keep, x = False, on_false
                else:
                    return None
            else:
                x, cond, fill = e.args[:3]
                if not _big_neg(g.scalar(fill)):
                    return None
                keep = False
            if not isinstance(cond, Node):
                return None
            c = g.concrete(cond)
            if c is not None and c.dtype == torch.bool and \
                    _causal_const(c if keep else ~c):
                causal = True
                continue
            mask, mode = cond, "keep" if keep else "drop"
            continue
        if t in _ADD and mask is None:
            if scale is not None:
                # the add sits under an already-peeled scale:
                # softmax((QK + bias) * s); the fused form would compute
                # s*QK + bias, silently unscaling the bias. No rewrite.
                return None
            for cand, other in ((e.args[0], e.args[1]),
                                (e.args[1], e.args[0])):
                if isinstance(cand, Node) and isinstance(other, Node) \
                        and _chains_to_bmm(g, cand) \
                        and _is_float(other):
                    x, mask, mode = cand, other, "add"
                    break
            else:
                return None
            continue
        if t in _MUL | _DIV and scale is None:
            for vv, sv in ((e.args[0], e.args[1]), (e.args[1], e.args[0])):
                s_ = g.scalar(sv) if not (isinstance(sv, Node) and
                                          val(sv).dim() > 0) else None
                if s_ is not None and isinstance(vv, Node):
                    if t in _DIV:
                        if sv is not e.args[1] or s_ == 0.0:
                            return None
                        s_ = 1.0 / s_
                    scale, x = s_, vv
                    break
            else:
                return None
            continue
        return x, causal, mask, mode, scale
    return None


def _chains_to_bmm(g, v, depth=4):
    """v reaches a bmm through views, casts and scalar scales: picks the
    logits operand of an additive-mask add."""
    for _ in range(depth):
        lay = layout(g, v)
        if lay is None:
            return False
        e = g.producer(lay[0])
        if e is None:
            return False
        if e.target is aten.bmm.default:
            return True
        if _is_cast(e) or (e.target in _MUL | _DIV and any(
                g.scalar(a) is not None and not (isinstance(a, Node) and
                                                 val(a).dim() > 0)
                for a in e.args[:2])):
            v = e.args[0] if isinstance(e.args[0], Node) and \
                val(e.args[0]).dim() > 0 else e.args[1]
            continue
        return False
    return False


def _leading_merged(dims, shape):
    """dims of an [N, S, T] view == the root's leading dims merged, then
    its last two whole."""
    nd = len(shape)
    if nd < 2 or len(dims) != 3:
        return False
    lead = _merge([(i, s, 1) for i, s in enumerate(shape[:-2]) if s != 1])
    return (dims[0] == lead and _whole(dims[1], nd - 2, shape[-2])
            and _whole(dims[2], nd - 1, shape[-1]))


def _leading_split(dims, n, s, t):
    """dims of the logits view of a QK bmm [N, S, T] == N split over the
    leading dims in order, then S and T whole."""
    if len(dims) < 2:
        return False
    lead = _merge([a for d in dims[:-2] for a in d])
    return (_whole(lead, 0, n) and _whole(dims[-2], 1, s)
            and _whole(dims[-1], 2, t))


def _head_split(grp, h):
    """Cut group atoms into (batch atoms, head atoms) with the head atoms'
    sizes multiplying to h, splitting one atom where needed; None when h
    does not divide on an atom's boundary."""
    heads, prod, grp = [], 1, list(grp)
    while prod < h:
        if not grp:
            return None
        a = grp.pop()
        if prod * a[1] <= h:
            heads.insert(0, a)
            prod *= a[1]
            continue
        need = h // prod
        if h % prod or a[1] % need:
            return None
        head, tail = _split(a, need)
        heads.insert(0, tail)
        grp.append(head)
        prod *= need
    return (grp, heads) if prod == h else None


def _plan(root, batch, row, heads, col, out_shape):
    """How to build an operand in the kernel's [B, R, H, D] layout from its
    root: split each root dim into its atoms, permute them into
    batch + row + heads + col order, reshape to out_shape."""
    want = batch + row + heads + col
    shape = tuple(val(root).shape)
    pieces = []                 # (root dim, atom) in root order
    for i, n in enumerate(shape):
        mine = sorted((a for a in want if a[0] == i), key=lambda a: -a[2])
        if not mine:
            if n != 1:
                return None
            mine = [(i, 1, 1)]
        inner = 1
        for a in reversed(mine):
            if a[2] != inner:
                return None
            inner *= a[1]
        if inner != n:
            return None
        pieces.extend(mine)
    order = [pieces.index(a) for a in want]
    order += [j for j in range(len(pieces)) if j not in order]
    return {"split": [a[1] for a in pieces], "perm": order,
            "shape": tuple(out_shape)}


def match_attention(g):
    out = []
    for n in g.graph.nodes:
        if n.op == "call_function" and n.target is aten.bmm.default:
            c = _match_attention_at(g, n)
            if c is not None:
                out.append(c)
    return out


def _match_attention_at(g, pv):
    p_op, v_op = pv.args[0], pv.args[1]
    if not (_is_float(p_op) and _is_float(v_op)):
        return None
    n_, s_, t_ = _shape(p_op)
    d_ = _shape(v_op)[2]
    # P: the softmax output's leading dims merged into N
    lay = layout(g, p_op)
    if lay is None:
        return None
    p_root, p_dims = lay
    if not _leading_merged(p_dims, _shape(p_root)):
        return None
    logits = _softmax_input(g, g.skip(p_root))
    if logits is None or _shape(logits) != _shape(p_root):
        return None
    peeled = _peel_logits(g, logits)
    if peeled is None:
        return None
    x, causal, mask, mode, scale = peeled
    lay = layout(g, x)
    if lay is None:
        return None
    qk, l_dims = lay
    if g.producer(qk) is None or qk.target is not aten.bmm.default or \
            _shape(qk) != (n_, s_, t_) or \
            not _leading_split(l_dims, n_, s_, t_) or \
            len(l_dims) != len(_shape(p_root)):
        return None
    q = _bmm_operand(g, qk.args[0])          # [N, S, D]
    k = _bmm_operand(g, qk.args[1])          # [N, D, T]
    v = _bmm_operand(g, v_op)                # [N, T, D]
    if q is None or k is None or v is None or q[2] != 1:
        return None
    if k[2] != v[2]:
        return None
    rep = k[2]
    # the kernel's heads: K/V's last group atom, times the repeat for q
    if not k[1] or not v[1]:
        return None
    hk = k[1][-1][1]
    if v[1][-1][1] != hk:
        return None
    cut_q = _head_split(q[1], hk * rep)
    cut_k = _head_split(k[1], hk)
    cut_v = _head_split(v[1], hk)
    if cut_q is None or cut_k is None or cut_v is None:
        return None
    b_ = n_ // (hk * rep)
    plans = (
        _plan(q[0], cut_q[0], q[3], cut_q[1], q[4], (b_, s_, hk * rep, d_)),
        _plan(k[0], cut_k[0], k[4], cut_k[1], k[3], (b_, t_, hk, d_)),
        _plan(v[0], cut_v[0], v[3], cut_v[1], v[4], (b_, t_, hk, d_)))
    if any(p is None for p in plans):
        return None
    inputs = [q[0], k[0], v[0]] + ([mask] if mask is not None else [])
    return Candidate(
        "attention", pv, inputs,
        {"causal": causal, "scale": 1.0 if scale is None else float(scale),
         "mask_mode": mode, "has_mask": mask is not None,
         "logits_shape": _shape(p_root), "plans": plans,
         "b": b_, "s_q": s_, "s_k": t_, "h": hk * rep, "h_kv": hk,
         "d": d_})


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

MATCHERS = {}


def register_matcher(name, fn=None):
    def deco(f):
        MATCHERS[name] = f
        return f
    if fn is not None:
        return deco(fn)
    return deco


register_matcher("attention", match_attention)
register_matcher("rms_norm", match_rms_norm)
register_matcher("swiglu", match_swiglu)
register_matcher("rope", match_rope)


def find_candidates(gm_or_graph, patterns=None):
    """All candidates of the named patterns (default: every registered
    matcher), in node order, deduped by head (first pattern wins).
    Returns (candidates, Graph)."""
    g = gm_or_graph if isinstance(gm_or_graph, Graph) else Graph(gm_or_graph)
    seen, out = set(), []
    for name in (patterns or list(MATCHERS)):
        for c in MATCHERS[name](g):
            if c.head not in seen:
                seen.add(c.head)
                out.append(c)
    return out, g

