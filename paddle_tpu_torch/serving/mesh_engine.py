"""Tensor-parallel serving: one device mesh behind ONE replica. The
counterpart of ``paddle_tpu/serving/mesh_engine.py``.

``MeshGenerationEngine`` runs the stock ``GenerationEngine`` step loop
over a mesh of devices, so a tensor-parallel model presents to the fleet
plane as a single replica. The JAX package lets GSPMD partition the same
programs; the port computes the shards itself, in one process (the
single-controller model of ``distributed.parallel_base``):

- **Weights** are placed by the canonical ``param_spec`` (the JAX
  package's rules, rule for rule): column-parallel q/k/v/gate/up (paddle
  ``[in, out]`` weights: the OUTPUT dim over ``tp``), row-parallel
  o/down (the input dim), the other dim over ``fsdp`` where the mesh has
  one; an axis that does not divide evenly replicates; embeddings,
  norms, rope tables and the lm_head replicate. Each placed piece is a
  tensor of its own on its mesh position's device (a replicated weight
  on the model's own device is the model's tensor). The model's
  parameters are never written: the placements live in the engine
  (``_param_vals``), and ``swap_weights`` re-places them.
- **KV pools** shard on the kv-head axis: one pool per shard, holding
  that shard's heads of every page. When the KV heads do not split over
  tp (GQA narrower than the mesh) the pools replicate: one pool, held
  by position 0, ``kv_shards = 1`` and an ``engine_mesh_kv_replicated``
  event. int8 scale rows are per (layer, page), shared by the heads, so
  they replicate (the shards on one device share one row).
- **The sharded forward** (``_ShardedForward``, the ``_fwd`` the step
  programs call): each layer runs every shard's column products, its
  paged attention (the kernels at per-shard shapes) over its own pool
  shard, then its row product, then ONE all-reduce; the MLP the same.
  With replicated pools the shards' q/k/v columns are all-gathered and
  attention runs once. Norms, embeddings, the residual stream and the
  head run once, on the model's device (position 0), so the logits are
  whole and sampling runs once. fsdp pieces are all-gathered at use.
  Partials are summed in rank order (``parallel_base``), as psum does;
  16-bit sums are not one GEMM's accumulation, so tokens agree with the
  single-device engine where the greedy margin exceeds the rounding.
  int8 writes take each row's absmax over every shard's heads (a max
  all-reduce), so the page scales are the single-device engine's.
- **The host plane does not fork**: ONE ``BlockManager``, one slot
  table, one scheduler, the programs of the single-device engine (CUDA
  graphs per bucket on the card, the sharded step captured whole; the
  same programs built per kind, frozen after warm-up).

Two knobs tell the fleet the truth about the mesh underneath, as in the
JAX package: ``mesh_devices`` scales wall time into the DEVICE-seconds of
the busy counter and the cost ledger, and ``kv_shards`` frames KV exports
as per-shard head streams (kvpages/v1 ``shards`` block; an importer with
another count refuses and re-prefills).

The ``engine_kv_pool_shard_bytes`` gauge is labelled by MESH POSITION
(flat index), not by device id as the JAX package labels it: on a
co-located mesh every shard has the same device and per-device gauges
would collapse into one. On the JAX package's 8 virtual CPU devices the
two labellings coincide (ids 0..n-1). Each position states the bytes it
holds: with fsdp the pool shards are held by the positions of fsdp row 0
(their compute runs there), and replicated pools by position 0 alone.

Meshes: ``make_mesh`` puts every position on the card by default (a
co-located mesh: the shards are separate tensors on one device, and the
collectives run on it); ``devices=[...]`` spreads them over CUDA cards,
where the collectives go through ``torch.cuda.nccl`` and the programs run
eagerly (a capture does not span cards); that path has not run on a
machine with two cards yet. Position 0 must be the model's device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..amp import amp_add
from ..device import resolve_device
from ..distributed import parallel_base as _PB
from ..distributed.auto_parallel.api import shard_index
from ..distributed.auto_parallel.placement import PartitionSpec
from ..distributed.auto_parallel.process_mesh import DeviceMesh
from ..inference.engine import GenerationEngine
from ..inference.programs import program_label
from ..nn import functional as F
from ..observability import flight_recorder as _FR
from ..observability.events import EVENTS as _EVENTS
from ..observability.metrics import REGISTRY as _REG
from ..quantization import page_quant

__all__ = ["MeshGenerationEngine", "make_mesh", "param_spec"]

# column-parallel: a paddle nn.Linear weight is [in, out]; these project
# ONTO heads/ffn, so the output dim shards over tp
_COL_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                 "gate_proj.weight", "up_proj.weight")
# row-parallel: these project FROM heads/ffn back to the residual stream,
# so the input dim shards (then one all-reduce)
_ROW_SUFFIXES = ("o_proj.weight", "down_proj.weight")


def make_mesh(mesh_devices, fsdp_devices=1, devices=None):
    """The serving mesh: axes ``("tp",)``, or ``("fsdp", "tp")`` with
    fsdp > 1. `devices`: None (every position on the card), one device
    (every position on it), or a list (the first fsdp * tp entries; fewer
    raise)."""
    tp = int(mesh_devices)
    fsdp = int(fsdp_devices)
    if tp < 1 or fsdp < 1:
        raise ValueError(f"bad mesh shape: tp={tp} fsdp={fsdp}")
    need = tp * fsdp
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = [resolve_device(devices)] * need
    else:
        devs = [resolve_device(d) for d in devices]
        if len(devs) < need:
            raise ValueError(
                f"mesh wants {need} devices (tp={tp} x fsdp={fsdp}) but "
                f"only {len(devs)} were given")
        devs = devs[:need]
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    if fsdp > 1:
        return DeviceMesh(arr.reshape(fsdp, tp), ("fsdp", "tp"))
    return DeviceMesh(arr, ("tp",))


def param_spec(name, shape, tp, fsdp=1):
    """The canonical PartitionSpec of one named parameter. An axis that
    does not divide evenly replicates instead of sharding."""
    def fits(axis, n):
        return n > 1 and len(shape) == 2 and shape[axis] % n == 0

    if name.endswith(_COL_SUFFIXES):
        col = "tp" if fits(1, tp) else None
        row = "fsdp" if fsdp > 1 and fits(0, fsdp) else None
        return PartitionSpec(row, col)
    if name.endswith(_ROW_SUFFIXES):
        row = "tp" if fits(0, tp) else None
        col = "fsdp" if fsdp > 1 and fits(1, fsdp) else None
        return PartitionSpec(row, col)
    # embeddings / norms / lm_head: replicated, so the logits (and
    # sampling) are whole
    return PartitionSpec()


class _Placed:
    """One parameter laid out on the mesh: the piece each position holds
    (a tensor on the position's device; positions holding the same slice
    on one device share it; a whole replica on the source's device is the
    source tensor itself)."""

    def __init__(self, name, src, spec, mesh):
        self.name = name
        self.spec = PartitionSpec(*spec)
        self.shape = tuple(src.shape)
        self.mesh = mesh
        sizes = dict(mesh.shape)
        self.index = {}
        self.pieces = {}
        for pos in np.ndindex(*mesh.devices.shape):
            self.index[pos] = shard_index(self.shape, sizes, self.spec,
                                          dict(zip(mesh.axis_names, pos)))
        self._place(src)

    def _key(self, pos):
        return (self.mesh.devices[pos],
                tuple((s.start, s.stop) for s in self.index[pos]))

    def _place(self, src):
        self._src_ptr = src.data_ptr()
        made = {}
        with torch.no_grad():
            for pos, idx in self.index.items():
                key = self._key(pos)
                t = made.get(key)
                if t is None:
                    dev = self.mesh.devices[pos]
                    whole = all(s == slice(None) for s in idx)
                    t = src.detach() if whole and dev == src.device else \
                        src.detach()[idx].to(dev, copy=True).contiguous()
                    made[key] = t
                self.pieces[pos] = t

    def refresh(self, src):
        """After a weight load: a source loaded in place has its values
        copied into the pieces in place (CUDA graphs keep their
        addresses); a source whose storage moved is placed anew."""
        if src.data_ptr() != self._src_ptr:
            self._place(src)
            return
        with torch.no_grad():
            for t in self.tensors():
                if t.data_ptr() == self._src_ptr:
                    continue                  # the source itself
                pos = next(p for p, v in self.pieces.items() if v is t)
                t.copy_(src.detach()[self.index[pos]])

    def tensors(self):
        seen, out = set(), []
        for t in self.pieces.values():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def actual_spec(self):
        """The layout the pieces hold, read off their slices: each tensor
        dim maps to the mesh axes along which its slice moves."""
        names = self.mesh.axis_names
        spec = []
        for d in range(len(self.shape)):
            axes = []
            for a, name in enumerate(names):
                starts = {self.index[pos][d].start
                          for pos in self.index}
                if len(starts) <= 1:
                    continue
                fixed = {}
                for pos in self.index:
                    rest = pos[:a] + pos[a + 1:]
                    fixed.setdefault(rest, set()).add(
                        self.index[pos][d].start)
                if any(len(v) > 1 for v in fixed.values()):
                    axes.append(name)
            spec.append(None if not axes else
                        axes[0] if len(axes) == 1 else tuple(axes))
        while spec and spec[-1] is None:
            spec.pop()
        return PartitionSpec(*spec)

    def is_sharded(self):
        return any(e is not None for e in self.actual_spec())

    def full(self, device):
        """The whole tensor on `device` (gathered from the pieces when it
        is laid out; an all-gather of the program)."""
        if not self.is_sharded():
            t = self.pieces[next(iter(self.pieces))]
            return t if t.device == device else t.to(device)
        out = None
        for pos, idx in self.index.items():
            piece = self.pieces[pos]
            if out is None:
                out = torch.empty(self.shape, dtype=piece.dtype,
                                  device=device)
            out[idx] = piece.to(device)
        _PB.note_program_collective("all-gather",
                                    out.numel() * out.element_size(),
                                    len(self.index))
        return out

    def tp_block(self, dim, t, tp, device):
        """Piece t of tp equal pieces along `dim` on `device`: the placed
        tp piece when the layout splits `dim` over tp (its fsdp pieces
        all-gathered), else a slice of the whole tensor."""
        spec = tuple(self.spec) + (None,) * (len(self.shape) - len(self.spec))
        rest = {d: e for d, e in enumerate(spec) if d != dim and e}
        if spec[dim] == "tp" and set(rest.values()) <= {"fsdp"}:
            if not rest:
                piece = self.pieces[self._pos(tp=t)]
            else:                     # fsdp pieces of the other dim
                piece = _PB.program_all_gather(
                    [self.pieces[self._pos(tp=t, fsdp=f)]
                     for f in range(self.mesh.shape["fsdp"])],
                    next(iter(rest)))[0]
            return piece if piece.device == device else piece.to(device)
        n = self.shape[dim]
        step = n // tp
        return self.full(device).narrow(dim, t * step, step)

    def _pos(self, **coord):
        return tuple(int(coord.get(name, 0)) for name in self.mesh.axis_names)


class _ShardedForward:
    """The paged model contract (``paged_spec``, ``paged_prefill``,
    ``paged_decode``, ``paged_prefill_ragged``, ``paged_verify``) computed
    shard by shard over an engine's mesh, for the port's Llama and GPT.
    Pools arrive as per-layer lists of per-shard pools (one shard when
    they replicate); the returns hold the logits only (the engine reads
    [0]), and the prefill's K/V come per shard."""

    def __init__(self, eng):
        self.eng = eng
        self.model = model = eng.model
        self.tp = eng._tp
        mesh = eng._mesh
        self.devs = [mesh.devices[eng._placed_pos(tp=t)]
                     for t in range(self.tp)]
        self.home = model.device
        self.llama = hasattr(model, "llama")
        cfg = model.config
        self.hd = cfg.hidden_size // cfg.num_attention_heads
        self.sharded_kv = eng.kv_shards > 1
        self.P = eng._placed_by_name

    def paged_spec(self):
        return self.model.paged_spec()

    # -- weights and collectives ------------------------------------------

    def _cols(self, name, xs, bias=None, lo=0, hi=None):
        """Per-shard products of the replicated input (one copy per shard
        in `xs`) with the column blocks of `name` over [lo, hi) split tp
        ways (+ the bias's matching pieces); one whole product on the home
        device when the range does not split."""
        p = self.P[name]
        hi = p.shape[1] if hi is None else hi
        width = hi - lo
        if self.tp == 1 or width % self.tp:
            w = p.full(self.home)[:, lo:hi]
            b = None if bias is None else \
                self.P[bias].full(self.home)[lo:hi]
            return [F.linear(xs[0], w, b)]
        step = width // self.tp
        whole = {}                    # one gather per device, when needed
        out = []
        for t, (x, d) in enumerate(zip(xs, self.devs)):
            if lo == 0 and hi == p.shape[1]:
                w = p.tp_block(1, t, self.tp, d)
            else:
                if d not in whole:
                    whole[d] = p.full(d)
                w = whole[d][:, lo + t * step:lo + (t + 1) * step]
            b = None
            if bias is not None:
                b = self.P[bias].full(d)[lo + t * step:lo + (t + 1) * step]
            out.append(F.linear(x, w, b))
        return out

    def _rows(self, name, parts, bias=None):
        """The row-parallel product of the per-shard pieces `parts` (the
        input's last dim split tp ways; one whole input when it is not):
        each shard's partial product, then ONE all-reduce, on the home
        device (+ the bias, once)."""
        p = self.P[name]
        n_in = p.shape[0]
        if self.tp > 1 and len(parts) == 1 and n_in % self.tp == 0:
            step = n_in // self.tp
            parts = [parts[0][..., t * step:(t + 1) * step].to(d)
                     for t, d in enumerate(self.devs)]
        if len(parts) == 1:
            out = F.linear(parts[0], p.full(self.home))
        else:
            partials = [F.linear(x, p.tp_block(0, t, self.tp, x.device))
                        for t, x in enumerate(parts)]
            out = _PB.program_all_reduce(partials)[0]
        out = out if out.device == self.home else out.to(self.home)
        if bias is not None:
            out = out + self.P[bias].full(self.home)
        return out

    def _scatter(self, x):
        return [x if d == x.device else x.to(d) for d in self.devs]

    def _on(self, x, dev):
        return x if x is None or x.device == dev else x.to(dev)

    def _gather_heads(self, parts):
        if len(parts) == 1:
            return parts
        full = _PB.program_all_gather(parts, -1)[0]
        return [full if full.device == self.home else full.to(self.home)]

    # -- a layer --------------------------------------------------------

    def _qkv(self, l, x):
        """Per-pool-shard q, k, v [B, S, heads, hd] (one set when the pools
        replicate: the shards' columns all-gathered)."""
        xs = self._scatter(x) if self.tp > 1 else [x]
        if self.llama:
            pre = f"llama.layers.{l}.self_attn."
            qs = self._cols(pre + "q_proj.weight", xs)
            ks = self._cols(pre + "k_proj.weight", xs)
            vs = self._cols(pre + "v_proj.weight", xs)
        else:
            name = f"gpt.h.{l}.attn.qkv_proj."
            h = self.P[name + "weight"].shape[0]
            qs, ks, vs = (self._cols(name + "weight", xs, name + "bias",
                                     i * h, (i + 1) * h) for i in range(3))
        if not self.sharded_kv:
            qs, ks, vs = (self._gather_heads(p) for p in (qs, ks, vs))
        b, s = x.shape[0], x.shape[1]
        return [(q.view(b, s, -1, self.hd), k.view(b, s, -1, self.hd),
                 v.view(b, s, -1, self.hd)) for q, k, v in zip(qs, ks, vs)]

    def _o(self, l, outs):
        """The attention outputs [.., heads, hd] per shard through the
        row-parallel output projection."""
        parts = [o.reshape(*o.shape[:-2], -1) for o in outs]
        if self.llama:
            return self._rows(f"llama.layers.{l}.self_attn.o_proj.weight",
                              parts)
        pre = f"gpt.h.{l}.attn.out_proj."
        return self._rows(pre + "weight", parts, pre + "bias")

    def _mlp(self, l, x):
        xs = self._scatter(x) if self.tp > 1 else [x]
        if self.llama:
            pre = f"llama.layers.{l}.mlp."
            g = self._cols(pre + "gate_proj.weight", xs)
            u = self._cols(pre + "up_proj.weight", xs)
            return self._rows(pre + "down_proj.weight",
                              [F.swiglu(a, c) for a, c in zip(g, u)])
        pre = f"gpt.h.{l}.mlp."
        act = self.model.gpt.h[l].mlp[1]
        hs = self._cols(pre + "0.weight", xs, pre + "0.bias")
        return self._rows(pre + "2.weight", [act(t) for t in hs],
                          pre + "2.bias")

    def _rope(self, parts, cos, sin):
        if not self.llama:
            return [(q.contiguous(), k.contiguous(), v.contiguous())
                    for q, k, v in parts]
        out = []
        for q, k, v in parts:
            q, k = F.fused_rope_qk(q, k, self._on(cos, q.device),
                                   self._on(sin, q.device))
            out.append((q, k, v))
        return out

    def _write(self, parts, pools, scales, which, wp, wo, sl):
        """Write each shard's K (which=1) or V (2) rows into its pool; int8
        pools quantize with each row's absmax over every shard's heads."""
        rows = [p[which][sl] for p in parts]
        maxes = [None] * len(rows)
        if scales[0] is not None and len(rows) > 1:
            maxes = _PB.program_all_reduce(
                [r.float().abs().amax(dim=(-2, -1)) for r in rows],
                _PB.ReduceOp.MAX)
        for r, pool, sc, m in zip(rows, pools, scales, maxes):
            page_quant.write_rows(pool, sc, self._on(wp, pool.device),
                                  self._on(wo, pool.device), r, row_max=m)

    def _attn_paged(self, l, x, cos, sin, kp, vp, ks, vs, bt, ctx, wp, wo,
                    q_lens=None):
        """One layer's attention over the paged pools: decode (q_lens
        None, x [B, 1, h]) or ragged (x [C, Q, h])."""
        parts = self._rope(self._qkv(l, x), cos, sin)
        ks = ks or [None] * len(kp)
        vs = vs or [None] * len(vp)
        sl = (slice(None), 0) if q_lens is None else (slice(None),)
        self._write(parts, kp, ks, 1, wp, wo, sl)
        self._write(parts, vp, vs, 2, wp, wo, sl)
        outs = []
        for (q, _k, _v), kpool, vpool, ksc, vsc in zip(parts, kp, vp, ks,
                                                       vs):
            dev = q.device
            if q_lens is None:
                o = F.paged_attention(q[:, 0], kpool, vpool,
                                      self._on(bt, dev), self._on(ctx, dev),
                                      k_scales=ksc, v_scales=vsc)[:, None]
            else:
                o = F.ragged_paged_attention(
                    q, kpool, vpool, self._on(bt, dev), self._on(ctx, dev),
                    self._on(q_lens, dev), k_scales=ksc, v_scales=vsc)
            outs.append(o.to(x.dtype))
        return self._o(l, outs)

    def _attn_dense(self, l, x, cos, sin):
        """One layer's dense causal attention; also its per-shard (k,
        v)."""
        parts = self._rope(self._qkv(l, x), cos, sin)
        outs = [F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               training=False)
                for q, k, v in parts]
        return self._o(l, outs), [(k, v) for _q, k, v in parts]

    # -- the stacks ---------------------------------------------------------

    def _blocks(self):
        if self.llama:
            return [(lay.input_layernorm, lay.post_attention_layernorm)
                    for lay in self.model.llama.layers]
        return [(b.ln_1, b.ln_2) for b in self.model.gpt.h]

    def _final(self, hidden):
        return (self.model.llama.norm if self.llama
                else self.model.gpt.ln_f)(hidden)

    def _embed(self, ids, positions):
        """Embedding (+ learned positions for GPT) of ids [B, S] at
        positions [B, S]; rope rows (cos, sin) [B, S, hd] for Llama."""
        if self.llama:
            m = self.model.llama
            return m.embed_tokens(ids), m.rope_cos[positions], \
                m.rope_sin[positions]
        g = self.model.gpt
        return amp_add(g.wte(ids), g.wpe(positions)), None, None

    def _paged_stack(self, hidden, cos, sin, k_pages, v_pages, k_scales,
                     v_scales, bt, ctx, wp, wo, q_lens=None):
        n = len(k_pages)
        k_scales = k_scales or [None] * n
        v_scales = v_scales or [None] * n
        for l, (n1, n2) in enumerate(self._blocks()):
            a = self._attn_paged(l, n1(hidden), cos, sin, k_pages[l],
                                 v_pages[l], k_scales[l], v_scales[l], bt,
                                 ctx, wp, wo, q_lens)
            hidden = amp_add(hidden, a)
            hidden = amp_add(hidden, self._mlp(l, n2(hidden)))
        return self._final(hidden)

    def paged_decode(self, tokens, positions, k_pages, v_pages,
                     block_tables, context_lens, write_pids, write_offs,
                     k_scales=None, v_scales=None):
        hidden, cos, sin = self._embed(tokens[:, None], positions[:, None])
        if cos is not None:
            cos, sin = cos[:, 0], sin[:, 0]
        hidden = self._paged_stack(hidden, cos, sin, k_pages, v_pages,
                                   k_scales, v_scales, block_tables,
                                   context_lens, write_pids, write_offs)
        return (self.model._head(hidden)[:, 0],)

    def _ragged(self, ids, q_lens, start_pos, k_pages, v_pages,
                block_tables, write_pids, write_offs, k_scales, v_scales):
        qm = ids.shape[1]
        positions = start_pos.long()[:, None] + \
            torch.arange(qm, device=ids.device)[None, :]
        positions = positions.clamp_max(self.model.config
                                        .max_position_embeddings - 1)
        hidden, cos, sin = self._embed(ids, positions)
        context_lens = (start_pos + q_lens).to(torch.int32)
        return self._paged_stack(hidden, cos, sin, k_pages, v_pages,
                                 k_scales, v_scales, block_tables,
                                 context_lens, write_pids, write_offs,
                                 q_lens)

    def paged_prefill_ragged(self, ids, q_lens, start_pos, k_pages,
                             v_pages, block_tables, write_pids, write_offs,
                             k_scales=None, v_scales=None):
        hidden = self._ragged(ids, q_lens, start_pos, k_pages, v_pages,
                              block_tables, write_pids, write_offs,
                              k_scales, v_scales)
        rows = torch.arange(ids.shape[0], device=ids.device)
        h_last = hidden[rows, q_lens.long() - 1][:, None]
        return (self.model._head(h_last)[:, 0],)

    def paged_verify(self, ids, q_lens, start_pos, k_pages, v_pages,
                     block_tables, write_pids, write_offs, k_scales=None,
                     v_scales=None):
        hidden = self._ragged(ids, q_lens, start_pos, k_pages, v_pages,
                              block_tables, write_pids, write_offs,
                              k_scales, v_scales)
        return (self.model._head(hidden),)

    def _dense(self, ids):
        """The dense causal stack over ids [B, S] at positions [0, S):
        (final hidden [B, S, h], per layer the per-shard (k, v))."""
        s = ids.shape[1]
        pos = torch.arange(s, device=ids.device)
        if self.llama:
            m = self.model.llama
            hidden = m.embed_tokens(ids)
            cos, sin = m.rope_cos[:s], m.rope_sin[:s]
        else:
            hidden, cos, sin = self._embed(ids, pos[None])
        kv = []
        for l, (n1, n2) in enumerate(self._blocks()):
            a, layer_kv = self._attn_dense(l, n1(hidden), cos, sin)
            kv.append(layer_kv)
            hidden = amp_add(hidden, a)
            hidden = amp_add(hidden, self._mlp(l, n2(hidden)))
        return self._final(hidden), kv

    def forward(self, input_ids):
        """Logits [B, S, V] of the sharded dense causal forward (the
        teacher-forced view of the engine's greedy path)."""
        return self.model._head(self._dense(input_ids)[0])

    __call__ = forward

    def paged_prefill(self, ids, lengths):
        """(last-real-token logits [C, V], ks, vs): ks/vs per pool shard,
        each [L, C, S_pad, heads of the shard, hd]."""
        hidden, kv = self._dense(ids)
        rows = torch.arange(ids.shape[0], device=ids.device)
        h_last = hidden[rows, lengths.long() - 1][:, None]
        n_sh = len(kv[0])
        ks = [torch.stack([layer[s_][0] for layer in kv])
              for s_ in range(n_sh)]
        vs = [torch.stack([layer[s_][1] for layer in kv])
              for s_ in range(n_sh)]
        return self.model._head(h_last)[:, 0], ks, vs


class MeshGenerationEngine(GenerationEngine):
    """``GenerationEngine`` sharded over a device mesh, presenting as one
    replica. Construct like the base engine plus ``mesh_devices`` (tp
    width), ``fsdp_devices``, ``mesh`` (a ``DeviceMesh`` from
    ``make_mesh``; default: every position on the model's device) and
    ``param_spec_overrides`` ({parameter name SUFFIX: PartitionSpec, axis
    tuple, or None for replicated}: a layout experiment that overrides
    the canonical ``param_spec`` at placement; the sharding observatory's
    ``partition_audit`` still compares against the canonical spec, so an
    override that contradicts it is a named violation). Every other
    keyword, method, metric and invariant is the base engine's."""

    def __init__(self, model, mesh_devices=2, fsdp_devices=1, mesh=None,
                 param_spec_overrides=None, **kw):
        tp = int(mesh_devices)
        fsdp = int(fsdp_devices)
        if mesh is None:
            mesh = make_mesh(tp, fsdp, devices=model.device)
        if mesh.shape.get("tp", 1) != tp or mesh.shape.get("fsdp", 1) != fsdp:
            raise ValueError(f"mesh {dict(mesh.shape)} is not tp={tp} x "
                             f"fsdp={fsdp}")
        if mesh.flat[0] != model.device:
            raise ValueError(
                f"mesh position 0 is on {mesh.flat[0]}, the model on "
                f"{model.device}: position 0 runs the replicated part of "
                "the forward with the model's own weights")
        self._mesh = mesh
        self._tp = tp
        self._fsdp = fsdp
        self.mesh_devices = tp * fsdp
        spec = model.paged_spec()
        n_kv = int(spec["n_kv_heads"])
        # GQA narrower than the mesh: heads cannot split, pools replicate
        # (weights still shard where they divide). kv_shards is an
        # OWNERSHIP count, not a device count
        self.kv_shards = tp if tp > 1 and n_kv % tp == 0 else 1
        self._spec_overrides = {}
        for suf, sp in (param_spec_overrides or {}).items():
            if sp is None:
                sp = PartitionSpec()
            elif not isinstance(sp, PartitionSpec):
                sp = PartitionSpec(*sp)
            self._spec_overrides[suf] = sp
        self._prog_suffix = f":tp{tp}" + (f"fsdp{fsdp}" if fsdp > 1
                                          else "")
        self._c_coll_disp = _REG.counter(
            "xla_collective_dispatch_bytes_total",
            "estimated collective payload bytes moved by mesh-engine "
            "dispatches (harvested per-program estimate x dispatches)")
        self._param_names = [n for n, _ in model.named_parameters()]
        self._placed = self._place_params(model)
        self._placed_by_name = {p.name: p for p in self._placed}

        # the base __init__ builds the pools through _make_pools
        super().__init__(model, **kw)
        self._fwd = _ShardedForward(self)
        if not mesh.co_located:
            # a CUDA graph capture does not span cards
            self._graphs = False

        if tp > 1 and self.kv_shards == 1:
            _EVENTS.record("engine_mesh_kv_replicated", n_kv_heads=n_kv,
                           tp=tp)
        _REG.gauge(
            "engine_mesh_devices",
            "devices behind this engine's dispatches (1 = single-chip)",
        ).set(self.mesh_devices)
        for pos, nbytes in sorted(self._pool_bytes_by_position().items()):
            _REG.gauge(
                "engine_kv_pool_shard_bytes",
                "device bytes of paged KV pool held per mesh shard",
                labels={"device": str(pos)}).set(nbytes)
        _EVENTS.record("engine_mesh_up", tp=tp, fsdp=fsdp,
                       kv_shards=self.kv_shards,
                       devices=[str(d) for d in mesh.flat])

    # -- placement ----------------------------------------------------------

    def _placed_pos(self, tp=0, fsdp=0):
        coord = {"tp": tp, "fsdp": fsdp}
        return tuple(coord[n] for n in self._mesh.axis_names)

    def _spec_for(self, name, shape):
        for suf, sp in self._spec_overrides.items():
            if name.endswith(suf):
                return sp
        return param_spec(name, shape, self._tp, self._fsdp)

    def _place_params(self, model):
        return [_Placed(name, p, self._spec_for(name, tuple(p.shape)),
                        self._mesh)
                for name, p in model.named_parameters()]

    def _param_vals(self):
        """The placed parameters (``_Placed``: pieces per mesh position),
        in ``model.named_parameters()`` order."""
        return self._placed

    def _param_tensors(self):
        out = []
        for p in self._placed:
            out.extend(p.tensors())
        return out + self._buffer_vals()

    def _weights_loaded(self):
        """After swap_weights' loader: re-place every parameter from the
        model's (new) values."""
        params = dict(self.model.named_parameters())
        for p in self._placed:
            p.refresh(params[p.name])

    # -- pools --------------------------------------------------------------

    def _pool_devices(self):
        n = self.kv_shards
        return [self._mesh.devices[self._placed_pos(tp=s)] for s in range(n)]

    def _make_pools(self, dtype):
        n_pages, page, h, d = self._pool_shape
        hps = h // self.kv_shards
        devs = self._pool_devices()
        shape = (n_pages, page, hps, d)
        self.k_pages = [[torch.zeros(shape, dtype=dtype, device=dv)
                         for dv in devs] for _ in range(self._n_layers)]
        self.v_pages = [[torch.zeros(shape, dtype=dtype, device=dv)
                         for dv in devs] for _ in range(self._n_layers)]
        self.k_scales = self.v_scales = None
        if self.kv_dtype == "int8":
            def rows():
                by_dev = {dv: torch.ones(n_pages, dtype=torch.float32,
                                         device=dv) for dv in set(devs)}
                return [by_dev[dv] for dv in devs]
            self.k_scales = [rows() for _ in range(self._n_layers)]
            self.v_scales = [rows() for _ in range(self._n_layers)]

    def _pool_shards(self):
        h = self._pool_shape[2]
        hps = h // self.kv_shards
        out = []
        for s in range(self.kv_shards):
            def pick(group):
                return None if group is None else [lay[s] for lay in group]
            heads = slice(None) if self.kv_shards == 1 else \
                slice(s * hps, (s + 1) * hps)
            out.append((pick(self.k_pages), pick(self.v_pages),
                        pick(self.k_scales), pick(self.v_scales), heads))
        return out

    def _pool_bytes_by_position(self):
        """{flat mesh position: bytes of the pool tensors it holds}."""
        pos_of = {}
        for s in range(self.kv_shards):
            pos = self._placed_pos(tp=s)
            pos_of[s] = int(np.ravel_multi_index(pos,
                                                 self._mesh.devices.shape))
        out = {}
        seen = set()
        for s, shard in enumerate(self._pool_shards()):
            for group in shard[:4]:
                for t in group or ():
                    if id(t) in seen:
                        continue
                    seen.add(id(t))
                    out[pos_of[s]] = out.get(pos_of[s], 0) + \
                        t.numel() * t.element_size()
        return out

    def _write_prefill(self, ks, vs, page_ids):
        """Write a dense prefill's per-shard K/V into the pool shards, whole
        pages; int8 pages quantize by their absmax over every shard's
        heads (a max all-reduce), as the single-device engine's."""
        flat = page_ids.reshape(-1)
        n_pg = page_ids.shape[1]
        for parts, pools, scales in ((ks, self.k_pages, self.k_scales),
                                     (vs, self.v_pages, self.v_scales)):
            pages = [self._prefill_pages(p, n_pg) for p in parts]
            page_scales = None
            if scales is not None:
                amax = [p.float().abs().amax(dim=(-3, -2, -1))
                        for p in pages]
                if len(amax) > 1:
                    _PB.program_all_reduce(amax, _PB.ReduceOp.MAX)
                page_scales = [torch.clamp_min(a, page_quant.EPS)
                               for a in amax]
                pages = [page_quant.quant_codes(
                    p.float(), sc[..., None, None, None]).to(torch.int8)
                    for p, sc in zip(pages, page_scales)]
            for li, layer in enumerate(pools):
                for s, pool in enumerate(layer):
                    pool[flat.to(pool.device)] = pages[s][li].to(pool.dtype)
                    if scales is not None:
                        sc = scales[li][s]
                        sc[flat.to(sc.device)] = page_scales[s][li]

    # -- the sharding observatory's hooks -------------------------------------

    def _label(self, program):
        label = program_label(*program)
        return None if label is None else label + self._prog_suffix

    @contextlib.contextmanager
    def _program_scope(self, kind, key):
        """The program's first (eager) run: its collectives are recorded
        and published as the program's harvest, under its label."""
        from ..observability import sharding, xla_introspect
        with _PB.record_collectives() as found:
            yield
        label = self._label((kind, key))
        if label is None:
            return
        sharded = sum(p.is_sharded() for p in self._placed)
        sharding.record_program(
            label, found,
            flops=xla_introspect.flops_of(label, harvest_missing=False),
            params_sharded=sharded,
            params_replicated=len(self._placed) - sharded,
            co_located=self._mesh.co_located)

    def _note_mesh_dispatch(self, program, t0, now):
        """Per dispatch: the harvested collective payload of its program
        (0 until harvested) feeds ``xla_collective_dispatch_bytes_total``
        and, with a flight recorder active, a committed ``mesh_dispatch``
        entry."""
        from ..observability import sharding
        label = self._label(program)
        est = sharding.collective_bytes_of(label) if label else 0
        if est:
            self._c_coll_disp.inc(est)
        if _FR.active():
            rec = _FR.get_recorder()
            if rec is not None:
                rec.record("mesh_dispatch", nbytes=int(est),
                           start_us=t0 * 1e6, end_us=now * 1e6)
