"""Mixture of experts with expert parallelism: the counterpart of
``paddle_tpu/incubate/distributed/moe_layer.py`` (``moe_dispatch_combine``
with its one-hot and sorted dispatch, the naive, GShard and Switch gates,
the load-balancing loss, ``MoELayer``).

The experts are stacked on a leading E dim (``w_gate_up [E, H, F]``,
``w_down [E, F, H]``; one ``w_gate_up`` product with JAX's tanh GELU, as
the JAX layer's FFN). Routing, dispatch, the expert products and the
combine run in float32 and the result is cast back to x's type, as in
JAX. Routing follows the JAX order exactly:

- top-k is a stable descending sort of the float32 router probabilities,
  so tied probabilities take the lower expert first (``jax.lax.top_k``'s
  order; ``torch.topk`` promises none on the card);
- capacity priority is token-major: the one-hot form counts with a cumsum
  over the (token, slot) pairs, the sorted form groups them by expert
  with ``torch.argsort(stable=True)``; both keep and drop the same pairs.

``FLAGS_moe_sorted_dispatch`` (default on) picks the sorted form.

Expert parallelism: ``MoELayer(mesh=, ep_axis=)`` annotates the expert
weights ``Shard(0)`` over `ep_axis` on the port's single-controller
``ProcessMesh`` (each ep position a device, co-located positions allowed).
The routing and dispatch run once on the weights' home device with the
tokens replicated there; each ep position then takes the tokens of its
own experts (``expert_in[lo:hi]``, moved to its device), runs its
experts' products on its slice of the weights, and the outputs are
gathered back in expert order (the all-to-all's counterpart) before the
one combine. Each expert's products are the dense run's, so a sharded run
equals the dense one wherever a batched product's per-expert result does
not depend on the batch's size (exact on the CPU).

All of it is plain PyTorch, ``torch.einsum`` / ``bmm`` where JAX has an
einsum: the JAX package computes it in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as _F

from ... import nn
from ...framework.flags import get_flag
from ...framework.random import default_generator
from ...ops.registry import OP_TABLE, register_op

__all__ = ["moe_dispatch_combine", "NaiveGate", "GShardGate", "SwitchGate",
           "load_balance_loss", "MoELayer", "route"]


def _gelu(x):
    return _F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def route(gate_logits, k):
    """(top-k probabilities, expert ids) [T, k] of the float32 softmax of
    gate_logits [T, E], ties to the lower expert id (``jax.lax.top_k``)."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _ep_shards(w):
    """[(lo, hi, device)] of the expert ranges the ep positions of a
    Shard(0)-annotated weight hold, or None for a dense weight."""
    attr = getattr(w, "_dist_attr", None)
    if attr is None:
        return None
    mesh = attr.process_mesh
    for dim, p in zip(mesh.dim_names, attr.placements):
        if p.is_shard(0):
            devs = mesh.get_device_mesh().axis_devices(dim)
            n, e = len(devs), w.shape[0]
            per = -(-e // n)
            return [(i * per, min((i + 1) * per, e), d)
                    for i, d in enumerate(devs) if i * per < e]
    return None


def _experts(expert_in, w_gate_up, w_down):
    """expert_out [E, C, H] float32 of expert_in [E, C, H] float32: each
    expert's gelu(x W_gate_up) W_down, split over the ep positions when
    the weights are sharded."""
    shards = _ep_shards(w_gate_up)
    if shards is None:
        hidden = _gelu(torch.einsum("ech,ehf->ecf", expert_in,
                                    w_gate_up.float()))
        return torch.einsum("ecf,efh->ech", hidden, w_down.float())
    home = expert_in.device
    outs = []
    for lo, hi, dev in shards:
        xi = expert_in[lo:hi].to(dev)
        hidden = _gelu(torch.einsum("ech,ehf->ecf", xi,
                                    w_gate_up[lo:hi].to(dev).float()))
        outs.append(torch.einsum("ecf,efh->ech", hidden,
                                 w_down[lo:hi].to(dev).float()).to(home))
    return torch.cat(outs, dim=0)


def capacity_of(tokens, k, experts, capacity_factor):
    """Each expert's buffer rows: max(int(cf * T * k / E), 1)."""
    return max(int(capacity_factor * tokens * k / experts), 1)


@register_op("moe_dispatch_combine")
def moe_dispatch_combine(x, gate_logits, w_gate_up, w_down, k=2,
                         capacity_factor=1.5, name=None):
    """GShard-style MoE core: x [T, H]; gate_logits [T, E]; experts
    w_gate_up [E, H, F], w_down [E, F, H]. Returns [T, H] in x's type."""
    T, H = x.shape
    E = gate_logits.shape[-1]
    capacity = capacity_of(T, k, E, capacity_factor)
    home = w_gate_up.device
    if x.device != home:             # tokens replicated onto the mesh
        x, gate_logits = x.to(home), gate_logits.to(home)
    topk_val, topk_idx = route(gate_logits, k)
    if get_flag("moe_sorted_dispatch"):
        out = _dispatch_sorted(x, topk_val, topk_idx, w_gate_up, w_down, E,
                               capacity)
    else:
        out = _dispatch_onehot(x, topk_val, topk_idx, w_gate_up, w_down, E,
                               capacity)
    return out.to(x.dtype)


def _onehot_keep(topk_idx, E, capacity):
    """(one-hot [T, k, E] int32, positions [T, k, E], kept [T, k, E])
    of the token-major capacity count."""
    T, k = topk_idx.shape
    onehot = _F.one_hot(topk_idx, E).to(torch.int32)            # [T, k, E]
    flat = onehot.reshape(T * k, E)
    pos = (torch.cumsum(flat, dim=0, dtype=torch.int32) * flat - 1) \
        .reshape(T, k, E)
    keep = (pos < capacity) & (onehot > 0)
    return onehot, pos, keep


def _dispatch_onehot(x, topk_val, topk_idx, w_gate_up, w_down, E,
                     capacity):
    """The einsum formulation: materializes the [T, E, C] dispatch
    tensor (O(T E C) memory)."""
    onehot, pos, keep = _onehot_keep(topk_idx, E, capacity)
    keep_f = keep.float()
    pos_oh = _F.one_hot(pos.clamp(0, capacity - 1).long(),
                        capacity).float()                       # [T,k,E,C]
    disp = torch.einsum("tke,tkec->tec", keep_f * onehot,
                        pos_oh * keep_f[..., None])
    gates = torch.einsum("tk,tke->te", topk_val.float(), keep_f)
    combine = disp * gates[..., None]                           # [T, E, C]
    expert_in = torch.einsum("tec,th->ech", disp, x.float())
    expert_out = _experts(expert_in, w_gate_up, w_down)
    return torch.einsum("tec,ech->th", combine, expert_out)


def _sorted_slots(topk_idx, E, capacity):
    """(order, token of each sorted pair, kept, buffer slot) of the
    stable expert sort of the token-major (token, slot) pairs; a dropped
    pair's slot is the trash row E * C."""
    T, k = topk_idx.shape
    dev = topk_idx.device
    pair_expert = topk_idx.reshape(T * k)
    pair_token = torch.arange(T * k, device=dev) // k
    order = torch.argsort(pair_expert, stable=True)
    sorted_expert = pair_expert[order]
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(E, device=dev, dtype=sorted_expert.dtype))
    pos_sorted = torch.arange(T * k, device=dev) - group_start[sorted_expert]
    keep_sorted = pos_sorted < capacity
    slot_sorted = torch.where(keep_sorted, sorted_expert * capacity
                              + pos_sorted,
                              torch.full_like(pos_sorted, E * capacity))
    return order, pair_token[order], keep_sorted, slot_sorted


def _dispatch_sorted(x, topk_val, topk_idx, w_gate_up, w_down, E,
                     capacity):
    """Sort-based dispatch: group the (token, slot) pairs by expert with
    one stable sort, scatter the kept tokens into [E * C, H] buffers, run
    the batched experts, gather back with the gate weights. O(E C H +
    T k) memory; keeps and drops exactly the one-hot form's pairs."""
    T, H = x.shape
    k = topk_idx.shape[1]
    xf = x.float()
    pair_gate = topk_val.float().reshape(T * k)
    order, token_sorted, keep_sorted, slot_sorted = _sorted_slots(
        topk_idx, E, capacity)
    buf = torch.zeros(E * capacity + 1, H, dtype=torch.float32,
                      device=x.device)
    buf = buf.index_put((slot_sorted,), xf[token_sorted])        # scatter
    expert_in = buf[:-1].reshape(E, capacity, H)
    flat_out = _experts(expert_in, w_gate_up, w_down).reshape(
        E * capacity, H)
    # combine: each kept pair's expert output, weighted, summed per token
    kept = keep_sorted.float()
    pair_out = torch.where(
        keep_sorted[:, None],
        flat_out[slot_sorted.clamp(0, E * capacity - 1)],
        torch.zeros((), dtype=torch.float32, device=x.device)) * \
        (pair_gate[order] * kept)[:, None]
    return torch.zeros(T, H, dtype=torch.float32, device=x.device) \
        .index_add(0, token_sorted, pair_out)


def dispatch_stats(gate_logits, k, capacity_factor):
    """{"capacity", "pairs", "dropped", "kept_mask" [T, k] bool} of the
    routing (the pairs each dispatch form keeps)."""
    T, E = gate_logits.shape
    capacity = capacity_of(T, k, E, capacity_factor)
    _, idx = route(gate_logits, k)
    _, _, keep = _onehot_keep(idx, E, capacity)
    kept = keep.any(dim=-1)
    return {"capacity": capacity, "pairs": T * k,
            "dropped": int((~kept).sum()), "kept_mask": kept}


class NaiveGate(nn.Layer):
    """A linear router with no aux loss."""

    def __init__(self, d_model, num_expert, topk=2, *, device=None,
                 dtype=None):
        super().__init__()
        self.gate = nn.Linear(d_model, num_expert, bias_attr=False,
                              device=device, dtype=dtype)
        self.topk = topk

    def forward(self, x):
        return self.gate(x)

    def aux_loss(self, logits):
        return None


class GShardGate(NaiveGate):
    """Top-k routing with the GShard load-balancing aux loss (eq. (4)),
    times aux_loss_weight."""

    def __init__(self, d_model, num_expert, topk=2, aux_loss_weight=1.0, *,
                 device=None, dtype=None):
        super().__init__(d_model, num_expert, topk, device=device,
                         dtype=dtype)
        self.aux_loss_weight = aux_loss_weight

    def aux_loss(self, logits):
        return load_balance_loss(logits, self.topk) * self.aux_loss_weight


class SwitchGate(NaiveGate):
    """Top-1 routing (Switch Transformer) with multiplicative uniform
    jitter on the logits in training (the port's generator of the logits'
    device) and the same aux loss with k = 1."""

    def __init__(self, d_model, num_expert, topk=1, switch_eps=0.1,
                 aux_loss_weight=1.0, *, device=None, dtype=None):
        if topk != 1:
            raise ValueError("SwitchGate routes top-1 by definition "
                             f"(got topk={topk}); use GShardGate for top-k")
        super().__init__(d_model, num_expert, topk=1, device=device,
                         dtype=dtype)
        self.switch_eps = switch_eps
        self.aux_loss_weight = aux_loss_weight

    def forward(self, x):
        logits = self.gate(x)
        if self.training and self.switch_eps > 0:
            lo, hi = 1.0 - self.switch_eps, 1.0 + self.switch_eps
            noise = torch.rand(logits.shape, dtype=logits.dtype,
                               device=logits.device,
                               generator=default_generator(logits.device))
            logits = logits * (noise * (hi - lo) + lo)
        return logits

    def aux_loss(self, logits):
        return load_balance_loss(logits, 1) * self.aux_loss_weight


def _balance_loss_impl(logits):
    probs = torch.softmax(logits.float(), dim=-1)
    E = logits.shape[-1]
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = _F.one_hot(top1, E).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)


def load_balance_loss(gate_logits, k=2):
    """GShard aux loss E * sum_e(frac of tokens whose top-1 is e * mean
    probability of e), registered as ``moe_balance_loss``."""
    if "moe_balance_loss" not in OP_TABLE:
        register_op("moe_balance_loss")(_balance_loss_impl)
    return OP_TABLE["moe_balance_loss"]["api"](gate_logits)


class MoELayer(nn.Layer):
    """Experts as stacked weights (E on dim 0): with `mesh`, Shard(0) over
    `ep_axis` gives expert parallelism. ``_aux_loss`` holds the last
    forward's gate aux loss (the GShard loss where the gate has none)."""

    def __init__(self, d_model, d_hidden, num_expert=8, topk=2,
                 capacity_factor=1.5, gate=None, mesh=None, ep_axis="ep",
                 recompute_interval=0, *, device=None, dtype=None, **kw):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.gate = gate or NaiveGate(d_model, num_expert, topk,
                                      device=device, dtype=dtype)
        init = nn.initializer.XavierNormal()
        self.w_gate_up = self.create_parameter(
            [num_expert, d_model, d_hidden], dtype=dtype,
            default_initializer=init, device=device)
        self.w_down = self.create_parameter(
            [num_expert, d_hidden, d_model], dtype=dtype,
            default_initializer=init, device=device)
        self._aux_loss = None
        if mesh is not None:
            from ... import distributed as dist
            placements = [dist.Shard(0) if n == ep_axis else dist.Replicate()
                          for n in mesh.dim_names]
            dist.shard_tensor(self.w_gate_up, mesh, placements)
            dist.shard_tensor(self.w_down, mesh, placements)
            home = self.w_gate_up.device
            with torch.no_grad():        # the router lives on the mesh too
                for p in self.gate.parameters():
                    if p.device != home:
                        p.data = p.data.to(home)

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, self.d_model)
        home = self.w_gate_up.device
        if flat.device != home:          # tokens replicated onto the mesh
            flat = flat.to(home)
        logits = self.gate(flat)
        k = getattr(self.gate, "topk", self.topk)
        out = OP_TABLE["moe_dispatch_combine"]["api"](
            flat, logits, self.w_gate_up, self.w_down, k,
            self.capacity_factor)
        aux = self.gate.aux_loss(logits) if hasattr(self.gate, "aux_loss") \
            else None
        self._aux_loss = aux if aux is not None else \
            load_balance_loss(logits, k)
        return out.reshape(shape)
