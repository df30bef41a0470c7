"""Context parallelism over a mesh axis: the counterpart of
``paddle_tpu/ops/ring_attention.py:26-148`` (``ring_flash_attention``,
``ulysses_attention``).

The sequence is sharded over a ``ProcessMesh`` axis of n ranks, each
holding [B, S/n, H, D] of q, k and v:

- in the port's single controller every rank's shard is a tensor on its
  rank's device (the mesh's devices; every rank on one card is a
  co-located mesh): the functions take the whole [B, S, H, D] tensors
  (split along S here) or a list of the n shards, and return the same
  form;
- in a multi-process world (``distributed.parallel_base``) each process
  passes its own shard and gets its own output's shard: the ring's K/V
  blocks travel by ``isend`` / ``irecv`` to the axis neighbours, and
  Ulysses' swaps are ``alltoall_single``.

**The ring.** Query shard i attends to key shard j in the JAX ring's
order (j = i, i + 1, ..., wrapping round). With ``causal`` a block j > i
is masked out whole: in the JAX arithmetic it comes after the diagonal
block and is weighted by exp(-1e30 - m) = 0, so it adds exactly nothing
and is skipped here; the diagonal block is causal, the earlier ones are
not. Each block runs through ``flash_attention_fwd`` (on CUDA tensors
the flash kernel; on CPU tensors its plain version), and the ring merges
the blocks' (out, lse) in float32 by their lse: each block's output is
rounded to q's type first, as the kernel writes it. Its backward (a
``torch.autograd.Function``) runs ``flash_attention_bwd`` for each
visited block with the MERGED out and lse, which gives each block's
exact share of dq, dk and dv; dq sums on the query's rank, dk / dv go
back to the key's rank (across processes they travel round the ring
with the blocks), in float32.

**Ulysses** swaps sequence sharding for head sharding (rank r gets heads
[r H/n, (r + 1) H/n) of the whole sequence), runs full attention on its
heads through the flash kernels' autograd op (``FlashAttention``), and
swaps back.
"""

from __future__ import annotations

import math

import torch

from ..distributed import parallel_base as pb


# ---------------------------------------------------------------------------
# the mesh axis
# ---------------------------------------------------------------------------

def _axis(mesh, axis_name):
    """(n, the axis's devices in a single controller, or this process's
    (position, global ranks along the axis) in a multi-process world)."""
    n = mesh.get_dim_size(axis_name)
    if pb.multi_process():
        k = mesh.dim_names.index(axis_name)
        arr = mesh.mesh
        pos = [tuple(int(x) for x in ix) for ix in zip(
            *(arr == pb.get_rank()).nonzero())]
        if len(pos) != 1:
            raise ValueError(f"rank {pb.get_rank()} is not once in the "
                             f"mesh {arr.tolist()}")
        idx = list(pos[0])
        ranks = []
        for p in range(n):
            idx[k] = p
            ranks.append(int(arr[tuple(idx)]))
        return n, None, (pos[0][k], ranks)
    return n, mesh.get_device_mesh().axis_devices(axis_name), None


def _shards(x, n, devices):
    """A [B, S, H, D] tensor split along S onto the ranks' devices, or a
    list of shards moved onto them."""
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"{len(x)} shards for a {n}-rank axis")
        return [t.to(d) for t, d in zip(x, devices)], False
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} does not split over {n} "
                         "ranks")
    return [c.to(d) for c, d in zip(x.chunk(n, dim=1), devices)], True


def _order(i, n, causal):
    """The key shards query shard i visits, in the JAX ring's order."""
    js = [(i + t) % n for t in range(n)]
    return [j for j in js if not causal or j <= i]


# ---------------------------------------------------------------------------
# the ring on the flash kernels
# ---------------------------------------------------------------------------

def _merge_lse(acc, lse_acc, o, lse):
    """(out, lse) of two disjoint key sets' attention, in float32."""
    if acc is None:
        return o.float(), lse
    m = torch.maximum(lse_acc, lse)
    a = torch.exp(lse_acc - m)
    b = torch.exp(lse - m)
    new = m + torch.log(a + b)
    wa = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
    wb = torch.exp(lse - new).transpose(1, 2)[..., None]
    return acc * wa + o.float() * wb, new


def _fwd_blocks(q, kv_of, js, i, causal, scale):
    """Query shard q (rank i) over the key shards js; kv_of(j) -> (k, v).
    Returns (out in q's type, lse float32 [B, H, S_q])."""
    from .kernels import flash_attention_fwd
    acc = lse = None
    for j in js:
        k, v = kv_of(j)
        o, l = flash_attention_fwd(q, k, v, causal=causal and j == i,
                                   scale=scale)
        acc, lse = _merge_lse(acc, lse, o, l)
    return acc.to(q.dtype), lse


class _RingKernel(torch.autograd.Function):
    """The single controller's ring on the flash kernels: inputs are the
    n q shards, then the n k and n v shards."""

    @staticmethod
    def forward(ctx, n, causal, scale, *qkv):
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = [], []
        for i in range(n):
            o, l = _fwd_blocks(
                qs[i], lambda j: (ks[j].to(qs[i].device),
                                  vs[j].to(qs[i].device)),
                _order(i, n, causal), i, causal, scale)
            outs.append(o)
            lses.append(l)
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        from .kernels import flash_attention_bwd
        n, causal, scale = ctx.n, ctx.causal, ctx.scale
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
              for q in qs]
        dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for k in ks]
        dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for v in vs]
        for i in range(n):
            do = douts[i] if douts[i] is not None else \
                torch.zeros_like(outs[i])
            dev = qs[i].device
            for j in _order(i, n, causal):
                g_q, g_k, g_v = flash_attention_bwd(
                    qs[i], ks[j].to(dev), vs[j].to(dev), outs[i], lses[i],
                    do, causal=causal and j == i, scale=scale)
                dq[i] += g_q.float()
                dk[j] += g_k.float().to(dk[j].device)
                dv[j] += g_v.float().to(dv[j].device)
        return (None, None, None,
                *[g.to(q.dtype) for g, q in zip(dq, qs)],
                *[g.to(k.dtype) for g, k in zip(dk, ks)],
                *[g.to(v.dtype) for g, v in zip(dv, vs)])


def _ring_exchange(tensors, pos, ranks):
    """Send `tensors` to the previous rank of the ring and receive the
    next rank's (counted isend / irecv pairs); returns the received."""
    n = len(ranks)
    prev, nxt = ranks[(pos - 1) % n], ranks[(pos + 1) % n]
    got = [torch.empty_like(t) for t in tensors]
    tasks = []
    for t, g in zip(tensors, got):
        if pos % 2 == 0:            # pair the blocking halves of gloo P2P
            tasks.append(pb.isend(t.contiguous(), prev))
            tasks.append(pb.irecv(g, nxt))
        else:
            tasks.append(pb.irecv(g, nxt))
            tasks.append(pb.isend(t.contiguous(), prev))
    for task in tasks:
        task.wait()
    return got


class _RingProcs(torch.autograd.Function):
    """The ring across processes on the flash kernels: this process's q,
    k, v shards; K/V blocks (and in the backward their dk / dv
    accumulators) travel to the previous rank each step."""

    @staticmethod
    def forward(ctx, q, k, v, pos, ranks, causal, scale):
        from .kernels import flash_attention_fwd
        n = len(ranks)
        acc = lse = None
        cur = (k, v)
        for t in range(n):
            src = (pos + t) % n
            if not causal or src <= pos:
                o, l = flash_attention_fwd(q, cur[0], cur[1],
                                           causal=causal and src == pos,
                                           scale=scale)
                acc, lse = _merge_lse(acc, lse, o, l)
            if t < n - 1:
                cur = tuple(_ring_exchange(list(cur), pos, ranks))
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.pos, ctx.ranks, ctx.causal, ctx.scale = pos, ranks, causal, \
            scale
        return out

    @staticmethod
    def backward(ctx, dout):
        from .kernels import flash_attention_bwd
        q, k, v, out, lse = ctx.saved_tensors
        pos, ranks, causal, scale = ctx.pos, ctx.ranks, ctx.causal, \
            ctx.scale
        n = len(ranks)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        cur = [k, v, torch.zeros(k.shape, dtype=torch.float32,
                                 device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        for t in range(n):
            src = (pos + t) % n
            if not causal or src <= pos:
                g_q, g_k, g_v = flash_attention_bwd(
                    q, cur[0], cur[1], out, lse, dout,
                    causal=causal and src == pos, scale=scale)
                dq += g_q.float()
                cur[2] += g_k.float()
                cur[3] += g_v.float()
            cur = _ring_exchange(cur, pos, ranks)   # n steps: home again
        return (dq.to(q.dtype), cur[2].to(k.dtype), cur[3].to(v.dtype),
                None, None, None, None)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def ring_flash_attention(q, k, v, mesh, axis_name="sp", causal=True,
                         scale=None):
    """q, k, v: [B, S, H, D] tensors (S split over the mesh axis here), or
    lists of the axis's n shards [B, S/n, H, D]; in a multi-process world
    this process's shards. Returns the attention output in the same form
    (see the module docstring)."""
    n, devices, proc = _axis(mesh, axis_name)
    d = (q[0] if isinstance(q, (list, tuple)) else q).shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if proc is not None:
        pos, ranks = proc
        return _RingProcs.apply(q, k, v, pos, ranks, bool(causal),
                                float(scale))
    home = (q[0] if isinstance(q, (list, tuple)) else q).device
    qs, whole = _shards(q, n, devices)
    ks, _ = _shards(k, n, devices)
    vs, _ = _shards(v, n, devices)
    outs = list(_RingKernel.apply(n, bool(causal), float(scale),
                                  *qs, *ks, *vs))
    if whole:
        return torch.cat([o.to(home) for o in outs], dim=1)
    return outs


class _A2AProcs(torch.autograd.Function):
    """Ulysses' swap across processes: [B, S/n, H, D] (heads split into n
    groups) -> [B, S, H/n, D] by one alltoall_single; its backward is
    the swap back."""

    @staticmethod
    def forward(ctx, x, n, to_heads):
        ctx.n, ctx.to_heads = n, to_heads
        return _a2a(x, n, to_heads)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.n, not ctx.to_heads), None, None


def _a2a(x, n, to_heads):
    from ..distributed import alltoall_single
    b, s, h, d = x.shape
    if to_heads:        # [B, S/n, H, D] -> [B, S, H/n, D]
        src = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    else:               # [B, S, H/n, D] -> [B, S/n, H, D]
        src = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    src = src.contiguous()
    out = torch.empty_like(src)
    alltoall_single(out, src)
    if to_heads:        # [n(src), B, S/n, H/n, D]: sequence in rank order
        return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


def ulysses_attention(q, k, v, mesh, axis_name="sep", causal=True,
                      scale=None):
    """All-to-all [B, S/n, H, D] -> [B, S, H/n, D], attention over the
    whole sequence with a head subset, then the swap back. Inputs and
    output as ``ring_flash_attention``'s."""
    from .kernels import FlashAttention
    n, devices, proc = _axis(mesh, axis_name)
    first = q[0] if isinstance(q, (list, tuple)) else q
    d, h = first.shape[-1], first.shape[-2]
    if h % n:
        raise ValueError(f"{h} heads do not split over {n} ranks")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if proc is not None:
        qh, kh, vh = (_A2AProcs.apply(t, n, True) for t in (q, k, v))
        o = FlashAttention.apply(qh, kh, vh, bool(causal), scale)
        return _A2AProcs.apply(o, n, False)
    home = first.device
    qs, whole = _shards(q, n, devices)
    ks, _ = _shards(k, n, devices)
    vs, _ = _shards(v, n, devices)
    g = h // n

    def to_heads(shards, r):
        """Rank r's heads of the whole sequence (the single controller's
        half of the all-to-all)."""
        return torch.cat([t[:, :, r * g:(r + 1) * g].to(devices[r])
                          for t in shards], dim=1)

    pb._count_collective("alltoall", qs, ks, vs)
    outs = [FlashAttention.apply(to_heads(qs, r), to_heads(ks, r),
                                 to_heads(vs, r), bool(causal), scale)
            for r in range(n)]
    pb._count_collective("alltoall", outs)
    sl = qs[0].shape[1]
    back = [torch.cat([o[:, s * sl:(s + 1) * sl].to(devices[s])
                       for o in outs], dim=2) for s in range(n)]
    if whole:
        return torch.cat([t.to(home) for t in back], dim=1)
    return back


__all__ = ["ring_flash_attention", "ulysses_attention"]
