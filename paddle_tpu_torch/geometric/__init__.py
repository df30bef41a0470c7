"""Graph message passing: the counterpart of
``paddle_tpu/geometric/__init__.py`` (``send_u_recv``, ``send_ue_recv``,
``send_uv``, the segment reductions, ``reindex_graph``,
``reindex_heter_graph``, ``sample_neighbors``,
``weighted_sample_neighbors``).

The message passing and segment ops are scatter reductions in PyTorch
(``index_add`` / ``scatter_reduce``), on the device of their inputs; a max
or min over no message gives 0, as in JAX. The segment ops read the
segment count from the ids on the host (a sync, as the JAX ops'
``device_get``). Reindexing and sampling have data-dependent output
shapes and run on the host in numpy, as the JAX functions do; the
sampling seed is drawn from the port's generators (``framework.random``),
so which neighbors a capped sample picks is not JAX's draw.
"""

import numpy as np
import torch

from ..ops.registry import register_op

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_sum",
           "segment_mean", "segment_max", "segment_min", "reindex_graph",
           "reindex_heter_graph", "sample_neighbors",
           "weighted_sample_neighbors"]


def _bcast(cnt, ndim):
    return cnt.reshape((-1,) + (1,) * (ndim - 1))


def _reduce(msgs, dst, n, reduce_op, inf_zero):
    """Scatter-reduce msgs [E, ...] into n rows by dst. inf_zero picks the
    infinities an empty max/min row leaves that become 0: "both" (either
    sign, send_u_recv's rule) or "own" (the reduction's own sign)."""
    shape = (n,) + tuple(msgs.shape[1:])
    dst = dst.long()
    if reduce_op == "sum":
        return msgs.new_zeros(shape).index_add(0, dst, msgs)
    if reduce_op == "mean":
        s = msgs.new_zeros(shape).index_add(0, dst, msgs)
        cnt = msgs.new_zeros((n,)).index_add(
            0, dst, msgs.new_ones(dst.shape))
        return s / _bcast(torch.clamp_min(cnt, 1.0), msgs.dim())
    if reduce_op in ("max", "min"):
        big = float("-inf") if reduce_op == "max" else float("inf")
        init = msgs.new_full(shape, big)
        idx = dst.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
        out = init.scatter_reduce(0, idx, msgs,
                                  "amax" if reduce_op == "max" else "amin")
        if inf_zero == "both":
            hit = torch.isinf(out)
        else:
            hit = torch.isneginf(out) if reduce_op == "max" else \
                torch.isposinf(out)
        return torch.where(hit, torch.zeros_like(out), out)
    raise ValueError(reduce_op)


@register_op("send_u_recv")
def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """x[src] reduced into rows dst (sum, mean, max or min)."""
    n = int(out_size) if out_size is not None else x.shape[0]
    msgs = x[src_index.long()]
    return _reduce(msgs, dst_index, n, reduce_op, "both")


_MESSAGE = {"add": torch.add, "sub": torch.subtract, "mul": torch.multiply,
            "div": torch.divide}


@register_op("send_ue_recv")
def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """(x[src] op y) reduced into rows dst."""
    msgs = _MESSAGE[message_op](x[src_index.long()], y)
    n = int(out_size) if out_size is not None else x.shape[0]
    return _reduce(msgs, dst_index, n, reduce_op, "own")


def _segments(segment_ids):
    return int(segment_ids.max()) + 1


@register_op("segment_sum")
def segment_sum(data, segment_ids, name=None):
    return _reduce(data, segment_ids, _segments(segment_ids), "sum", "own")


@register_op("segment_mean")
def segment_mean(data, segment_ids, name=None):
    return _reduce(data, segment_ids, _segments(segment_ids), "mean", "own")


@register_op("segment_max")
def segment_max(data, segment_ids, name=None):
    return _reduce(data, segment_ids, _segments(segment_ids), "max", "own")


@register_op("segment_min")
def segment_min(data, segment_ids, name=None):
    return _reduce(data, segment_ids, _segments(segment_ids), "min", "own")


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """The per-edge message x[src] op y[dst]."""
    x, y = _as_tensor(x), _as_tensor(y)
    si = _as_tensor(src_index).long().to(x.device)
    di = _as_tensor(dst_index).long().to(y.device)
    return _MESSAGE[message_op](x[si], y[di])


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _device(v):
    if isinstance(v, torch.Tensor):
        return v.device
    from ..device import resolve_device
    return resolve_device()


def _out(arr, dev):
    return torch.as_tensor(np.asarray(arr)).to(dev)


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Center nodes x and flat neighbors (count per center) -> (reindex_src,
    reindex_dst, out_nodes): local ids, out_nodes = x then the new
    neighbors in order of first appearance."""
    dev = _device(x)
    xs, nb, cnt = _np(x), _np(neighbors), _np(count)
    mapping, out_nodes = {}, []
    for v in xs.tolist():
        if v not in mapping:
            mapping[v] = len(out_nodes)
            out_nodes.append(v)
    src = np.empty(len(nb), np.int64)
    for i, v in enumerate(nb.tolist()):
        if v not in mapping:
            mapping[v] = len(out_nodes)
            out_nodes.append(v)
        src[i] = mapping[v]
    dst = np.repeat(np.arange(len(xs)), cnt)
    return (_out(src, dev), _out(dst, dev),
            _out(np.asarray(out_nodes, np.int64), dev))


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """``reindex_graph`` over per-edge-type neighbor / count lists that
    share one node-id space."""
    dev = _device(x)
    xs = _np(x)
    mapping, out_nodes = {}, []
    for v in xs.tolist():
        if v not in mapping:
            mapping[v] = len(out_nodes)
            out_nodes.append(v)
    srcs, dsts = [], []
    for nb_t, cnt_t in zip(neighbors, count):
        nb, cnt = _np(nb_t), _np(cnt_t)
        src = np.empty(len(nb), np.int64)
        for i, v in enumerate(nb.tolist()):
            if v not in mapping:
                mapping[v] = len(out_nodes)
                out_nodes.append(v)
            src[i] = mapping[v]
        srcs.append(_out(src, dev))
        dsts.append(_out(np.repeat(np.arange(len(xs)), cnt), dev))
    return srcs, dsts, _out(np.asarray(out_nodes, np.int64), dev)


def _sample(r, cp, nodes, ev, pick_fn):
    outs, counts, oeids = [], [], []
    for v in nodes.tolist():
        beg, end = int(cp[v]), int(cp[v + 1])
        pick = pick_fn(beg, end)
        if pick is None:
            counts.append(0)
            continue
        outs.append(r[pick])
        counts.append(len(pick))
        if ev is not None:
            oeids.append(ev[pick])
    out = np.concatenate(outs) if outs else np.empty(0, r.dtype)
    return out, np.asarray(counts, np.int32), oeids


def _rng():
    from ..framework.random import next_seed
    return np.random.default_rng(next_seed())


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform sampling without replacement of at most sample_size
    neighbors of each input node of a CSC graph -> (out_neighbors,
    out_count[, out_eids])."""
    dev = _device(input_nodes)
    r, cp, nodes = _np(row), _np(colptr), _np(input_nodes)
    rng = _rng()
    ev = _np(eids) if eids is not None else None

    def pick(beg, end):
        deg = end - beg
        if sample_size < 0 or deg <= sample_size:
            return np.arange(beg, end)
        return beg + rng.choice(deg, size=sample_size, replace=False)
    out, counts, oeids = _sample(r, cp, nodes, ev, pick)
    res = (_out(out, dev), _out(counts, dev))
    if return_eids and ev is not None:
        return res + (_out(np.concatenate(oeids), dev),)
    return res


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    """Weight-proportional sampling without replacement (the
    Efraimidis-Spirakis exponential keys)."""
    dev = _device(input_nodes)
    r, cp, nodes = _np(row), _np(colptr), _np(input_nodes)
    w = _np(edge_weight).astype(np.float64)
    rng = _rng()
    ev = _np(eids) if eids is not None else None

    def pick(beg, end):
        deg = end - beg
        if deg == 0:
            return None
        if sample_size < 0 or deg <= sample_size:
            return np.arange(beg, end)
        keys = rng.random(deg) ** (1.0 / np.maximum(w[beg:end], 1e-12))
        return beg + np.argsort(-keys)[:sample_size]
    out, counts, oeids = _sample(r, cp, nodes, ev, pick)
    res = (_out(out, dev), _out(counts, dev))
    if return_eids and ev is not None:
        return res + (_out(np.concatenate(oeids), dev),)
    return res
