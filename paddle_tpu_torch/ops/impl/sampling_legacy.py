"""Host-side sampling, alignment and graph ops: the counterpart of
``paddle_tpu/ops/impl/sampling_legacy.py`` — ``shuffle_batch``,
``ctc_align``, ``chunk_eval``, ``graph_sample_neighbors``,
``weighted_sample_neighbors``, ``reindex_graph``, ``graph_khop_sampler``,
``tdm_child``, ``tdm_sampler`` and ``pyramid_hash``.

Every output size depends on the data, so these run on the host in numpy
(as in the JAX package, whose reference ships CPU-only kernels) and
return their outputs on their input's device. Draws come from a numpy
Generator seeded by the op's ``seed`` or, without one, by the port's last
``seed`` (``framework.random.initial_seed``): reproducible runs, numbers
other than the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ...framework import random as fw_random
from ..registry import register_op
from ._common import device_of_input as _dev
from ._common import from_host as _out
from ._common import to_host as _host


def _rng(seed=0):
    return np.random.default_rng(seed if seed else
                                 (fw_random.initial_seed() or None))


@register_op("shuffle_batch")
def shuffle_batch(x, seed=None, startup_seed=0, name=None):
    """A random row permutation: (out, shuffle_idx, seed_out = seed + 1)."""
    xv = _host(x)
    sd = int(_host(seed).reshape(-1)[0]) if seed is not None else \
        startup_seed
    perm = np.random.default_rng(sd if sd else None).permutation(
        xv.shape[0])
    dev = _dev(x)
    return (_out(xv[perm], dev), _out(perm.astype(np.int64), dev),
            _out(np.asarray([sd + 1], np.int64), dev))


@register_op("ctc_align")
def ctc_align(input, input_length=None, blank=0,  # noqa: A002
              merge_repeated=True, padding_value=0, name=None):
    """Collapse repeats, then drop blanks, per row of input [N, T] (up to
    input_length [N, 1]); rows padded with padding_value. Returns
    (output, output_length [N, 1])."""
    inp = _host(input)
    n, t = inp.shape
    lens = (_host(input_length).reshape(-1).astype(np.int64)
            if input_length is not None else np.full((n,), t, np.int64))
    rows = []
    for i in range(n):
        prev, row = None, []
        for tok in inp[i, :lens[i]]:
            if merge_repeated and prev is not None and tok == prev:
                continue
            prev = tok
            if tok != blank:
                row.append(tok)
        rows.append(row)
    out_lens = [len(r) for r in rows]
    out = np.full((n, max(1, max(out_lens, default=1))), padding_value,
                  inp.dtype)
    for i, row in enumerate(rows):
        out[i, :len(row)] = row
    dev = _dev(input)
    return (_out(out, dev),
            _out(np.asarray(out_lens, np.int64).reshape(n, 1), dev))


def _extract_chunks(tags, num_types, scheme):
    """(type, begin, end) chunks of a tag sequence. IOB: tag = type*2 +
    (0=B, 1=I); IOE: (0=I, 1=E); IOBES: type*4 + (0=B, 1=I, 2=E, 3=S);
    plain: tag = type; the outside tag is num_types * arity."""
    chunks = set()
    if scheme == "plain":
        start = None
        for i, tg in enumerate(list(tags) + [num_types]):
            ty = tg if tg < num_types else None
            if start is not None and (ty is None or ty != start[0]):
                chunks.add((start[0], start[1], i - 1))
                start = None
            if ty is not None and start is None:
                start = (ty, i)
        return chunks
    arity = {"IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    out_tag = num_types * arity
    cur = None
    for i, tg in enumerate(list(tags) + [out_tag]):
        ty, pos = (None, None) if tg >= out_tag else divmod(int(tg), arity)
        if scheme == "IOB":
            is_begin = pos == 0
            if cur is not None and (ty is None or is_begin or ty != cur[0]):
                chunks.add((cur[0], cur[1], i - 1))
                cur = None
            if ty is not None and (is_begin or (pos == 1 and cur is None)):
                cur = (ty, i)
        elif scheme == "IOE":
            if ty is None and cur is not None:
                chunks.add((cur[0], cur[1], i - 1))
                cur = None
            elif ty is not None:
                if cur is not None and ty != cur[0]:
                    chunks.add((cur[0], cur[1], i - 1))
                    cur = None
                if cur is None:
                    cur = (ty, i)
                if pos == 1:
                    chunks.add((cur[0], cur[1], i))
                    cur = None
        else:
            if cur is not None and (ty is None or pos in (0, 3) or
                                    ty != cur[0]):
                chunks.add((cur[0], cur[1], i - 1))
                cur = None
            if ty is not None:
                if pos == 3:
                    chunks.add((ty, i, i))
                elif pos == 0 or (pos == 1 and cur is None):
                    cur = (ty, i)
                elif pos == 2:
                    if cur is None:
                        cur = (ty, i)
                    chunks.add((cur[0], cur[1], i))
                    cur = None
    return chunks


@register_op("chunk_eval")
def chunk_eval(inference, label, lod=None, num_chunk_types=1,
               chunk_scheme="IOB", excluded_chunk_types=(), seq_length=None,
               name=None):
    """NER chunk precision, recall and F1 of inference against label [T]
    (or [N, T] with seq_length, or split by lod). Returns (precision,
    recall, f1, num_infer_chunks, num_label_chunks, num_correct_chunks)."""
    inf, lab = _host(inference), _host(label)
    seqs = []
    if seq_length is not None:
        lens = _host(seq_length).reshape(-1)
        seqs = [(inf[i, :lens[i]], lab[i, :lens[i]])
                for i in range(inf.shape[0])]
    else:
        inf, lab = inf.reshape(-1), lab.reshape(-1)
        if lod is not None:
            off = _host(lod).reshape(-1)
            seqs = [(inf[off[i]:off[i + 1]], lab[off[i]:off[i + 1]])
                    for i in range(len(off) - 1)]
        else:
            seqs = [(inf, lab)]
    excl = set(excluded_chunk_types)
    n_inf = n_lab = n_cor = 0
    for iseq, lseq in seqs:
        ci = {c for c in _extract_chunks(iseq, num_chunk_types,
                                         chunk_scheme) if c[0] not in excl}
        cl = {c for c in _extract_chunks(lseq, num_chunk_types,
                                         chunk_scheme) if c[0] not in excl}
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    dev = _dev(inference)
    return tuple(_out(np.asarray(v, np.float32), dev) for v in (p, r, f1)) + \
        tuple(_out(np.asarray(v, np.int64), dev)
              for v in (n_inf, n_lab, n_cor))


def _sample_neighbors(row, colptr, nodes, sample_size, eids, weights, rng):
    outs, counts, oeids = [], [], []
    for node in nodes:
        s, e = int(colptr[node]), int(colptr[node + 1])
        nbrs, ids = row[s:e], np.arange(s, e)
        if sample_size >= 0 and len(nbrs) > sample_size:
            p = None
            if weights is not None:
                w = weights[s:e]
                p = w / w.sum() if w.sum() > 0 else None
            pick = rng.choice(len(nbrs), size=sample_size, replace=False,
                              p=p)
            nbrs, ids = nbrs[pick], ids[pick]
        outs.append(nbrs)
        counts.append(len(nbrs))
        if eids is not None:
            oeids.append(eids[ids])
    out = np.concatenate(outs) if outs else np.zeros((0,), row.dtype)
    res = [out, np.asarray(counts, np.int32)]
    if eids is not None:
        res.append(np.concatenate(oeids) if oeids else
                   np.zeros((0,), eids.dtype))
    return res


@register_op("graph_sample_neighbors")
def graph_sample_neighbors(row, colptr, x, eids=None, perm_buffer=None,
                           sample_size=-1, return_eids=False,
                           flag_perm_buffer=False, name=None):
    """Up to sample_size uniformly drawn in-neighbours (CSC: row, colptr)
    of each node of x. Returns (out, out_count [, out_eids])."""
    eh = _host(eids) if (eids is not None and return_eids) else None
    res = _sample_neighbors(_host(row), _host(colptr),
                            _host(x).reshape(-1), sample_size, eh, None,
                            _rng())
    return tuple(_out(a, _dev(row)) for a in res)


@register_op("weighted_sample_neighbors")
def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              eids=None, sample_size=-1, return_eids=False,
                              name=None):
    """As graph_sample_neighbors, drawn without replacement with
    probability proportional to edge_weight."""
    eh = _host(eids) if (eids is not None and return_eids) else None
    res = _sample_neighbors(_host(row), _host(colptr),
                            _host(input_nodes).reshape(-1), sample_size, eh,
                            _host(edge_weight).astype(np.float64), _rng())
    return tuple(_out(a, _dev(row)) for a in res)


def _reindex(x, neighbors):
    """Renumber x then the new neighbours to consecutive ids: (the
    neighbours' new ids, the node table)."""
    table = {}
    for v in x:
        table.setdefault(int(v), len(table))
    dst_of = []
    for v in neighbors:
        dst_of.append(table.setdefault(int(v), len(table)))
    nodes = np.empty(len(table), np.int64)
    for k, i in table.items():
        nodes[i] = k
    return np.asarray(dst_of, np.int64), nodes


@register_op("reindex_graph")
def reindex_graph(x, neighbors, count, hashtable_value=None,
                  hashtable_index=None, name=None):
    """(reindex_src, reindex_dst, out_nodes): neighbours renumbered, each
    center node repeated by its count, the node table with x first."""
    xh = _host(x).reshape(-1)
    src_new, nodes = _reindex(xh, _host(neighbors).reshape(-1))
    dst = np.repeat(np.arange(len(xh)), _host(count).reshape(-1))
    dev = _dev(x)
    return (_out(src_new, dev), _out(dst.astype(np.int64), dev),
            _out(nodes, dev))


@register_op("graph_khop_sampler")
def graph_khop_sampler(row, colptr, x, eids=None, sample_sizes=(),
                       return_eids=False, name=None):
    """Uniform sampling hop by hop (sample_sizes), then one renumbering.
    Returns (out_src, out_dst, sample_index, reindex_x [, out_eids])."""
    rowh, cp = _host(row), _host(colptr)
    eh = _host(eids) if (eids is not None and return_eids) else None
    xh = _host(x).reshape(-1)
    frontier = xh
    rng = _rng()
    all_src, all_dst, all_eids = [], [], []
    for size in sample_sizes:
        res = _sample_neighbors(rowh, cp, frontier, size, eh, None, rng)
        all_src.append(res[0])
        all_dst.append(np.repeat(frontier, res[1]))
        if eh is not None:
            all_eids.append(res[2])
        frontier = np.unique(res[0])
    src = (np.concatenate(all_src) if all_src else
           np.zeros((0,), np.int64)).astype(np.int64)
    dst = (np.concatenate(all_dst) if all_dst else
           np.zeros((0,), np.int64)).astype(np.int64)
    src_new, nodes = _reindex(xh, src)
    table = {int(v): i for i, v in enumerate(nodes)}
    dev = _dev(row)
    res = [_out(src_new, dev),
           _out(np.asarray([table[int(v)] for v in dst], np.int64), dev),
           _out(nodes, dev),
           _out(np.asarray([table[int(v)] for v in xh], np.int64), dev)]
    if return_eids:
        res.append(_out(np.concatenate(all_eids) if all_eids else
                        np.zeros((0,), np.int64), dev))
    return tuple(res)


@register_op("tdm_child")
def tdm_child(x, tree_info, child_nums, dtype="int32", name=None):
    """Children of each node of x in tree_info rows [item_id, layer_id,
    ancestor_id, child_0, ...]. Returns (child, leaf_mask), each
    [*x.shape, child_nums]."""
    xh = _host(x).astype(np.int64)
    info = _host(tree_info)
    flat = xh.reshape(-1)
    child = np.zeros((flat.size, child_nums), np.int64)
    mask = np.zeros((flat.size, child_nums), np.int64)
    for i, node in enumerate(flat):
        if node == 0 or info[node, 3] == 0:
            continue
        for j in range(child_nums):
            cid = int(info[node, 3 + j])
            child[i, j] = cid
            mask[i, j] = 1 if info[cid, 0] != 0 else 0
    np_dtype = np.int64 if str(dtype) in ("int64", "DataType.INT64") \
        else np.int32
    shp = tuple(xh.shape) + (child_nums,)
    dev = _dev(x)
    return (_out(child.reshape(shp).astype(np_dtype), dev),
            _out(mask.reshape(shp).astype(np_dtype), dev))


@register_op("tdm_sampler")
def tdm_sampler(x, travel, layer, output_positive=True,
                neg_samples_num_list=(), layer_offset_lod=(), seed=0,
                dtype="int32", name=None):
    """Per input id and tree layer: the positive node of travel[id] and
    uniform negatives from the layer (not the positive). Returns (out,
    labels, mask)."""
    xh = _host(x).reshape(-1).astype(np.int64)
    tr, ly = _host(travel), _host(layer).reshape(-1)
    rng = _rng(seed)
    res_len = sum(int(n) + (1 if output_positive else 0)
                  for n in neg_samples_num_list)
    out = np.zeros((len(xh), res_len), np.int64)
    lab = np.zeros((len(xh), res_len), np.int64)
    mask = np.ones((len(xh), res_len), np.int64)
    for i, idx in enumerate(xh):
        off = 0
        for li, neg_n in enumerate(neg_samples_num_list):
            neg_n = int(neg_n)
            width = neg_n + (1 if output_positive else 0)
            lo, hi = int(layer_offset_lod[li]), int(layer_offset_lod[li + 1])
            pos = int(tr[idx, li])
            if pos == 0:
                mask[i, off:off + width] = 0
                off += width
                continue
            col = off
            if output_positive:
                out[i, col] = pos
                lab[i, col] = 1
                col += 1
            node_ids = ly[lo:hi]
            cand = np.delete(np.arange(hi - lo),
                             np.nonzero(node_ids == pos)[0])
            pick = rng.choice(cand, size=min(neg_n, len(cand)),
                              replace=False)
            out[i, col:col + len(pick)] = node_ids[pick]
            off += width
    np_dtype = np.int64 if str(dtype) in ("3", "int64") else np.int32
    dev = _dev(x)
    return tuple(_out(a.astype(np_dtype), dev) for a in (out, lab, mask))


def _fnv(tokens, salt, space):
    h = (0xcbf29ce484222325 ^ salt) & 0xFFFFFFFFFFFFFFFF
    for t in tokens:
        h = ((h ^ int(t)) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h % space


@register_op("pyramid_hash")
def pyramid_hash(x, w, lod, white_list=None, black_list=None, num_emb=0,
                 space_len=None, pyramid_layer=2, rand_len=16,
                 drop_out_percent=0, is_training=False, use_filter=False,
                 white_list_len=0, black_list_len=0, seed=0, lr=0.0,
                 distribute_update_vars="", name=None):
    """Hash embeddings of every n-gram (n = 2..pyramid_layer) of each
    sequence: each n-gram hashed (FNV-1a, as the JAX op's stand-in for
    the reference's xxhash) into [0, space_len), num_emb / rand_len
    row-chunks of w concatenated. Returns (out [n-grams, width], the
    output offsets)."""
    xh = _host(x).reshape(-1).astype(np.int64)
    wh = _host(w)
    space = space_len or wh.shape[0] - 1
    off = _host(lod).reshape(-1)
    n_chunk = max(1, num_emb // rand_len) if num_emb else 1
    width = n_chunk * rand_len
    white = set(_host(white_list).reshape(-1).tolist()) \
        if (white_list is not None and white_list_len) else None
    black = set(_host(black_list).reshape(-1).tolist()) \
        if (black_list is not None and black_list_len) else None
    rows, out_lod = [], [0]
    for i in range(len(off) - 1):
        seq = xh[off[i]:off[i + 1]]
        for s in range(len(seq)):
            for glen in range(2, pyramid_layer + 1):
                if s + glen > len(seq):
                    continue
                gram = tuple(seq[s:s + glen])
                key = _fnv(gram, 0, space)
                if black is not None and key in black:
                    continue
                if use_filter and white is not None and key not in white:
                    continue
                emb = np.concatenate([wh[_fnv(gram, c + 1, space)][:rand_len]
                                      for c in range(n_chunk)])
                rows.append(emb[:width])
        out_lod.append(len(rows))
    out = np.stack(rows) if rows else np.zeros((0, width), wh.dtype)
    dev = _dev(w)
    return _out(out, dev), _out(np.asarray(out_lod, np.int64), dev)
