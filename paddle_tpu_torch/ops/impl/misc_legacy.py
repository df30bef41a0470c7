"""Legacy and CTR-era ops: the counterpart of
``paddle_tpu/ops/impl/misc_legacy.py`` — the channel ops
(``shuffle_channel``, ``affine_channel``), ``partial_concat`` /
``partial_sum``, ``im2sequence``, ``add_position_encoding``,
``correlation``, ``cvm``, ``batch_fc``, ``rank_attention``,
``lookup_table_dequant`` and the sequence (LoD) ops (``sequence_pool``,
``sequence_conv``, ``match_matrix_tensor``, ``attention_lstm``,
``row_conv``, ``sequence_expand``, ``sequence_softmax``).

Dense ops are PyTorch on the input's device. As in the JAX package there
is no LoD tensor type: a sequence op takes the packed [total_T, ...]
values and an explicit offsets vector ``lod`` ([0, n1, n1 + n2, ...]),
which is read on the host (it decides the shapes).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..registry import register_op
from ._common import to_host


def _lod_segments(lod):
    arr = to_host(lod).astype(np.int64).reshape(-1)
    return [(int(arr[i]), int(arr[i + 1])) for i in range(len(arr) - 1)]


@register_op("shuffle_channel")
def shuffle_channel(x, group=1, name=None):
    """ShuffleNet's channel shuffle of [N, C, H, W], C % group == 0."""
    n, c, h, w = x.shape
    return x.reshape(n, group, c // group, h, w).transpose(1, 2).reshape(
        n, c, h, w)


@register_op("affine_channel")
def affine_channel(x, scale, bias, data_layout="NCHW", name=None):
    """scale_c * x + bias_c."""
    if data_layout in ("NCHW", "AnyLayout"):
        shp = (1, -1) + (1,) * (x.dim() - 2)
    else:
        shp = (1,) * (x.dim() - 1) + (-1,)
    return x * scale.reshape(shp) + bias.reshape(shp)


@register_op("partial_concat")
def partial_concat(x, start_index=0, length=-1, name=None):
    """The same column slice of each [N, C] input, concatenated."""
    return torch.cat([t[:, start_index:(t.shape[1] if length < 0 else
                                        start_index + length)] for t in x],
                     dim=1)


@register_op("partial_sum")
def partial_sum(x, start_index=0, length=-1, name=None):
    """The sum of the same column slice of each [N, C] input."""
    end = x[0].shape[1] if length < 0 else start_index + length
    out = x[0][:, start_index:end]
    for t in x[1:]:
        out = out + t[:, start_index:end]
    return out


@register_op("im2sequence")
def im2sequence(x, y=None, kernels=(1, 1), strides=(1, 1),
                paddings=(0, 0, 0, 0), out_stride=(1, 1), name=None):
    """Sliding-window im2col: [N, C, H, W] -> [N*oh*ow, C*kh*kw] (windows
    row-major; paddings (up, left, down, right))."""
    n, c = x.shape[:2]
    pu, pl, pd, pr = paddings
    xp = TF.pad(x, (pl, pr, pu, pd))
    cols = TF.unfold(xp, tuple(kernels), stride=tuple(strides))
    return cols.transpose(1, 2).reshape(-1, c * kernels[0] * kernels[1])


@register_op("add_position_encoding")
def add_position_encoding(x, alpha=1.0, beta=1.0, name=None):
    """alpha x + beta PE, PE the half-split sinusoid (sin in the first
    half of the features, cos in the second)."""
    seq, d = x.shape[-2], x.shape[-1]
    half = d // 2
    pos = torch.arange(seq, dtype=torch.float32, device=x.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, device=x.device),
                    torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    if d % 2:
        pe = TF.pad(pe, (0, 1))
    return alpha * x + beta * pe.to(x.dtype)


@register_op("correlation")
def correlation(input1, input2, pad_size, kernel_size, max_displacement,
                stride1, stride2, corr_type_multiply=1, name=None):
    """FlowNet's cost volume of NCHW inputs: out[:, d, i, j] = the mean
    over (C, K, K) of x1's patch at (i, j) times x2's patch displaced by
    d (displacements on a stride2 grid within max_displacement)."""
    n, c, h, w = input1.shape
    k = int(kernel_size)
    kr = k // 2
    d = int(max_displacement)
    pad = pad_size
    x1 = TF.pad(input1, (pad, pad, pad, pad))
    x2 = TF.pad(input2, (pad, pad, pad, pad))
    oh = int(np.ceil((h + 2 * pad - 2 * d - k + 1) / stride1))
    ow = int(np.ceil((w + 2 * pad - 2 * d - k + 1) / stride1))
    norm = c * k * k
    span_h, span_w = oh * stride1, ow * stride1
    outs = []
    for di in range(-(d // stride2), d // stride2 + 1):
        for dj in range(-(d // stride2), d // stride2 + 1):
            oy, ox = di * stride2, dj * stride2
            prod = torch.zeros((n, oh, ow), dtype=input1.dtype,
                               device=input1.device)
            for ky in range(-kr, -kr + k):
                for kx in range(-kr, -kr + k):
                    y0, x0 = d + kr + ky, d + kr + kx
                    a = x1[:, :, y0:y0 + span_h:stride1,
                           x0:x0 + span_w:stride1]
                    b = x2[:, :, y0 + oy:y0 + oy + span_h:stride1,
                           x0 + ox:x0 + ox + span_w:stride1]
                    prod = prod + (a * b).sum(1)
            outs.append(prod / norm)
    return torch.stack(outs, dim=1)


@register_op("cvm")
def cvm(x, cvm_in, use_cvm=True, name=None):
    """Rows starting with (show, click): use_cvm keeps the width with
    y0 = log(x0 + 1), y1 = log(x1 + 1) - y0; else the two columns go."""
    if use_cvm:
        y0 = torch.log(x[:, :1] + 1.0)
        y1 = torch.log(x[:, 1:2] + 1.0) - y0
        return torch.cat([y0, y1, x[:, 2:]], dim=1)
    return x[:, 2:]


@register_op("batch_fc")
def batch_fc(input, w, bias, name=None):  # noqa: A002
    """relu(input [slot, batch, in] @ w [slot, in, out] + bias [slot,
    out])."""
    return torch.relu(torch.einsum("sbi,sio->sbo", input, w) +
                      bias[:, None, :])


@register_op("rank_attention")
def rank_attention(x, rank_offset, rank_param, max_rank=3, max_size=0,
                   name=None):
    """x [N, M]; rank_offset [N, 2*max_rank+1] (col 0 the instance's
    1-based rank, then (rank_k, index_k) pairs); rank_param rows
    (lower*max_rank + faster)*M + m. Returns (input_help [N, K*M], out
    [N, P], ins_rank [N, 1])."""
    n, m = x.shape
    ro = rank_offset.long()
    ins_rank = ro[:, 0].to(x.dtype)[:, None]
    lower = ro[:, 0] - 1
    ks = torch.arange(max_rank, device=x.device)
    faster = ro[:, 1 + 2 * ks] - 1
    index = ro[:, 2 + 2 * ks]
    valid = (lower[:, None] >= 0) & (faster >= 0)
    gathered = x[index.clamp(0, n - 1)]
    input_help = torch.where(valid[:, :, None], gathered,
                             torch.zeros_like(gathered)).reshape(
                                 n, max_rank * m)
    start = (lower[:, None] * max_rank + faster).clamp(
        0, rank_param.shape[0] // max(m, 1) - 1)
    rows = (start[:, :, None] * m + torch.arange(m, device=x.device)).clamp(
        0, rank_param.shape[0] - 1)
    block = rank_param[rows]
    block = torch.where(valid[:, :, None, None], block,
                        torch.zeros_like(block))
    out = torch.einsum("nkm,nkmp->np", input_help.reshape(n, max_rank, m),
                       block)
    return input_help, out, ins_rank


@register_op("lookup_table_dequant")
def lookup_table_dequant(w, ids, padding_idx=-1, name=None):
    """Rows of w ([min, max, float32 words holding 4 uint8 codes each]) at
    ids, dequantized to (max - min) / 256 * code + min."""
    ids_flat = ids.reshape(-1).long()
    rows = w[ids_flat]
    mn, mx = rows[:, 0:1], rows[:, 1:2]
    codes = rows[:, 2:].contiguous().view(torch.uint8).reshape(
        rows.shape[0], -1).to(torch.float32)
    out = (mx - mn) / 256.0 * codes + mn
    if padding_idx >= 0:
        out = torch.where((ids_flat == padding_idx)[:, None],
                          torch.zeros_like(out), out)
    out = out.reshape(tuple(ids.shape) + (out.shape[-1],))
    if ids.dim() > 1 and ids.shape[-1] == 1:
        out = out.squeeze(-2)
    return out


@register_op("sequence_pool")
def sequence_pool(x, lod, pooltype="AVERAGE", pad_value=0.0, is_test=False,
                  name=None):
    """Pool each sequence of x [total_T, D]: AVERAGE, SUM, SQRT (sum /
    sqrt(len)), MAX (with the max's row [N, D]), LAST or FIRST; an empty
    sequence gives pad_value."""
    segs = _lod_segments(lod)
    d = x.shape[1]
    outs, idxs = [], []
    for s, e in segs:
        if e <= s:
            outs.append(torch.full((d,), pad_value, dtype=x.dtype,
                                   device=x.device))
            idxs.append(torch.full((d,), -1, dtype=torch.int32,
                                   device=x.device))
            continue
        seg = x[s:e]
        if pooltype == "AVERAGE":
            outs.append(seg.mean(0))
        elif pooltype == "SUM":
            outs.append(seg.sum(0))
        elif pooltype == "SQRT":
            outs.append(seg.sum(0) / np.sqrt(float(e - s)))
        elif pooltype == "MAX":
            outs.append(seg.amax(0))
            idxs.append((seg.argmax(0) + s).to(torch.int32))
        elif pooltype == "LAST":
            outs.append(seg[-1])
        elif pooltype == "FIRST":
            outs.append(seg[0])
        else:
            raise ValueError(f"unknown pooltype {pooltype}")
    out = torch.stack(outs)
    if pooltype == "MAX":
        return out, torch.stack(idxs)
    return out


@register_op("sequence_conv")
def sequence_conv(x, lod, filter, context_length,  # noqa: A002
                  padding_data=None, padding_trainable=False,
                  context_start=None, context_stride=1, name=None):
    """Per-sequence context-window conv: each step concatenates
    context_length rows (zeros, or padding_data's rows with
    padding_trainable, outside the sequence) and multiplies filter
    [context_length*D, out]."""
    if context_start is None:
        context_start = -((context_length - 1) // 2)
    d = x.shape[1]
    zero = torch.zeros((d,), dtype=x.dtype, device=x.device)
    cols = []
    for s, e in _lod_segments(lod):
        length = e - s
        seg = x[s:e]
        for t in range(length):
            row = []
            for c in range(context_length):
                pos = t + context_start + c
                if 0 <= pos < length:
                    row.append(seg[pos])
                elif padding_trainable and padding_data is not None:
                    row.append(padding_data[c] if pos < 0 else padding_data[
                        padding_data.shape[0] - (context_length - c)])
                else:
                    row.append(zero)
            cols.append(torch.cat(row))
    col = torch.stack(cols) if cols else x.new_zeros((0, context_length * d))
    return col @ filter


@register_op("match_matrix_tensor")
def match_matrix_tensor(x, y, w, x_lod, y_lod, dim_t=1, name=None):
    """Per sequence pair i: out[t, jx, jy] = x_i[jx] @ w[:, t, :] @
    y_i[jy]; the pairs' [t, len_x, len_y] blocks flattened and
    concatenated, and tmp = x @ w [total_x, dim_t*dy]."""
    dx, dy = x.shape[1], y.shape[1]
    tmp = torch.einsum("nd,dte->nte", x, w.reshape(dx, dim_t, dy))
    outs = [torch.einsum("xte,ye->txy", tmp[sx:ex], y[sy:ey]).reshape(-1)
            for (sx, ex), (sy, ey) in zip(_lod_segments(x_lod),
                                          _lod_segments(y_lod))]
    out = torch.cat(outs) if outs else x.new_zeros((0,))
    return out, tmp.reshape(x.shape[0], dim_t * dy)


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": (lambda v: v)}


@register_op("attention_lstm")
def attention_lstm(x, lod, c0, h0=None, attention_weight=None,
                   attention_bias=None, attention_scalar=None,
                   attention_scalar_bias=None, lstm_weight=None,
                   lstm_bias=None, gate_activation="sigmoid",
                   cell_activation="tanh", candidate_activation="tanh",
                   name=None):
    """An LSTM whose input at each step is the attention-pooled sequence.
    x [total_T, M]; attention_weight [M+D, 1]; lstm_weight [D+M, 4D]
    (hidden rows first; gates forget, input, output, candidate). Returns
    (hidden [total_T, D], cell [total_T, D])."""
    act_gate = _ACTS[gate_activation]
    act_cell = _ACTS[cell_activation]
    act_cand = _ACTS[candidate_activation]
    m = x.shape[1]
    d = lstm_weight.shape[1] // 4
    atted_x = x @ attention_weight[:m]
    if attention_bias is not None:
        atted_x = atted_x + attention_bias.reshape(1, 1)
    hid_rows, cell_rows = [], []
    for i, (s, e) in enumerate(_lod_segments(lod)):
        seq_att = atted_x[s:e, 0]
        seq_x = x[s:e]
        prev_c = c0[i]
        prev_h = h0[i] if h0 is not None else x.new_zeros((d,))
        for _ in range(e - s):
            sc = torch.relu(seq_att + prev_c @ attention_weight[m:, 0])
            if attention_scalar is not None:
                sc = sc * attention_scalar.reshape(())
                if attention_scalar_bias is not None:
                    sc = torch.relu(sc + attention_scalar_bias.reshape(()))
            lstm_x = torch.softmax(sc, dim=0) @ seq_x
            gates = lstm_x @ lstm_weight[d:] + prev_h @ lstm_weight[:d] + \
                lstm_bias.reshape(-1)
            f = act_gate(gates[:d])
            i_g = act_gate(gates[d:2 * d])
            o = act_gate(gates[2 * d:3 * d])
            cand = act_cand(gates[3 * d:])
            prev_c = f * prev_c + i_g * cand
            prev_h = o * act_cell(prev_c)
            hid_rows.append(prev_h)
            cell_rows.append(prev_c)
    if not hid_rows:
        return x.new_zeros((0, d)), x.new_zeros((0, d))
    return torch.stack(hid_rows), torch.stack(cell_rows)


@register_op("row_conv")
def row_conv(x, weight, lod=None, name=None):
    """Lookahead conv: out[b, t, d] = sum_i x[b, t+i, d] weight[i, d];
    a packed [total_T, D] input with lod stops at each sequence's end."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    ctx, t = weight.shape[0], x.shape[1]
    xp = TF.pad(x, (0, 0, 0, ctx - 1))
    sid = None
    if squeeze and lod is not None:
        seg_ids = np.full(t + ctx - 1, -1, np.int64)
        for i, (s, e) in enumerate(_lod_segments(lod)):
            seg_ids[s:e] = i
        sid = torch.as_tensor(seg_ids, device=x.device)
    out = torch.zeros_like(x)
    for i in range(ctx):
        term = xp[:, i:i + t] * weight[i]
        if sid is not None:
            same = (sid[i:i + t] == sid[:t])[None, :, None]
            term = torch.where(same, term, torch.zeros_like(term))
        out = out + term
    return out[0] if squeeze else out


@register_op("sequence_expand")
def sequence_expand(x, lod, name=None):
    """Row i of x repeated by the length of lod's i-th sequence."""
    reps = torch.as_tensor([e - s for s, e in _lod_segments(lod)],
                           device=x.device)
    return torch.repeat_interleave(x, reps, dim=0)


@register_op("sequence_softmax")
def sequence_softmax(x, lod, name=None):
    """Softmax within each sequence of a packed [total_T] (or [total_T,
    1]) tensor."""
    v = x.reshape(-1)
    outs = [torch.softmax(v[s:e], dim=0) for s, e in _lod_segments(lod)]
    return torch.cat(outs).reshape(x.shape)
