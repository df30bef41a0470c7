"""The kernel functionals of the port's models and the fused loss:
``swiglu`` (the SwiGLU kernel), ``fused_rope`` and ``fused_rope_qk`` (the
RoPE kernel; q and k in one launch), and the ``fused_linear_cross_entropy``
op (``paddle_tpu/ops/impl/fused.py:271-396``) as a ``torch.library`` op
with its chunked backward. Each hands its kernel dense tensors
(``attention._dense``).
"""

from __future__ import annotations

import torch
import torch.utils.flop_counter

from ...amp import amp_cast
from ...ops import kernels as _k
from .attention import _dense


def swiglu(x, y=None, name=None):
    """silu(x) * y in float32, cast to x's type; with y None, x's last dim
    splits in two halves (x, y), as the JAX op splits it."""
    x, y = amp_cast("swiglu", x, y)
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return _k.SwiGLU.apply(*_dense(x, y))


def fused_rope(x, cos, sin):
    """Rotate-half RoPE. x: [B, S, H, D]; cos/sin: [S, D], cast to x's
    type first. The tables get no gradient."""
    x, cos, sin = amp_cast("fused_rope", x, cos, sin)
    return _k.FusedRoPE.apply(*_dense(x, cos, sin))


def fused_rope_qk(q, k, cos, sin):
    """Rotate-half RoPE of q [B, S, Hq, D] and k [B, S, Hk, D] (Hk
    dividing Hq) by the same tables, in one kernel launch each way: the
    port's own, where the JAX model rotates q and k apart. cos/sin: [S, D]
    or the rows at each token's own position ([B, S, D], or [B, D] when
    S = 1; these take no gradient). Returns (q_rot, k_rot). Counted as
    the JAX model's two ``fused_rope`` ops (amp.debugging)."""
    q, cos, sin = amp_cast("fused_rope", q, cos, sin)
    k, cos, sin = amp_cast("fused_rope", k, cos, sin)
    return _k.FusedRoPEQK.apply(*_dense(q, k, cos, sin))



def _flce_logits(hid, weight, off, chunk, v, transpose_w):
    """float32 logits [T, chunk] of vocab columns [off, off + chunk), the
    columns past V at -inf (``_flce_fwd_impl``'s padded chunk)."""
    end = min(off + chunk, v)
    wc = (weight[off:end] if transpose_w else weight[:, off:end]).float()
    logits = hid @ (wc.t() if transpose_w else wc)
    if end - off < chunk:
        logits = torch.nn.functional.pad(logits, (0, chunk - (end - off)),
                                         value=float("-inf"))
    return logits, wc


def _flce_forward(hidden: torch.Tensor, weight: torch.Tensor,
                  labels: torch.Tensor, transpose_w: bool,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_fused_linear_ce`` of ``ops/impl/fused.py``: (the mean
    cross-entropy of hidden [T, H] @ weight [H, V] ([V, H] with
    transpose_w) against labels [T], in hidden's type; the float32 lse
    [T]), streaming the vocab in chunks through an online logsumexp so the
    [T, V] logits never exist. The chunk products are float32
    ``torch.matmul`` (the JAX package leaves them to XLA: no TPU
    kernel)."""
    t = hidden.shape[0]
    v = weight.shape[0] if transpose_w else weight.shape[1]
    n_chunks = -(-v // chunk)
    hid = hidden.float()
    lab = labels.long()
    valid = lab >= 0
    m = torch.full((t,), float("-inf"), device=hidden.device)
    s = torch.zeros(t, device=hidden.device)
    zl = torch.zeros(t, device=hidden.device)
    for ci in range(n_chunks):
        off = ci * chunk
        logits, _ = _flce_logits(hid, weight, off, chunk, v, transpose_w)
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=1)
        in_c = (lab >= off) & (lab < off + chunk)
        picked = logits.gather(
            1, (lab - off).clamp(0, chunk - 1)[:, None])[:, 0]
        zl = zl + torch.where(in_c, picked, torch.zeros_like(picked))
        m = m_new
    lse = m + torch.log(s)
    n_valid = valid.sum().clamp_min(1).float()
    loss = torch.where(valid, lse - zl, torch.zeros_like(lse)).sum() / \
        n_valid
    return loss.to(hidden.dtype), lse


# a torch.library op, so that a capture (compiler, jit.to_static) records
# the loss as one node with this backward instead of inlining the chunk
# loop (see ops.kernels._ops)
_flce_op = torch.library.custom_op(
    "ptt::fused_linear_cross_entropy", _flce_forward, mutates_args=(),
    device_types=("cpu", "cuda"))


@_flce_op.register_fake
def _(hidden, weight, labels, transpose_w, chunk):
    return (hidden.new_empty(()),
            hidden.new_empty((hidden.shape[0],), dtype=torch.float32))


def _flce_setup(ctx, inputs, output):
    hidden, weight, labels, transpose_w, chunk = inputs
    ctx.save_for_backward(hidden, weight, labels, output[1])
    ctx.mark_non_differentiable(output[1])
    ctx.transpose_w, ctx.chunk = transpose_w, chunk


def _flce_backward(ctx, g, _dlse):
    """Recompute each chunk's logits and fold (softmax - onehot) into the
    dhidden and dweight products."""
    hidden, weight, labels, lse = ctx.saved_tensors
    lab = labels.long()
    transpose_w, chunk = ctx.transpose_w, ctx.chunk
    v = weight.shape[0] if transpose_w else weight.shape[1]
    n_chunks = -(-v // chunk)
    hid = hidden.float()
    valid = lab >= 0
    n_valid = valid.sum().clamp_min(1).float()
    # d(mean over valid rows): ignored rows get no pull at all
    gt = (g.float() / n_valid) * valid.float()
    dhid = torch.zeros_like(hid)
    dw = torch.empty_like(weight)
    rows = torch.arange(hid.shape[0], device=hid.device)
    for ci in range(n_chunks):
        off = ci * chunk
        n = min(chunk, v - off)
        logits, wc = _flce_logits(hid, weight, off, chunk, v, transpose_w)
        d = torch.exp(logits[:, :n] - lse[:, None])
        in_c = valid & (lab >= off) & (lab < off + n)
        # softmax - onehot: -1 at the label's column of each row labelled
        # in this chunk (-0 elsewhere), in place and of no data-dependent
        # shape
        d.index_put_((rows, (lab - off).clamp(0, n - 1)), -in_c.float(),
                     accumulate=True)
        d = d * gt[:, None]
        if transpose_w:
            dw[off:off + n] = (d.t() @ hid).to(weight.dtype)
            dhid = dhid + d @ wc
        else:
            dw[:, off:off + n] = (hid.t() @ d).to(weight.dtype)
            dhid = dhid + d @ wc.t()
    return dhid.to(hidden.dtype), dw, None, None, None


_flce_op.register_autograd(_flce_backward, setup_context=_flce_setup)


def _flce_flops(hidden_shape, weight_shape, *args, out_shape=None, **kw):
    """The forward's chunk products, 2 T h V, for FlopCounterMode (the
    modes do not see inside an op)."""
    return 2 * hidden_shape[0] * hidden_shape[1] * (
        weight_shape[0] * weight_shape[1] // hidden_shape[1])


torch.utils.flop_counter.register_flop_formula(
    torch.ops.ptt.fused_linear_cross_entropy)(
    _flce_flops)


def fused_linear_cross_entropy(hidden, weight, labels,
                               transpose_weight=False, chunk_size=4096):
    """Mean softmax cross-entropy of ``hidden @ weight`` against int labels
    without materializing the [T, V] logits. hidden [..., H] is flattened
    to [T, H] and labels to [T]; weight [H, V] ([V, H] with
    transpose_weight, the tied-embedding layout). Labels below 0 add 0 and
    the mean is over the others; the loss has hidden's type. The chunk is
    min(chunk_size, V rounded up to 128), as in the JAX op."""
    hidden, weight = amp_cast("fused_linear_cross_entropy", hidden, weight)
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = labels.reshape(-1)
    v = weight.shape[0] if transpose_weight else weight.shape[-1]
    chunk = min(int(chunk_size), max(128, -(-int(v) // 128) * 128))
    return _flce_op(h2, weight, l2, bool(transpose_weight), chunk)[0]
