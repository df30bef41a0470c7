"""Each kernel wrapper's cost for the program counter of
``observability.xla_introspect``.

The kernels are ``ctypes`` launches, so a ``TorchDispatchMode``
(``FlopCounterMode`` among them) never sees their work: on the card it sees only the output's allocation, on the CPU
it sees the plain version, whose products are not the kernel's (a causal
plain attention multiplies every pair, the kernel only the visible ones).
A kernel reached through its op (``_ops``) is charged by the counter's
dispatch mode, which sees the op as one call (``_ops.COSTS``); inside the
op the modes are popped, so the wrapper charges nothing there.
``costed(name, cost)`` wraps a wrapper so that, while a counter is active
in the calling thread, the call adds ``cost(*args, **kwargs) -> (flops,
bytes)`` under `name` and the counter forgets what the dispatch mode saw
inside the call. The counts are those ``chip_smoke.py`` takes for each
kernel's bound: the products over the visible pairs for attention, a few
operations an element for the elementwise kernels, each input read once
and each output written once. Where the work depends on the data (the
paged kernels' context lengths, a flashmask's bounds) the cost reads it
from the card, which is a sync: it runs only under a counter.

Outside a counter a wrapped call costs one list check.
"""

from __future__ import annotations

import functools

# the counters (xla_introspect.Counter) entered and not yet left, in any
# thread; a call charges the ones whose dispatch mode is on its own
# thread's mode stack (which the autograd engine carries into its threads)
ACTIVE = []


def _counters_here():
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    stack = _get_current_dispatch_mode_stack()
    return [c for c in list(ACTIVE) if c.mode in stack]


def costed(name, cost):
    """Decorator: under an active counter, `fn`'s call is charged
    ``cost(*args, **kwargs) -> (flops, bytes)`` as kernel `name`, in place
    of the torch ops it runs."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            here = _counters_here()
            if not here:
                return fn(*args, **kwargs)
            marks = [c.mark() for c in here]
            out = fn(*args, **kwargs)
            try:
                flops, nbytes = cost(*args, **kwargs)
            except Exception:  # noqa: BLE001 — telemetry never breaks a call
                flops = nbytes = None
            for c, m in zip(here, marks):
                c.kernel(name, flops, nbytes, since=m)
            return out
        return wrapper
    return deco


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def causal_pairs(s_q, s_k):
    """Visible (query, key) pairs of one head under the bottom-right
    causal mask."""
    off = s_k - s_q
    return sum(max(0, min(i + off + 1, s_k)) for i in range(s_q))


def _flash_pairs(q, k, causal, bounds=None):
    b, s_q, h, _ = q.shape
    s_k = k.shape[1]
    if bounds is None:
        return b * h * (causal_pairs(s_q, s_k) if causal else s_q * s_k)
    from .flash_attention import _visible
    h_kv = k.shape[2]
    vis = _visible(b, s_q, s_k, h_kv, h // h_kv, causal, bounds, q.device)
    if vis is None:
        return b * h * s_q * s_k
    return int(vis.expand(b, h_kv, h // h_kv, s_q, s_k).sum())


def flash_fwd(q, k, v, causal=False, scale=None, bounds=None):
    """Two products over the visible pairs; q, k, v read, out and the
    float32 lse written."""
    d = q.shape[3]
    lse = q.shape[0] * q.shape[1] * q.shape[2] * 4
    return (4 * d * _flash_pairs(q, k, causal, bounds),
            nbytes(q, k, v, q) + lse + nbytes(*(bounds or ())))


def flash_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
              bounds=None):
    """S, dP, dV, dQ and dK over the visible pairs; q, k, v, out, dout and
    lse read, dq, dk, dv written."""
    d = q.shape[3]
    return (10 * d * _flash_pairs(q, k, causal, bounds),
            nbytes(q, k, v, out, dout, lse, q, k, v)
            + nbytes(*(bounds or ())))


def flashmask_fwd(q, k, v, start, end, start2=None, end2=None, causal=True,
                  scale=None):
    return flash_fwd(q, k, v, causal, scale, (start, end, start2, end2))


def flashmask_bwd(q, k, v, out, lse, dout, start, end, start2=None,
                  end2=None, causal=True, scale=None):
    return flash_bwd(q, k, v, out, lse, dout, causal, scale,
                     (start, end, start2, end2))


def rms_norm(x, w, eps=1e-6):
    return 4 * x.numel(), 2 * nbytes(x) + nbytes(w)


def swiglu(gate, up):
    return 5 * gate.numel(), 3 * nbytes(gate)


def rope(x, cos, sin, k=None):
    n = x.numel() + (k.numel() if k is not None else 0)
    return 3 * n, 2 * n * x.element_size() + nbytes(cos, sin)


def rope_qk(q, k, cos, sin):
    return rope(q, cos, sin, k)


def rope_bwd(g, cos, sin, g_k=None):
    return rope(g, cos, sin, g_k)


def bdrln(x, residual, ln_w, ln_b, bias=None, eps=1e-5, p=0.0, seed=0,
          *args, **kwargs):
    n = x.numel()
    return 10 * n, 4 * nbytes(x) + (n if p > 0.0 else 0) + \
        nbytes(ln_w, ln_b, bias)


def _page_reads(k_pages, lens):
    """Bytes of K and V read up to each context ([N, page, H_kv, D]
    pools)."""
    _, _, h_kv, d = k_pages.shape
    return 2 * sum(lens) * h_kv * d * k_pages.element_size()


def decode(q, k_pages, v_pages, block_tables, context_lens, *args,
           **kwargs):
    """One query a row against its context: two products per visible
    key; q read and out written, K and V read up to the context."""
    lens = [int(n) for n in context_lens.tolist()]
    h, d = q.shape[-2], q.shape[-1]
    return 4 * sum(lens) * h * d, 2 * nbytes(q) + _page_reads(k_pages, lens)


def decode_int8(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                context_lens, *args, **kwargs):
    flops, nb = decode(q, k_pages, v_pages, block_tables, context_lens)
    page = k_pages.shape[1]
    return flops, nb + 2 * 4 * sum(-(-int(n) // page)
                                   for n in context_lens.tolist())


def ragged(q, k_pages, v_pages, block_tables, context_lens, q_lens, *args,
           **kwargs):
    """Each row's real queries against its context under the causal
    mask; q read for the real queries, out written whole, K and V read up
    to each context."""
    ctx = [int(n) for n in context_lens.tolist()]
    ql = [int(n) for n in q_lens.tolist()]
    h, d = q.shape[-2], q.shape[-1]
    pairs = sum(causal_pairs(n, c) for c, n in zip(ctx, ql))
    elt = q.element_size()
    return (4 * pairs * h * d,
            sum(ql) * h * d * elt + nbytes(q) + _page_reads(k_pages, ctx))


def ragged_int8(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                context_lens, q_lens, *args, **kwargs):
    flops, nb = ragged(q, k_pages, v_pages, block_tables, context_lens,
                       q_lens)
    page = k_pages.shape[1]
    return flops, nb + 2 * 4 * sum(-(-int(n) // page)
                                   for n in context_lens.tolist())
