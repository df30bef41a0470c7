"""Per-page int8 KV quantization: the port's copy of
``paddle_tpu/quantization/page_quant.py`` on torch tensors.

Symmetric absmax codes ``q = clip(round(x / max(s, EPS) * 127), -127,
127)`` with one float32 scale per (layer, page), dequantized as
``q * max(s, EPS) / 127``. The expressions run in the JAX module's order
(divide, then multiply by QMAX; ``torch.round`` rounds half to even as
``jnp.round`` does), so equal float32 inputs give bit-equal codes and
scales.

The offset-0 freeze rule (``write_rows``): a page's scale is set only by
a dispatch that writes offset 0 of that page, as the absmax over every
row of the dispatch that lands in it; rows written into a page that this
dispatch did not open clip against the page's frozen scale. Already
written rows are never requantized, so shared, forked and copied pages
keep their codes and scales bit for bit. The trash page 0 is opened by
every dispatch's padding rows; its content is never read as context.

Unlike the JAX module, which returns new arrays, ``write_rows`` updates
the pool and the scale row IN PLACE (the engine owns them) and returns
the same tensors. It is plain PyTorch on the card too: the JAX package
computes it in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

__all__ = ["QMAX", "EPS", "INV_QMAX", "quant_codes", "dequant_codes",
           "quantize_pages", "dequantize_pages", "write_rows"]

# symmetric int8: codes in [-127, 127]
QMAX = 127.0
# the zero-scale guard
EPS = 1e-9
# the dequant multiplier of the attention reads: codes * (scale * INV_QMAX)
# (float32(1/127), the JAX kernels' _INV_QMAX)
INV_QMAX = 1.0 / 127.0


def quant_codes(x, scale, qmax=QMAX):
    """x -> float codes in [-qmax, qmax]; ``scale`` broadcasts against x."""
    s = torch.clamp_min(scale, EPS)
    return torch.clamp(torch.round(x / s * qmax), -qmax, qmax)


def dequant_codes(q, scale, qmax=QMAX):
    """Inverse map: codes * scale / qmax (float)."""
    s = torch.clamp_min(scale, EPS)
    return q * s / qmax


def quantize_pages(page_rows):
    """Quantize whole pages (the dense prefill holds every row of a page,
    so the scale is the page's exact absmax). page_rows: [..., page, H, D]
    float -> (int8 codes of the same shape, float32 scales [...])."""
    x = page_rows.float()
    scales = torch.clamp_min(x.abs().amax(dim=(-3, -2, -1)), EPS)
    q = quant_codes(x, scales[..., None, None, None]).to(torch.int8)
    return q, scales


def dequantize_pages(pages, scales):
    """int8 pages [..., page, H, D] + scales [...] -> float32 pages."""
    return pages.float() * (torch.clamp_min(scales, EPS)[..., None, None, None]
                            / QMAX)


def write_rows(pages, scales, pids, offs, rows):
    """Quantizing scatter of KV rows into a page pool under the offset-0
    freeze rule, in place.

    pages: [N, page, H, D]; scales: [N] float32, or None for a float pool
    (then the rows are cast to the pool's dtype and written); pids/offs:
    integer tensors of any one shape [..]; rows: float [.., H, D].
    Returns (pages, scales), the tensors given. Duplicate (pid, offset)
    targets are only ever the trash page 0's."""
    pids = pids.reshape(-1).long()
    offs = offs.reshape(-1).long()
    rows = rows.reshape((-1,) + tuple(rows.shape[-2:]))
    if scales is None:
        pages.index_put_((pids, offs), rows.to(pages.dtype))
        return pages, None
    n = pages.shape[0]
    rows = rows.float()
    row_max = rows.abs().amax(dim=(1, 2))                        # [M]
    # pages opened by this dispatch (a row lands at offset 0) take the
    # dispatch absmax over every row landing in them; the scatter-max
    # combines duplicate pids deterministically
    opened = torch.zeros(n, dtype=torch.int32, device=pages.device) \
        .scatter_reduce_(0, pids, (offs == 0).to(torch.int32), "amax")
    disp_max = torch.zeros(n, dtype=torch.float32, device=pages.device) \
        .scatter_reduce_(0, pids, row_max, "amax")
    scales.copy_(torch.where(opened > 0, torch.clamp_min(disp_max, EPS),
                             scales))
    q = quant_codes(rows, scales[pids][:, None, None]).to(torch.int8)
    pages.index_put_((pids, offs), q)
    return pages, scales
