"""``paddle.signal``: the counterpart of ``paddle_tpu/signal.py``
(``frame``, ``overlap_add``, ``stft``), with the JAX package's layouts:
``frame`` gives [..., frame_length, num_frames] (the framed axis moved
last first), ``stft`` [..., freq, frames]."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops.registry import register_op


@register_op("frame")
def frame(x, frame_length, hop_length, axis=-1, name=None):
    moved = torch.movedim(x, axis, -1)
    return moved.unfold(-1, frame_length, hop_length).transpose(-1, -2)


@register_op("overlap_add")
def overlap_add(x, hop_length, axis=-1, name=None):
    """Frames [..., frame_length, num_frames] summed back into a signal
    of frame_length + hop_length * (num_frames - 1) samples."""
    fl, num = x.shape[-2], x.shape[-1]
    n = fl + hop_length * (num - 1)
    idx = (torch.arange(fl, device=x.device)[:, None]
           + hop_length * torch.arange(num, device=x.device)[None, :])
    out = torch.zeros(x.shape[:-2] + (n,), dtype=x.dtype, device=x.device)
    return out.index_add(-1, idx.reshape(-1),
                         x.reshape(x.shape[:-2] + (fl * num,)))


@register_op("stft")
def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    hop_length = hop_length or n_fft // 4
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        y = x.reshape((1, -1, x.shape[-1]))
        y = F.pad(y, (pad, pad),
                  mode="reflect" if pad_mode == "reflect" else "constant")
        x = y.reshape(lead + (y.shape[-1],))
    frames = x.unfold(-1, n_fft, hop_length)          # [..., num, n_fft]
    if window is not None:
        w = window
        if w.shape[-1] < n_fft:          # centre the window in n_fft
            pad_l = (n_fft - w.shape[-1]) // 2
            w = F.pad(w, (pad_l, n_fft - w.shape[-1] - pad_l))
        frames = frames * w
    spec = torch.fft.rfft(frames, dim=-1) if onesided else \
        torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / math.sqrt(n_fft)
    return torch.movedim(spec, -1, -2)


__all__ = ["frame", "overlap_add", "stft"]
