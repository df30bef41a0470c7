"""Gradient clipping: the counterparts of ``paddle_tpu/optimizer/clip.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``). Each
maps a list of (param, grad) pairs to a new list; a parameter whose
``need_clip`` attribute is False keeps its gradient. The norms stay on
the device: nothing waits for the host."""

from __future__ import annotations

import torch


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to a norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            norm = torch.linalg.vector_norm(g.reshape(-1))
            scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All clipped gradients scaled by clip_norm / max(global norm,
    clip_norm), the global norm taken over them in float32.
    auto_skip_clip is taken and changes nothing, as in the JAX package:
    the gradients are clipped by the global norm either way."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def __call__(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads
              if _clipped(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / global_norm.clamp_min(self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]
