"""Device resolution for every entry point of the port.

The port runs on the CUDA card unless the caller asks for the CPU by
passing ``device="cpu"`` (the tests do). With no CUDA device and no
explicit CPU request, entry points raise: a serving run never drops to the
CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Returns a ``torch.device``; raises
    RuntimeError when CUDA is asked for (explicitly or by default) and no
    CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
