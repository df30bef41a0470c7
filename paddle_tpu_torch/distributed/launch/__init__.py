"""The launch CLI: ``python -m paddle_tpu_torch.distributed.launch``."""

from .main import build_parser, launch  # noqa: F401
