"""Quantization for the port's serving path: int8 KV pages
(``page_quant``), the counterpart of ``paddle_tpu.quantization``."""

from . import page_quant

__all__ = ["page_quant"]
