"""The layers of ``nn``, one module per JAX module of
``paddle_tpu/nn/layer/`` (``activation``, ``common``, ``conv``, ``norm``,
``pooling``, ``loss``); the base ``Layer`` and the basic layers live in
``nn.layers``."""
