"""The op surface's bodies, one module per JAX module of
``paddle_tpu/ops/impl/``; each op is registered in ``ops.registry``."""
