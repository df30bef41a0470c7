"""``paddle.distributed.communication``: the eager collectives, with the
``stream.*`` variants (the counterpart of
``paddle_tpu/distributed/communication``)."""

from ..parallel_base import (  # noqa: F401
    all_reduce, all_gather, broadcast, reduce, scatter, reduce_scatter,
    alltoall, barrier, ReduceOp, send, recv, isend, irecv,
)
from . import stream  # noqa: F401
