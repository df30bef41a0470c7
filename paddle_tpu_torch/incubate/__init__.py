"""The port's ``incubate`` surface, the counterpart of
``paddle_tpu/incubate/__init__.py``: the fused functionals and layers
(``nn``), mixture of experts with expert parallelism (``distributed``),
n:m sparsity (``asp``), ``LookAhead``, ``ModelAverage`` and
``DistributedFusedLamb`` (``optimizer``), ``autograd``, the legacy graph
aliases of ``geometric``, ``softmax_mask_fuse_upper_triangle``,
``identity_loss`` and ``graph_khop_sampler``."""

import torch as _torch

from . import nn  # noqa: F401
from . import distributed  # noqa: F401
from . import autograd  # noqa: F401
from . import asp  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import (DistributedFusedLamb, LookAhead,  # noqa: F401
                        ModelAverage)
from ..geometric import (  # noqa: F401,E402
    segment_max, segment_mean, segment_min, segment_sum,
    reindex_graph as graph_reindex,
    sample_neighbors as graph_sample_neighbors,
    send_u_recv as graph_send_recv,
)
from ..nn.functional import softmax_mask_fuse  # noqa: F401,E402
from .. import inference  # noqa: F401,E402


def softmax_mask_fuse_upper_triangle(x):
    """softmax over the last axis of x with the entries above the
    diagonal of its last two dims replaced by -1e30."""
    from ..ops.registry import OP_TABLE
    keep = _torch.tril(_torch.ones(x.shape[-2:], dtype=_torch.bool,
                                   device=x.device))
    return OP_TABLE["softmax"]["api"](
        _torch.where(keep, x, _torch.tensor(-1e30, dtype=x.dtype,
                                            device=x.device)), axis=-1)


def identity_loss(x, reduction="none"):
    """The loss as it is ("none"), its sum or its mean."""
    if reduction in ("none", 0):
        return x
    if reduction in ("sum", 1):
        return x.sum()
    return x.mean()


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbor sampling: a round of ``sample_neighbors`` and
    ``reindex_graph`` per sample size -> (nodes, src, dst, the last
    round's counts)."""
    from ..geometric import reindex_graph, sample_neighbors
    cur = input_nodes
    layers = []
    for size in sample_sizes:
        nb, cnt = sample_neighbors(row, colptr, cur, sample_size=size)
        src, dst, nodes = reindex_graph(cur, nb, cnt)
        layers.append((src, dst, nodes))
        cur = nodes
    src, dst, nodes = layers[-1]
    return nodes, src, dst, cnt


__all__ = ["nn", "distributed", "autograd", "asp", "optimizer",
           "LookAhead", "ModelAverage", "DistributedFusedLamb",
           "segment_sum", "segment_mean", "segment_max", "segment_min",
           "graph_reindex", "graph_sample_neighbors", "graph_send_recv",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
           "inference", "identity_loss", "graph_khop_sampler"]
