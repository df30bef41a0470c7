"""``fleet``: the hybrid topology (``init``,
``get_hybrid_communicate_group``), the wrappers ``distributed_model``
picks (``PipelineParallel`` or its interleaved form, ``TensorParallel``,
``SegmentParallel``, ``DataParallel``), ``distributed_optimizer`` (ZeRO
through ``DygraphShardingOptimizer`` when the sharding axis has more than
one rank) and ``distributed_scaler``, the mpu layers, ``meta_parallel``,
``meta_optimizers``, ``utils`` (``recompute``, ``sequence_parallel_utils``)
and the ``elastic`` manager: the counterparts of
``paddle_tpu/distributed/fleet``'s (``fleet/__init__.py``,
``base/topology.py``, ``layers/mpu``, ``meta_parallel``,
``meta_optimizers``).
"""

from __future__ import annotations

from . import elastic, layers, meta_optimizers, meta_parallel, utils
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            get_hcg)
from .meta_optimizers import (  # noqa: F401
    DygraphShardingOptimizer, HybridParallelGradScaler,
    HybridParallelOptimizer,
)
from .utils import recompute


class DistributedStrategy:
    """Config bag (``base/distributed_strategy.py:284``)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.tensor_parallel_configs = {}
        self.sharding_configs = {}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


_FLEET = {"initialized": False, "strategy": None}


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", *, devices=None):
    """``fleet/fleet.py:218``: build the hybrid topology and its mesh.
    `devices` (a device or a list, repeats allowed; default the card)
    places the ranks; ``devices="cpu"`` runs every rank on the CPU."""
    strategy = strategy or DistributedStrategy()
    h = strategy.hybrid_configs
    topo = CommunicateTopology(
        ("data", "pipe", "sharding", "model", "sep"),
        (h.get("dp_degree", 1), h.get("pp_degree", 1),
         h.get("sharding_degree", 1), h.get("mp_degree", 1),
         h.get("sep_degree", 1)))
    HybridCommunicateGroup(topo, devices=devices)
    _FLEET["initialized"] = True
    _FLEET["strategy"] = strategy


def get_hybrid_communicate_group():
    return get_hcg()


def is_first_worker():
    return True


def worker_index():
    return 0


def worker_num():
    return 1


def barrier_worker():
    from ..parallel_base import barrier
    barrier()


def distributed_model(model):
    """``fleet.py`` distributed_model: the wrapper for the topology, in
    the JAX package's order (``fleet/__init__.py:93-121``): a
    ``PipelineLayer`` with pp > 1 gets ``PipelineParallel`` (the
    interleaved form when it has virtual stages); else mp > 1 gives
    ``TensorParallel``, sep > 1 ``SegmentParallel`` and dp > 1
    ``DataParallel`` over the dp ranks."""
    hcg = get_hcg()
    if hcg is None:
        return model
    strategy = _FLEET["strategy"]
    if hcg.get_pipe_parallel_world_size() > 1 and \
            isinstance(model, meta_parallel.PipelineLayer):
        if getattr(model, "_num_virtual", 1) > 1:
            return meta_parallel.PipelineParallelWithInterleave(
                model, hcg, strategy)
        return meta_parallel.PipelineParallel(model, hcg, strategy)
    if hcg.get_model_parallel_world_size() > 1:
        return meta_parallel.TensorParallel(model, hcg, strategy)
    if hcg.get_sep_parallel_world_size() > 1:
        return meta_parallel.SegmentParallel(model, hcg, strategy)
    if hcg.get_data_parallel_world_size() > 1:
        from ..parallel import DataParallel
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """``fleet.py:1427``: ZeRO stage 1 (``DygraphShardingOptimizer``) when
    the sharding axis has more than one rank, inside a
    ``HybridParallelOptimizer``."""
    hcg = get_hcg()
    strategy = strategy or _FLEET["strategy"]
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1 and \
            not isinstance(optimizer, DygraphShardingOptimizer):
        optimizer = DygraphShardingOptimizer(optimizer, hcg)
    return HybridParallelOptimizer(optimizer, hcg, strategy)


def distributed_scaler(scaler):
    return HybridParallelGradScaler(scaler, get_hcg())


__all__ = ["CommunicateTopology", "DistributedStrategy",
           "DygraphShardingOptimizer", "HybridCommunicateGroup",
           "HybridParallelGradScaler", "HybridParallelOptimizer",
           "barrier_worker", "distributed_model", "distributed_optimizer",
           "distributed_scaler", "elastic", "get_hybrid_communicate_group",
           "init", "is_first_worker", "layers", "meta_optimizers",
           "meta_parallel", "recompute", "utils", "worker_index",
           "worker_num"]
