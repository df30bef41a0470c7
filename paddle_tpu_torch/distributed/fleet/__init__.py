"""``fleet``: the hybrid topology and its tensor-parallel part (``init``,
``get_hybrid_communicate_group``, ``distributed_model``, the mpu layers),
``utils.recompute`` and the ``elastic`` manager: the counterparts of
``paddle_tpu/distributed/fleet``'s (``fleet/__init__.py``,
``base/topology.py``, ``layers/mpu``).

Data, pipeline, segment and sharding parallelism (``DataParallel``,
``meta_parallel``'s pipelines, ``meta_optimizers``,
``distributed_optimizer``) belong to a later slice (ROADMAP §A.13) and
raise.
"""

from __future__ import annotations

from . import elastic, layers, meta_parallel, utils
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            get_hcg)
from .utils import recompute

_LATER = "belongs to a later slice of paddle_tpu_torch (ROADMAP §A.13: {})"


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
    """``fleet.py`` distributed_model: the wrapper for the topology.
    mp > 1 gives ``TensorParallel``; segment and data parallelism raise (a
    later slice, as ``PipelineLayer``, the only model the pipeline
    wrapper takes, does)."""
    hcg = get_hcg()
    if hcg is None:
        return model
    if hcg.get_model_parallel_world_size() > 1:
        return meta_parallel.TensorParallel(model, hcg, _FLEET["strategy"])
    if hcg.get_sep_parallel_world_size() > 1:
        raise NotImplementedError(_LATER.format("segment parallelism"))
    if hcg.get_data_parallel_world_size() > 1:
        raise NotImplementedError(_LATER.format("DataParallel"))
    return model


def distributed_optimizer(optimizer, strategy=None):
    raise NotImplementedError(_LATER.format(
        "meta_optimizers: HybridParallelOptimizer, sharding"))


__all__ = ["CommunicateTopology", "DistributedStrategy",
           "HybridCommunicateGroup", "barrier_worker", "distributed_model",
           "distributed_optimizer", "elastic", "get_hybrid_communicate_group",
           "init", "is_first_worker", "layers", "meta_parallel",
           "recompute", "utils", "worker_index", "worker_num"]
