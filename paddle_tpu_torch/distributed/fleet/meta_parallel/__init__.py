"""``fleet.meta_parallel``: ``TensorParallel``, the wrapper
``fleet.distributed_model`` puts around a model whose layers are the mpu
layers (their forward already runs rank by rank; the wrapper keeps the
model's surface, as in the JAX package). The pipeline and segment
wrappers belong to a later slice (ROADMAP §A.13) and raise."""

from __future__ import annotations

from torch import nn

_LATER = ("belongs to a later slice of paddle_tpu_torch (ROADMAP §A.13: "
          "meta_parallel pipeline and segment parallelism)")


class TensorParallel(nn.Module):
    """``fleet/meta_parallel/tensor_parallel.py``: the model as it is
    (the mp group's inputs are one process's tensors already)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._layers.load_state_dict(*args, **kwargs)


def _later_class(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} {_LATER}")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"{name}: raises ({_LATER})."})


PipelineLayer = _later_class("PipelineLayer")
LayerDesc = _later_class("LayerDesc")
PipelineParallel = _later_class("PipelineParallel")
PipelineParallelWithInterleave = _later_class(
    "PipelineParallelWithInterleave")
SegmentParallel = _later_class("SegmentParallel")
