"""``fleet.meta_parallel``: the pipeline (``PipelineLayer``,
``LayerDesc``, ``SharedLayerDesc``, ``PipelineParallel``,
``PipelineParallelWithInterleave``), ``TensorParallel``,
``SegmentParallel`` and the compiled pipeline (``CompiledPipeline``,
``pipeline_spmd``, ``stack_layer_params``): the counterparts of
``paddle_tpu/distributed/fleet/meta_parallel``'s."""

from .pp_layers import PipelineLayer, LayerDesc, SharedLayerDesc  # noqa: F401
from .pipeline_parallel import (  # noqa: F401
    PipelineParallel, PipelineParallelWithInterleave, TensorParallel,
    SegmentParallel,
)
from .compiled_pipeline import (  # noqa: F401
    CompiledPipeline, pipeline_spmd, stack_layer_params,
)
