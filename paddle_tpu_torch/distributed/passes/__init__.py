"""``paddle.distributed.passes`` in the port, the counterpart of
``paddle_tpu/distributed/passes/__init__.py`` (ref:
python/paddle/distributed/passes/*).

In the reference these are program-rewrite passes over the static IR. In
the port each capability lives elsewhere, named in ``PASS_EQUIVALENTS``;
graph rewrites are the graph compiler's (``compiler``), whose registry
and PassManager are re-exported here, so distributed passes and graph
passes share one registration and ordering mechanism.

``new_pass(name)``: a name that resolves to a registered GRAPH pass (the
compiler registry, plus ``GRAPH_PASS_ALIASES``) returns an applicator
whose ``apply_graph(gm)`` rewrites a captured fx GraphModule through that
pass (then DCE); every other name keeps the documented no-op and
warning.
"""

from __future__ import annotations

import warnings

# one registration/ordering mechanism for graph + distributed passes
from ...compiler import (  # noqa: F401
    Pass, FunctionPass, PassContext, PassManager, PASS_REGISTRY,
    register_graph_pass, default_pipeline, default_pass_manager,
)

__all__ = ["new_pass", "GRAPH_PASS_ALIASES", "PASS_EQUIVALENTS", "Pass",
           "FunctionPass", "PassContext", "PassManager", "PASS_REGISTRY",
           "register_graph_pass", "default_pipeline",
           "default_pass_manager"]

# reference pass names that the compiler registry provides
GRAPH_PASS_ALIASES = {
    "fused_attention": "pattern_fusion",
    "fused_feedforward": "pattern_fusion",
    "build_cinn_pass": "pattern_fusion",
    "fuse_elewise_add_act": "pattern_fusion",
    "recompute_tagging": "remat_tag",
}

# pass name -> the mechanism that provides the capability in the port
PASS_EQUIVALENTS = {
    "auto_parallel_amp": "paddle_tpu_torch.amp.auto_cast / amp.decorate",
    "auto_parallel_fp16": "paddle_tpu_torch.amp.decorate(level='O2')",
    "auto_parallel_bf16":
        "paddle_tpu_torch.amp.auto_cast(dtype='bfloat16')",
    "auto_parallel_recompute":
        "fleet.utils.recompute / models.apply_llama_remat "
        "(torch.utils.checkpoint), or compile_train_step("
        "remat_policy='fused')",
    "auto_parallel_sharding":
        "dist.shard_optimizer(opt, dist.ShardingStage1/2/3)",
    "auto_parallel_gradient_merge_pass":
        "fleet PipelineParallel's micro-batches (accumulate_steps)",
    "auto_parallel_grad_clip": "optimizer grad_clip=",
    "auto_parallel_master_grad_pass":
        "optimizer multi_precision=True master weights",
    "auto_parallel_pipeline": "fleet PipelineLayer + PipelineParallel",
    "fuse_all_reduce":
        "the mesh engine's one all-reduce per row product",
    "allreduce_matmul_grad_overlapping":
        "DataParallel's bucketed all-reduces during the backward",
    "fuse_optimizer": "compile_train_step (the optimizer's update)",
    "fused_attention":
        "paddle_tpu_torch.compiler pattern_fusion (jit fuse=True / "
        "PADDLE_TPU_FUSION=1): a graph rewrite onto the flash kernel",
    "fused_feedforward":
        "paddle_tpu_torch.compiler pattern_fusion (swiglu/rms rewrites)",
    "pipeline_scheduler_FThenB":
        "meta_parallel.pipeline_schedules.f_then_b",
    "pipeline_scheduler_1F1B":
        "meta_parallel.pipeline_schedules.one_f_one_b (PipelineParallel)",
    "pipeline_scheduler_VPP":
        "meta_parallel.pipeline_schedules.interleaved_1f1b "
        "(PipelineParallelWithInterleave)",
    "pipeline_scheduler_ZBH1":
        "CompiledPipeline.compile_train_step(schedule='ZBH1') (the B / W "
        "split of zero_bubble)",
}


class _Pass:
    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs or {}

    def apply(self, main_programs=None, startup_programs=None, context=None):
        """There is no program IR to rewrite: applying one is a NO-OP and
        warns, pointing at the mechanism that provides the capability
        (never silently 'succeeds')."""
        eq = PASS_EQUIVALENTS.get(self.name)
        hint = f" Use {eq} instead." if eq else ""
        warnings.warn(
            f"distributed pass '{self.name}' is a no-op in the port "
            f"(there is no program IR to rewrite).{hint}",
            UserWarning, stacklevel=2)
        return None


class _GraphPass(_Pass):
    """A reference pass name that the graph compiler provides:
    ``apply_graph`` rewrites a captured GraphModule through the registered
    compiler pass; the program-based ``apply`` still warns, pointing at
    the jit-level switch."""

    def __init__(self, name, attrs, graph_pass_name):
        super().__init__(name, attrs)
        self.graph_pass_name = graph_pass_name

    def apply_graph(self, gm, program="program", ctx=None):
        pm = PassManager([self.graph_pass_name, "dce"])
        return pm.run(gm, program=program, ctx=ctx)

    def apply(self, main_programs=None, startup_programs=None, context=None):
        warnings.warn(
            f"pass '{self.name}' is provided by the graph compiler "
            f"(paddle_tpu_torch.compiler pass '{self.graph_pass_name}'): "
            "enable it with jit.to_static(build_strategy=BuildStrategy("
            "fuse=True)) / compile_train_step(fuse=True) / "
            "PADDLE_TPU_FUSION=1, or rewrite a captured graph with "
            ".apply_graph(gm).", UserWarning, stacklevel=2)
        return None


def new_pass(name, pass_attrs=None):
    graph_name = GRAPH_PASS_ALIASES.get(name, name)
    if graph_name in PASS_REGISTRY:
        return _GraphPass(name, pass_attrs, graph_name)
    return _Pass(name, pass_attrs)
