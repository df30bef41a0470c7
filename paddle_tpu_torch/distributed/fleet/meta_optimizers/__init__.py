from .dygraph_optimizer import (  # noqa: F401
    HybridParallelOptimizer, DygraphShardingOptimizer,
    HybridParallelGradScaler,
)
