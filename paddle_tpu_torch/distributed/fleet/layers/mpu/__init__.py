from .mp_layers import (  # noqa: F401
    VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear,
    ParallelCrossEntropy,
)
from . import mp_ops  # noqa: F401
from .random import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
