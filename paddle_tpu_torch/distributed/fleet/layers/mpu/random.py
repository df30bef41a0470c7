"""Tensor-parallel random states (``fleet/layers/mpu/random.py``): the
tracker of ``framework.random`` and ``model_parallel_random_seed``."""

from .....framework.random import (RNGStatesTracker,  # noqa: F401
                                   get_rng_state_tracker)


def model_parallel_random_seed(seed=None):
    """Reset the tracker and seed everything from `seed` (default 2718):
    the default generators, "global_seed" and "local_seed" (seed + 1024),
    as the JAX package does."""
    from .....framework.random import seed as _seed
    tracker = get_rng_state_tracker()
    tracker.reset()
    base = seed if seed is not None else 2718
    _seed(base)
    tracker.add("global_seed", base)
    tracker.add("local_seed", base + 1024)
