"""Random state of the port: the counterpart of
``paddle_tpu/framework/random.py`` (``seed`` :75, ``next_key`` :104).

JAX threads keys; the port keeps one default ``torch.Generator`` per
device, all seeded by ``seed(n)`` (a generator made later starts from the
last seed). Every functional that draws takes ``generator=`` and falls
back to the default generator of its tensors' device. ``next_seed`` draws
one int in [0, 2^31 - 1), as ``ops/impl/fused.py:135`` draws the seed of
the dropout kernel. ``get_rng_state`` / ``set_rng_state`` save and
restore them all (``recompute`` replays a forward's draws with them). The
numbers differ from JAX's for the same seed.

``RNGStatesTracker`` (``:114``) keeps named states for model-parallel
regions, each a seed with its own generator per device:
``tracker.rng_state(name)`` makes them the default generators inside the
``with`` block (``get_rng_state_tracker``, ``:159``, is the process's
tracker that ``model_parallel_random_seed`` fills).
"""

from __future__ import annotations

import torch

_SEED = [0]
_GENERATORS = {}


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(n):
    """Seed every default generator (``paddle.seed``)."""
    _SEED[0] = int(n)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED[0])


def initial_seed():
    """The last seed given to ``seed`` (0 before any)."""
    return _SEED[0]


def default_generator(device="cpu"):
    """The default generator of `device`, made on first use from the last
    seed (inside a tracker's ``rng_state`` block: that state's)."""
    dev = _key(device)
    if _ACTIVE:
        return _ACTIVE[-1].generator(dev)
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_SEED[0])
        _GENERATORS[dev] = gen
    return gen


def next_seed(generator=None):
    """One int in [0, 2^31 - 1) from `generator` (default: the CPU
    generator, so drawing it needs no device sync)."""
    gen = generator if generator is not None else default_generator("cpu")
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             device=gen.device).item())


def get_rng_state():
    """{device: state} of every default generator made so far
    (``paddle.get_rng_state``)."""
    return {dev: gen.get_state() for dev, gen in _GENERATORS.items()}


def set_rng_state(states):
    """Restore the default generators saved by ``get_rng_state``; one made
    since then starts again from the last seed, as it did when it was
    made."""
    for dev, gen in _GENERATORS.items():
        if dev in states:
            gen.set_state(states[dev])
        else:
            gen.manual_seed(_SEED[0])


class _NamedState:
    """A seed and its generator per device (made on first use)."""

    def __init__(self, seed):
        self.seed = int(seed)
        self.gens = {}

    def generator(self, dev):
        gen = self.gens.get(dev)
        if gen is None:
            gen = self.gens[dev] = torch.Generator(device=dev)
            gen.manual_seed(self.seed)
        return gen


_ACTIVE = []        # the states of the rng_state blocks open, innermost last


class RNGStatesTracker:
    """Named random states for model-parallel regions (ref:
    fleet/layers/mpu/random.py RNGStatesTracker): a tensor-parallel local
    dropout draws from one state, a global one from another."""

    def __init__(self):
        self.states = {}

    def reset(self):
        self.states = {}

    def add(self, name, seed):
        if name in self.states:
            raise ValueError(f"rng state {name} already exists")
        self.states[name] = _NamedState(seed)

    def get_states_tracker(self):
        return dict(self.states)

    def set_states_tracker(self, states):
        self.states = dict(states)

    class _Guard:
        def __init__(self, state):
            self.state = state

        def __enter__(self):
            _ACTIVE.append(self.state)

        def __exit__(self, *exc):
            _ACTIVE.remove(self.state)
            return False

    def rng_state(self, name="model-parallel-rng"):
        if name not in self.states:
            raise ValueError(f"rng state {name} not added")
        return RNGStatesTracker._Guard(self.states[name])


_model_parallel_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _model_parallel_tracker
