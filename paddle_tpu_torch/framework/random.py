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


def default_generator(device="cpu"):
    """The default generator of `device`, made on first use from the last
    seed."""
    dev = _key(device)
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
