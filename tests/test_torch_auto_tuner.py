"""The port's auto-tuner against ``paddle_tpu.distributed.auto_tuner``:
the same memory and step-time estimates (exactly: the same float
arithmetic), the same pruned candidates and the same ``search`` ranking
for every hardware key of the JAX table; the port's ``h100`` profile and
default; and ``measure_memory`` on the CPU (torch's memory tracker)."""

import pytest
import torch

import paddle_tpu.distributed.auto_tuner as jat

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as tdevice
import paddle_tpu_torch.distributed.auto_tuner as tat

JAX_KEYS = sorted(jat.HARDWARE)
# Llama-2-7B-like and GPT-3 1.3B-like searches
MODELS = [dict(world_size=8, n_params=6.7e9, seq=4096, hidden=4096,
               layers=32, global_bsz=16, n_heads=32),
          dict(world_size=4, n_params=1.3e9, seq=2048, hidden=2048,
               layers=24, global_bsz=8, n_heads=16, vocab=50304,
               sharding_stage=2)]


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU as the current device; the previous one back after."""
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


@pytest.mark.parametrize("hw", JAX_KEYS)
@pytest.mark.parametrize("model", range(len(MODELS)))
def test_same_candidates_estimates_and_ranking(hw, model):
    kw = dict(MODELS[model], hardware=hw)
    j, t = jat.AutoTuner(**kw), tat.AutoTuner(**kw)
    jc, tc = j.candidates(), t.candidates()
    assert tc == jc and tc
    assert [t.cost(c) for c, _ in tc] == [j.cost(c) for c, _ in jc]
    assert t.search(top_k=10) == j.search(top_k=10)
    assert [(r["cfg"], r["time"], r["mem"]) for r in t.recorder.history] \
        == [(r["cfg"], r["time"], r["mem"]) for r in j.recorder.history]
    assert t.recorder.best() == j.recorder.best()


@pytest.mark.parametrize("hw", JAX_KEYS + [(123.0, 40.0, 50.0)])
def test_models_equal(hw):
    cfgs = [{"dp_degree": 2, "mp_degree": 2, "pp_degree": 2,
             "sharding_degree": 2}, {"dp_degree": 8}, {"mp_degree": 4,
                                                        "pp_degree": 2}]
    for stage in (1, 2, 3):
        for recompute in (True, False):
            for cfg in cfgs:
                args = (cfg, 2, 2048, recompute, stage)
                assert tat.MemoryCostModel(1.3e9, 24, 2048).estimate(
                    *args) == jat.MemoryCostModel(1.3e9, 24, 2048) \
                    .estimate(*args)
                targs = (cfg, 2, 2048, 16, recompute)
                assert tat.CostModel(1.3e9, 24, 2048, hw).step_time(
                    *targs) == jat.CostModel(1.3e9, 24, 2048, hw) \
                    .step_time(*targs)
    p_t = tat.Prune(1e10, 2048, 24, 16)
    p_j = jat.Prune(1e10, 2048, 24, 16)
    for cfg in cfgs + [{"mp_degree": 3}, {"pp_degree": 5}]:
        for mem in (1e9, 2e10):
            assert p_t.ok(cfg, mem) == p_j.ok(cfg, mem)


def test_h100_profile_is_the_default():
    assert tat.HARDWARE["h100"] == (989.0, 80.0, 900.0)
    assert tat.DEFAULT_HARDWARE == "h100"
    t = tat.AutoTuner(**MODELS[0])
    assert t.prune.max_mem_bytes == 80.0 * 2**30 * 0.9
    cm = tat.CostModel(1e9, 24, 2048)
    assert cm.flops == 989.0 * 1e12 * 0.45 and cm.ici == 900.0 * 1e9
    assert t.search(top_k=3)
    with pytest.raises(ValueError, match="hardware"):
        tat.CostModel(1e9, 24, 2048, hardware="a100")


def test_measure_memory_on_the_cpu():
    """Torch's memory tracker on the CPU: a step that makes a 4 MiB
    temporary from a 1 MiB input peaks at no less than the two plus the
    model's parameters and gradients."""
    lin = torch.nn.Linear(256, 256)
    x = torch.randn(1024, 256)                      # 1 MiB

    def step(m, x):
        big = x.repeat(4, 1)                        # 4 MiB
        m(big).sum().backward()

    got = tat.measure_memory(step, lin, x)
    params = sum(p.numel() * 4 for p in lin.parameters())
    assert got >= (1 << 20) + (4 << 20) + params
    assert got < 64 << 20
    with pytest.raises(ValueError, match="no tensor"):
        tat.measure_memory(lambda: None)
    with pytest.raises(ValueError, match="no memory tracker"):
        tat.measure_memory(lambda t: t, torch.zeros(2, device="meta"))
