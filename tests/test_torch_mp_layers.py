"""The port's tensor-parallel layers and topology
(``paddle_tpu_torch.distributed.fleet``: ``CommunicateTopology``,
``HybridCommunicateGroup``, the mpu layers and ops, the mp RNG tracker)
and ``apply_llama_tp`` / ``apply_gpt_tp``, held to the JAX package's:
the cases of ``test_fleet_hybrid.py``'s ``test_topology``,
``test_tp_layers_match_serial``, ``test_vocab_parallel_embedding``,
``test_parallel_cross_entropy`` and ``test_mp_rng_tracker``.

Both packages run ``fleet.init`` with dp 2 x mp 2 x pp 2 (the JAX one on
its 8 virtual CPU devices, the port's on the CPU 8 times). The port's
layers compute rank by rank over the mp group (2 ranks); each takes the
JAX layer's weights, and the outputs and every gradient are held to the
JAX layer's (GSPMD over the same placements). The placed Llama and GPT
must leave the forward and the gradients those of the unsharded model,
in both packages.

Tolerance: float32 outputs within 1e-5 (rtol 1e-5), gradients within
1e-5 of the largest (atol) plus 1e-4 relative; model logits 1e-4 against
JAX, and the port's placed model exactly equal to its unsharded twin.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.fleet as jfleet
from paddle_tpu.distributed.fleet.layers import mpu as jmpu
from paddle_tpu.distributed.fleet.layers.mpu import mp_ops as jops
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models.gpt import apply_gpt_tp as japply_gpt_tp
from paddle_tpu.models.llama import apply_llama_tp as japply_llama_tp

import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed.fleet.layers import mpu
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
from paddle_tpu_torch.framework import random as frandom
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, apply_gpt_tp,
                                     apply_llama_tp)
from paddle_tpu_torch.observability.metrics import REGISTRY

HYBRID = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2,
          "sharding_degree": 1, "sep_degree": 1}


@pytest.fixture(scope="module", autouse=True)
def _init_fleet():
    js = jfleet.DistributedStrategy()
    js.hybrid_configs = dict(HYBRID)
    js.pipeline_configs = {"accumulate_steps": 2}
    jfleet.init(is_collective=True, strategy=js)
    ts = fleet.DistributedStrategy()
    ts.hybrid_configs = dict(HYBRID)
    fleet.init(is_collective=True, strategy=ts, devices="cpu")
    yield


def _np(t):
    return np.asarray(t._value) if hasattr(t, "_value") else \
        t.detach().numpy()


def _close_grads(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def _load(param, value):
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value, np.float32)))


def test_topology():
    jh = jfleet.get_hybrid_communicate_group()
    th = fleet.get_hybrid_communicate_group()
    for name in ("get_data_parallel_world_size",
                 "get_model_parallel_world_size",
                 "get_pipe_parallel_world_size",
                 "get_sharding_parallel_world_size",
                 "get_sep_parallel_world_size", "get_parallel_mode",
                 "get_model_parallel_rank", "get_stage_id"):
        assert getattr(th, name)() == getattr(jh, name)(), name
    jt, tt = jh.topology(), th.topology()
    assert tt.world_size() == jt.world_size() == 8
    for axis in ("data", "pipe", "model"):
        assert tt.get_comm_list(axis) == jt.get_comm_list(axis)
        assert tt.get_axis_list(axis, 1) == jt.get_axis_list(axis, 1)
    assert len(tt.get_comm_list("model")[0]) == 2
    assert tt.get_coord(5) == jt.get_coord(5)
    assert tt.get_rank(data=1, pipe=0, sharding=0, model=1, sep=0) == \
        jt.get_rank(data=1, pipe=0, sharding=0, model=1, sep=0)
    g = th.get_model_parallel_group()
    assert g.nranks == jh.get_model_parallel_group().nranks == 2
    assert g.devices == [torch.device("cpu")] * 2
    assert dict(th.mesh.shape) == {"dp": 2, "pp": 2, "sharding": 1,
                                   "mp": 2, "sep": 1}
    model = torch.nn.Linear(2, 2)
    assert isinstance(fleet.distributed_model(model),
                      fleet.meta_parallel.TensorParallel)
    # sharding degree 1: no ZeRO, the hybrid wrapper around the optimizer
    opt = fleet.distributed_optimizer(torch.optim.SGD(model.parameters(),
                                                      0.1))
    assert isinstance(opt, fleet.HybridParallelOptimizer)
    assert isinstance(opt._inner_opt, torch.optim.SGD)


@pytest.mark.parametrize("gather_output", [False, True])
def test_tp_layers_match_serial(gather_output):
    """Column -> row parallel linears: outputs and weight/bias/input
    gradients equal the JAX layers' and the dense product."""
    paddle.seed(3)
    jcol = jmpu.ColumnParallelLinear(16, 32, has_bias=True,
                                     gather_output=gather_output)
    jrow = jmpu.RowParallelLinear(32, 16, has_bias=True)
    jcol.bias._value = jcol.bias._value + 0.25    # non-zero biases
    jrow.bias._value = jrow.bias._value - 0.5
    col = mpu.ColumnParallelLinear(16, 32, has_bias=True,
                                   gather_output=gather_output,
                                   device="cpu")
    row = mpu.RowParallelLinear(32, 16, has_bias=True, device="cpu")
    for a, b in ((col, jcol), (row, jrow)):
        _load(a.weight, _np(b.weight))
        _load(a.bias, _np(b.bias))
    x = _x((4, 16), 1)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jrow(jcol(jx))
    tx = torch.from_numpy(x).requires_grad_(True)
    calls = REGISTRY.counter("collective_calls_total",
                             labels={"op": "all_reduce"})
    c0 = calls.value
    tout = row(col(tx))
    assert calls.value > c0          # the row layer's all-reduce ran
    ref = (x @ _np(jcol.weight) + _np(jcol.bias)) @ _np(jrow.weight) \
        + _np(jrow.bias)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tout), ref, rtol=1e-4, atol=1e-5)
    jout.sum().backward()
    tout.sum().backward()
    for a, b in ((col.weight, jcol.weight), (col.bias, jcol.bias),
                 (row.weight, jrow.weight), (row.bias, jrow.bias),
                 (tx, jx)):
        _close_grads(a.grad.numpy(), _np(b.grad))
    # the weight is laid out by columns over mp, as JAX's is
    shapes = sorted({tuple(s.shape) for s in dist.local_shards(col.weight)})
    jshapes = sorted({tuple(s.data.shape)
                      for s in jcol.weight._value.addressable_shards})
    assert shapes == jshapes == [(16, 16)]


def test_vocab_parallel_embedding():
    paddle.seed(4)
    jemb = jmpu.VocabParallelEmbedding(64, 16)
    emb = mpu.VocabParallelEmbedding(64, 16, device="cpu")
    _load(emb.weight, _np(jemb.weight))
    ids = np.random.default_rng(2).integers(0, 64, (2, 8))
    jout = jemb(paddle.to_tensor(ids))
    tout = emb(torch.from_numpy(ids))
    assert list(tout.shape) == jout.shape == [2, 8, 16]
    np.testing.assert_array_equal(_np(tout), _np(jout))
    np.testing.assert_array_equal(_np(tout), _np(jemb.weight)[ids])
    g = _x((2, 8, 16), 3)
    (jout * paddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    _close_grads(emb.weight.grad.numpy(), _np(jemb.weight.grad))
    assert sorted({tuple(s.shape) for s in
                   dist.local_shards(emb.weight)}) == [(32, 16)]


def test_parallel_cross_entropy():
    """Vocab-parallel cross-entropy (three all-reduces over the 2 mp
    ranks): the loss per label and the logits' gradient equal JAX's
    (ignore_index rows add nothing)."""
    logits = _x((4, 64), 5) * 3
    labels = np.array([3, 40, -100, 63])
    jl = paddle.to_tensor(logits, stop_gradient=False)
    jloss = jmpu.ParallelCrossEntropy()(jl, paddle.to_tensor(labels))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tloss = mpu.ParallelCrossEntropy()(tl, torch.from_numpy(labels))
    assert list(tloss.shape) == jloss.shape == [4]
    np.testing.assert_allclose(_np(tloss), _np(jloss), rtol=1e-5, atol=1e-6)
    assert float(tloss[2].detach()) == 0.0
    jloss.sum().backward()
    tloss.sum().backward()
    _close_grads(tl.grad.numpy(), _np(jl.grad))


def test_mp_ops():
    """The value-keeping layout ops, the lookup, the mp softmax
    cross-entropy and ``split`` against the JAX package's."""
    x = _x((4, 8), 6)
    tx = torch.from_numpy(x).requires_grad_(True)
    for top, jop in ((mp_ops._c_identity, jops._c_identity),
                     (mp_ops._c_split, jops._c_split),
                     (mp_ops._c_concat, jops._c_concat),
                     (mp_ops._mp_allreduce, jops._mp_allreduce)):
        np.testing.assert_array_equal(_np(top(tx)),
                                      _np(jop(paddle.to_tensor(x))))
    split = mp_ops._c_split(tx)
    assert [repr(p) for p in split._dist_attr.placements] == \
        ["Replicate()"] * 3 + ["Shard(dim=1)", "Replicate()"]
    (split * 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.full_like(x, 2.0))

    table = _x((10, 4), 7)
    idx = np.array([[1, 9], [0, 4]])
    np.testing.assert_array_equal(
        _np(mp_ops._c_lookup_table(torch.from_numpy(table),
                                   torch.from_numpy(idx))),
        _np(jops._c_lookup_table(paddle.to_tensor(table),
                                 paddle.to_tensor(idx))))

    logits, lab = _x((3, 16), 8), np.array([[1], [15], [-100]])
    jloss, jsm = jops._c_softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(lab),
        return_softmax=True)
    tloss, tsm = mp_ops._c_softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(lab),
        return_softmax=True)
    assert list(tloss.shape) == jloss.shape == [3, 1]
    np.testing.assert_allclose(_np(tloss), _np(jloss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tsm), _np(jsm), rtol=1e-5, atol=1e-7)

    out = dist.split(torch.from_numpy(x), (8, 6), "linear", axis=1)
    assert tuple(out.shape) == (4, 6)
    with pytest.raises(ValueError):
        dist.split(torch.from_numpy(x), (8, 6), "conv")


def test_mp_rng_tracker():
    """Named states: local and global draws differ, a state's draws
    repeat under the same seed, and the default generator is back
    outside the block."""
    mpu.model_parallel_random_seed(1234)
    tracker = mpu.get_rng_state_tracker()

    def draw():
        return torch.rand(4, generator=frandom.default_generator("cpu"))

    with tracker.rng_state("local_seed"):
        a = draw()
    with tracker.rng_state("global_seed"):
        b = draw()
    assert not np.allclose(a.numpy(), b.numpy())
    outside = draw()
    mpu.model_parallel_random_seed(1234)
    with tracker.rng_state("local_seed"):
        a2 = draw()
    with tracker.rng_state("global_seed"):
        b2 = draw()
    np.testing.assert_array_equal(a2.numpy(), a.numpy())
    np.testing.assert_array_equal(b2.numpy(), b.numpy())
    np.testing.assert_array_equal(draw().numpy(), outside.numpy())
    with pytest.raises(ValueError):
        tracker.add("local_seed", 1)
    with pytest.raises(ValueError):
        tracker.rng_state("missing")
    # the JAX tracker is the same machine
    jmpu.random.model_parallel_random_seed(1234)
    jt = jmpu.get_rng_state_tracker()
    assert sorted(jt.states) == sorted(tracker.states)


def _model_pair(kind):
    rng_ids = np.random.default_rng(9)
    if kind == "llama":
        kw = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2,
                  ffn=64, seq=64)
        paddle.seed(0)
        jm = JLlama(JLlamaConfig.tiny(**kw))
        make = lambda: LlamaForCausalLM(LlamaConfig.tiny(**kw),  # noqa
                                        device="cpu")
    else:
        kw = dict(vocab=128, hidden=32, layers=2, heads=4, ffn=64, seq=64)
        paddle.seed(0)
        jm = JGPT(JGPTConfig.tiny(**kw))
        make = lambda: GPTForCausalLM(GPTConfig.tiny(**kw),  # noqa
                                      device="cpu")
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm, tref = make(), make()
    weights.from_paddle_tpu_state(arrays, tm)
    weights.from_paddle_tpu_state(arrays, tref)
    ids = rng_ids.integers(1, 127, (2, 12))
    lab = rng_ids.integers(1, 127, (2, 12))
    return jm, tm, tref, ids, lab


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_apply_tp_keeps_forward_and_grads(kind):
    """apply_llama_tp / apply_gpt_tp mark the Megatron placements; the
    forward and the gradients stay the unsharded model's (the port
    exactly, JAX within tolerance of the port)."""
    jm, tm, tref, ids, lab = _model_pair(kind)
    ids_np = np.arange(8).reshape(4, 2)
    jmesh = jdist.ProcessMesh(ids_np, ["dp", "mp"])
    tmesh = dist.ProcessMesh(ids_np, ["dp", "mp"], devices="cpu")
    if kind == "llama":
        japply_llama_tp(jm, jmesh)
        assert apply_llama_tp(tm, tmesh) is tm
        col = tm.llama.layers[0].self_attn.q_proj.weight
        row = tm.llama.layers[0].mlp.down_proj.weight
        emb = tm.llama.embed_tokens.weight
    else:
        japply_gpt_tp(jm, jmesh)
        assert apply_gpt_tp(tm, tmesh) is tm
        col = tm.gpt.h[0].attn.qkv_proj.weight
        row = tm.gpt.h[0].mlp[2].weight
        emb = tm.gpt.wte.weight
    for p, want in ((col, "Shard(dim=1)"), (row, "Shard(dim=0)"),
                    (emb, "Shard(dim=0)")):
        assert [repr(x) for x in p._dist_attr.placements] == \
            ["Replicate()", want]
    jn = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        attr = getattr(p, "_dist_attr", None)
        if attr is None:
            continue
        jshapes = sorted({tuple(s.data.shape)
                          for s in jn[name]._value.addressable_shards})
        assert sorted({tuple(s.shape) for s in dist.local_shards(p)}) == \
            jshapes, name

    tid, tlab = torch.from_numpy(ids), torch.from_numpy(lab)
    logits, ref = tm(tid), tref(tid)
    np.testing.assert_array_equal(_np(logits), _np(ref))
    np.testing.assert_allclose(_np(logits), _np(jm(paddle.to_tensor(ids))),
                               rtol=1e-4, atol=1e-4)
    loss, rloss = tm(tid, labels=tlab), tref(tid, labels=tlab)
    jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(lab))
    assert float(loss) == float(rloss)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    loss.backward()
    rloss.backward()
    jloss.backward()
    rn = dict(tref.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.grad.numpy(), rn[name].grad.numpy())
        _close_grads(p.grad.numpy(), np.asarray(jn[name].grad._value))


def test_plain_layers_without_mp():
    """A topology with one mp rank: the layers are the plain ones."""
    st = fleet.DistributedStrategy()
    fleet.init(strategy=st, devices="cpu")
    try:
        col = mpu.ColumnParallelLinear(4, 6, has_bias=True, device="cpu")
        x = torch.ones(2, 4)
        np.testing.assert_allclose(
            _np(col(x)), x.numpy() @ _np(col.weight) + _np(col.bias),
            rtol=1e-6)
        loss = mpu.ParallelCrossEntropy()(torch.zeros(2, 4),
                                          torch.tensor([0, 1]))
        np.testing.assert_allclose(_np(loss), np.full(2, np.log(4.0)),
                                   rtol=1e-6)
    finally:
        ts = fleet.DistributedStrategy()
        ts.hybrid_configs = dict(HYBRID)
        fleet.init(strategy=ts, devices="cpu")
