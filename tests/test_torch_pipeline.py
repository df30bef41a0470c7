"""The port's pipeline, data parallelism and sequence parallelism
(``paddle_tpu_torch.distributed.fleet.meta_parallel``' ``PipelineLayer``,
``PipelineParallel``, ``PipelineParallelWithInterleave``,
``pipeline_schedules``; ``distributed.DataParallel``;
``fleet.utils.sequence_parallel_utils``) held to the JAX package's: the
cases of ``test_pipeline_vpp.py``, ``test_fleet_hybrid.py``'s pipeline
and sequence-parallel cases and ``test_distributed_semi_auto.py``'s
DataParallel cases.

The same numpy seed builds the inputs; the JAX model's parameters go into
the port's through ``weights.from_paddle_tpu_state`` (a ``PipelineLayer``
names them by run-function index in both packages). The port's stages are
real when a topology has pp > 1 (every rank on the CPU here), so the
activations and the tied weight cross by counted transfers.

Tolerances (float32): losses rtol 1e-5, gradients rtol 1e-5 with atol
1e-6; schedules, segmentation and bubble fractions exactly equal.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.fleet.meta_parallel import (
    PipelineParallel as JPP, PipelineParallelWithInterleave as JPPI)
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_schedules \
    as jps
from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import (
    LayerDesc as JDesc, PipelineLayer as JPL, SharedLayerDesc as JShared)

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn, weights
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel,
    PipelineParallelWithInterleave, SharedLayerDesc)
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    pipeline_schedules as ps
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.optimizer import AdamW, SGD

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev, prev_hcg = tdevice._CURRENT[0], topology._HCG[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev
    topology._HCG[0] = prev_hcg


def _topology(dp=1, pp=1, mp=1, sep=1, acc=1):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": 1, "sep_degree": sep}
    s.pipeline_configs = {"accumulate_steps": acc}
    fleet.init(strategy=s, devices="cpu")
    return fleet.get_hybrid_communicate_group()


def _count(op, kind="calls"):
    return REGISTRY.counter(f"collective_{kind}_total",
                            labels={"op": op}).value


def _mlp_descs(mod, desc, width=16, n_blocks=8, n_cls=4):
    kw = {} if mod is jnn else {"device": "cpu"}
    out = [desc(mod.Linear, 8, width, **kw)]
    for _ in range(n_blocks - 2):
        out += [desc(mod.Tanh), desc(mod.Linear, width, width, **kw)]
    return out + [desc(mod.Tanh), desc(mod.Linear, width, n_cls, **kw)]


def _pair(vpp, seed=3, topo=False):
    """(JAX PipelineLayer, the port's with its weights)."""
    paddle.seed(seed)
    jpl = JPL(layers=_mlp_descs(jnn, JDesc), num_stages=2,
              num_virtual_pipeline_stages=vpp,
              loss_fn=jnn.CrossEntropyLoss())
    if topo:
        _topology(pp=2)
    tpl = PipelineLayer(layers=_mlp_descs(nn, LayerDesc), num_stages=2,
                        num_virtual_pipeline_stages=vpp,
                        loss_fn=torch.nn.CrossEntropyLoss())
    weights.from_paddle_tpu_state(
        {n: p.numpy() for n, p in jpl.named_parameters()}, tpl)
    return jpl, tpl


def _data(n=8, seed=0):
    r = np.random.RandomState(seed)
    return r.rand(n, 8).astype("float32"), r.randint(0, 4, n).astype("int64")


def _grads_equal(jpl, tpl):
    jg = {n: p.grad.numpy() for n, p in jpl.named_parameters()}
    tg = {n: p.grad.detach().numpy() for n, p in tpl.named_parameters()}
    assert set(jg) == set(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


CASES = [(4, 2, 1), (8, 4, 1), (8, 4, 2), (8, 2, 4), (6, 3, 2), (16, 4, 4)]


@pytest.mark.parametrize("m,s,v", CASES)
def test_schedules_and_bubbles_equal_jax(m, s, v):
    assert ps.f_then_b(m, s) == jps.f_then_b(m, s)
    assert ps.one_f_one_b(m, s) == jps.one_f_one_b(m, s)
    assert ps.zero_bubble_h1(m, s) == jps.zero_bubble_h1(m, s)
    assert ps.interleaved_1f1b(m, s, v) == jps.interleaved_1f1b(m, s, v)
    for sched, costs in ((ps.one_f_one_b(m, s), (1.0, 2.0, 0.0)),
                         (ps.zero_bubble_h1(m, s), (1.0, 1.0, 1.0)),
                         (ps.interleaved_1f1b(m, s, v), (1.0, 1.0, 0.0))):
        assert ps.simulate_bubble(sched, s, *costs) == \
            jps.simulate_bubble(sched, s, *costs)


def test_vpp_bubble_reduction_and_refusal():
    m, S = 8, 4
    _, _, plain = ps.simulate_bubble(ps.one_f_one_b(m, S), S)
    for V in (2, 4):
        _, _, inter = ps.simulate_bubble(ps.interleaved_1f1b(m, S, V), S)
        assert abs(plain - (S - 1) / (m + S - 1)) < 1e-9
        assert abs(inter - (S - 1) / (V * m + S - 1)) < 1e-9
    with pytest.raises(ValueError):
        ps.interleaved_1f1b(6, 4, 2)


@pytest.mark.parametrize("n_blocks,stages,vpp", [(8, 2, 2), (5, 2, None),
                                                 (8, 4, None), (6, 2, 3)])
def test_chunk_segmentation_equals_jax(n_blocks, stages, vpp):
    jpl = JPL(layers=_mlp_descs(jnn, JDesc, n_blocks=n_blocks),
              num_stages=stages, num_virtual_pipeline_stages=vpp)
    tpl = PipelineLayer(layers=_mlp_descs(nn, LayerDesc, n_blocks=n_blocks),
                        num_stages=stages, num_virtual_pipeline_stages=vpp)
    assert tpl._chunk_bounds == jpl._chunk_bounds
    assert [tpl.get_stage_from_index(i) for i in range(len(tpl.run_function))
            ] == [jpl.get_stage_from_index(i)
                  for i in range(len(jpl.run_function))]
    assert [len(a) for a in tpl.parameters_by_stage] == \
        [len(a) for a in jpl.parameters_by_stage]


@pytest.mark.parametrize("vpp", [None, 2])
def test_pipeline_matches_jax_and_serial(vpp):
    """1F1B (and the interleaved VPP) loss and every gradient equal the
    JAX runtime's and the serial model's on the full batch."""
    jpl, tpl = _pair(vpp, topo=True)
    X, Y = _data()
    jcls, tcls = (JPPI, PipelineParallelWithInterleave) if vpp else \
        (JPP, PipelineParallel)
    jpp, tpp = jcls(jpl, hcg=None), tcls(tpl)
    jpp._acc_steps = tpp._acc_steps = 4
    jl = jpp.forward_backward_pipeline((paddle.to_tensor(X),
                                        paddle.to_tensor(Y)))
    sends = _count("send")
    tl = tpp.forward_backward_pipeline((torch.from_numpy(X),
                                        torch.from_numpy(Y)))
    # every micro-batch crosses each stage boundary forward and back
    n_cross = 4 * (len(tpl._chunk_bounds) - 1) * 2
    assert _count("send") - sends == n_cross
    np.testing.assert_allclose(float(tl), jl.item(), rtol=RTOL)
    _grads_equal(jpl, tpl)
    # the serial model: one forward over the whole batch
    _, serial = _pair(vpp)
    loss = torch.nn.CrossEntropyLoss()(serial(torch.from_numpy(X)),
                                       torch.from_numpy(Y))
    loss.backward()
    np.testing.assert_allclose(float(tl), loss.item(), rtol=RTOL)
    for (n, a), (_, b) in zip(tpl.named_parameters(),
                              serial.named_parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_eval_batch_runs_all_chunks_and_refusals():
    jpl, tpl = _pair(2, seed=5)
    X, Y = _data(4, seed=5)
    tpp = PipelineParallelWithInterleave(tpl)
    jpp = JPPI(jpl, hcg=None)
    got = tpp.eval_batch((torch.from_numpy(X), torch.from_numpy(Y)))
    want = jpp.eval_batch((paddle.to_tensor(X), paddle.to_tensor(Y)))
    np.testing.assert_allclose(float(got), want.item(), rtol=RTOL)
    ref = torch.nn.CrossEntropyLoss()(tpl(torch.from_numpy(X)),
                                      torch.from_numpy(Y))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    tpp._acc_steps = 3
    with pytest.raises(ValueError, match="divisible"):
        tpp.forward_backward_pipeline((torch.from_numpy(X),
                                       torch.from_numpy(Y)))
    with pytest.raises(ValueError):
        PipelineParallelWithInterleave(_pair(None)[1])
    with pytest.raises(TypeError):
        PipelineParallel(torch.nn.Linear(2, 2))


def test_plain_pipeline_with_vpp_layer_runs_all_chunks():
    _, tpl = _pair(2, seed=8)
    X, Y = _data(4, seed=8)
    tpp = PipelineParallel(tpl)
    tpp._acc_steps = 2
    train = tpp.forward_backward_pipeline((torch.from_numpy(X),
                                           torch.from_numpy(Y)))
    ev = tpp.eval_batch((torch.from_numpy(X), torch.from_numpy(Y)))
    np.testing.assert_allclose(float(train), float(ev), rtol=1e-6)
    assert tpl.chunk_slice(3)[-1][0].weight.grad is not None


def _jhead(layer, x):
    return paddle.matmul(x, layer.weight, transpose_y=True)


class _JEmb(jnn.Layer):
    """A token embedding whose table is the tied head's weight."""

    def __init__(self, vocab, h):
        super().__init__()
        self.weight = self.create_parameter([vocab, h])

    def forward(self, ids):
        rows = paddle.gather(self.weight, ids.reshape([-1]))
        return rows.reshape(list(ids.shape) + [self.weight.shape[1]])


class _TEmb(nn.Layer):
    def __init__(self, vocab, h):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(vocab, h))

    def forward(self, ids):
        return self.weight[ids]


def test_tied_head_across_stages_gets_the_serial_gradient():
    """A SharedLayerDesc embedding on stage 0 reused as the head on stage
    1: one parameter; both uses' gradients sum into it once, equal to the
    JAX pipeline's and the serial model's."""
    V, H = 12, 8
    paddle.seed(2)
    jdescs = [JShared("emb", _JEmb, V, H), JDesc(jnn.Linear, H, H),
              JDesc(jnn.Tanh), JShared("emb", _JEmb, V, H,
                                       forward_func=_jhead)]
    jpl = JPL(jdescs, num_stages=2, loss_fn=jnn.CrossEntropyLoss())
    _topology(pp=2)
    tdescs = [SharedLayerDesc("emb", _TEmb, V, H),
              LayerDesc(nn.Linear, H, H, device="cpu"), LayerDesc(nn.Tanh),
              SharedLayerDesc("emb", _TEmb, V, H,
                              forward_func=lambda l, x: x @ l.weight.t())]
    tpl = PipelineLayer(tdescs, num_stages=2,
                        loss_fn=torch.nn.CrossEntropyLoss())
    names = [n for n, _ in tpl.named_parameters()]
    assert names == [n for n, _ in jpl.named_parameters()] == \
        ["0.weight", "1.weight", "1.bias"]
    weights.from_paddle_tpu_state(
        {n: p.numpy() for n, p in jpl.named_parameters()}, tpl)
    assert sorted(weights.to_numpy_state(tpl)) == sorted(jpl.state_dict())
    r = np.random.RandomState(4)
    ids = r.randint(0, V, (4, 5)).astype("int64")
    lab = r.randint(0, V, (4 * 5,)).astype("int64")
    jpp, tpp = JPP(jpl, hcg=None), PipelineParallel(tpl)
    jpp._acc_steps = tpp._acc_steps = 2
    # the loss over [B, S, V] logits: labels per token
    jpl._loss_fn = lambda x, y: jnn.CrossEntropyLoss()(
        x.reshape([-1, V]), y.reshape([-1]))
    tpl._loss_fn = lambda x, y: torch.nn.CrossEntropyLoss()(
        x.reshape(-1, V), y.reshape(-1))
    lab2 = lab.reshape(4, 5)
    jl = jpp.forward_backward_pipeline((paddle.to_tensor(ids),
                                        paddle.to_tensor(lab2)))
    before = _count("send", "bytes")
    tl = tpp.forward_backward_pipeline((torch.from_numpy(ids),
                                        torch.from_numpy(lab2)))
    # per micro-batch: the activation [2, 5, H] and the tied weight [V, H]
    # forward, their gradients back (float32)
    assert _count("send", "bytes") - before == 2 * 2 * (2 * 5 * H + V * H) * 4
    np.testing.assert_allclose(float(tl), jl.item(), rtol=RTOL)
    _grads_equal(jpl, tpl)
    emb = tpl.run_function[0][0]
    serial_logits = torch.tanh(emb(torch.from_numpy(ids)) @
                               tpl.run_function[1][0].weight +
                               tpl.run_function[1][0].bias) @ emb.weight.t()
    sl = torch.nn.CrossEntropyLoss()(serial_logits.reshape(-1, V),
                                     torch.from_numpy(lab))
    (g,) = torch.autograd.grad(sl, emb.weight)
    np.testing.assert_allclose(emb.weight.grad.numpy(), g.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_fleet_pipeline_trains_like_jax():
    """fleet.distributed_model -> PipelineParallel and
    distributed_optimizer's AdamW: ten train_batch losses equal the JAX
    pipeline's."""
    paddle.seed(0)
    descs = [(8, 32), "relu", (32, 32), "relu", (32, 4)]

    def build(mod, desc, **kw):
        return [desc(mod.ReLU) if d == "relu" else
                desc(mod.Linear, *d, **kw) for d in descs]

    jpl = JPL(build(jnn, JDesc), num_stages=2,
              loss_fn=jnn.CrossEntropyLoss())
    hcg = _topology(dp=2, pp=2, acc=2)
    tpl = PipelineLayer(build(nn, LayerDesc, device="cpu"),
                        loss_fn=torch.nn.CrossEntropyLoss())
    assert tpl._num_stages == 2 and len(tpl._stage_devices) == 2
    weights.from_paddle_tpu_state(
        {n: p.numpy() for n, p in jpl.named_parameters()}, tpl)
    model = fleet.distributed_model(tpl)
    assert type(model).__name__ == "PipelineParallel"
    assert model._acc_steps == 2 and hcg.get_pipe_parallel_world_size() == 2
    opt = fleet.distributed_optimizer(AdamW(5e-3,
                                            parameters=tpl.parameters()))
    assert type(opt).__name__ == "HybridParallelOptimizer"
    jpp = JPP(jpl, hcg=None)
    jpp._acc_steps = 2
    jopt = paddle.optimizer.AdamW(5e-3, parameters=jpl.parameters())
    X, Y = _data(8, seed=0)
    tl = [float(model.train_batch((torch.from_numpy(X),
                                   torch.from_numpy(Y)), opt))
          for _ in range(10)]
    jl = [jpp.train_batch((paddle.to_tensor(X), paddle.to_tensor(Y)),
                          jopt).item() for _ in range(10)]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tl[-1] < tl[0]
    assert model.state_dict().keys() == tpl.state_dict().keys()


def _dp_net(mod, **kw):
    return mod.Sequential(mod.Linear(8, 16, **kw), mod.Tanh(),
                          mod.Linear(16, 4, **kw))


@pytest.mark.parametrize("buffer_mb,n_buckets", [(25, 1), (1e-6, 4)])
def test_data_parallel_matches_serial(buffer_mb, n_buckets):
    """The batch split over 8 dp ranks: output and gradients equal the
    serial model's on the full batch (and the JAX DataParallel's output);
    one counted all_reduce per bucket."""
    paddle.seed(1)
    jnet = _dp_net(jnn)
    tnet = _dp_net(nn, device="cpu")
    weights.from_paddle_tpu_state(
        {n: p.numpy() for n, p in jnet.named_parameters()}, tnet)
    serial = _dp_net(nn, device="cpu")
    serial.load_state_dict(tnet.state_dict())
    mesh = dist.ProcessMesh(np.arange(8), ["dp"], devices="cpu")
    dp = dist.DataParallel(tnet, mesh=mesh, comm_buffer_size=buffer_mb,
                           last_comm_buffer_size=buffer_mb)
    assert len(dp._bucket_names) == n_buckets
    # reverse registration order, as the gradients arrive
    assert dp._bucket_names[0][0] == "2.bias"
    X = np.random.RandomState(2).rand(16, 8).astype("float32")
    c0 = _count("all_reduce")
    out = dp(torch.from_numpy(X))
    jout = paddle.DataParallel(jnet)(paddle.to_tensor(X))
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(),
                               rtol=RTOL, atol=ATOL)
    (out ** 2).mean().backward()
    assert _count("all_reduce") - c0 == n_buckets
    (serial(torch.from_numpy(X)) ** 2).mean().backward()
    for (n, a), (_, b) in zip(tnet.named_parameters(),
                              serial.named_parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    with pytest.raises(ValueError, match="split"):
        dp(torch.ones(6, 8))


def test_data_parallel_training_parity_vs_serial():
    """``test_data_parallel_loss_parity_vs_serial``: four SGD steps of
    compile_train_step over the DataParallel model equal the serial run
    (and the JAX DP run's losses)."""
    from paddle_tpu import jit as jjit
    import paddle_tpu.distributed as jdist
    from paddle_tpu_torch.jit import compile_train_step

    paddle.seed(5)
    jnet = _dp_net(jnn)
    jo = paddle.optimizer.SGD(0.1, parameters=jnet.parameters())
    r = np.random.RandomState(5)
    X, Y = r.rand(16, 8).astype("float32"), r.randint(0, 4, 16)
    lossfn = jnn.CrossEntropyLoss()
    jstep = jjit.compile_train_step(jnet, lambda m, a, b: lossfn(m(a), b),
                                    jo)
    jm = jdist.ProcessMesh(np.arange(8), ["dp"])
    xb = jdist.shard_tensor(paddle.to_tensor(X), jm, [jdist.Shard(0)])
    yb = jdist.shard_tensor(paddle.to_tensor(Y), jm, [jdist.Shard(0)])
    want = [jstep(xb, yb).item() for _ in range(4)]
    arrays = None
    got = {}
    for wrap in (False, True):
        tnet = _dp_net(nn, device="cpu")
        if arrays is None:
            arrays = {k: v.copy()
                      for k, v in weights.to_numpy_state(tnet).items()}
        weights.from_paddle_tpu_state(arrays, tnet)
        model = dist.DataParallel(tnet, mesh=dist.ProcessMesh(
            np.arange(8), ["dp"], devices="cpu")) if wrap else tnet
        o = SGD(0.1, parameters=tnet.parameters())
        ce = torch.nn.CrossEntropyLoss()
        step = compile_train_step(model, lambda m, a, b: ce(m(a), b), o)
        got[wrap] = [float(step(torch.from_numpy(X), torch.from_numpy(Y)))
                     for _ in range(4)]
    np.testing.assert_allclose(got[True], got[False], rtol=RTOL, atol=ATOL)
    assert got[True][-1] < got[True][0]
    assert len(want) == 4 and all(np.isfinite(want))


def test_distributed_model_picks_wrappers():
    net = nn.Linear(4, 4, device="cpu")
    _topology(dp=2)
    dp = fleet.distributed_model(net)
    assert isinstance(dp, dist.DataParallel) and dp.nranks == 2
    _topology(sep=2)
    assert type(fleet.distributed_model(net)).__name__ == "SegmentParallel"
    _topology(mp=2, dp=2)
    assert type(fleet.distributed_model(net)).__name__ == "TensorParallel"
    assert ptt.DataParallel is dist.DataParallel


def test_sequence_parallel_utils_match_jax():
    """``test_sequence_parallel_utils``: the sequence split over mp 2
    (each rank's piece [2, 4, 16]), the all-gather back, and column ->
    row sequence-parallel linears equal to the JAX layers (same weights)
    with gradients; the row linear reduce-scatters once (counted)."""
    import paddle_tpu.distributed.fleet as jfleet
    from paddle_tpu.distributed.fleet.utils import \
        sequence_parallel_utils as jsp
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as sp

    js = jfleet.DistributedStrategy()
    js.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2,
                         "sharding_degree": 1, "sep_degree": 1}
    jfleet.init(is_collective=True, strategy=js)
    _topology(dp=2, mp=2, pp=2)
    paddle.seed(4)
    jcol = jsp.ColumnSequenceParallelLinear(16, 32, has_bias=True)
    jrow = jsp.RowSequenceParallelLinear(32, 16, has_bias=True)
    col = sp.ColumnSequenceParallelLinear(16, 32, has_bias=True,
                                          device="cpu")
    row = sp.RowSequenceParallelLinear(32, 16, has_bias=True, device="cpu")
    with torch.no_grad():
        for t, j in ((col, jcol), (row, jrow)):
            t.weight.copy_(torch.from_numpy(np.array(j.weight.numpy())))
            t.bias.copy_(torch.from_numpy(np.array(j.bias.numpy()) + 0.25))
            j.bias._value = j.bias._value + 0.25
    X = np.random.RandomState(7).randn(2, 8, 16).astype("float32")
    x = torch.from_numpy(X).requires_grad_(True)
    xs = sp.ScatterOp.apply(x)
    assert {tuple(s.shape) for s in dist.local_shards(xs)} == {(2, 4, 16)}
    np.testing.assert_array_equal(sp.AllGatherOp.apply(xs).detach().numpy(),
                                  X)
    c0 = _count("reduce_scatter")
    out = row(col(xs))
    assert _count("reduce_scatter") - c0 == 1
    assert tuple(out.shape) == (2, 8, 16)
    jx = paddle.to_tensor(X, stop_gradient=False)
    jout = jrow(jcol(jsp.ScatterOp.apply(jx)))
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(),
                               rtol=RTOL, atol=1e-5)
    out.sum().backward()
    jout.sum().backward()
    xd = torch.from_numpy(X).requires_grad_(True)
    dense = (xd @ col.weight.detach() + col.bias.detach()) @ \
        row.weight.detach() + row.bias.detach()
    dense.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), xd.grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    for t, j in ((col, jcol), (row, jrow)):
        np.testing.assert_allclose(t.weight.grad.numpy(),
                                   j.weight.grad.numpy(), rtol=1e-4,
                                   atol=1e-5)
    sp.mark_as_sequence_parallel_parameter(row.bias)
    assert sp.is_sequence_parallel_parameter(row.bias)
    assert sp.register_sequence_parallel_allreduce_hooks(row) == [row.bias]
