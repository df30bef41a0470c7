"""The port's compiled pipeline (``fleet.meta_parallel.compiled_pipeline``:
``CompiledPipeline``, ``pipeline_spmd``, ``stack_layer_params``, the
``"1F1B"`` and ``"ZBH1"`` train steps; ``zero_bubble``'s B / W split)
held to the JAX package's: the cases of ``test_compiled_pipeline.py``
and ``test_zero_bubble.py``, and ``__graft_entry__.full_hybrid_demo``'s
dp 2 x pp 2 x mp 2 composition with ``zero_axis="dp"`` against the JAX
model's serial eager loss (that test's own reference; its compiled JAX
program may skip on this jaxlib).

The port issues the schedule tick by tick over stages on a mesh whose
positions are all the CPU; the JAX program runs on the 8 virtual CPU
devices. Weights go JAX -> port by name.

Tolerances (float32): outputs and losses against JAX rtol 1e-5 (atol
1e-5 for the pipelined Llama layers, 2e-4 in the JAX test), gradients
rtol 1e-4 / atol 1e-5 as the JAX test holds its own; ZBH1 against 1F1B
in the port bit-equal (the same gradient products, accumulated in the
same order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.meta_parallel.compiled_pipeline import \
    CompiledPipeline as JCP

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn, optimizer as O, weights
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    CompiledPipeline, stack_layer_params)
from paddle_tpu_torch.distributed.fleet.meta_parallel.zero_bubble import \
    capture_and_split
from paddle_tpu_torch.observability.metrics import REGISTRY


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


class JBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.lin = jnn.Linear(d, d)

    def forward(self, x):
        return x + paddle.tanh(self.lin(x))


class Block(nn.Layer):
    def __init__(self, d):
        super().__init__()
        self.lin = nn.Linear(d, d, device="cpu")

    def forward(self, x):
        return x + torch.tanh(self.lin(x))


def _jmesh(n):
    return Mesh(np.asarray(jax.devices())[:n], ("pp",))


def _mesh(n, names=("pp",), shape=None):
    return dist.ProcessMesh(np.arange(n).reshape(shape or (n,)),
                            list(names), devices="cpu")


def _blocks(seed, n, d):
    """(JAX blocks, the port's with their weights)."""
    paddle.seed(seed)
    jl = [JBlock(d) for _ in range(n)]
    tl = [Block(d) for _ in range(n)]
    for a, b in zip(jl, tl):
        weights.from_paddle_tpu_state(
            {k: np.array(p.numpy()) for k, p in a.named_parameters()}, b)
    return jl, tl


def test_pipeline_forward_matches_serial_and_jax():
    D = 16
    jl, tl = _blocks(0, 8, D)
    micro = np.random.RandomState(0).rand(4, 2, D).astype("float32")
    jcp = JCP(jl, mesh=_jmesh(4), n_micro=4)
    want = np.asarray(jax.jit(jcp.build_forward())(jcp._stacked,
                                                   jnp.asarray(micro)))
    cp = CompiledPipeline(tl, mesh=_mesh(4), n_micro=4)
    sends = REGISTRY.counter("collective_calls_total",
                             labels={"op": "send"}).value
    got = cp.build_forward()(cp._stacked, torch.from_numpy(micro))
    # each micro-batch crosses 3 stage boundaries and comes back home
    assert REGISTRY.counter("collective_calls_total", labels={
        "op": "send"}).value - sends == 4 * 4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    h = micro.reshape(-1, D)
    for b in tl:
        h = h + np.tanh(h @ b.lin.weight.detach().numpy() +
                        b.lin.bias.detach().numpy())
    np.testing.assert_allclose(got.numpy(), h.reshape(4, 2, D), rtol=1e-5,
                               atol=1e-5)


def _train(schedule, seed=7, steps=3, n_micro=4, jax_ref=False):
    D = 16
    jl, tl = _blocks(seed, 8, D)
    r = np.random.RandomState(seed)
    mx = r.rand(n_micro, 2, D).astype("float32")
    ty = r.rand(n_micro, 2, D).astype("float32")
    cp = CompiledPipeline(tl, mesh=_mesh(4), n_micro=n_micro)
    o = O.AdamW(5e-3, parameters=[p for b in tl for p in b.parameters()])
    step = cp.compile_train_step(
        o, lambda outs, ys: torch.mean((outs - ys) ** 2), schedule=schedule)
    got = [float(step(torch.from_numpy(mx), torch.from_numpy(ty)))
           for _ in range(steps)]
    want = None
    if jax_ref:
        jcp = JCP(jl, mesh=_jmesh(4), n_micro=n_micro)
        jo = jopt.AdamW(5e-3, parameters=[p for b in jl
                                          for p in b.parameters()])
        jstep = jcp.compile_train_step(
            jo, lambda outs, ys: jnp.mean((outs - ys) ** 2),
            schedule=schedule)
        want = [float(jstep(jnp.asarray(mx), jnp.asarray(ty)).numpy())
                for _ in range(steps)]
    return got, want, cp, step, tl


def test_pipeline_train_step_matches_jax():
    got, want, cp, step, tl = _train("1F1B", seed=1, steps=8, jax_ref=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0]
    # two layers per stage, each stage's parameters tagged and placed
    assert [p._pp_stage for b in tl for p in b.parameters()] == \
        [s for s in range(4) for _ in range(2 * 2)]
    assert cp._names == ["lin.weight", "lin.bias"]       # torch's order
    assert [tuple(v.shape) for v in cp._stacked] == [(8, 16, 16), (8, 16)]
    step.sync_layers()
    assert step.timing["fwd"] >= 0 and step.timing["w"] >= 0


def test_pipeline_grad_matches_serial():
    D = 8
    _, tl = _blocks(2, 4, D)
    cp = CompiledPipeline(tl, mesh=_mesh(2), n_micro=2)
    micro = torch.from_numpy(np.random.RandomState(2).rand(2, 3, D)
                             .astype("float32"))
    stacked = [v.clone().requires_grad_(True) for v in cp._stacked]
    (cp.build_forward()(stacked, micro) ** 2).sum().backward()
    serial = [v.detach().clone().requires_grad_(True) for v in cp._stacked]
    b_i, w_i = cp._names.index("lin.bias"), cp._names.index("lin.weight")
    h = micro.reshape(-1, D)
    for i in range(4):
        h = h + torch.tanh(h @ serial[w_i][i] + serial[b_i][i])
    (h ** 2).sum().backward()
    for a, b in zip(stacked, serial):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_pipeline_llama_decoder_layers():
    from paddle_tpu.models import LlamaConfig as JCfg, LlamaModel as JLM
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import LlamaModel

    kw = dict(vocab=64, hidden=32, layers=4, heads=4, kv_heads=4, ffn=64,
              seq=16)
    paddle.seed(3)
    jmodel = JLM(JCfg.tiny(**kw))
    model = LlamaModel(LlamaConfig.tiny(**kw), device="cpu")
    weights.from_paddle_tpu_state(
        {k: np.array(p.numpy()) for k, p in jmodel.named_parameters()},
        model)
    hidden = np.random.RandomState(3).randn(2, 2, 16, 32).astype("float32")
    jcp = JCP(list(jmodel.layers), mesh=_jmesh(2), n_micro=2)
    want = np.asarray(jax.jit(jcp.build_forward())(
        jcp._stacked, jnp.asarray(hidden), jmodel.rope_cos._value[:16],
        jmodel.rope_sin._value[:16]))
    cp = CompiledPipeline(list(model.layers), mesh=_mesh(2), n_micro=2)
    cos, sin = model.rope_cos[:16], model.rope_sin[:16]
    with torch.no_grad():
        got = cp.build_forward()(cp._stacked, torch.from_numpy(hidden), cos,
                                 sin)
        h = torch.from_numpy(hidden).reshape(4, 16, 32)
        for layer in model.layers:
            h = layer(h, cos, sin)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.reshape(4, 16, 32).numpy(), h.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_rejects_uneven_layers():
    with pytest.raises(ValueError, match="divisible"):
        CompiledPipeline([Block(8) for _ in range(5)], mesh=_mesh(4))
    with pytest.raises(ValueError, match="homogeneous"):
        CompiledPipeline([Block(8), Block(4)], mesh=_mesh(2))
    with pytest.raises(ValueError, match="homogeneous"):
        stack_layer_params([Block(8), nn.Linear(8, 8, device="cpu")])
    cp = CompiledPipeline([Block(8) for _ in range(2)], mesh=_mesh(2))
    with pytest.raises(ValueError, match="schedule"):
        cp.compile_train_step(O.SGD(0.1, parameters=[]), None,
                              schedule="VPP")


def test_zbh1_matches_1f1b_and_jax():
    """Same data, same init: the ZBH1 step's split backward gives the 1F1B
    step's losses bit for bit, and both the JAX schedules' losses."""
    l_ref, j_ref, *_ = _train("1F1B", jax_ref=True)
    l_zb, j_zb, *_ = _train("ZBH1", jax_ref=True)
    assert l_zb == l_ref
    np.testing.assert_allclose(l_ref, j_ref, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(l_zb, j_zb, rtol=2e-5, atol=1e-6)
    assert l_zb[-1] < l_zb[0]


def test_zbh1_with_outer_head_and_embed():
    """Outer embedding and head weights train through the split backward:
    dx of stage 0 feeds the embedding's backward, the loss's backward the
    head; equal to 1F1B and to the JAX steps."""
    D, V = 16, 12

    def build(schedule, seed=11):
        paddle.seed(seed)
        jl = [JBlock(D) for _ in range(4)]
        jemb, jhead = jnn.Linear(V, D), jnn.Linear(D, 1)
        tl = [Block(D) for _ in range(4)]
        emb = nn.Linear(V, D, device="cpu")
        head = nn.Linear(D, 1, device="cpu")
        for a, b in list(zip(jl, tl)) + [(jemb, emb), (jhead, head)]:
            weights.from_paddle_tpu_state(
                {k: np.array(p.numpy()) for k, p in a.named_parameters()}, b)
        jouter = list(jemb.parameters()) + list(jhead.parameters())
        outer = list(emb.parameters()) + list(head.parameters())
        r = np.random.RandomState(seed + 1)
        xs = r.rand(4, 2, V).astype("float32")
        ys = r.rand(4, 2, 1).astype("float32")
        jcp = JCP(jl, mesh=_jmesh(4), n_micro=4)
        jo = jopt.AdamW(5e-3, parameters=[p for b in jl
                                          for p in b.parameters()] + jouter)
        jstep = jcp.compile_train_step(
            jo, lambda ov, outs, y: jnp.mean((outs @ ov[2] + ov[3] - y) ** 2),
            outer_params=jouter, embed_fn=lambda ov, x: x @ ov[0] + ov[1],
            schedule=schedule)
        want = [float(jstep(jnp.asarray(xs), jnp.asarray(ys)).numpy())
                for _ in range(3)]
        cp = CompiledPipeline(tl, mesh=_mesh(4), n_micro=4)
        o = O.AdamW(5e-3, parameters=[p for b in tl
                                      for p in b.parameters()] + outer)
        step = cp.compile_train_step(
            o, lambda ov, outs, y: torch.mean((outs @ ov[2] + ov[3] - y)
                                              ** 2),
            outer_params=outer, embed_fn=lambda ov, x: x @ ov[0] + ov[1],
            schedule=schedule)
        got = [float(step(torch.from_numpy(xs), torch.from_numpy(ys)))
               for _ in range(3)]
        return got, want

    g1, w1 = build("1F1B")
    g2, w2 = build("ZBH1")
    assert g1 == g2
    np.testing.assert_allclose(g1, w1, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(g2, w2, rtol=2e-5, atol=1e-6)
    assert g2[-1] < g2[0]


def test_zbh1_reshapes():
    """Another micro-batch size or count runs the schedule anew."""
    _, tl = _blocks(5, 4, 16)
    cp = CompiledPipeline(tl, mesh=_mesh(4), n_micro=4)
    o = O.AdamW(1e-3, parameters=[p for b in tl for p in b.parameters()])
    step = cp.compile_train_step(
        o, lambda outs, ys: torch.mean((outs - ys) ** 2), schedule="ZBH1")
    for n_micro, mb in ((4, 2), (4, 5), (6, 2)):
        xs = torch.rand(n_micro, mb, 16)
        assert np.isfinite(float(step(xs, torch.rand(n_micro, mb, 16))))


def test_layer_split_grad_parity():
    """B (the dx chain) and W (the weight gradients) together give the
    layer's whole backward exactly."""
    D = 12
    r = np.random.RandomState(0)
    w = torch.from_numpy(r.randn(D, D).astype("float32")).requires_grad_()
    b = torch.zeros(D, requires_grad=True)
    x = torch.from_numpy(r.randn(5, D).astype("float32"))
    g = torch.from_numpy(r.randn(5, D).astype("float32"))

    def layer_fn(params, key, x):
        return x + torch.tanh(x @ params[0] + params[1])

    box = {}
    y, variant = capture_and_split(layer_fn, [w, b], None, x, (), box)
    split = box["split"]
    consts = split.merge_consts([w, b], (), variant)
    dx, cuts = split.chain_fn(g, consts)
    assert w.grad is None               # B computed no weight gradient
    dps = split.wgrad_fn(g, [consts[i] for i in split.wgrad_const_idx],
                         cuts)
    xr = x.clone().requires_grad_(True)
    yr = layer_fn([w, b], None, xr)
    want = torch.autograd.grad(yr, [w, b, xr], g)
    assert torch.equal(y, yr)
    assert torch.equal(dx, want[2])
    for a, c in zip(dps, want[:2]):
        assert torch.equal(a, c)
    with pytest.raises(RuntimeError, match="one call site"):
        capture_and_split(layer_fn, [w, b], None, x, (), box)


def _llama_pair(seed=0, **kw):
    from paddle_tpu.models import LlamaConfig as JCfg
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    kw = dict(vocab=128, hidden=64, layers=4, heads=4, kv_heads=4, ffn=128,
              seq=32, **kw)
    paddle.seed(seed)
    jm = JLlama(JCfg.tiny(**kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    weights.from_paddle_tpu_state(
        {k: np.array(p.numpy()) for k, p in jm.named_parameters()}, tm)
    return jm, tm


TP_RULES = {"q_proj": 1, "k_proj": 1, "v_proj": 1, "gate_proj": 1,
            "up_proj": 1, "o_proj": 0, "down_proj": 0}


def test_apply_tp_and_zero_specs_equal_jax():
    jm, tm = _llama_pair()
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                 ("dp", "pp", "mp"))
    jcp = JCP(jm.llama.layers, mesh=jmesh, axis="pp", n_micro=4)
    jcp.apply_tp(TP_RULES)
    cp = CompiledPipeline(tm.llama.layers, mesh=_mesh(
        8, ("dp", "pp", "mp"), (2, 2, 2)), axis="pp", n_micro=4)
    cp.apply_tp(TP_RULES)
    assert cp._names == jcp._names
    assert [tuple(s) for s in cp._param_specs] == \
        [tuple(s) for s in jcp._param_specs]
    for spec, v in zip(cp._param_specs, jcp._stacked):
        assert tuple(cp._zero_spec(spec, v.shape, "dp")) == \
            tuple(jcp._zero_spec(jax.sharding.PartitionSpec(*spec),
                                 v.shape, "dp"))
    q = tm.llama.layers[0].self_attn.q_proj.weight
    assert [repr(p) for p in q._dist_attr.placements] == \
        ["Replicate()", "Replicate()", "Shard(dim=1)"]


def test_full_hybrid_tp_pp_dp_zero2():
    """``full_hybrid_demo``: dp 2 x pp 2 x mp 2 (placements) with ZeRO-2
    over dp, the embedding, final norm and head outside the pipelined
    stack: the first loss equals the JAX model's serial eager loss, the
    loss falls, each dp owner holds half of every q_proj moment, and ZBH1
    gives the same losses."""
    import paddle_tpu.framework.flags as jflags

    jm, _ = _llama_pair()
    cfg = jm.config
    batch, seq, n_micro = 8, 32, 4
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq))
    lab = np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, seq))
    prev = jflags.get_flag("fused_lm_head_ce")
    jflags.set_flags({"FLAGS_fused_lm_head_ce": False})
    try:
        with paddle.no_grad():
            eager = float(jm(paddle.to_tensor(ids.astype(np.int32)),
                             labels=paddle.to_tensor(lab.astype(np.int32))
                             ).numpy())
    finally:
        jflags.set_flags({"FLAGS_fused_lm_head_ce": prev})
    eps = cfg.rms_norm_eps
    mx = torch.from_numpy(ids.reshape(n_micro, batch // n_micro, seq))
    my = torch.from_numpy(lab.reshape(n_micro, batch // n_micro, seq))

    def embed_fn(ov, x):
        return ov[0][x]

    def loss_fn(ov, outs, ys):
        h = outs * torch.rsqrt((outs.float() ** 2).mean(-1, keepdim=True)
                               + eps) * ov[1]
        logp = torch.log_softmax((h @ ov[2]).float(), -1)
        return -logp.gather(-1, ys[..., None]).mean()

    runs = {}
    for schedule in ("1F1B", "ZBH1"):
        _, tm = _llama_pair()
        cp = CompiledPipeline(tm.llama.layers, mesh=_mesh(
            8, ("dp", "pp", "mp"), (2, 2, 2)), axis="pp", n_micro=n_micro)
        cp.apply_tp(TP_RULES)
        outer = [tm.llama.embed_tokens.weight, tm.llama.norm.weight,
                 tm.lm_head.weight]
        o = O.AdamW(1e-3, parameters=tm.parameters())
        step = cp.compile_train_step(o, loss_fn, outer_params=outer,
                                     zero_axis="dp", embed_fn=embed_fn,
                                     schedule=schedule)
        cos, sin = tm.llama.rope_cos[:seq], tm.llama.rope_sin[:seq]
        runs[schedule] = [float(step(mx, my, cos, sin)) for _ in range(3)]
        q = tm.llama.layers[0].self_attn.q_proj.weight
        sh = step.zero.shards[id(q)]
        m = [st[0] for st in sh.states]
        assert [tuple(t.shape) for t in m] == [(cfg.hidden_size // 2,
                                                cfg.hidden_size)] * 2
        b = step.zero.state_bytes()
        assert b["per_rank"][0] == b["per_rank"][1]
    losses = runs["1F1B"]
    np.testing.assert_allclose(losses[0], eager, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert runs["ZBH1"] == losses
