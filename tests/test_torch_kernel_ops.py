"""The kernels as capturable ops (``paddle_tpu_torch.ops.kernels._ops``).

- every ``ptt`` custom op passes ``torch.library.opcheck`` (schema, fake
  implementation against the real one, autograd registration, and an
  AOT capture with dynamic shapes);
- each differentiable op's gradient equals the gradient of the JAX
  package's reference composition (``jax.vjp`` of ``_rms_xla``,
  ``_swiglu_xla``, ``_rope_xla``, ``_sdpa_reference_gqa``), float32,
  atol 2e-5 / rtol 1e-5 (the two sides sum in other orders);
- ``make_fx`` of the port's Llama records one node per kernel (flash
  forward L, RMSNorm 2L + 1, SwiGLU L, the q + k RoPE L, the fused loss
  1) and no autograd Function's forward inlined; its replay's loss and
  gradients equal eager's exactly, and its backward reaches the flash
  and RoPE backward ops;
- the fused linear cross-entropy under capture gives eager's gradient
  (bit for bit: the same backward runs);
- under ``xla_introspect``'s counter each kernel's op is charged once,
  its cost from the op's arguments.

Inputs are numpy draws from fixed seeds.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.ops.pallas.flash_attention import _sdpa_reference_gqa
from paddle_tpu.ops.pallas.fused_ffn import _swiglu_xla
from paddle_tpu.ops.pallas.norms import _rms_xla, _rope_xla

from paddle_tpu_torch import compiler, weights
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import xla_introspect as txi
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _ops

ATOL, RTOL = 2e-5, 1e-5


def _rand(rng, *shape, grad=False):
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return t.requires_grad_(grad)


def _cases():
    rng = np.random.default_rng(0)
    r = lambda *s, g=False: _rand(rng, *s, grad=g)  # noqa: E731
    q, k, v = r(2, 8, 4, 16, g=True), r(2, 8, 2, 16, g=True), \
        r(2, 8, 2, 16, g=True)
    st = torch.full((2, 1, 8), 5, dtype=torch.int32)
    en = torch.full((2, 1, 8), 8, dtype=torch.int32)
    with torch.no_grad():
        out, lse = _ops.flash_attention_fwd_op(q, k, v, True, None)
    do = r(2, 8, 4, 16)
    qq, kk, vv = (t.detach() for t in (q, k, v))
    return {
        "flash_attention_fwd": (_ops.flash_attention_fwd_op,
                                (q, k, v, True, None)),
        "flash_attention_bwd": (_ops.flash_attention_bwd_op,
                                (qq, kk, vv, out, lse, do, True, None)),
        "flashmask_attention_fwd": (_ops.flashmask_attention_fwd_op,
                                    (q, k, v, st, en, None, None, True,
                                     0.3)),
        "flashmask_attention_bwd": (_ops.flashmask_attention_bwd_op,
                                    (qq, kk, vv, out, lse, do, st, en, None,
                                     None, True, None)),
        "rms_norm": (_ops.rms_norm_op, (r(4, 32, g=True), r(32, g=True),
                                        1e-6)),
        "swiglu": (_ops.swiglu_op, (r(4, 32, g=True), r(4, 32, g=True))),
        "fused_rope": (_ops.fused_rope_op, (r(2, 8, 4, 16, g=True),
                                            r(8, 16), r(8, 16))),
        "fused_rope_qk": (_ops.fused_rope_qk_op,
                          (r(2, 8, 4, 16, g=True), r(2, 8, 2, 16, g=True),
                           r(8, 16), r(8, 16))),
        "fused_rope_bwd": (_ops.fused_rope_bwd_op,
                           (r(2, 8, 4, 16), r(8, 16), r(8, 16))),
        "fused_rope_qk_bwd": (_ops.fused_rope_qk_bwd_op,
                              (r(2, 8, 4, 16), r(2, 8, 2, 16), r(8, 16),
                               r(8, 16))),
        "bias_dropout_residual_ln": (
            _ops.bias_dropout_residual_ln_op,
            (r(4, 32, g=True), r(4, 32, g=True), r(32, g=True),
             r(32, g=True), r(32, g=True), 1e-5, 0.0, 0)),
        "bias_dropout_residual_ln[p0.1]": (
            _ops.bias_dropout_residual_ln_op,
            (r(4, 32, g=True), r(4, 32, g=True), r(32, g=True),
             r(32, g=True), None, 1e-5, 0.1, 7)),
        "fused_linear_cross_entropy": (
            F._flce_op, (r(6, 16, g=True), r(16, 300, g=True),
                         torch.tensor([1, 5, 299, 0, -100, 7]), False,
                         128)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_opcheck(name):
    op, args = _cases()[name]
    torch.library.opcheck(op, args)


def _jax_grads(fn, args, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL, err_msg=what)


def test_op_gradients_equal_jax_reference():
    """Each op's registered backward against jax.vjp of the JAX package's
    reference composition, on the same inputs."""
    rng = np.random.default_rng(1)
    x, w = rng.normal(size=(4, 32)), rng.normal(size=(32,))
    g = rng.normal(size=(4, 32))
    tx, tw = (torch.tensor(a, dtype=torch.float32, requires_grad=True)
              for a in (x, w))
    _ops.RMSNorm.apply(tx, tw, 1e-6).backward(torch.tensor(
        g, dtype=torch.float32))
    want = _jax_grads(lambda a, b: _rms_xla(a, b, 1e-6),
                      (x.astype(np.float32), w.astype(np.float32)),
                      g.astype(np.float32))
    _close(tx.grad, want[0], "rms dx")
    _close(tw.grad, want[1], "rms dw")

    gate, up = (rng.normal(size=(4, 32)).astype(np.float32)
                for _ in range(2))
    tg, tu = (torch.tensor(a, requires_grad=True) for a in (gate, up))
    _ops.SwiGLU.apply(tg, tu).backward(torch.tensor(g, dtype=torch.float32))
    want = _jax_grads(_swiglu_xla, (gate, up), g.astype(np.float32))
    _close(tg.grad, want[0], "swiglu dgate")
    _close(tu.grad, want[1], "swiglu dup")

    xq = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    xk = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    cos, sin = (rng.normal(size=(8, 16)).astype(np.float32)
                for _ in range(2))
    gq = rng.normal(size=xq.shape).astype(np.float32)
    gk = rng.normal(size=xk.shape).astype(np.float32)
    tq, tk = (torch.tensor(a, requires_grad=True) for a in (xq, xk))
    oq, ok = _ops.FusedRoPEQK.apply(tq, tk, torch.tensor(cos),
                                    torch.tensor(sin))
    torch.autograd.backward((oq, ok), (torch.tensor(gq), torch.tensor(gk)))
    c4, s4 = cos[None, :, None, :], sin[None, :, None, :]
    _close(tq.grad, _jax_grads(lambda a: _rope_xla(a, c4, s4), (xq,),
                               gq)[0], "rope dq")
    _close(tk.grad, _jax_grads(lambda a: _rope_xla(a, c4, s4), (xk,),
                               gk)[0], "rope dk")

    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=q.shape).astype(np.float32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    _ops.FlashAttention.apply(tq, tk, tv, True, None).backward(
        torch.tensor(do))

    def ref(a, b, c):          # [B, S, H, D] <-> [B * H, S, D]
        flat = [jnp.swapaxes(t, 1, 2).reshape(-1, 8, 16) for t in (a, b, c)]
        out = _sdpa_reference_gqa(*flat, True, 1.0 / np.sqrt(16), 4, 2)
        return jnp.swapaxes(out.reshape(2, 4, 8, 16), 1, 2)
    want = _jax_grads(ref, (q, k, v), do)
    for got, w_, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        _close(got, w_, f"flash d{name}")


class _Calls(TorchDispatchMode):
    """Counts the ptt ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "ptt":
            name = func.name().split("::")[1]
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _tiny_llama(seed=0):
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                           kv_heads=2, ffn=64, seq=32)
    return weights.init_random_(LlamaForCausalLM(cfg, device="cpu"), seed)


def _batch(seed, vocab=64):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, vocab, (2, 16)))
                 for _ in range(2))


def test_make_fx_of_port_llama_records_one_node_per_kernel():
    model = _tiny_llama()
    model.train()
    ids, lab = _batch(2)
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    names = list(state)

    def loss(*ts):
        return torch.func.functional_call(
            model, dict(zip(names, ts[:-2])), (ts[-2],),
            {"labels": ts[-1]})

    gm = make_fx(loss, tracing_mode="fake")(*state.values(), ids, lab)
    nodes = {}
    for n in gm.graph.nodes:
        if isinstance(n.target, torch._ops.OpOverload) and \
                n.target.namespace == "ptt":
            name = n.target.name().split("::")[1]
            nodes[name] = nodes.get(name, 0) + 1
    layers = model.config.num_hidden_layers
    assert nodes == {"flash_attention_fwd": layers,
                     "rms_norm": 2 * layers + 1, "swiglu": layers,
                     "fused_rope_qk": layers,
                     "fused_linear_cross_entropy": 1}
    # the replay is the eager program: the same loss and gradients
    want = model(ids, labels=lab)
    want.backward()
    want_g = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    with _Calls() as calls:
        got = gm(*state.values(), ids, lab)
        got.backward()
    assert torch.equal(got, want)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, want_g[n]), n
    # the kernels' own backwards ran, one launch each per layer
    assert calls.calls["flash_attention_bwd"] == layers
    assert calls.calls["fused_rope_qk_bwd"] == layers


def test_fused_linear_cross_entropy_under_capture_gives_eager_gradient():
    rng = np.random.default_rng(3)
    hid = torch.from_numpy(rng.normal(size=(12, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 300)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(-1, 300, (12,)))

    def loss(h, w, lab):
        return F.fused_linear_cross_entropy(h, w, lab, chunk_size=128)

    grads = []
    for fn in (loss, compiler.optimize(loss, name="flce",
                                       pass_manager=compiler.PassManager(
                                           []))):
        h, ww = hid.clone().requires_grad_(), w.clone().requires_grad_()
        fn(h, ww, lab).backward()
        grads.append((h.grad, ww.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    gm = make_fx(loss, tracing_mode="fake")(hid, w, lab)
    assert [n.target for n in gm.graph.nodes
            if n.op == "call_function" and "ptt" in str(n.target)] == \
        [torch.ops.ptt.fused_linear_cross_entropy.default]


def test_counter_charges_each_kernel_op_once():
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 64, 32), _rand(rng, 32)
    from paddle_tpu_torch.observability import metrics
    was = metrics.enabled()
    metrics.enable()
    try:
        with txi.count("kernel_ops_once", args=(x, w)) as c:
            out = K.RMSNorm.apply(x, w, 1e-6)
            c.outputs = out
    finally:
        if not was:
            metrics.disable()
    k = c.analysis["kernels"]["rms_norm"]
    assert k["calls"] == 1
    assert (k["flops"], k["bytes"]) == tuple(
        int(v) for v in K._cost.rms_norm(x, w))
    assert c.analysis["flops"] == k["flops"]


def test_cpu_ops_launch_nothing():
    """On the CPU each op computes the plain version: no launch counted,
    exactly as the wrappers did before they became ops."""
    K.reset_launch_counts()
    for name, (op, args) in _cases().items():
        op(*args)
    assert all(v == 0 for v in K.launch_counts().values())
